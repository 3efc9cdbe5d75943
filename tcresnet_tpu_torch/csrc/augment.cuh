// The per-sample body of the port's augmentation kernels (K1, K6) and of
// the fused front end (K3): shift, silence zeroing, background mix, clip.
//
//   out[t] = clip(keep * x[t - shift] + vol * noise[clip, off + t], -1, 1)
//
// with x[t - shift] = 0 outside [0, n) (zero fill, signed shift), keep 0
// for silence rows, off quantized down to a multiple of 1024 when
// noise_crop_quantize is set (the TPU kernel's DMA-tile crops). The same
// expression as tcresnet_tpu/ops/pallas/augment.py::shift_row and
// ::mix_crop_row, without their roll decomposition: on Hopper a shifted
// read is a coalesced load at an offset.
//
// Bit-exactness with the plain PyTorch version (and so with the JAX
// kernel): the product and sum are written with __fmul_rn / __fadd_rn so
// that nvcc cannot contract them into an FMA (one rounding instead of
// two); keep is applied as a multiply, as shift_row does. The int16
// decode (x * 2^-15) is exact.

#pragma once

#include <cuda_runtime.h>

#define AUG_QUANTUM 1024  // crop-offset quantum of noise_crop_quantize

struct AugArgs {
  const void* src;     // int16 dataset [rows, row_stride] (K1, K3) or f32 batch [batch, row_stride] (K6)
  const int* idx;      // [batch] source row of each output row; null: row b (K6)
  const int* shifts;   // [batch] signed sample shift
  const int* clips;    // [batch] noise clip
  const int* offs;     // [batch] crop offset in the clip
  const float* vols;   // [batch] background volume
  const float* keeps;  // [batch] 0 for silence rows, else 1
  const float* noise;  // [num_clips, clip_len]
  float* out;          // [batch, n] augmented rows (K1, K6); [batch, frames, C] features (K3)
  long long row_stride;  // elements between source rows
  int batch, n, clip_len, quantize;
};

// The per-row scalars of output row b, resolved to pointers.
template <typename T>
struct AugRow {
  const T* src;
  const float* crop;
  int shift;
  float keep, vol, scale;
};

template <typename T>
__device__ __forceinline__ AugRow<T> aug_row(const AugArgs& a, int b, float scale) {
  AugRow<T> r;
  const long long row = a.idx ? (long long)__ldg(a.idx + b) : (long long)b;
  r.src = static_cast<const T*>(a.src) + row * a.row_stride;
  int off = __ldg(a.offs + b);
  if (a.quantize) off -= off % AUG_QUANTUM;
  r.crop = a.noise + (long long)__ldg(a.clips + b) * a.clip_len + off;
  r.shift = __ldg(a.shifts + b);
  r.keep = __ldg(a.keeps + b);
  r.vol = __ldg(a.vols + b);
  r.scale = scale;
  return r;
}

template <typename T>
__device__ __forceinline__ float aug_sample(const AugRow<T>& r, int n, int t) {
  const int s = t - r.shift;
  float x = 0.f;
  if (s >= 0 && s < n) x = __fmul_rn((float)__ldg(r.src + s), r.scale);
  x = __fmul_rn(x, r.keep);
  const float y = __fadd_rn(x, __fmul_rn(r.vol, __ldg(r.crop + t)));
  return fminf(fmaxf(y, -1.f), 1.f);
}
