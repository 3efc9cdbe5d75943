// Gather + decode + augment (K1) and augment of a gathered batch (K6).
//
// Replaces the TPU kernels tcresnet_tpu/ops/pallas/augment.py::_kernel_gather
// (K1: int16 dataset row idx[b] x 2^-15) and ::_kernel (K6: an f32 batch,
// row b). Both compute, per output sample (augment.cuh):
//   out[b, t] = clip(keep * x[t - shift] + vol * noise[clip, off + t], -1, 1)
//
// What bounds it on the H100: memory. Per 1 s row it reads 32 KB of int16
// (K1) or 64 KB of f32 (K6), reads a 64 KB noise crop and writes 64 KB of
// f32: at batch 1536 about 246 MB for K1, ~73 us at 3.35 TB/s. The noise
// bank (4 clips of 2 s, 512 KB) stays in L2, so in practice the dataset
// reads and the output writes set the time.
//
// What the design does about it. The TPU kernel decomposed every shifted
// read into sublane/lane rolls of a pow2-padded [P/128, 128] row, and DMA'd
// the noise crop at 8-row granularity, because Mosaic has no lane gather.
// None of that carries over: here each thread reads its sample at the
// shifted offset, and neighbouring threads read neighbouring addresses, so
// every load and the store are coalesced. One thread per output sample,
// a 2D grid (samples, batch rows); the per-row scalars are loaded by every
// thread of the row and served from L1. The dataset keeps a flat
// [rows, row_stride] int16 layout with 16-byte aligned rows.
//
// Numerics: bit-exact with the plain version (augment.cuh).
//
// Build: ops/kernels/_build.py (nvcc, sm_90a, plain C entry points that
// launch on the given stream and return cudaGetLastError()).

#include <cuda_runtime.h>

#include "augment.cuh"

#define AUG_THREADS 256

template <typename T>
__global__ void __launch_bounds__(AUG_THREADS) aug_kernel(const AugArgs a, float scale) {
  const int b = blockIdx.y;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= a.n) return;
  const AugRow<T> r = aug_row<T>(a, b, scale);
  a.out[(long long)b * a.n + t] = aug_sample(r, a.n, t);
}

template <typename T>
static int launch(const AugArgs* a, float scale, void* stream) {
  const dim3 grid((a->n + AUG_THREADS - 1) / AUG_THREADS, a->batch);
  aug_kernel<T><<<grid, AUG_THREADS, 0, (cudaStream_t)stream>>>(*a, scale);
  return (int)cudaGetLastError();
}

// K1: rows of the int16 dataset by idx, decoded by 2^-15.
extern "C" int k1_gather_augment(const AugArgs* a, void* stream) {
  return launch<short>(a, 1.0f / 32768.0f, stream);
}

// K6: rows of an f32 batch (idx null).
extern "C" int k6_augment(const AugArgs* a, void* stream) {
  return launch<float>(a, 1.0f, stream);
}

extern "C" int aug_args_size(void) { return (int)sizeof(AugArgs); }

extern "C" const char* aug_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
