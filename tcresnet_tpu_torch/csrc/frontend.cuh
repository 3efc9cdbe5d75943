// The front ends' shared pieces (FeArgs, FeVariant, fe_launch, fe_bf16,
// fe_sample), and K4's spectral front end: one utterance's samples in
// shared memory -> MFCC or log-mel features, on the CUDA cores.
//
//   K4  csrc/infer.cu    wav -> features -> convs -> logits (infer.py::_kernel)
//
// runs the stage below (fe_features). The other front ends run on the
// tensor cores: K2 (mfcc.py::_kernel, k2_mfcc) and K3's hops entry point,
// K8 (::_kernel_phases) and K3's phases entry point in dft_tc.cuh, K9
// (::_kernel_radix4) and K3's radix4 entry point in radix4.cuh.
//
// K4 runs, with all threads of the block:
//   1. fe_dft_hops: every frame's full-window dot with the windowed DFT,
//      reim[f] = frame[f] @ W, into the power (MFCC) or magnitude (log-mel)
//      spectrum [frames, nbp] in region B;
//   2. fe_tail: mel and log(mel + 1e-6), then the DCT for MFCC.
// The DFT is the bulk of the work: per 1 s clip 24.2 M multiply-adds at
// 480/160, 32.2 M at 640/320. Its bound on the H100 is FP32 FMA issue: this
// stage runs on the CUDA cores. It is register-blocked: each thread owns 4
// output columns x RF frames, the columns interleaved (re_k, im_k, re_k+1,
// im_k+1) so that a thread forms two power bins from its own accumulators.
//
// Shared memory: region A holds the samples on entry and the log-mel after
// step 2; region B holds the power spectrum [frames, nbp] after step 1 and
// the features [frames, C] on return (C <= nbp). nbp = 2 * ncg. The caller
// fills region A (through fe_sample, which applies the bf16 rounding of
// dsp_matmul_dtype="bfloat16" to the DFT's A operand) and synchronises
// before the call; the call ends synchronised.
//
// Numerics: float32, fmaf in a fixed order, IEEE logf/sqrtf (the build
// has no --use_fast_math). With round_bf16 the DFT's A operand is rounded
// to bf16 and its constant is passed already rounded; products still
// accumulate in float32 (the JAX path's preferred_element_type=f32).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define FE_THREADS 256
#define FE_RF 14  // frames per thread in the DFT micro-tile
#define FE_RM 7   // frames per thread in the mel / DCT micro-tile

struct FeArgs {
  // K4: [window, 4 * ncg], columns (re_k, im_k, re_k+1, im_k+1); K2, K8:
  // [window rounded up to 32, 128 units], zero rows and columns past it
  const float* dft;
  const float* mel;  // [num_bins, num_mel]; K2, K8, K9: the nonzero weights of their mel runs
  const float* dct;  // [num_mel, num_coef]; unused when magnitude
  int n, window, hop, frames, ncg, num_bins, num_mel, num_coef;
  int magnitude, round_bf16;
};

// The tensor-core stages' constants: K2 and K8 (the frames' stage,
// dft_tc.cuh) and K9 (radix4.cuh); K4's stage needs none.
struct FeVariant {
  // radix4: the live columns of M0 [L, L], M1 [2L, 2L], M2 [L, L] back to
  // back, row-major, each as (re, im) pairs; frames: FeArgs.dft
  const float* w;
  const float* win;   // radix4: the window zero-padded to 4L
  const int* runs;    // the mel runs [units][num_mel][3] (dft_tc.cuh)
  float* part;        // frames, split tiles: the units' mel contributions
  int* done;          // frames, split tiles: per tile, its blocks that finished (0 between calls)
  int length;         // radix4: L
  int mel_nnz;        // the mel's nonzero weights (FeArgs.mel)
  int units;          // frames: column units of 128 (fft / 128, at least 1)
  int rows;           // frames: rows of a block's tile (the host plan's)
  int splits;         // frames: blocks a tile's units are split over (the host plan's)
  int stride, gap;    // frames: the staged samples' chunk stride and piece gap (floats)
};

// Launches Kernel on `grid` blocks of FE_THREADS. Above 48 KB of dynamic
// shared memory a kernel needs its limit raised first: that is done once
// per kernel, device and larger size, not on every launch.
template <class Args, void (*Kernel)(Args)>
static int fe_launch(int grid, int smem_bytes, const Args& args, void* stream) {
  static int granted[64] = {};  // per device: the bytes this kernel may use
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int& have = granted[dev & 63];
  if (smem_bytes > 48 * 1024 && smem_bytes > have) {
    e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    have = smem_bytes;
  }
  Kernel<<<grid, FE_THREADS, smem_bytes, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

__device__ __forceinline__ float fe_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float fe_sample(const FeArgs& a, float x) {
  return a.round_bf16 ? fe_bf16(x) : x;
}

__device__ __forceinline__ int fe_width(const FeArgs& a) {
  return a.magnitude ? a.num_mel : a.num_coef;
}

// One register tile of a DFT product: for RF rows of x starting at base[i],
// acc[i][q] = sum_{s < k} x[base[i] + s] * w[s][4 cg + q], w read as
// float4 rows `ld` float4s apart. base[i] and k are multiples of 4.
template <int RF>
__device__ __forceinline__ void fe_dft_tile(const float* x, const int (&base)[RF],
                                            const float4* w4, int ld, int cg, int k,
                                            float (&acc)[RF][4]) {
#pragma unroll
  for (int i = 0; i < RF; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll 2
  for (int s = 0; s < k; s += 4) {
    const float4 w0 = __ldg(&w4[(s + 0) * ld + cg]);
    const float4 w1 = __ldg(&w4[(s + 1) * ld + cg]);
    const float4 w2 = __ldg(&w4[(s + 2) * ld + cg]);
    const float4 w3 = __ldg(&w4[(s + 3) * ld + cg]);
#pragma unroll
    for (int i = 0; i < RF; ++i) {
      const float4 xv = *reinterpret_cast<const float4*>(x + base[i] + s);
      acc[i][0] = fmaf(xv.x, w0.x, acc[i][0]);
      acc[i][1] = fmaf(xv.x, w0.y, acc[i][1]);
      acc[i][2] = fmaf(xv.x, w0.z, acc[i][2]);
      acc[i][3] = fmaf(xv.x, w0.w, acc[i][3]);
      acc[i][0] = fmaf(xv.y, w1.x, acc[i][0]);
      acc[i][1] = fmaf(xv.y, w1.y, acc[i][1]);
      acc[i][2] = fmaf(xv.y, w1.z, acc[i][2]);
      acc[i][3] = fmaf(xv.y, w1.w, acc[i][3]);
      acc[i][0] = fmaf(xv.z, w2.x, acc[i][0]);
      acc[i][1] = fmaf(xv.z, w2.y, acc[i][1]);
      acc[i][2] = fmaf(xv.z, w2.z, acc[i][2]);
      acc[i][3] = fmaf(xv.z, w2.w, acc[i][3]);
      acc[i][0] = fmaf(xv.w, w3.x, acc[i][0]);
      acc[i][1] = fmaf(xv.w, w3.y, acc[i][1]);
      acc[i][2] = fmaf(xv.w, w3.z, acc[i][2]);
      acc[i][3] = fmaf(xv.w, w3.w, acc[i][3]);
    }
  }
}

// Two power (or magnitude) bins from one (re, im, re, im) accumulator group.
__device__ __forceinline__ void fe_power2(const FeArgs& a, const float (&acc)[4], float* dst) {
  float p0 = acc[0] * acc[0] + acc[1] * acc[1];
  float p1 = acc[2] * acc[2] + acc[3] * acc[3];
  if (a.magnitude) {
    p0 = sqrtf(p0);
    p1 = sqrtf(p1);
  }
  dst[0] = p0;
  dst[1] = p1;
}

// ---- 1. DFT stage -> power / magnitude [frames, nbp] in B ----

__device__ __forceinline__ void fe_dft_hops(const FeArgs& a, const float* reg_a, float* reg_b) {
  const int nbp = 2 * a.ncg;
  const float4* dft4 = reinterpret_cast<const float4*>(a.dft);
  const int nfg = (a.frames + FE_RF - 1) / FE_RF;
  for (int item = threadIdx.x; item < a.ncg * nfg; item += blockDim.x) {
    const int cg = item % a.ncg;
    const int fg = item / a.ncg;
    int base[FE_RF];
#pragma unroll
    for (int i = 0; i < FE_RF; ++i) base[i] = min(fg * FE_RF + i, a.frames - 1) * a.hop;
    float acc[FE_RF][4];
    fe_dft_tile<FE_RF>(reg_a, base, dft4, a.ncg, cg, a.window, acc);
#pragma unroll
    for (int i = 0; i < FE_RF; ++i) {
      const int f = fg * FE_RF + i;
      if (f < a.frames) fe_power2(a, acc[i], reg_b + f * nbp + 2 * cg);
    }
  }
}

// ---- 2-3. mel, log and DCT ----
__device__ __forceinline__ void fe_tail(const FeArgs& a, float* reg_a, float* reg_b) {
  const int nbp = 2 * a.ncg;  // power bins per row, padded to the column groups
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;

  // ---- 2. mel + log -> log-mel [frames, num_mel] in A (the samples are dead) ----
  {
    const int mfg = (a.frames + FE_RM - 1) / FE_RM;
    for (int item = tid; item < a.num_mel * mfg; item += nthr) {
      const int m = item % a.num_mel;
      const int fg = item / a.num_mel;
      int row[FE_RM];
      float acc[FE_RM];
#pragma unroll
      for (int i = 0; i < FE_RM; ++i) {
        row[i] = min(fg * FE_RM + i, a.frames - 1) * nbp;
        acc[i] = 0.f;
      }
      for (int k = 0; k < a.num_bins; ++k) {
        const float w = __ldg(&a.mel[k * a.num_mel + m]);
#pragma unroll
        for (int i = 0; i < FE_RM; ++i) acc[i] = fmaf(reg_b[row[i] + k], w, acc[i]);
      }
#pragma unroll
      for (int i = 0; i < FE_RM; ++i) {
        const int f = fg * FE_RM + i;
        if (f < a.frames) reg_a[f * a.num_mel + m] = logf(acc[i] + 1e-6f);
      }
    }
  }
  __syncthreads();

  // ---- 3. features [frames, C] in B (the power spectrum is dead) ----
  if (a.magnitude) {
    for (int i = tid; i < a.frames * a.num_mel; i += nthr) reg_b[i] = reg_a[i];
  } else {
    const int mfg = (a.frames + FE_RM - 1) / FE_RM;
    for (int item = tid; item < a.num_coef * mfg; item += nthr) {
      const int c = item % a.num_coef;
      const int fg = item / a.num_coef;
      int row[FE_RM];
      float acc[FE_RM];
#pragma unroll
      for (int i = 0; i < FE_RM; ++i) {
        row[i] = min(fg * FE_RM + i, a.frames - 1) * a.num_mel;
        acc[i] = 0.f;
      }
      for (int m = 0; m < a.num_mel; ++m) {
        const float w = __ldg(&a.dct[m * a.num_coef + c]);
#pragma unroll
        for (int i = 0; i < FE_RM; ++i) acc[i] = fmaf(reg_a[row[i] + m], w, acc[i]);
      }
#pragma unroll
      for (int i = 0; i < FE_RM; ++i) {
        const int f = fg * FE_RM + i;
        if (f < a.frames) reg_b[f * a.num_coef + c] = acc[i];
      }
    }
  }
  __syncthreads();
}

// Steps 1-3 (K4)
__device__ __forceinline__ void fe_features(const FeArgs& a, float* reg_a, float* reg_b) {
  fe_dft_hops(a, reg_a, reg_b);
  __syncthreads();
  fe_tail(a, reg_a, reg_b);
}
