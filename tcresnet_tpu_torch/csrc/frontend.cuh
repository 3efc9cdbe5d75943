// The spectral front end shared by the port's CUDA kernels: one
// utterance's samples in shared memory -> MFCC or log-mel features.
//
// One implementation for three kernels, as the JAX package has one
// `mfcc_tail` (tcresnet_tpu/ops/pallas/mfcc.py) for its fused MFCC,
// front-end and inference kernels:
//   K2 csrc/mfcc.cu      wav -> features (ops/pallas/mfcc.py::_kernel)
//   K3 csrc/frontend.cu  gather + augment -> features (frontend.py::_kernel)
//   K4 csrc/infer.cu     wav -> features -> convs -> logits (infer.py::_kernel)
//
// fe_features() runs, with all threads of the block:
//   1. the windowed real DFT of every frame from the L2-resident constant
//      (reim[f] = frame[f] @ W) and power (MFCC) or magnitude (log-mel),
//   2. mel and log(mel + 1e-6),
//   3. the DCT for MFCC.
// The DFT is the bulk of the work (~24.7 M multiply-adds per 1 s clip of
// ~27 M); its bound on the H100 is FP32 FMA issue (no tensor cores here).
// It is register-blocked: each thread owns 4 output columns x 14 frames,
// the columns interleaved (re_k, im_k, re_k+1, im_k+1) so that a thread
// forms two power bins from its own accumulators.
//
// Shared memory: region A holds the samples on entry and the log-mel
// after step 2; region B holds the power spectrum [frames, 2*ncg] after
// step 1 and the features [frames, C] on return (C <= 2*ncg). The caller
// fills region A (through fe_sample, which applies the bf16 rounding of
// dsp_matmul_dtype="bfloat16") and synchronises before the call; the call
// ends synchronised.
//
// Numerics: float32, fmaf in a fixed order, IEEE logf/sqrtf (the build
// has no --use_fast_math). With round_bf16 the samples are rounded to
// bf16 and the DFT constant is passed already rounded; products still
// accumulate in float32 (the JAX path's preferred_element_type=f32).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define FE_THREADS 256
#define FE_RF 14  // frames per thread in the DFT micro-tile
#define FE_RM 7   // frames per thread in the mel / DCT micro-tile

struct FeArgs {
  const float* dft;  // [window, 4 * ncg], columns (re_k, im_k, re_k+1, im_k+1)
  const float* mel;  // [num_bins, num_mel]
  const float* dct;  // [num_mel, num_coef]; unused when magnitude
  int n, window, hop, frames, ncg, num_bins, num_mel, num_coef;
  int magnitude, round_bf16;
};

__device__ __forceinline__ float fe_sample(const FeArgs& a, float x) {
  return a.round_bf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

__device__ __forceinline__ int fe_width(const FeArgs& a) {
  return a.magnitude ? a.num_mel : a.num_coef;
}

__device__ __forceinline__ void fe_features(const FeArgs& a, float* reg_a, float* reg_b) {
  const int nbp = 2 * a.ncg;  // power bins per row, padded to the column groups
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;

  // ---- 1. windowed real DFT -> power / magnitude [frames, nbp] in B ----
  {
    const float4* dft4 = reinterpret_cast<const float4*>(a.dft);
    const int nfg = (a.frames + FE_RF - 1) / FE_RF;
    for (int item = tid; item < a.ncg * nfg; item += nthr) {
      const int cg = item % a.ncg;
      const int fg = item / a.ncg;
      int base[FE_RF];
#pragma unroll
      for (int i = 0; i < FE_RF; ++i) base[i] = min(fg * FE_RF + i, a.frames - 1) * a.hop;
      float acc[FE_RF][4];
#pragma unroll
      for (int i = 0; i < FE_RF; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll 2
      for (int s = 0; s < a.window; s += 4) {
        const float4 w0 = __ldg(&dft4[(s + 0) * a.ncg + cg]);
        const float4 w1 = __ldg(&dft4[(s + 1) * a.ncg + cg]);
        const float4 w2 = __ldg(&dft4[(s + 2) * a.ncg + cg]);
        const float4 w3 = __ldg(&dft4[(s + 3) * a.ncg + cg]);
#pragma unroll
        for (int i = 0; i < FE_RF; ++i) {
          const float4 x = *reinterpret_cast<const float4*>(reg_a + base[i] + s);
          acc[i][0] = fmaf(x.x, w0.x, acc[i][0]);
          acc[i][1] = fmaf(x.x, w0.y, acc[i][1]);
          acc[i][2] = fmaf(x.x, w0.z, acc[i][2]);
          acc[i][3] = fmaf(x.x, w0.w, acc[i][3]);
          acc[i][0] = fmaf(x.y, w1.x, acc[i][0]);
          acc[i][1] = fmaf(x.y, w1.y, acc[i][1]);
          acc[i][2] = fmaf(x.y, w1.z, acc[i][2]);
          acc[i][3] = fmaf(x.y, w1.w, acc[i][3]);
          acc[i][0] = fmaf(x.z, w2.x, acc[i][0]);
          acc[i][1] = fmaf(x.z, w2.y, acc[i][1]);
          acc[i][2] = fmaf(x.z, w2.z, acc[i][2]);
          acc[i][3] = fmaf(x.z, w2.w, acc[i][3]);
          acc[i][0] = fmaf(x.w, w3.x, acc[i][0]);
          acc[i][1] = fmaf(x.w, w3.y, acc[i][1]);
          acc[i][2] = fmaf(x.w, w3.z, acc[i][2]);
          acc[i][3] = fmaf(x.w, w3.w, acc[i][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < FE_RF; ++i) {
        const int f = fg * FE_RF + i;
        if (f < a.frames) {
          float p0 = acc[i][0] * acc[i][0] + acc[i][1] * acc[i][1];
          float p1 = acc[i][2] * acc[i][2] + acc[i][3] * acc[i][3];
          if (a.magnitude) {
            p0 = sqrtf(p0);
            p1 = sqrtf(p1);
          }
          reg_b[f * nbp + 2 * cg] = p0;
          reg_b[f * nbp + 2 * cg + 1] = p1;
        }
      }
    }
  }
  __syncthreads();

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

// Features [frames, C] from region B to out (row-major, C contiguous).
__device__ __forceinline__ void fe_store(const FeArgs& a, const float* reg_b, float* out) {
  const int total = a.frames * fe_width(a);
  for (int i = threadIdx.x; i < total; i += blockDim.x) out[i] = reg_b[i];
}
