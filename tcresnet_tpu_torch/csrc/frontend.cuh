// The front ends' shared pieces: FeArgs and FeVariant (their constants),
// fe_launch, fe_bf16, fe_sample and fe_width. The stages themselves run on
// the tensor cores:
//
//   K2 (mfcc.py::_kernel, k2_mfcc), K8 (::_kernel_phases), K3's hops and
//   phases entry point, and K4's front end (infer.cu): the frames' stage,
//   dft_tc.cuh, at the 128-row tile dft_wgmma.cuh
//   K9 (::_kernel_radix4) and K3's radix4 entry point: radix4.cuh
//
// Numerics: float32 sums of 3xTF32 products, IEEE logf/sqrtf (the build has
// no --use_fast_math). With round_bf16 the DFT's A operand is rounded to
// bf16 (fe_bf16) and its constant is passed already rounded; products
// still accumulate in float32 (the JAX path's preferred_element_type=f32).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define FE_THREADS 256

struct FeArgs {
  // K2, K8, K4: [Kp, 128 units], zero rows and columns past the window's
  // (mfcc.py::tc_dft_matrix); K9: its live columns of M0 | M1 | M2
  const float* dft;
  const float* mel;  // the nonzero weights of the stage's mel runs
  const float* dct;  // [num_mel, num_coef]; unused when magnitude
  int n, window, hop, frames, num_mel, num_coef;
  int magnitude, round_bf16;
};

// The tensor-core stages' constants: K2, K8 and K4 (the frames' stage,
// dft_tc.cuh) and K9 (radix4.cuh).
struct FeVariant {
  // radix4: the live columns of M0 [L, L], M1 [2L, 2L], M2 [L, L] back to
  // back, row-major, each as (re, im) pairs; frames: FeArgs.dft
  const float* w;
  const float* win;   // radix4: the window zero-padded to 4L
  const int* runs;    // the mel runs [units][num_mel][3] (dft_tc.cuh)
  float* part;        // frames, split tiles: the units' mel contributions
  int* done;          // frames, split tiles: per tile, its blocks that finished (0 between calls)
  const float* wsplit;  // frames, 128-row tiles: the DFT constant's TF32 parts (dft_wgmma.cuh)
  int length;         // radix4: L
  int mel_nnz;        // the mel's nonzero weights (FeArgs.mel)
  int units;          // frames: column units of 128 (fft / 128, at least 1)
  int rows;           // frames: rows of a block's tile (the host plan's)
  int splits;         // frames: blocks a tile's units are split over (the host plan's)
  int stride, gap;    // frames: the staged samples' chunk stride and piece gap (floats)
  int stages;         // frames, 128-row tiles: the ring's slots (the host plan's)
};

// Launches Kernel on `grid` blocks of FE_THREADS. Above 48 KB of dynamic
// shared memory a kernel needs its limit raised first: that is done once
// per kernel, device and larger size, not on every launch.
template <class Args, void (*Kernel)(Args), int THREADS = FE_THREADS>
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
  Kernel<<<grid, THREADS, smem_bytes, (cudaStream_t)stream>>>(args);
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
