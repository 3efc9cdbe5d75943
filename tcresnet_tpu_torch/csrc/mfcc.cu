// Fused MFCC / log-mel front end (K2): wav [B, n] -> features [B, frames, C].
//
// Replaces the TPU kernel tcresnet_tpu/ops/pallas/mfcc.py::_kernel (hops
// variant: hop rows @ the hop-blocked DFT, shifted adds, power, mel, log,
// DCT, all in VMEM; only the wav read and the feature write touch HBM).
//
// What bounds it on the H100: FP32 FMA issue in the DFT (~24.7 M
// multiply-adds per 1 s clip of ~27 M), not memory: per row it reads 64 KB
// and writes 15.7 KB. This is K4's front end run alone (frontend.cuh):
// the DFT constant (~260 KB) stays in global memory, L2-resident, because
// it does not fit next to the samples and the power spectrum in one
// block's 227 KB of shared memory; the DFT runs on frames instead of hops
// (same math, no shifted-add buffer).
//
// What the design does about it: one block per utterance (the batch is
// the grid), the register-blocked DFT of frontend.cuh, and only the
// features leave the block. Tensor cores for the DFT (3xTF32 or split
// bf16 to keep the 1e-4 gate) are later work.
//
// Build: ops/kernels/_build.py (nvcc, sm_90a, plain C entry point that
// launches on the given stream and returns cudaGetLastError()).

#include <cuda_runtime.h>

#include "frontend.cuh"

struct K2Args {
  FeArgs fe;
  const float* wavs;  // [batch, n]
  float* out;         // [batch, frames, C]
  int batch, region_a, smem_bytes;
};

__global__ void __launch_bounds__(FE_THREADS, 1) k2_kernel(const K2Args a) {
  extern __shared__ __align__(16) float smem[];
  float* reg_a = smem;
  float* reg_b = smem + a.region_a;
  const float* wav = a.wavs + (size_t)blockIdx.x * a.fe.n;
  for (int i = threadIdx.x; i < a.fe.n; i += blockDim.x) reg_a[i] = fe_sample(a.fe, wav[i]);
  __syncthreads();
  fe_features(a.fe, reg_a, reg_b);
  fe_store(a.fe, reg_b, a.out + (size_t)blockIdx.x * a.fe.frames * fe_width(a.fe));
}

extern "C" int k2_mfcc(const K2Args* args, void* stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      k2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, args->smem_bytes);
  if (e != cudaSuccess) return (int)e;
  k2_kernel<<<args->batch, FE_THREADS, args->smem_bytes, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

extern "C" int k2_args_size(void) { return (int)sizeof(K2Args); }

extern "C" const char* k2_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
