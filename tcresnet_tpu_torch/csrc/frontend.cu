// Single-kernel training input path (K3): int16 dataset rows by index ->
// decode -> shift, silence zeroing, background mix, clip -> MFCC or
// log-mel features [B, frames, C]. The augmented wave never reaches
// device memory.
//
// Replaces the TPU kernel tcresnet_tpu/ops/pallas/frontend.py::_kernel
// (hops branch): K1's body (augment.cuh) writes the augmented row into
// shared memory, and the shared front end (frontend.cuh, K2's and K4's)
// turns it into features. Per 1 s row that reads 32 KB of int16 and a
// 64 KB noise crop and writes 15.7 KB of features, where K1 then K2 also
// write and read back the 64 KB augmented row.
//
// What bounds it on the H100: the DFT's FP32 FMA issue, as in K2; the
// augment phase adds a few microseconds of memory traffic per block. The
// design is K2's (one block per utterance, ~165 KB of shared memory, the
// DFT constant L2-resident) with the sample load replaced by the augment.
//
// Numerics: the augmented samples are bit-exact with K1 (augment.cuh),
// and the features are computed by the same code as K2's, so K3 equals
// K2(K1(x)) for the same scalars.
//
// Build: ops/kernels/_build.py (nvcc, sm_90a, plain C entry point that
// launches on the given stream and returns cudaGetLastError()).

#include <cuda_runtime.h>

#include "augment.cuh"
#include "frontend.cuh"

struct K3Args {
  FeArgs fe;
  AugArgs aug;  // aug.out is the feature output [batch, frames, C]
  int region_a, smem_bytes;
};

__global__ void __launch_bounds__(FE_THREADS, 1) k3_kernel(const K3Args a) {
  extern __shared__ __align__(16) float smem[];
  float* reg_a = smem;
  float* reg_b = smem + a.region_a;
  const int b = blockIdx.x;
  const AugRow<short> r = aug_row<short>(a.aug, b, 1.0f / 32768.0f);
  for (int t = threadIdx.x; t < a.fe.n; t += blockDim.x)
    reg_a[t] = fe_sample(a.fe, aug_sample(r, a.aug.n, t));
  __syncthreads();
  fe_features(a.fe, reg_a, reg_b);
  fe_store(a.fe, reg_b, a.aug.out + (size_t)b * a.fe.frames * fe_width(a.fe));
}

extern "C" int k3_frontend(const K3Args* args, void* stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      k3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, args->smem_bytes);
  if (e != cudaSuccess) return (int)e;
  k3_kernel<<<args->aug.batch, FE_THREADS, args->smem_bytes, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

extern "C" int k3_args_size(void) { return (int)sizeof(K3Args); }

extern "C" const char* k3_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
