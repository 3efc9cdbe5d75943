// Fused MFCC / log-mel front end: wav [B, n] -> features [B, frames, C],
// in each of the JAX kernel's three DFT variants (one entry point each):
//
//   k2_mfcc  K2, replaces tcresnet_tpu/ops/pallas/mfcc.py::_kernel (hops)
//   k8_mfcc  K8, replaces ::_kernel_phases (phase-grouped DFT)
//   k9_mfcc  K9, replaces ::_kernel_radix4 (radix-4 DIF factored rDFT)
//
// The TPU kernels keep one utterance tile in VMEM from the wav read to the
// feature write; these keep one utterance in shared memory, and only the
// wav read and the feature write touch device memory.
//
// What bounds them on the H100: FP32 FMA issue in the DFT stage, not
// memory (per row 64 KB in, 15.7 KB or less out). Per 1 s clip at 480/160
// the stages do 24.2 M (K2), 28.9 M (K8, W_p's zero rows included) and
// 12.85 M (K9) multiply-adds; at 640/320 32.2 M, 35.3 M and 25.7 M.
// frontend.cuh says how each stage is laid out.
//
// What the design does about it: one block per utterance (the batch is the
// grid), the register-blocked products of frontend.cuh, the constants in
// global memory where they stay L2-resident (the DFT constant, ~260 KB to
// 2.6 MB, does not fit beside the samples and the power spectrum in one
// block's 227 KB). K8 differs from K2 only in its A addressing (a strided
// lane-row view instead of hop-spaced frames), its per-phase constants and
// their zero rows, so what the phase layout costs on this card is what
// their times compare. K9 stores its butterflies per tile of 8 or 4
// frames in the shared memory that the samples and the full [frames, 3L]
// power leave, so each tile re-reads M0-M2 (2 MB at L = 256) from L2:
// tensor cores and larger tiles are later work.
//
// Build: ops/kernels/_build.py (nvcc, sm_90a, plain C entry points that
// launch on the given stream and return cudaGetLastError()).

#include <cuda_runtime.h>

#include "frontend.cuh"

struct K2Args {
  FeArgs fe;
  FeVariant v;        // K8 / K9 only
  const float* wavs;  // [batch, n]
  float* out;         // [batch, frames, C]
  int batch, region_a, smem_bytes;
};

template <int V>
__global__ void __launch_bounds__(FE_THREADS, 1) k2_kernel(const K2Args a) {
  extern __shared__ __align__(16) float smem[];
  float* reg_a = smem;
  float* reg_b = smem + a.region_a;
  const float* wav = a.wavs + (size_t)blockIdx.x * a.fe.n;
  for (int i = threadIdx.x; i < a.fe.n; i += blockDim.x) reg_a[i] = fe_sample_v<V>(a.fe, wav[i]);
  __syncthreads();
  fe_features_v<V>(a.fe, a.v, reg_a, reg_b);
  fe_store(a.fe, reg_b, a.out + (size_t)blockIdx.x * a.fe.frames * fe_width(a.fe));
}

template <int V>
static int launch(const K2Args* args, void* stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      k2_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, args->smem_bytes);
  if (e != cudaSuccess) return (int)e;
  k2_kernel<V><<<args->batch, FE_THREADS, args->smem_bytes, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

extern "C" int k2_mfcc(const K2Args* args, void* stream) { return launch<FE_HOPS>(args, stream); }

extern "C" int k8_mfcc(const K2Args* args, void* stream) { return launch<FE_PHASES>(args, stream); }

extern "C" int k9_mfcc(const K2Args* args, void* stream) { return launch<FE_RADIX4>(args, stream); }

extern "C" int k2_args_size(void) { return (int)sizeof(K2Args); }

extern "C" const char* k2_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
