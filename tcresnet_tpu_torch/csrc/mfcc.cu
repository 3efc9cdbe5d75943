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
// What bounds them on the H100. K2 and K8: FP32 FMA issue in the DFT stage,
// not memory (per row 64 KB in, 15.7 KB or less out): 24.2 M (K2) and
// 28.9 M (K8, W_p's zero rows included) multiply-adds per 1 s clip at
// 480/160, 32.2 M and 35.3 M at 640/320. K9: its stage-2 products, 6 L^2 a
// frame (9.6 M at 480/160, 19.3 M at 640/320), at the tensor cores'
// float32-exact (3xTF32) rate, and the L2 reads of M0-M2 (1.5 MB at
// 640/320) that feed them.
//
// What the design does about it: one block per utterance (the batch is the
// grid). K2 and K8 run the register-blocked products of frontend.cuh with
// the DFT constant (~260 KB to 2.6 MB) in global memory, L2-resident; K8
// differs from K2 only in its A addressing (a strided lane-row view instead
// of hop-spaced frames), its per-phase constants and their zero rows, so
// what the phase layout costs on this card is what their times compare. K9
// (radix4.cuh) makes all frames of the utterance one product on the tensor
// cores, so each slice of M0-M2 is read from L2 once per utterance, and
// folds the mel into its column loop so that no power spectrum is stored.
//
// Build: ops/kernels/_build.py (nvcc, sm_90a, plain C entry points that
// launch on the given stream and return cudaGetLastError()).

#include <cuda_runtime.h>

#include "frontend.cuh"
#include "radix4.cuh"

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
  for (int i = threadIdx.x; i < a.fe.n; i += blockDim.x) reg_a[i] = fe_sample(a.fe, wav[i]);
  __syncthreads();
  fe_features_v<V>(a.fe, a.v, reg_a, reg_b);
  fe_store(a.fe, reg_b, a.out + (size_t)blockIdx.x * a.fe.frames * fe_width(a.fe));
}

// K9: the samples unrounded (the butterfly rounds after the window), copied
// with cp.async (radix4 clips are multiples of 128 samples)
template <int MI, int WM>
__global__ void __launch_bounds__(FE_THREADS, 1) k9_kernel(const K2Args a) {
  extern __shared__ __align__(16) float smem[];
  r4_copy(smem, a.wavs + (size_t)blockIdx.x * a.fe.n, a.fe.n / 4);
  r4_features<MI, WM>(a.fe, a.v, smem, a.region_a,
                      a.out + (size_t)blockIdx.x * a.fe.frames * fe_width(a.fe));
}

static int launch(void (*kernel)(K2Args), const K2Args* args, void* stream) {
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, args->smem_bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<args->batch, FE_THREADS, args->smem_bytes, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

extern "C" int k2_mfcc(const K2Args* args, void* stream) {
  return launch(k2_kernel<FE_HOPS>, args, stream);
}

extern "C" int k8_mfcc(const K2Args* args, void* stream) {
  return launch(k2_kernel<FE_PHASES>, args, stream);
}

// the 64-row product up to 64 frames (640/320: 49), the 112-row one up to
// 112 (480/160: 98)
extern "C" int k9_mfcc(const K2Args* args, void* stream) {
  if (args->fe.frames > R4_MAX_FRAMES) return (int)cudaErrorInvalidValue;
  return launch(args->fe.frames <= R4_SMALL_FRAMES ? k9_kernel<2, 2> : k9_kernel<7, 1>, args,
                stream);
}

extern "C" int k2_args_size(void) { return (int)sizeof(K2Args); }

extern "C" const char* k2_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
