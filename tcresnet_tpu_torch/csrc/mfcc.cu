// Fused MFCC / log-mel front end: wav [B, n] -> features [B, frames, C],
// in each of the JAX kernel's three DFT variants:
//
//   k2_mfcc  K2, replaces tcresnet_tpu/ops/pallas/mfcc.py::_kernel (hops),
//            and K8, replaces ::_kernel_phases (phase-grouped DFT)
//   k9_mfcc  K9, replaces ::_kernel_radix4 (radix-4 DIF factored rDFT)
//
// The TPU kernels keep one utterance tile in VMEM from the wav read to the
// feature write; these keep their samples in shared memory, and only the
// wav read and the feature write touch device memory.
//
// What bounds them on the H100: their products at the tensor cores'
// float32-exact (3xTF32) rate, K2's and K8's window x fft a frame (24.1 M
// a 1 s clip at 480/160, 32.1 M at 640/320), K9's 6 L^2 (9.6 M, 19.3 M),
// and the L2 reads of their constants that feed them; not memory (per row
// 64 KB in, 15.7 KB or less out).
//
// What the designs do about it. K2 and K8 are one stage (dft_tc.cuh):
// every frame's product with the windowed DFT, the batch's frames one row
// space, a block a tile of 128, 64, or 16 and fewer of them (the host's
// plan, from the batch), read in place from the staged samples on the
// tensor cores (the 128-row tile on wgmma with the constant split on the
// host and streamed by TMA, dft_wgmma.cuh; the others on mma.sync);
// they share their kernels (frames_kernel, frames_wg_kernel) and one
// entry point (the host counts launches by variant). K9 (radix4.cuh): one
// block per utterance, all its frames one product on the tensor cores, so
// each slice of M0-M2 is read from L2 once per utterance. All fold the mel
// into their column loop, so that no power spectrum is stored.
//
// Build: ops/kernels/_build.py (nvcc, sm_90a, plain C entry points that
// launch on the given stream and return cudaGetLastError()).

#include <cuda_runtime.h>

#include "dft_tc.cuh"
#include "dft_wgmma.cuh"
#include "frontend.cuh"
#include "radix4.cuh"

struct K2Args {
  FeArgs fe;
  FeVariant v;
  const float* wavs;  // [batch, n]
  float* out;         // [batch, frames, C]
  int batch, region_a, smem_bytes;
};

// K2 and K8: the tile's sample span copied with cp.async, rounded to bf16
// for dsp_matmul_dtype="bfloat16" (tc_stage_wavs), then the stage
template <int MI, int WM, bool SPLIT>
__global__ void __launch_bounds__(FE_THREADS, 1) frames_kernel(const K2Args a) {
  extern __shared__ __align__(16) float smem[];
  const TcTile tl = tc_tile<SPLIT>(a.fe, a.v, a.batch);
  tc_stage_wavs(a.fe, a.v, tl, smem, a.wavs, a.region_a);
  tc_frames_features<MI, WM, SPLIT>(a.fe, a.v, tl, smem, a.region_a, a.out);
}

// the same at the 128-row tile: the copies issued, then
// dft_wgmma.cuh's product (which rounds them to bf16 where asked)
__global__ void __launch_bounds__(WG_THREADS, 1) frames_wg_kernel(const K2Args a) {
  extern __shared__ __align__(16) float smem[];
  const TcTile tl = tc_tile<false>(a.fe, a.v, a.batch);
  const float* wavs = a.wavs;
  const int n = a.fe.n;
  tc_wg_features(
      a.fe, a.v, tl, smem, a.region_a, a.out,
      [&] {
        tc_stage(a.fe, a.v, tl, smem, [wavs, n](int b) {
          const float* wav = wavs + (size_t)b * n;
          return [wav](int t, float* dst) { cp_async16(dst, wav + t, true); };
        });
      });
}

// K9: the samples unrounded (the butterfly rounds after the window), copied
// with cp.async (radix4 clips are multiples of 128 samples)
template <int MI, int WM>
__global__ void __launch_bounds__(FE_THREADS, 1) k9_kernel(const K2Args a) {
  extern __shared__ __align__(16) float smem[];
  tc_copy(smem, a.wavs + (size_t)blockIdx.x * a.fe.n, a.fe.n / 4);
  r4_features<MI, WM>(a.fe, a.v, smem, a.region_a,
                      a.out + (size_t)blockIdx.x * a.fe.frames * fe_width(a.fe));
}

template <int MI, int WM, bool SPLIT = false>
static int frames_launch(const K2Args* args, void* stream) {
  if (!SPLIT && args->v.splits != 1) return (int)cudaErrorInvalidValue;
  const int grid = tc_grid(args->fe, args->v, args->batch);
  return fe_launch<K2Args, frames_kernel<MI, WM, SPLIT>>(grid, args->smem_bytes, *args, stream);
}

// the tile rows of the host's plan (tc_product)
static int frames_stage(const K2Args* args, void* stream) {
  switch (tc_product(args->v.rows)) {
    case 128:
      if (args->v.splits != 1) return (int)cudaErrorInvalidValue;
      return fe_launch<K2Args, frames_wg_kernel, WG_THREADS>(
          tc_grid(args->fe, args->v, args->batch), args->smem_bytes, *args, stream);
    case 64: return frames_launch<2, 2>(args, stream);
    case 16: return frames_launch<1, 1, true>(args, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// K2 and K8: the same stage
extern "C" int k2_mfcc(const K2Args* args, void* stream) { return frames_stage(args, stream); }

// the 64-row product up to 64 frames (640/320: 49), the 112-row one up to
// 112 (480/160: 98)
extern "C" int k9_mfcc(const K2Args* args, void* stream) {
  if (args->fe.frames > R4_MAX_FRAMES) return (int)cudaErrorInvalidValue;
  return args->fe.frames <= R4_SMALL_FRAMES
             ? fe_launch<K2Args, k9_kernel<2, 2>>(args->batch, args->smem_bytes, *args, stream)
             : fe_launch<K2Args, k9_kernel<7, 1>>(args->batch, args->smem_bytes, *args, stream);
}

extern "C" int k2_args_size(void) { return (int)sizeof(K2Args); }

extern "C" const char* k2_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
