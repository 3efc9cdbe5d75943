// Single-kernel training input path (K3): int16 dataset rows by index ->
// decode -> shift, silence zeroing, background mix, clip -> MFCC or
// log-mel features [B, frames, C]. The augmented wave never reaches
// device memory.
//
// Replaces the TPU kernel tcresnet_tpu/ops/pallas/frontend.py::_kernel, in
// its three DFT branches: k3_frontend (the hops branch, and the phases
// branch, frontend.py:164-173: K2's and K8's stage, dft_tc.cuh; the host
// counts launches by variant), and
// k3_radix4 (the radix4 branch, K9's stage, frontend.py:175-185). K1's
// body (augment.cuh) writes the augmented samples into shared memory, and
// the stage turns them into features. Per 1 s row that reads 32 KB of
// int16 and a 64 KB noise crop and writes 15.7 KB of features, where K1
// then K2 also write and read back the 64 KB augmented row.
//
// What bounds it on the H100: the DFT stage, as in mfcc.cu (the 3xTF32
// products and the L2 reads of their constants); the augment adds a few
// microseconds of memory traffic per block. The design is mfcc.cu's (hops
// and phases: a tile of the batch's frames, whose utterances each augment
// with their own scalars; radix4: one block per utterance) with the sample
// load replaced by the augment. The training batch (8,192 clips, 6,272
// tiles of 128 frames) takes the 128-row product, dft_wgmma.cuh: the
// constant split on the host and streamed by TMA, wgmma on two consumer
// warpgroups; on the H100 it took K3 from 10.19 to 6.39 ms at that batch
// (PERF.md), its bound at 3xTF32 2.42 ms.
//
// Numerics: the augmented samples are bit-exact with K1 (augment.cuh),
// and the features are computed by the same code as mfcc.cu's, so K3
// equals K2(K1(x)) (K8(K1(x)), K9(K1(x))) for the same scalars, at every
// tile the plan takes (tests/test_torch_cuda.py holds it at 1,536 and
// 8,192 clips).
//
// Build: ops/kernels/_build.py (nvcc, sm_90a, plain C entry points that
// launch on the given stream and return cudaGetLastError()).

#include <cuda_runtime.h>

#include "augment.cuh"
#include "dft_tc.cuh"
#include "dft_wgmma.cuh"
#include "frontend.cuh"
#include "radix4.cuh"

struct K3Args {
  FeArgs fe;
  FeVariant v;
  AugArgs aug;  // aug.out is the feature output [batch, frames, C]
  int region_a, smem_bytes;
};

// hops and phases: each utterance of the tile augmented with its own
// scalars over the sample span its rows read (the stage's layout,
// dft_tc.cuh), then K2's and K8's stage
template <int MI, int WM, bool SPLIT>
__global__ void __launch_bounds__(FE_THREADS, 1) k3_frames_kernel(const K3Args a) {
  extern __shared__ __align__(16) float smem[];
  const TcTile tl = tc_tile<SPLIT>(a.fe, a.v, a.aug.batch);
  const AugArgs& aug = a.aug;
  const FeArgs& fe = a.fe;
  tc_stage(a.fe, a.v, tl, smem, [&aug, &fe](int b) {
    const AugRow<short> r = aug_row<short>(aug, b, 1.0f / 32768.0f);
    return [&aug, &fe, r](int t, float* dst) {
#pragma unroll
      for (int k = 0; k < 4; ++k) dst[k] = fe_sample(fe, aug_sample(r, aug.n, t + k));
    };
  });
  tc_frames_features<MI, WM, SPLIT>(a.fe, a.v, tl, smem, a.region_a, a.aug.out);
}

// the same at the 128-row tile: the augment, then
// dft_wgmma.cuh's product
__global__ void __launch_bounds__(WG_THREADS, 1) k3_frames_wg_kernel(const K3Args a) {
  extern __shared__ __align__(16) float smem[];
  const TcTile tl = tc_tile<false>(a.fe, a.v, a.aug.batch);
  const AugArgs& aug = a.aug;
  const FeArgs& fe = a.fe;
  tc_wg_features(
      a.fe, a.v, tl, smem, a.region_a, a.aug.out,
      [&] {
        tc_stage(a.fe, a.v, tl, smem, [&aug, &fe](int b) {
          const AugRow<short> r = aug_row<short>(aug, b, 1.0f / 32768.0f);
          return [&aug, &fe, r](int t, float* dst) {
#pragma unroll
            for (int k = 0; k < 4; ++k) dst[k] = fe_sample(fe, aug_sample(r, aug.n, t + k));
          };
        });
      });
}

// radix4: the augmented samples unrounded (the butterfly rounds after the window)
template <int MI, int WM>
__global__ void __launch_bounds__(FE_THREADS, 1) k3_radix4_kernel(const K3Args a) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const AugRow<short> r = aug_row<short>(a.aug, b, 1.0f / 32768.0f);
  for (int t = threadIdx.x; t < a.fe.n; t += blockDim.x) smem[t] = aug_sample(r, a.aug.n, t);
  r4_features<MI, WM>(a.fe, a.v, smem, a.region_a,
                      a.aug.out + (size_t)b * a.fe.frames * fe_width(a.fe));
}

template <int MI, int WM, bool SPLIT = false>
static int k3_frames_launch(const K3Args* args, void* stream) {
  if (!SPLIT && args->v.splits != 1) return (int)cudaErrorInvalidValue;
  const int grid = tc_grid(args->fe, args->v, args->aug.batch);
  return fe_launch<K3Args, k3_frames_kernel<MI, WM, SPLIT>>(grid, args->smem_bytes, *args,
                                                            stream);
}

// as mfcc.cu's frames_stage: the tile rows of the host's plan
static int k3_frames_stage(const K3Args* args, void* stream) {
  switch (tc_product(args->v.rows)) {
    case 128:
      if (args->v.splits != 1) return (int)cudaErrorInvalidValue;
      return fe_launch<K3Args, k3_frames_wg_kernel, WG_THREADS>(
          tc_grid(args->fe, args->v, args->aug.batch), args->smem_bytes, *args, stream);
    case 64: return k3_frames_launch<2, 2>(args, stream);
    case 16: return k3_frames_launch<1, 1, true>(args, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// hops and phases: the same stage
extern "C" int k3_frontend(const K3Args* args, void* stream) {
  return k3_frames_stage(args, stream);
}

// as k9_mfcc: the 64-row product up to 64 frames, the 112-row one up to 112
extern "C" int k3_radix4(const K3Args* args, void* stream) {
  if (args->fe.frames > R4_MAX_FRAMES) return (int)cudaErrorInvalidValue;
  return args->fe.frames <= R4_SMALL_FRAMES
             ? fe_launch<K3Args, k3_radix4_kernel<2, 2>>(args->aug.batch, args->smem_bytes,
                                                         *args, stream)
             : fe_launch<K3Args, k3_radix4_kernel<7, 1>>(args->aug.batch, args->smem_bytes,
                                                         *args, stream);
}

extern "C" int k3_args_size(void) { return (int)sizeof(K3Args); }

extern "C" const char* k3_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
