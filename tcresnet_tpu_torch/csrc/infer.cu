// Whole-model TC-ResNet inference on Hopper: wav -> logits in one call.
//
// Replaces the TPU kernel tcresnet_tpu/ops/pallas/infer.py::_kernel (the
// fused wav -> MFCC -> 7..16 BN-folded temporal convs -> GAP -> fc
// program). It computes, per utterance:
//   1. the windowed real DFT of every frame (frame[f] @ W),
//   2. power (MFCC) or magnitude (log-mel), mel, log(mel + 1e-6), and the
//      DCT for MFCC,
//   3. the BN-folded TF-SAME k x 1 convs with their residual dataflow,
//   4. the global average pool and the fc.
//
// What bounds it on the H100. Per TCResNet8-1.0 utterance the DFT is
// ~24.1 M multiply-adds (window x fft a frame) of ~26 M in total (mel's
// nonzero weights 0.1 M, DCT 0.16 M, convs 1.5 M, fc 0.6 k), so the front
// end sets the kernel's work: at the tensor cores' float32-exact rate
// (3xTF32) it is ~0.3 ms of a 1024 batch's bound, the convs and fc in
// FP32 ~0.05 ms. At batch 1 no bound is near: the time is latency, the
// front end's products over their K slices, then one utterance's 7..16
// convs in sequence on one SM.
//
// What the design does about it.
//  - Steps 1 and 2 are K2's tensor-core stage (dft_tc.cuh), over every
//    frame of the batch as one row space: a block takes a tile of 128, 64
//    or 16 and fewer (utterance, frame) rows of the host's plan
//    (ops/kernels/mfcc.py::tc_tile_plan), and a small batch's tiles split
//    their column units over blocks, so that batch 1 runs its front end on
//    28 blocks (480/160), not one. The features of a tile go to a
//    [batch, frames, C] workspace in device memory (L2-resident: 15.7 KB
//    an utterance); the stage's bits do not depend on the tile, so they
//    are K2's.
//  - For one utterance (a served request), steps 3 and 4 run in the block
//    that stores the last of its rows: after a tile's features are stored
//    (by a split tile's last block), the block fences, adds the rows it
//    stored of each utterance to that utterance's counter (count, 0
//    between calls), and the block whose add brings an utterance to
//    `frames` reads its features back (__ldcg: L2, not a stale L1 line),
//    sets its counter back to 0, and runs its conv stack, GAP and fc in
//    the stage's shared memory, which the stage no longer needs. It is the
//    split tiles' "last block to finish" pattern
//    (dft_tc.cuh::tc_frames_features), so the call is one launch with no
//    second pass and no memset.
//  - A batch of more utterances (the host's rule,
//    ops/kernels/infer.py::FusedInfer.two_kernels; always on the 128-row
//    product, dft_wgmma.cuh) runs its conv stacks in a second kernel, one
//    block per utterance: in the stage's blocks, one
//    whose tile ends two utterances runs both stacks in turn, and a stage
//    block holds its SM (registers, shared memory) while other tiles
//    wait; at batch 3-5 that took 1.2-1.8x the split's time (PERF.md). The
//    same code in the same order: the same bits.
//  - Each conv thread computes 4 output channels of one row: one float4
//    weight load feeds 4 independent FMA chains (channel counts are
//    multiples of 4; the wrapper checks).
//  - Shared memory: the stage's plan for the tile's rows (dft_tc.cuh), or,
//    if larger, the conv stage's: a flag, the utterance's features [frames,
//    C], three conv ping-pong / shortcut buffers of act_max floats and the
//    pooled vector (ops/kernels/infer.py::_Geometry; ~28 KB for
//    TCResNet14-1.5 at 1 s).
//  - One utterance's convs stay in one block: at batch 1 they run on one SM
//    of 132 after the front end, ~0.07 ms of TCResNet8-1.0's ~0.1 (PERF.md:
//    the next lever).
//
// Numerics: the features are K2's (dft_tc.cuh: 3xTF32 products summed in
// float32 in a fixed k order, IEEE logf/sqrtf, built without
// --use_fast_math). The convs, GAP and fc accumulate in float32 with fmaf
// in a fixed order, one partial sum per tap. So an utterance's logits do
// not depend on the batch it came in, bit for bit. With round_bf16 the
// samples are rounded to bf16 in shared memory and the DFT constant is
// passed already rounded; products still accumulate in float32 (the JAX
// path's dsp_matmul_dtype="bfloat16").
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC  (ops/kernels/_build.py). The C entry
// point k4_infer launches on the given stream (one kernel for one
// utterance, two for a batch) and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "dft_tc.cuh"
#include "dft_wgmma.cuh"
#include "frontend.cuh"

#define K4_MAX_CONVS 32
#define K4_FLAG 4  // floats before the conv stage's features: the block's flag

enum { ROLE_CONV0 = 0, ROLE_DOWN = 1, ROLE_BLOCK0 = 2, ROLE_BLOCK1 = 3 };

struct K4Conv {
  int k, stride, role, relu, ci, co, w_off, b_off;
};

struct K4Args {
  FeArgs fe;          // K2's stage's constants (the hops FrontEnd)
  FeVariant v;        // this batch's tile plan (mfcc.py::tc_tile_plan), K4's own split counters
  const float* wavs;  // [batch, n]
  float* feats;       // workspace [batch, frames, C]
  int* count;         // [batch] rows stored per utterance (0 between calls)
  float* out;         // [batch, ncls]
  const float* wts;   // folded conv weights [k*ci, co] and biases [co], by offset
  const float* fc;    // [c_last, ncls]
  int batch, n_convs, ncls, act_max, region_a, smem_bytes;
  int two_kernels;    // the stage alone, then k4_conv_kernel (the host's rule: a batch)
  int conv_bytes;     // the conv stage's shared memory
  K4Conv convs[K4_MAX_CONVS];
};

// Utterance b's conv stack (residual dataflow by role), GAP and fc, its
// features read back from the workspace; smem from the features on (the
// flag before it is the caller's). Ends synchronised.
__device__ __forceinline__ void k4_convs(const K4Args& a, int b, float* smem) {
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int n_feat = fe_width(a.fe);
  const int nf = a.fe.frames * n_feat;
  float* feats = smem;
  float* reg = smem + tc_up4(nf);
  float* pooled = reg + 3 * a.act_max;
  const float* src = a.feats + (size_t)b * nf;
  for (int i = tid; i < nf; i += nthr) feats[i] = __ldcg(src + i);
  __syncthreads();

  float* bufs[3] = {reg, reg + a.act_max, reg + 2 * a.act_max};
  const float* x = feats;
  const float* sc = nullptr;
  int t_len = a.fe.frames;
  int c_len = n_feat;
  for (int l = 0; l < a.n_convs; ++l) {
    const K4Conv cv = a.convs[l];
    if (cv.role == ROLE_BLOCK0 && sc == nullptr) sc = x;  // identity shortcut
    float* dst = bufs[0];
    for (int j = 0; j < 3; ++j) {
      if (bufs[j] != x && bufs[j] != sc) {
        dst = bufs[j];
        break;
      }
    }
    // TF-SAME: out rows ceil(T / stride), left pad total // 2
    const int to = (t_len + cv.stride - 1) / cv.stride;
    const int lo = max((to - 1) * cv.stride + cv.k - t_len, 0) / 2;
    const float* w = a.wts + cv.w_off;
    const float* bias = a.wts + cv.b_off;
    const int cq = cv.co / 4;  // 4 output channels per thread
    for (int item = tid; item < to * cq; item += nthr) {
      const int oq = item % cq;
      const int t = item / cq;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int j = 0; j < cv.k; ++j) {
        const int r = t * cv.stride + j - lo;
        if (r < 0 || r >= t_len) continue;  // zero padding
        const float* xr = x + r * cv.ci;
        const float4* wr = reinterpret_cast<const float4*>(w + (j * cv.ci) * cv.co) + oq;
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        for (int c = 0; c < cv.ci; ++c) {
          const float xv = xr[c];
          const float4 wv = __ldg(wr + c * cq);
          part[0] = fmaf(xv, wv.x, part[0]);
          part[1] = fmaf(xv, wv.y, part[1]);
          part[2] = fmaf(xv, wv.z, part[2]);
          part[3] = fmaf(xv, wv.w, part[3]);
        }
        // one partial per tap, as the per-tap matmuls sum them
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[q] += part[q];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int o = 4 * oq + q;
        float y = acc[q] + __ldg(bias + o);
        if (cv.role == ROLE_BLOCK1) {
          y = fmaxf(y + sc[t * cv.co + o], 0.f);  // no ReLU before the add
        } else if (cv.relu) {
          y = fmaxf(y, 0.f);
        }
        dst[t * cv.co + o] = y;
      }
    }
    __syncthreads();
    if (cv.role == ROLE_DOWN) {
      sc = dst;
    } else {
      x = dst;
      t_len = to;
      c_len = cv.co;
      if (cv.role == ROLE_BLOCK1) sc = nullptr;
    }
  }

  // global average pool + fc
  for (int c = tid; c < c_len; c += nthr) {
    float s = 0.f;
    for (int t = 0; t < t_len; ++t) s += x[t * c_len + c];
    pooled[c] = s / (float)t_len;
  }
  __syncthreads();
  for (int o = tid; o < a.ncls; o += nthr) {
    float s = 0.f;
    for (int c = 0; c < c_len; ++c) s = fmaf(pooled[c], __ldg(&a.fc[c * a.ncls + o]), s);
    a.out[(size_t)b * a.ncls + o] = s;
  }
  __syncthreads();
}

// The block's counts of the tile it stored, then the conv stack of every
// utterance whose last rows they were. The tile is taken again from
// blockIdx here, so that nothing of it stays live across the stage, whose
// 128-row product uses every register (kept live, it spilled).
template <bool SPLIT>
__device__ __forceinline__ void k4_finish(const K4Args& a) {
  extern __shared__ __align__(16) float smem[];
  const TcTile tl = tc_tile<SPLIT>(a.fe, a.v, a.batch);
  __threadfence();  // this block's features, before its counts
  const int frames = a.fe.frames;
  const int end = tl.r0 + tl.nrows;  // rows [r0, end) of the batch x frames rows
  int* ready = reinterpret_cast<int*>(smem);  // the stage's memory is free after the barrier
  for (int b = tl.b0; b * frames < end; ++b) {
    __syncthreads();  // the stage's (or the last utterance's) reads of smem are done
    if (threadIdx.x == 0) {
      const int rows = min(end, (b + 1) * frames) - max(tl.r0, b * frames);
      *ready = atomicAdd(a.count + b, rows) + rows == frames;
    }
    __syncthreads();
    if (!*ready) continue;
    __threadfence();  // the other blocks' features, after their counts
    if (threadIdx.x == 0) a.count[b] = 0;  // every block's add is in: 0 for the next call
    k4_convs(a, b, smem + K4_FLAG);
  }
}

// A tile of the batch's frames through K2's stage (frames_kernel's body,
// mfcc.cu), then, with CONVS, the conv stack of every utterance whose last
// rows this block stored (k4_finish); without, k4_conv_kernel runs them
// after this launch
template <int MI, int WM, bool SPLIT, bool CONVS>
__global__ void __launch_bounds__(FE_THREADS, 1) k4_kernel(const __grid_constant__ K4Args a) {
  extern __shared__ __align__(16) float smem[];
  const TcTile tl = tc_tile<SPLIT>(a.fe, a.v, a.batch);
  tc_stage_wavs(a.fe, a.v, tl, smem, a.wavs, a.region_a);
  if (!tc_frames_features<MI, WM, SPLIT>(a.fe, a.v, tl, smem, a.region_a, a.feats)) return;
  if (CONVS) k4_finish<SPLIT>(a);
}

// the same at the 128-row tile: dft_wgmma.cuh's product; the conv stacks
// always follow in k4_conv_kernel (a tile of 128 rows never holds a single
// utterance's whole call, and both paths give the same bits)
__global__ void __launch_bounds__(WG_THREADS, 1) k4_wg_kernel(const __grid_constant__ K4Args a) {
  extern __shared__ __align__(16) float smem[];
  const TcTile tl = tc_tile<false>(a.fe, a.v, a.batch);
  const float* wavs = a.wavs;
  const int n = a.fe.n;
  tc_wg_features(
      a.fe, a.v, tl, smem, a.region_a, a.feats,
      [&] {
        tc_stage(a.fe, a.v, tl, smem, [wavs, n](int b) {
          const float* wav = wavs + (size_t)b * n;
          return [wav](int t, float* dst) { cp_async16(dst, wav + t, true); };
        });
      });
}

// one utterance's conv stack a block, after the stage's launch (its
// features are in the workspace: the launch boundary orders them). Min
// blocks 1: the conv loop is latency-bound, and with the registers that
// frees (125, not 64) it ran faster on the H100 at every batch timed, 1 to
// 1024, though fewer blocks fit an SM
__global__ void __launch_bounds__(FE_THREADS, 1) k4_conv_kernel(const __grid_constant__ K4Args a) {
  extern __shared__ __align__(16) float smem[];
  k4_convs(a, blockIdx.x, smem + K4_FLAG);
}

template <int MI, int WM, bool SPLIT = false>
static int k4_launch(const K4Args* args, void* stream) {
  if (!SPLIT && args->v.splits != 1) return (int)cudaErrorInvalidValue;
  const int grid = tc_grid(args->fe, args->v, args->batch);
  if (!args->two_kernels)
    return fe_launch<K4Args, k4_kernel<MI, WM, SPLIT, true>>(grid, args->smem_bytes, *args, stream);
  const int e = fe_launch<K4Args, k4_kernel<MI, WM, SPLIT, false>>(grid, args->smem_bytes, *args,
                                                                   stream);
  if (e != 0) return e;
  return fe_launch<K4Args, k4_conv_kernel>(args->batch, args->conv_bytes, *args, stream);
}

// the tile rows of the host's plan (tc_product), as mfcc.cu's frames_stage;
// the shared-memory limit raised once per device and larger size (fe_launch)
extern "C" int k4_infer(const K4Args* args, void* stream) {
  switch (tc_product(args->v.rows)) {
    case 128: {
      if (args->v.splits != 1) return (int)cudaErrorInvalidValue;
      const int e = fe_launch<K4Args, k4_wg_kernel, WG_THREADS>(
          tc_grid(args->fe, args->v, args->batch), args->smem_bytes, *args, stream);
      if (e != 0) return e;
      return fe_launch<K4Args, k4_conv_kernel>(args->batch, args->conv_bytes, *args, stream);
    }
    case 64: return k4_launch<2, 2>(args, stream);
    case 16: return k4_launch<1, 1, true>(args, stream);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int k4_args_size(void) { return (int)sizeof(K4Args); }

extern "C" const char* k4_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
