// Whole-model 2D inference on Hopper (K5): features -> logits in one launch.
//
// Replaces the TPU kernel tcresnet_tpu/ops/pallas/infer2d.py::_kernel2d,
// the op-list interpreter that serves the 2D families: TCResNet2D8[Pool],
// Res8/15[Narrow], DSCNN S/M/L and the seven Google-KWS baselines. The
// host (ops/kernels/infer2d.py) folds eval-mode BatchNorm into the convs,
// builds the JAX package's op list and lowers it to this kernel's program:
// a table of K5Op, one per step, with every shape, tile and K split
// computed on the host for the call's batch. The twelve op kinds of the
// TPU kernel arrive as:
//   conv (full, c1 = one input channel, dw = depthwise; SAME or VALID,
//        stride, dilation)                     -> K5_CONV
//   affine, addsc                              -> the epilogue of the conv
//        they follow: acc + b, ReLU, + shortcut, ReLU, x * scale + shift,
//        in the TPU kernel's order
//   save and the conv roles (down, block0, block1)
//                                              -> workspace slots: each op
//        names the slot it reads (src), the shortcut it adds (res) and the
//        slot it writes (dst); three slots, plus the features and logits
//   pool (VALID average), maxpool (SAME pads with -inf)
//                                              -> K5_POOL, K5_MAXPOOL
//   gap                                        -> K5_GAP
//   dense, flatten_dense                       -> K5_DENSE: the port keeps
//        activations [T, F, C] with C fastest, which is Flax's flatten
//        order, so a flatten is no data movement at all
//   tconv_full, svdf                           -> K5_TCONV_FULL, K5_SVDF
//
// What the card forces. A map does not fit a block: Res15's 98 x 40 x 45
// f32 map is 705.6 KB per utterance, against 227 KB of shared memory. So
// activations live in a global workspace (the wrapper allocates it with
// torch.empty); at small batch it stays in the 50 MB L2.
//
// What bounds it on the H100. At batch 1024 the convs, which the host
// plans as an implicit GEMM: Res15 is ~0.83 G multiply-adds per utterance
// (taps on the zero padding skipped; its 3x3 convs dilate up to 16), KWS
// trad_fpool3 38 M, so the least time is the tensor cores' float32-exact
// rate. What holds this kernel back from it is the instruction count of
// each K slice's per-element work, not the tensor cores: the im2col
// address arithmetic and 4-byte copies of a 45-channel map, the barrier
// per slice, then the TF32 splits and fragment loads. At batch 1 every
// model is bound by latency: the grid barrier between steps (two in a
// split step) and the longest chain of a step.
//
// What the design does about it:
//  - Convs in full and c1 mode, and the dense layers (a dense layer is a
//    1x1 conv over a 1x1 map with K input channels), are one implicit
//    GEMM: M = utterance x output row x output column, N = c_out, K =
//    taps x c_in (k = tap * c_in + ci, tap = i * kw + j, the weights'
//    [taps, Ci, c_pad] layout read as [K, c_pad]). A work unit is an
//    output tile over a run of 32-wide K slices: 64 x 64 (K5Wide), or
//    128 x 32 where c_pad <= 32 (K5Narrow: no warp idles on N). The
//    block's 256 threads stage the im2col slice of the activations (taps
//    on the zero padding zero-filled) and the weight slice in shared memory
//    with cp.async, in a ring of three stages: two slices load while one
//    computes, across the boundary between the block's units, so that a
//    unit's first loads and its epilogue overlap its neighbours' work; one
//    barrier per slice.
//    Copies are 16 bytes where c_in is a multiple of 4, 4 bytes otherwise
//    (Res's 45 and 19 channels). The rows' strides (BK + 4 and BN + 8
//    floats) make the fragment reads free of bank conflicts.
//  - The products run on the tensor cores as 3xTF32 mma.sync m16n8k8:
//    each float32 operand splits into a TF32 high part (its low 13
//    mantissa bits cleared) and the exact residual, and lo*hi + hi*lo +
//    hi*hi accumulate in float32. Plain TF32 keeps ~3 decimal digits and
//    breaks the 1e-5 softmax gate; 3xTF32 keeps float32 accuracy at 495/3
//    = 165 TFLOP/s, against 67 TFLOP/s for FP32 FMA. No case is kept on
//    FP32 FMA: every full, c1 and dense step meets the gate in 3xTF32.
//  - Batch 1 spreads over the whole grid. Units go out block-first (unit
//    u to block u mod grid). Where a step has fewer tiles than the grid
//    has blocks, the host splits K into `splits` parts of `split_slices`
//    slices each (a part is at least MIN_K_PART = 32 K indices, one
//    slice) until tiles x splits reaches the grid. Each part writes its
//    partial tile to the workspace; after a grid barrier one thread per
//    output adds the parts in a fixed order (split 0, 1, ...). No float
//    atomics: repeated calls give the same bits. (A warp per output with a
//    shuffle tree measured no faster, even for KWS's 336-part `lin`.)
//  - The epilogue (bias, ReLU, + shortcut, ReLU, affine) runs on the
//    registers of an unsplit tile, or in that second pass. (Staging the
//    tile through shared memory for whole-row stores measured slower on
//    every batch-1024 model: it takes L1 and a barrier.)
//  - The other steps keep their arithmetic and spread by warp,
//    block-first (warp w of block b takes item run b + w x grid), so that a
//    step of a few hundred items lands on as many SMs: a depthwise-conv
//    thread computes 4 output columns x 4 channels from float4 weights;
//    pools a thread per output; gap two passes (warps sum fixed chunks,
//    then a thread per output adds the chunks in order); tconv_full and
//    svdf a thread per 4 outputs.
//  - Activations are read with plain loads or cp.async (not __ldg):
//    another block wrote them earlier in this launch, and the grid barrier
//    orders them. Weights and the op table are read-only for the launch.
//
// Numerics: float32 storage and accumulation; a unit's sum runs slice by
// slice in K order, the parts in split order, so repeated calls give the
// same bits; against the plain version (per-tap matmuls) the order of the
// float32 sums and the 3xTF32 products differ.
//
// Build: ops/kernels/_build.py (nvcc, sm_90a, plain C entry point that
// launches on the given stream and returns cudaGetLastError()).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_mma.cuh"

namespace cg = cooperative_groups;

#define K5_THREADS 256
#define K5_PF 4  // output columns per depthwise-conv thread
#define K5_BK 32      // the K slice of one shared-memory stage
#define K5_STAGES 3   // slices in the cp.async ring: two load while one computes

// The GEMM tiles (GEMM_TILES in ops/kernels/infer2d.py, by the op's `tile`):
// BM x BN outputs, 8 warps as WM (M) x WN (N), each MI m16 x NI n8 mma
// tiles. Row strides: A's BK + 4 floats (lanes (g, t) read banks 4g + t),
// B's BN + 8 (banks 8t + g).
template <int BM_, int BN_, int WM_, int WN_>
struct K5Cfg {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int MI = BM / WM / 16, NI = BN / WN / 8;
  static constexpr int SA = K5_BK + 4, SB = BN + 8;
};
using K5Wide = K5Cfg<64, 64, 2, 4>;    // tile 0
using K5Narrow = K5Cfg<128, 32, 4, 2>; // tile 1: c_pad <= 32

enum { K5_CONV = 0, K5_POOL = 1, K5_MAXPOOL = 2, K5_GAP = 3, K5_DENSE = 4,
       K5_TCONV_FULL = 5, K5_SVDF = 6 };
enum { MODE_FULL = 0, MODE_C1 = 1, MODE_DW = 2 };
enum { SLOT_INPUT = -1, SLOT_OUTPUT = -2 };

// One step of the program: OP_FIELDS in ops/kernels/infer2d.py, in order.
struct K5Op {
  int kind, mode, relu, relu2, res, src, dst;
  int kh, kw, sh, sw, dil, pad_t, pad_f;
  int t_in, f_in, c_in, t_out, f_out, c_out, c_pad;
  int w_off, w2_off, b_off, aff_off, rank, n_chunks, chunk;
  // the GEMM plan of conv full / c1 and dense, for this call's batch
  int tile, vec, k_total, tiles_m, tiles_n, splits, split_slices;
};
#define K5_OP_FIELDS 35
static_assert(sizeof(K5Op) == K5_OP_FIELDS * sizeof(int), "K5Op holds ints only");

struct K5Args {
  const float* feats;  // [batch, T, F]
  float* out;          // [batch, ncls]
  const float* wts;    // the folded weights, by offset
  const int* ops;      // [n_ops, K5_OP_FIELDS]
  float* ws;           // [3, batch, slot_floats]
  float* partial;      // K parts of a split GEMM; first pass of gap
  int batch, n_ops, in_floats, slot_floats, ncls;
};

// per tile row of a unit: its utterance's input map, the first input row
// and column of its window, and (utterance or -1 past M, output position)
template <class C>
struct K5Rows {
  const float* src[C::BM];
  int2 tf[C::BM];
  int2 bp[C::BM];
};

// dynamic shared memory: the ring of K5_STAGES slices, and the rows of the
// units in flight (the producer runs at most K5_STAGES - 1 slices, so
// K5_STAGES units, ahead of the unit whose epilogue may still read its rows)
template <class C>
struct K5Smem {
  float a[K5_STAGES][C::BM][C::SA];  // im2col slices
  float b[K5_STAGES][K5_BK][C::SB];  // weight slices
  K5Rows<C> rows[K5_STAGES + 1];
};

constexpr size_t k5_smem_bytes() {
  return sizeof(K5Smem<K5Wide>) > sizeof(K5Smem<K5Narrow>) ? sizeof(K5Smem<K5Wide>)
                                                           : sizeof(K5Smem<K5Narrow>);
}

__device__ __forceinline__ const float* k5_src(const K5Args& a, int slot, int b) {
  if (slot == SLOT_INPUT) return a.feats + (size_t)b * a.in_floats;
  return a.ws + ((size_t)slot * a.batch + b) * a.slot_floats;
}

__device__ __forceinline__ float* k5_dst(const K5Args& a, int slot, int b) {
  if (slot == SLOT_OUTPUT) return a.out + (size_t)b * a.ncls;
  return a.ws + ((size_t)slot * a.batch + b) * a.slot_floats;
}

__device__ __forceinline__ void fma4(float (&acc)[4], float x, const float4 w) {
  acc[0] = fmaf(x, w.x, acc[0]);
  acc[1] = fmaf(x, w.y, acc[1]);
  acc[2] = fmaf(x, w.z, acc[2]);
  acc[3] = fmaf(x, w.w, acc[3]);
}

// ---- the epilogue of a conv / dense output, after its bias: the TPU
// kernel's order, ReLU, + shortcut (*res unless null), ReLU, affine ----
__device__ __forceinline__ float k5_epilogue(const K5Op& op, float v, const float* res,
                                             float scale, float shift) {
  if (op.relu) v = fmaxf(v, 0.f);
  if (res != nullptr) {
    v += *res;
    if (op.relu2) v = fmaxf(v, 0.f);
  }
  return op.aff_off >= 0 ? v * scale + shift : v;
}

// output channel n of utterance b at position p
__device__ __forceinline__ void k5_store(const K5Args& a, const K5Op& op, int b, int p, int n,
                                         float v) {
  const size_t at = (size_t)p * op.c_out + n;
  const float bias = op.b_off >= 0 ? __ldg(a.wts + op.b_off + n) : 0.f;
  const float* res = op.res >= 0 ? k5_src(a, op.res, b) + at : nullptr;
  const float scale = op.aff_off >= 0 ? __ldg(a.wts + op.aff_off + n) : 1.f;
  const float shift = op.aff_off >= 0 ? __ldg(a.wts + op.aff_off + op.c_out + n) : 0.f;
  k5_dst(a, op.dst, b)[at] = k5_epilogue(op, v + bias, res, scale, shift);
}

// ---- the implicit GEMM ----
// A unit: an M x N output tile and a run of K slices [sl0, sl1).
// Rows, units and positions fit in 32 bits (the host checks them).
struct K5Unit {
  int m0, n0, s, sl0, sl1;
};

template <class C>
__device__ __forceinline__ K5Unit k5_unit(const K5Op& op, int u, int slices) {
  K5Unit t;
  const int tn = u % op.tiles_n;  // n tile fastest, then m tile, then K part
  const int r = u / op.tiles_n;
  t.m0 = (r % op.tiles_m) * C::BM;
  t.s = r / op.tiles_m;
  t.n0 = tn * C::BN;
  t.sl0 = t.s * op.split_slices;
  t.sl1 = min(t.sl0 + op.split_slices, slices);
  return t;
}

// the rows of the tile at m0 (threads 0..BM-1)
template <class C>
__device__ __forceinline__ void k5_rows(const K5Args& a, const K5Op& op, K5Rows<C>& rows, int m0) {
  const int tid = threadIdx.x;
  if (tid >= C::BM) return;
  const int P = op.t_out * op.f_out;
  const int m = m0 + tid;
  if (m < a.batch * P) {
    const int b = m / P;
    const int p = m - b * P;
    const int to = p / op.f_out;
    rows.src[tid] = k5_src(a, op.src, b);
    rows.tf[tid] = make_int2(to * op.sh - op.pad_t, (p - to * op.f_out) * op.sw - op.pad_f);
    rows.bp[tid] = make_int2(b, p);
  } else {
    rows.src[tid] = a.wts;
    rows.tf[tid] = make_int2(-(1 << 30), 0);  // never inside the map
    rows.bp[tid] = make_int2(-1, 0);
  }
}

// one K slice of A (the unit's rows) and B into ring stage `st`
template <class C, int VEC>
__device__ __forceinline__ void k5_load_slice(const K5Args& a, const K5Op& op, K5Smem<C>& sm,
                                              int st, const K5Rows<C>& rows, int slice, int n0) {
  const int tid = threadIdx.x;
  const int k0 = slice * K5_BK;
  // A: the thread's K columns are fixed for the slice, its rows spaced by
  // 256 / (BK / VEC)
  constexpr int KG = K5_BK / VEC;  // column groups per row
  constexpr int RSTEP = K5_THREADS / KG;
  const int kcol = (tid % KG) * VEC;
  const int k = k0 + kcol;
  const int tap = k / op.c_in;
  const int ci = k - tap * op.c_in;
  const int ti = tap / op.kw;
  const int di = ti * op.dil;
  const int dj = (tap - ti * op.kw) * op.dil;
  const bool k_ok = k < op.k_total;
#pragma unroll
  for (int r = 0; r < C::BM / RSTEP; ++r) {
    const int row = tid / KG + r * RSTEP;
    const int2 tf = rows.tf[row];
    const int it = tf.x + di;
    const int jf = tf.y + dj;
    const bool ok = k_ok && it >= 0 && it < op.t_in && jf >= 0 && jf < op.f_in;
    const float* src = rows.src[row] + (ok ? (it * op.f_in + jf) * op.c_in + ci : 0);
    if (VEC == 4) {
      cp_async16(&sm.a[st][row][kcol], src, ok);
    } else {
      cp_async4(&sm.a[st][row][kcol], src, ok);
    }
  }
  // B: [K, c_pad] rows, 16-byte chunks; past K or c_pad zero-filled
  const float* w = a.wts + op.w_off;
#pragma unroll
  for (int r = 0; r < (K5_BK * C::BN / 4) / K5_THREADS; ++r) {
    const int c = tid + r * K5_THREADS;
    const int row = c / (C::BN / 4);
    const int col = (c % (C::BN / 4)) * 4;
    const int kb = k0 + row;
    const int n = n0 + col;
    const bool ok = kb < op.k_total && n < op.c_pad;
    cp_async16(&sm.b[st][row][col], ok ? w + (size_t)kb * op.c_pad + n : w, ok);
  }
}

// one slice on the tensor cores: 4 k8 steps of MI x NI mma tiles, 3 products each
template <class C>
__device__ __forceinline__ void k5_mma_slice(const K5Smem<C>& sm, int st, int wm, int wn,
                                             float (&acc)[C::MI][C::NI][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < K5_BK; kk += 8) {
    uint32_t ahi[C::MI][4], alo[C::MI][4], bhi[C::NI][2], blo[C::NI][2];
#pragma unroll
    for (int mi = 0; mi < C::MI; ++mi) {
      const int r = wm * (C::BM / C::WM) + mi * 16 + g;
      split_tf32(sm.a[st][r][kk + t], ahi[mi][0], alo[mi][0]);
      split_tf32(sm.a[st][r + 8][kk + t], ahi[mi][1], alo[mi][1]);
      split_tf32(sm.a[st][r][kk + t + 4], ahi[mi][2], alo[mi][2]);
      split_tf32(sm.a[st][r + 8][kk + t + 4], ahi[mi][3], alo[mi][3]);
    }
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni) {
      const int c = wn * (C::BN / C::WN) + ni * 8 + g;
      split_tf32(sm.b[st][kk + t][c], bhi[ni][0], blo[ni][0]);
      split_tf32(sm.b[st][kk + t + 4][c], bhi[ni][1], blo[ni][1]);
    }
#pragma unroll
    for (int mi = 0; mi < C::MI; ++mi) {
#pragma unroll
      for (int ni = 0; ni < C::NI; ++ni) {
        mma_tf32(acc[mi][ni], alo[mi], bhi[ni]);
        mma_tf32(acc[mi][ni], ahi[mi], blo[ni]);
        mma_tf32(acc[mi][ni], ahi[mi], bhi[ni]);
      }
    }
  }
}

// a finished unit: the epilogue of an unsplit tile, else its part to the
// workspace. The thread's columns' constants and rows' addresses once.
template <class C>
__device__ __forceinline__ void k5_unit_out(const K5Args& a, const K5Op& op, const K5Rows<C>& rows,
                                            const K5Unit& t, int wm, int wn,
                                            const float (&acc)[C::MI][C::NI][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // acc[mi][ni][2h + e]: row wm*BM/WM + mi*16 + g + 8h, column
  // n0 + wn*BN/WN + ni*8 + 2*t4 + e
  int col[C::NI][2];
  float bias[C::NI][2], scale[C::NI][2], shift[C::NI][2];
#pragma unroll
  for (int ni = 0; ni < C::NI; ++ni) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = t.n0 + wn * (C::BN / C::WN) + ni * 8 + 2 * t4 + e;
      col[ni][e] = n < op.c_out ? n : -1;
      const int nn = n < op.c_out ? n : 0;
      bias[ni][e] = op.b_off >= 0 ? __ldg(a.wts + op.b_off + nn) : 0.f;
      scale[ni][e] = op.aff_off >= 0 ? __ldg(a.wts + op.aff_off + nn) : 1.f;
      shift[ni][e] = op.aff_off >= 0 ? __ldg(a.wts + op.aff_off + op.c_out + nn) : 0.f;
    }
  }
  const size_t mn = (size_t)a.batch * op.t_out * op.f_out * op.c_out;
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wm * (C::BM / C::WM) + mi * 16 + g + 8 * h;
      const int2 bp = rows.bp[row];
      if (bp.x < 0) continue;
      const size_t at = (size_t)bp.y * op.c_out;
      if (op.splits > 1) {
        float* part = a.partial + (size_t)t.s * mn + (size_t)(t.m0 + row) * op.c_out;
#pragma unroll
        for (int ni = 0; ni < C::NI; ++ni) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (col[ni][e] >= 0) part[col[ni][e]] = acc[mi][ni][2 * h + e];
          }
        }
        continue;
      }
      float* y = k5_dst(a, op.dst, bp.x) + at;
      const float* res = op.res >= 0 ? k5_src(a, op.res, bp.x) + at : nullptr;
#pragma unroll
      for (int ni = 0; ni < C::NI; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = col[ni][e];
          if (n < 0) continue;
          y[n] = k5_epilogue(op, acc[mi][ni][2 * h + e] + bias[ni][e],
                             res != nullptr ? res + n : nullptr, scale[ni][e], shift[ni][e]);
        }
      }
    }
  }
}

// Where the block's slice stream stands: unit u (its j-th), slice sl.
struct K5Cursor {
  int u;
  K5Unit t;
  int sl, j;
};

// the next slice: this unit's, or the first of the block's next unit;
// whether it starts a new unit
template <class C>
__device__ __forceinline__ bool k5_advance(const K5Op& op, K5Cursor& c, int slices) {
  if (c.sl + 1 < c.t.sl1) {
    ++c.sl;
    return false;
  }
  c.u += gridDim.x;
  ++c.j;
  c.t = k5_unit<C>(op, c.u, slices);
  c.sl = c.t.sl0;
  return true;
}

// The block's units u = blockIdx.x + j x grid (block-first) as one stream of
// slices through a ring of K5_STAGES shared-memory stages: the producer
// loads K5_STAGES - 1 slices ahead of the consumer, across unit
// boundaries, so a unit's first loads and its epilogue overlap its
// neighbours' work; one barrier per slice.
template <class C, int VEC>
__device__ void k5_gemm(const K5Args& a, const K5Op& op, unsigned char* smem) {
  K5Smem<C>& sm = *reinterpret_cast<K5Smem<C>*>(smem);
  const int units = op.tiles_m * op.tiles_n * op.splits;
  if ((int)blockIdx.x >= units) return;
  const int warp = threadIdx.x >> 5;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int M = a.batch * op.t_out * op.f_out;
  const int slices = (op.k_total + K5_BK - 1) / K5_BK;
  constexpr int R = K5_STAGES + 1;
  K5Cursor prod;
  prod.u = blockIdx.x;
  prod.j = 0;
  prod.t = k5_unit<C>(op, prod.u, slices);
  prod.sl = prod.t.sl0;
  K5Cursor cons = prod;
  k5_rows<C>(a, op, sm.rows[0], prod.t.m0);
  __syncthreads();
#pragma unroll
  for (int st = 0; st < K5_STAGES - 1; ++st) {
    if (prod.u < units) {
      k5_load_slice<C, VEC>(a, op, sm, st, sm.rows[prod.j % R], prod.sl, prod.t.n0);
      if (k5_advance<C>(op, prod, slices) && prod.u < units) {
        k5_rows<C>(a, op, sm.rows[prod.j % R], prod.t.m0);
        __syncthreads();  // its rows before its first load
      }
    }
    cp_async_commit();
  }
  float acc[C::MI][C::NI][4];
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi) {
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    }
  }
  int st = 0;  // the consumer's stage
  while (true) {
    cp_async_wait<K5_STAGES - 2>();  // the consumer's slice has landed
    __syncthreads();  // for every thread; the stage freed last iteration may refill
    if (prod.u < units) {
      k5_load_slice<C, VEC>(a, op, sm, (st + K5_STAGES - 1) % K5_STAGES, sm.rows[prod.j % R],
                            prod.sl, prod.t.n0);
    }
    cp_async_commit();
    // a warp whose sub-tile lies wholly past M or c_pad skips the products
    if (cons.t.m0 + wm * (C::BM / C::WM) < M && cons.t.n0 + wn * (C::BN / C::WN) < op.c_pad) {
      k5_mma_slice<C>(sm, st, wm, wn, acc);
    }
    if (cons.sl + 1 >= cons.t.sl1) {
      k5_unit_out<C>(a, op, sm.rows[cons.j % R], cons.t, wm, wn, acc);
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi) {
#pragma unroll
        for (int ni = 0; ni < C::NI; ++ni) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
        }
      }
    }
    k5_advance<C>(op, cons, slices);
    if (cons.u >= units) break;
    // the producer's next slice; a new unit's rows now, visible after the
    // next barrier and read no earlier
    if (prod.u < units && k5_advance<C>(op, prod, slices) && prod.u < units) {
      k5_rows<C>(a, op, sm.rows[prod.j % R], prod.t.m0);
    }
    st = (st + 1) % K5_STAGES;
  }
  cp_async_wait<0>();
}

// ---- second pass of a split GEMM: the parts added in split order ----
__device__ __forceinline__ void k5_store_at(const K5Args& a, const K5Op& op, int o,
                                            float v) {
  const int P = op.t_out * op.f_out;
  const int m = o / op.c_out;
  const int b = m / P;
  k5_store(a, op, b, m - b * P, o - m * op.c_out, v);
}

__device__ void k5_gemm_reduce(const K5Args& a, const K5Op& op, int gtid, int nthr) {
  const int mn = a.batch * op.t_out * op.f_out * op.c_out;
  for (int o = gtid; o < mn; o += nthr) {
    float v = 0.f;
    for (int s = 0; s < op.splits; ++s) v += a.partial[(size_t)s * mn + o];
    k5_store_at(a, op, o, v);
  }
}

// ---- depthwise conv: item = (utterance, output row, 4 output columns, 4 channels) ----
__device__ void k5_dwconv(const K5Args& a, const K5Op& op, int gtid, int nthr) {
  const int nq = op.c_pad >> 2;
  const int nfg = (op.f_out + K5_PF - 1) / K5_PF;
  const int items = a.batch * op.t_out * nfg * nq;
  const float* w = a.wts + op.w_off;
  const float* bias = a.wts + op.b_off;
  const float* aff = op.aff_off >= 0 ? a.wts + op.aff_off : nullptr;
  for (int it = gtid; it < items; it += nthr) {
    const int q = it % nq;
    int r = it / nq;
    const int f0 = (r % nfg) * K5_PF;
    r /= nfg;
    const int to = r % op.t_out;
    const int b = r / op.t_out;
    const float* x = k5_src(a, op.src, b);
    float acc[K5_PF][4];
#pragma unroll
    for (int p = 0; p < K5_PF; ++p) {
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[p][k] = 0.f;
    }
    const int left = op.c_in - 4 * q;  // >= 1; output channel o reads input channel o
    for (int i = 0; i < op.kh; ++i) {
      const int row = to * op.sh + i * op.dil - op.pad_t;
      if (row < 0 || row >= op.t_in) continue;  // a tap on the zero padding
      const float* xr = x + (size_t)row * op.f_in * op.c_in;
      for (int j = 0; j < op.kw; ++j) {
        const float4 wv =
            __ldg(reinterpret_cast<const float4*>(w + (size_t)(i * op.kw + j) * op.c_pad) + q);
#pragma unroll
        for (int p = 0; p < K5_PF; ++p) {
          const int col = (f0 + p) * op.sw + j * op.dil - op.pad_f;
          if (f0 + p < op.f_out && col >= 0 && col < op.f_in) {
            const float* xp = xr + (size_t)col * op.c_in + 4 * q;
            acc[p][0] = fmaf(xp[0], wv.x, acc[p][0]);
            if (left > 1) acc[p][1] = fmaf(xp[1], wv.y, acc[p][1]);
            if (left > 2) acc[p][2] = fmaf(xp[2], wv.z, acc[p][2]);
            if (left > 3) acc[p][3] = fmaf(xp[3], wv.w, acc[p][3]);
          }
        }
      }
    }
    const size_t row_off = (size_t)to * op.f_out * op.c_out;
    float* y = k5_dst(a, op.dst, b) + row_off;
    const float* res = op.res >= 0 ? k5_src(a, op.res, b) + row_off : nullptr;
#pragma unroll
    for (int p = 0; p < K5_PF; ++p) {
      const int fo = f0 + p;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int o = 4 * q + k;
        if (fo < op.f_out && o < op.c_out) {
          const size_t at = (size_t)fo * op.c_out + o;
          y[at] = k5_epilogue(op, acc[p][k] + __ldg(bias + o),
                              res != nullptr ? res + at : nullptr,
                              aff != nullptr ? __ldg(aff + o) : 1.f,
                              aff != nullptr ? __ldg(aff + op.c_out + o) : 0.f);
        }
      }
    }
  }
}

// ---- pool (VALID average) and maxpool (padding taps skipped = -inf) ----
__device__ void k5_pool(const K5Args& a, const K5Op& op, int gtid, int nthr) {
  const int C = op.c_in;
  const int items = a.batch * op.t_out * op.f_out * C;
  const bool avg = op.kind == K5_POOL;
  for (int it = gtid; it < items; it += nthr) {
    const int c = (it % C);
    int r = it / C;
    const int fo = r % op.f_out;
    r /= op.f_out;
    const int to = r % op.t_out;
    const int b = r / op.t_out;
    const float* x = k5_src(a, op.src, b);
    float s = avg ? 0.f : __int_as_float((int)0xff800000u);  // -inf
    for (int i = 0; i < op.kh; ++i) {
      const int row = to * op.sh + i - op.pad_t;
      if (row < 0 || row >= op.t_in) continue;
      for (int j = 0; j < op.kw; ++j) {
        const int col = fo * op.sw + j - op.pad_f;
        if (col < 0 || col >= op.f_in) continue;
        const float v = x[((size_t)row * op.f_in + col) * C + c];
        s = avg ? s + v : fmaxf(s, v);
      }
    }
    if (avg) s *= 1.0f / (float)(op.kh * op.kw);
    k5_dst(a, op.dst, b)[((size_t)to * op.f_out + fo) * C + c] = s;
  }
}

// ---- gap, first pass: a warp sums `chunk` positions, lanes over channels ----
__device__ void k5_gap_partial(const K5Args& a, const K5Op& op, int gwarp,
                               int nwarps, int lane) {
  const int C = op.c_in;
  const int P = op.t_in * op.f_in;
  const int units = a.batch * op.n_chunks;
  for (int u = gwarp; u < units; u += nwarps) {
    const int ch = u % op.n_chunks;
    const int b = u / op.n_chunks;
    const float* x = k5_src(a, op.src, b);
    const int p0 = ch * op.chunk;
    const int p1 = min(p0 + op.chunk, P);
    float* part = a.partial + (size_t)u * C;
    for (int c = lane; c < C; c += 32) {
      float s = 0.f;
      for (int p = p0; p < p1; ++p) s += x[(size_t)p * C + c];
      part[c] = s;
    }
  }
}

// ---- gap, second pass: out[b, c] = the chunks added in order / positions ----
__device__ void k5_gap_finish(const K5Args& a, const K5Op& op, int gtid, int nthr) {
  const int C = op.c_in;
  const int items = a.batch * C;
  for (int it = gtid; it < items; it += nthr) {
    const int c = (it % C);
    const int b = (it / C);
    const float* part = a.partial + (size_t)b * op.n_chunks * C + c;
    float s = 0.f;
    for (int ch = 0; ch < op.n_chunks; ++ch) s += part[(size_t)ch * C];
    k5_dst(a, op.dst, b)[c] = s / (float)(op.t_in * op.f_in);
  }
}

// ---- tconv_full: x [T, F], w [kw, T, U]; item = (utterance, fo, 4 units) ----
__device__ void k5_tconv_full(const K5Args& a, const K5Op& op, int gtid, int nthr) {
  const int nq = op.c_pad >> 2;
  const int items = a.batch * op.f_out * nq;
  for (int it = gtid; it < items; it += nthr) {
    const int q = it % nq;
    const int r = it / nq;
    const int fo = r % op.f_out;
    const int b = r / op.f_out;
    const float* x = k5_src(a, op.src, b);
    const float4* w4 = reinterpret_cast<const float4*>(a.wts + op.w_off) + q;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < op.kw; ++j) {
      const int col = fo * op.sw + j;
      for (int t = 0; t < op.t_in; ++t) {
        fma4(acc, x[(size_t)t * op.f_in + col], __ldg(w4 + ((size_t)j * op.t_in + t) * nq));
      }
    }
    float* y = k5_dst(a, op.dst, b) + (size_t)fo * op.c_out;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int o = 4 * q + k;
      if (o < op.c_out) {
        float v = acc[k];
        if (op.b_off >= 0) v += __ldg(a.wts + op.b_off + o);
        y[o] = op.relu ? fmaxf(v, 0.f) : v;
      }
    }
  }
}

// ---- svdf: per rank component, frequency filters then the time dot ----
__device__ void k5_svdf(const K5Args& a, const K5Op& op, int gtid, int nthr) {
  const int nq = op.c_pad >> 2;
  const int items = a.batch * nq;
  for (int it = gtid; it < items; it += nthr) {
    const int q = it % nq;
    const int b = it / nq;
    const float* x = k5_src(a, op.src, b);
    float out[4] = {0.f, 0.f, 0.f, 0.f};
    for (int rk = 0; rk < op.rank; ++rk) {
      const float4* wf =
          reinterpret_cast<const float4*>(a.wts + op.w_off + (size_t)rk * op.f_in * op.c_pad) + q;
      const float4* wt =
          reinterpret_cast<const float4*>(a.wts + op.w2_off + (size_t)rk * op.t_in * op.c_pad) + q;
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      for (int t = 0; t < op.t_in; ++t) {
        float acts[4] = {0.f, 0.f, 0.f, 0.f};
        const float* xt = x + (size_t)t * op.f_in;
        for (int f = 0; f < op.f_in; ++f) fma4(acts, xt[f], __ldg(wf + (size_t)f * nq));
        const float4 tv = __ldg(wt + (size_t)t * nq);
        part[0] = fmaf(acts[0], tv.x, part[0]);
        part[1] = fmaf(acts[1], tv.y, part[1]);
        part[2] = fmaf(acts[2], tv.z, part[2]);
        part[3] = fmaf(acts[3], tv.w, part[3]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) out[k] += part[k];
    }
    float* y = k5_dst(a, op.dst, b);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int o = 4 * q + k;
      if (o < op.c_out) y[o] = fmaxf(out[k] + __ldg(a.wts + op.b_off + o), 0.f);
    }
  }
}

__global__ void __launch_bounds__(K5_THREADS, 2) k5_kernel(const K5Args a) {
  extern __shared__ __align__(16) unsigned char k5_smem[];
  cg::grid_group grid = cg::this_grid();
  // block-first numbering: warp w of block b is global warp b + w x grid,
  // so consecutive runs of 32 items land in different blocks. Items,
  // positions and workspace offsets within a slot fit in 32 bits (the host
  // checks batch x a step's floats < 2^31)
  const int lane = threadIdx.x & 31;
  const int gwarp = (threadIdx.x >> 5) * gridDim.x + blockIdx.x;
  const int nwarps = gridDim.x * (K5_THREADS / 32);
  const int gtid = gwarp * 32 + lane;
  const int nthr = nwarps * 32;
  const K5Op* ops = reinterpret_cast<const K5Op*>(a.ops);
  for (int i = 0; i < a.n_ops; ++i) {
    const K5Op op = ops[i];
    const bool gemm = op.kind == K5_DENSE || (op.kind == K5_CONV && op.mode != MODE_DW);
    if (gemm) {
      if (op.tile == 1) {
        if (op.vec == 4) {
          k5_gemm<K5Narrow, 4>(a, op, k5_smem);
        } else {
          k5_gemm<K5Narrow, 1>(a, op, k5_smem);
        }
      } else if (op.vec == 4) {
        k5_gemm<K5Wide, 4>(a, op, k5_smem);
      } else {
        k5_gemm<K5Wide, 1>(a, op, k5_smem);
      }
      if (op.splits > 1) {
        grid.sync();
        k5_gemm_reduce(a, op, gtid, nthr);
      }
    } else {
      switch (op.kind) {
        case K5_CONV:
          k5_dwconv(a, op, gtid, nthr);
          break;
        case K5_POOL:
        case K5_MAXPOOL:
          k5_pool(a, op, gtid, nthr);
          break;
        case K5_GAP:
          k5_gap_partial(a, op, gwarp, nwarps, lane);
          grid.sync();
          k5_gap_finish(a, op, gtid, nthr);
          break;
        case K5_TCONV_FULL:
          k5_tconv_full(a, op, gtid, nthr);
          break;
        case K5_SVDF:
          k5_svdf(a, op, gtid, nthr);
          break;
        default:
          break;  // the host builds only the kinds above
      }
    }
    if (i + 1 < a.n_ops) grid.sync();
  }
}

// The co-resident grid for this device: occupancy x SMs, found once.
static int k5_grid_blocks(int* blocks) {
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 64 && cached[dev] > 0) {
    *blocks = cached[dev];
    return 0;
  }
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(k5_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)k5_smem_bytes());
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k5_kernel, K5_THREADS,
                                                    k5_smem_bytes());
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *blocks = sms * per_sm;
  if (dev < 64) cached[dev] = *blocks;
  return 0;
}

extern "C" int k5_infer2d(const K5Args* args, void* stream) {
  int blocks = 0;
  const int rc = k5_grid_blocks(&blocks);
  if (rc != 0) return rc;
  void* params[] = {const_cast<K5Args*>(args)};
  const cudaError_t e = cudaLaunchCooperativeKernel((const void*)k5_kernel, dim3(blocks),
                                                    dim3(K5_THREADS), params, k5_smem_bytes(),
                                                    (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The grid the next launch on the current device uses (for reports and
// for the host's plan of K splits).
extern "C" int k5_grid_size(void) {
  int blocks = 0;
  return k5_grid_blocks(&blocks) == 0 ? blocks : -1;
}

extern "C" int k5_args_size(void) { return (int)sizeof(K5Args); }

extern "C" int k5_op_fields(void) { return (int)(sizeof(K5Op) / sizeof(int)); }

// The GEMM tiles (M, N, K) this build computes, checked by the host's plan.
extern "C" int k5_gemm_tile(int tile, int axis) {
  if (axis == 2) return K5_BK;
  if (tile == 1) return axis == 0 ? K5Narrow::BM : K5Narrow::BN;
  return axis == 0 ? K5Wide::BM : K5Wide::BN;
}

extern "C" const char* k5_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
