// The port's DFT front ends on the tensor cores: K2 and K8 share a stage
// here, and K9 (radix4.cuh) its pieces.
//
// Shared by K9 (radix4.cuh) and the frames' stage (below): an [rows, K] A
// times column units of 128 DFT columns, streamed as [32, 128] K slices
// through a three-stage cp.async ring, in 3xTF32 mma.sync (tc_mma); a
// finished unit's power (magnitude for log-mel) to a [rows, 65] tile
// (tc_power); the mel folded in unit by unit through runs of nonzero
// weights (tc_mel), so that no power spectrum is stored; log(mel + 1e-6)
// and, for MFCC, the DCT (tc_tail). A unit is 64 (re, im) pairs of bins,
// interleaved.
//
// The frames' stage: every frame's full-window product with the windowed
// DFT, frame[f] @ W, for every frame of the batch. It is K2 and K8 at once:
//  - K2, the hops DFT. Replaces tcresnet_tpu/ops/pallas/mfcc.py::_kernel
//    (entry point k2_mfcc, mfcc.cu) and the hops branch of
//    tcresnet_tpu/ops/pallas/frontend.py::_kernel (k3_frontend,
//    frontend.cu). The TPU kernel sums hop-row products of [hop, k 2K]
//    pieces of W; summed over the hops, that is frame @ W.
//  - K8, the phase-grouped DFT. Replaces ::_kernel_phases and the phases
//    branch of frontend.py, through the same entry points (the host
//    counts their launches by variant). The TPU kernel groups
//    frames by phase f mod P so that each group is one product of a
//    strided lane-row view against W_p, whose rows outside [o_p, o_p +
//    window) are zero. Every W_p[o_p : o_p + window] is the windowed DFT,
//    and the A row of every frame starts at the frame's own first sample,
//    so the phase-grouped DFT is frame @ W too, W's zero rows adding exact
//    zeros (tests/test_torch_k8_tc.py checks this at every geometry the
//    plan covers).
//  - K4's front end (infer.cu), the hops DFT of the JAX whole-model kernel,
//    in its own kernel, so that its conv stacks follow in the same call.
// On Hopper nothing ties a product tile to a hop or a phase:
//
//  - Rows: (utterance, frame) flattened into batch x frames rows; a block
//    takes v.rows consecutive rows (128, 64, or 16 and fewer: the host
//    plan, ops/kernels/mfcc.py::tc_tile_plan, takes the largest whose
//    tiles fill every SM at least once) and reads the DFT constant from L2
//    once for all of them. The 128-row tile runs on wgmma with the
//    constant split on the host (dft_wgmma.cuh); the 64- and 16-row ones
//    on the mma.sync product below. A small batch's tiles of 16 rows or
//    fewer split their column units over blocks as well
//    (tc_frames_features), so that batch 1 runs on 28 (480/160), 32
//    (640/320) or 20 (400/200) blocks.
//  - A is read in place from the staged samples; nothing is rebuilt. A
//    tile's rows touch a few utterances ("pieces"); each piece's samples
//    from hop fa on are staged in chunks, chunk c of the tile at c * stride
//    floats, the pieces a further gap (a multiple of 32) apart beyond the
//    chunks of their frames' tails. A chunk holds hs = hop rounded up to
//    32 samples, from hop (fa + c) on (zeros past the clip's end), and
//    stride = hs + 4: the eight rows of a fragment read eight distinct
//    4-bank groups. Local row lr of piece i starts at lr stride + i gap.
//  - K: a frame spans window / hop chunks; K runs over them, hs rows a
//    chunk (Kp = window / hop * hs), and the constant's rows past the hop
//    in each chunk are zero. So a K slice never straddles two chunks and
//    reads at + k0 + 4 (k0 / hs), with the fragment's offsets immediate,
//    as where hs = hop (every hop a multiple of 32: 480/160, 640/320, K8's
//    every geometry). Where the hop is not (400/200: hop 200, hs 224, Kp
//    448 for a 400 window) the zero rows cost 12% more products; the
//    alternatives cost more: a per-slice table of chunk offsets, read for
//    every A load, ran K8's 128-row tile 3.1% slower on the H100, and
//    frames stored contiguously put all eight rows of a fragment in one
//    bank where the hop is a multiple of 32. The samples a chunk holds
//    past its hop are finite (the next chunk's, or zeros: 3xTF32 of a NaN
//    times an exact zero would be NaN).
//  - B: the windowed DFT [Kp, 128 units] in that row order with its (re_k,
//    im_k) columns interleaved, its first 64 units bins: up to fft / 2,
//    the Nyquist bin carrying no mel weight (the host checks); columns
//    past the bins of a short fft are zero.
//
// What bounds the stage on the H100: its products, window x fft
// multiply-adds a frame (245,760 at 480/160, 655,360 at 640/320, 204,800
// at 400/200) at the tensor cores' float32-exact rate (3xTF32), and the L2
// reads of the DFT constant (0.98 / 2.6 MB a block; the 128-row product's
// split parts 1.97 MB) that feed them: the tile's rows set how often it is
// read.
//
// Numerics (K9's, K5's and K7's): both parts of each operand rounded to the
// nearest TF32 value (split_tf32_rn); per k8 step a tile's lo*hi, hi*lo,
// hi*hi are summed from zero on the tensor cores and added to the unit's
// sums in float32 (the tensor cores' own accumulation rounds toward zero:
// chained, it drifts past the float64 gate on loud dataset rows). An
// element's sum depends only on its row's A, its column and the fixed k
// order, never on the tile, the batch or the staged layout: the stage of
// one utterance equals its row of any batch bit for bit (the 128-row
// product's wgmma too: tests/test_torch_cuda.py), K2 equals K8 where both
// serve a geometry, and k3_frontend equals k2_mfcc(K1(x)) in either
// variant. The zero rows' steps add exact zeros.
// With dsp_matmul_dtype="bfloat16" A and B are bf16 values, exact in TF32:
// their lo parts are zero, and the same three products give the exact
// bf16 products summed in float32 (one would do; the code path is shared).

#pragma once

#include "async_mma.cuh"
#include "frontend.cuh"

#define TC_BK 32              // K rows of a slice
#define TC_BN 128             // columns of a unit
#define TC_PAIRS (TC_BN / 2)  // power bins of a unit
#define TC_STAGES 3           // slices in the ring
#define TC_SB (TC_BN + 8)     // B row stride: lanes (g, t) read banks 8t + g
#define TC_SP (TC_PAIRS + 1)  // power tile row stride, odd: the mel's lanes read by row
#define TC_MAX_ROWS 128       // rows of the largest product
#define TC_PAD 4              // floats between staged chunks (stride = hs + TC_PAD)

// 8 warps as WM (rows) x WN (columns), MI m16 x NI n8 tiles each
template <int MI, int WM>
struct TcCfg {
  static constexpr int WN = 8 / WM;
  static constexpr int NI = TC_BN / WN / 8;
  static constexpr int ROWS = WM * MI * 16;
};

__device__ __forceinline__ int tc_up4(int x) { return (x + 3) & ~3; }

// 16-byte cp.async copies of n4 float4s (not committed)
__device__ __forceinline__ void tc_copy(void* dst, const void* src, int n4) {
  for (int i = threadIdx.x; i < n4; i += FE_THREADS)
    cp_async16(reinterpret_cast<float4*>(dst) + i, reinterpret_cast<const float4*>(src) + i, true);
}

// acc[mp + i] += p[i] for a group's tile rows (round to nearest)
template <int MI, int NI>
__device__ __forceinline__ void tc_add_group(float (&acc)[MI][NI][4], const float (&p)[2][NI][4],
                                             int mp) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (mp + i < MI) {
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mp + i][ni][e] = __fadd_rn(acc[mp + i][ni][e], p[i][ni][e]);
      }
    }
  }
}

// One slice on the tensor cores, added to acc. afrag(mi, kk, v) gives the
// thread's A fragment of its m16 tile mi at the slice's k8 step kk: v =
// A[g][kk + t], A[g + 8][kk + t], A[g][kk + t + 4], A[g + 8][kk + t + 4] of
// that tile (g = lane / 4, t = lane % 4). Per k8 step, tile by tile, lo*hi
// (from zero), + hi*lo, + hi*hi on the tensor cores, then acc += that sum
// in a round-to-nearest add (the header says why). The work runs in groups
// of two m16 tile rows: a group's three products go out in three passes
// over its tiles (so that consecutive mma.sync are independent), then the
// sums of the group before are added while they run. between(j) runs after
// step j's products are issued.
template <int MI, int WM, class AFrag, class Between>
__device__ __forceinline__ void tc_mma(AFrag&& afrag, const float* bst, int wn,
                                       float (&acc)[MI][TcCfg<MI, WM>::NI][4],
                                       Between&& between) {
  using C = TcCfg<MI, WM>;
  constexpr int G = (MI + 1) / 2;  // groups of two tile rows a k8 step
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float p[2][2][C::NI][4];  // the sums of the group in flight and of the one before
  uint32_t bhi[C::NI][2], blo[C::NI][2];
#pragma unroll
  for (int q = 0; q < (TC_BK / 8) * G; ++q) {
    const int kk = (q / G) * 8, mp = (q % G) * 2;
    if (q % G == 0) {
#pragma unroll
      for (int ni = 0; ni < C::NI; ++ni) {
        const float* bc = bst + (kk + t) * TC_SB + (wn * C::NI + ni) * 8 + g;
        split_tf32_rn(bc[0], bhi[ni][0], blo[ni][0]);
        split_tf32_rn(bc[4 * TC_SB], bhi[ni][1], blo[ni][1]);
      }
    }
    uint32_t ahi[2][4], alo[2][4];
#pragma unroll
    for (int i = 0; i < 2 && mp + i < MI; ++i) {
      float av[4];
      afrag(mp + i, kk, av);
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32_rn(av[e], ahi[i][e], alo[i][e]);
    }
    float (&pq)[2][C::NI][4] = p[q & 1];
#pragma unroll
    for (int i = 0; i < 2 && mp + i < MI; ++i) {
#pragma unroll
      for (int ni = 0; ni < C::NI; ++ni) mma_tf32_zero(pq[i][ni], alo[i], bhi[ni]);
    }
#pragma unroll
    for (int i = 0; i < 2 && mp + i < MI; ++i) {
#pragma unroll
      for (int ni = 0; ni < C::NI; ++ni) mma_tf32(pq[i][ni], ahi[i], blo[ni]);
    }
#pragma unroll
    for (int i = 0; i < 2 && mp + i < MI; ++i) {
#pragma unroll
      for (int ni = 0; ni < C::NI; ++ni) mma_tf32(pq[i][ni], ahi[i], bhi[ni]);
    }
    if (q % G == G - 1) between(q / G);
    if (q > 0) tc_add_group<MI, C::NI>(acc, p[(q - 1) & 1], ((q - 1) % G) * 2);
  }
  tc_add_group<MI, C::NI>(acc, p[((TC_BK / 8) * G - 1) & 1], (G - 1) * 2);
}

// a finished unit: acc[mi][ni] holds (re, im) of one bin in elements (0, 1)
// for row g and (2, 3) for row g + 8; the power (magnitude) of the rows
// below `rows` to the tile, pair (wn NI + ni) 4 + t, and the accumulators
// back to zero
template <int MI, int WM>
__device__ __forceinline__ void tc_power(const FeArgs& a, float (&acc)[MI][TcCfg<MI, WM>::NI][4],
                                         float* ptile, int wm, int wn, int rows) {
  using C = TcCfg<MI, WM>;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wm * MI * 16 + mi * 16 + g + 8 * h;
#pragma unroll
      for (int ni = 0; ni < C::NI; ++ni) {
        const float re = acc[mi][ni][2 * h], im = acc[mi][ni][2 * h + 1];
        float p = re * re + im * im;
        if (a.magnitude) p = sqrtf(p);
        if (row < rows) ptile[row * TC_SP + (wn * C::NI + ni) * 4 + t] = p;
        acc[mi][ni][2 * h] = acc[mi][ni][2 * h + 1] = 0.f;
      }
    }
  }
}

// unit u's power tile through the mel: warp w takes bands w, w + 8, ...,
// lane l rows l, l + 32, ... (rows <= TC_MAX_ROWS); the band's run (the
// [first, end) rows of nonzero weight in the unit, and where their weights
// start in vals: runs [units][num_mel][3]) and weights are the same across
// the warp. sums is band-major [num_mel][rows]; each sum is owned by one
// thread. PART: the unit's contributions are written to sums, not added.
template <bool PART = false>
__device__ __forceinline__ void tc_mel(const FeArgs& a, const int* runs, const float* vals,
                                       const float* ptile, float* sums, int u, int rows) {
  const int nm = a.num_mel;
  const int lane = threadIdx.x & 31;
  const int* ru = runs + u * nm * 3;
  for (int m = threadIdx.x >> 5; m < nm; m += FE_THREADS / 32) {
    const int r0 = ru[3 * m], r1 = ru[3 * m + 1];
    const float* w = vals + ru[3 * m + 2] - r0;
    constexpr int FL = (TC_MAX_ROWS + 31) / 32;  // rows a lane
    float acc[FL] = {};
    for (int k = r0; k < r1; ++k) {
      const float wk = w[k];
#pragma unroll
      for (int i = 0; i < FL; ++i) {
        const int f = lane + 32 * i;
        if (f < rows) acc[i] = fmaf(ptile[f * TC_SP + k], wk, acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < FL; ++i) {
      const int f = lane + 32 * i;
      if (f < rows) {
        if (PART) {
          sums[m * rows + f] = acc[i];
        } else {
          sums[m * rows + f] += acc[i];
        }
      }
    }
  }
}

// log(mel + 1e-6), then for MFCC the DCT (staged in `scratch`, the ring;
// with GLOBAL, where it does not fit there, read from global memory: the
// same bits), into out [rows, C]; sums is band-major [num_mel][rows]
template <bool GLOBAL = false>
__device__ __forceinline__ void tc_tail(const FeArgs& a, float* sums, float* scratch, float* out,
                                        int rows) {
  const int total = rows * a.num_mel;
  for (int i = threadIdx.x; i < total; i += FE_THREADS) {
    const float lm = logf(sums[i] + 1e-6f);
    if (a.magnitude) {
      const int m = i / rows;
      out[(i - m * rows) * a.num_mel + m] = lm;
    } else {
      sums[i] = lm;
    }
  }
  if (a.magnitude) return;
  const float* dct = GLOBAL ? a.dct : scratch;
  if (!GLOBAL) {
    for (int i = threadIdx.x; i < a.num_mel * a.num_coef; i += FE_THREADS) scratch[i] = a.dct[i];
  }
  __syncthreads();
  for (int item = threadIdx.x; item < rows * a.num_coef; item += FE_THREADS) {
    const int f = item / a.num_coef, c = item - f * a.num_coef;
    float acc = 0.f;
    for (int m = 0; m < a.num_mel; ++m)
      acc = fmaf(sums[m * rows + f], dct[m * a.num_coef + c], acc);
    out[item] = acc;
  }
}

// ---- K2 and K8: the frames' DFT as one product over the live DFT rows ----

// A block's rows [r0, r0 + nrows) of the batch x frames row space (tile
// `tile` of v.rows rows); row r0 is frame f0 of utterance b0. The block
// takes the tile's column units [u0, u1): all of them, or with SPLIT its
// share of v.splits (the split bookkeeping only where it is compiled in:
// the large tiles' products use every register).
struct TcTile {
  int tile, r0, nrows, b0, f0, u0, u1;
};

// The product a tile of v.rows rows (the host plan's) runs on: 128
// (dft_wgmma.cuh: two warpgroups on wgmma), 64 (2 x 4 warps, 2 m16 tiles
// each), or, for 16 rows or fewer, 16 (8 warps, 1 m16 tile; the only one
// with the split bookkeeping); 0 for any other count
static inline int tc_product(int rows) {
  return rows == 128 || rows == 64 ? rows : (rows >= 1 && rows <= 16 ? 16 : 0);
}

// A launch's blocks: the batch's frames in tiles of v.rows, each tile's
// units over v.splits blocks
static inline int tc_grid(const FeArgs& a, const FeVariant& v, int batch) {
  return (batch * a.frames + v.rows - 1) / v.rows * v.splits;
}

template <bool SPLIT>
__device__ __forceinline__ TcTile tc_tile(const FeArgs& a, const FeVariant& v, int batch) {
  const int rows = v.rows;
  TcTile tl;
  tl.tile = SPLIT ? blockIdx.x / v.splits : blockIdx.x;
  const int per = SPLIT ? v.units / v.splits : v.units;
  tl.u0 = SPLIT ? (blockIdx.x - tl.tile * v.splits) * per : 0;
  tl.u1 = tl.u0 + per;
  tl.r0 = tl.tile * rows;
  tl.nrows = min(rows, batch * a.frames - tl.r0);
  tl.b0 = tl.r0 / a.frames;
  tl.f0 = tl.r0 - tl.b0 * a.frames;
  return tl;
}

// Stages the tile's samples (the header's layout): for each piece,
// piece(b) gives put(t, dst), which writes (or issues the copies of)
// samples t .. t + 3 of utterance b to dst; past the clip's end zeros are
// written instead. Copies are not committed.
template <class Piece>
__device__ __forceinline__ void tc_stage(const FeArgs& a, const FeVariant& v, const TcTile& tl,
                                         float* x, Piece&& piece) {
  const int wh = a.window / a.hop;         // chunks a frame spans
  const int q = (v.stride - TC_PAD) / 4;  // float4s a chunk
  const int last = tl.r0 + tl.nrows - 1;
  const int b1 = last / a.frames;
  for (int b = tl.b0; b <= b1; ++b) {
    const int i = b - tl.b0;
    const int fa = i ? 0 : tl.f0;
    const int fb = b == b1 ? last - b * a.frames : a.frames - 1;
    float* dst = x + (b * a.frames + fa - tl.r0) * v.stride + i * v.gap;
    auto put = piece(b);
    const int n4 = (fb - fa + wh) * q;
    for (int e = threadIdx.x; e < n4; e += FE_THREADS) {
      const int c = e / q, j = e - c * q;
      const int t = a.hop * (fa + c) + 4 * j;
      float* d = dst + c * v.stride + 4 * j;
      if (t < a.n) {
        put(t, d);
      } else {
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }
}

// K2, K8 and K4: the tile's samples of wavs [batch, n] staged by tc_stage
// with cp.async (16-byte aligned: n and hop are multiples of 4), rounded to
// bf16 in place for dsp_matmul_dtype="bfloat16" (the DFT's A operand, as
// fe_sample does); the copies are committed only when rounding
__device__ __forceinline__ void tc_stage_wavs(const FeArgs& a, const FeVariant& v,
                                              const TcTile& tl, float* smem, const float* wavs,
                                              int region_a) {
  const int n = a.n;
  tc_stage(a, v, tl, smem, [wavs, n](int b) {
    const float* wav = wavs + (size_t)b * n;
    return [wav](int t, float* dst) { cp_async16(dst, wav + t, true); };
  });
  if (a.round_bf16) {
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int i = threadIdx.x; i < region_a; i += FE_THREADS) smem[i] = fe_bf16(smem[i]);
  }
}

// the [32, 128] block of the DFT (row stride ld) at rows k0.., columns n0..
// into a ring stage
__device__ __forceinline__ void tc_load_b(const float* w, int ld, float* dst, int n0, int k0) {
  w += (size_t)k0 * ld + n0;
#pragma unroll
  for (int r = 0; r < TC_BK * TC_BN / 4 / FE_THREADS; ++r) {
    const int c = threadIdx.x + r * FE_THREADS;
    const int row = c / (TC_BN / 4), col = (c % (TC_BN / 4)) * 4;
    cp_async16(dst + row * TC_SB + col, w + (size_t)row * ld + col, true);
  }
}

// The product of the tile's units [u0, u1), unit by unit over the Kp / 32
// K slices, each unit's power tile through mel(u) after the next barrier.
// x holds the staged samples (landed or in committed-or-pending cp.async
// groups), the tables are in shared memory; on return the last unit's
// power tile is written, not yet synchronised.
template <int MI, int WM, class Mel>
__device__ __forceinline__ void tc_frames_run(const FeArgs& a, const FeVariant& v, const TcTile& tl,
                                              const float* x, float* ring, float* ptile,
                                              Mel&& mel) {
  using C = TcCfg<MI, WM>;
  const int hs = v.stride - TC_PAD;            // K rows a chunk
  const int kp = a.window / a.hop * hs;        // K rows of a unit
  const int slices = kp / TC_BK;               // K slices of a unit
  const int total = (tl.u1 - tl.u0) * slices;
  const int n0 = tl.u0 * TC_BN;
  const int ld = TC_BN * v.units;
  const int warp = threadIdx.x >> 5;
  const int wm = warp / C::WN, wn = warp % C::WN;
  // where the thread's fragment rows g and g + 8 of tile mi read sample 0
  // of their frames (+ t), 16 bits each (shared memory holds < 2^16
  // floats); rows past the tile read its last row's, whose results are
  // dropped
  uint32_t base[MI];
  {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      base[mi] = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int lr = min(wm * MI * 16 + mi * 16 + g + 8 * h, tl.nrows - 1);
        base[mi] |= (uint32_t)(lr * v.stride + ((tl.r0 + lr) / a.frames - tl.b0) * v.gap + t)
                    << (16 * h);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < total) tc_load_b(a.dft, ld, ring + s * TC_BK * TC_SB, n0 + s / slices * TC_BN,
                             s % slices * TC_BK);
    cp_async_commit();
  }
  float acc[MI][C::NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    }
  }
  for (int s = 0; s < total; ++s) {
    cp_async_wait<TC_STAGES - 2>();  // slice s (and the samples) have landed
    __syncthreads();  // for every thread; the stage of slice s - 1 is free
    const int ls = s + TC_STAGES - 1;
    if (ls < total) tc_load_b(a.dft, ld, ring + ls % TC_STAGES * TC_BK * TC_SB,
                              n0 + ls / slices * TC_BN, ls % slices * TC_BK);
    cp_async_commit();
    const int u = s / slices, k0 = (s - u * slices) * TC_BK;
    const float* xs = x + k0 + TC_PAD * (k0 / hs);  // the slice lies in one chunk
    tc_mma<MI, WM>(
        [&](int mi, int kk, float (&av)[4]) {
          const float* r0 = xs + (base[mi] & 0xffffu) + kk;
          const float* r1 = xs + (base[mi] >> 16) + kk;
          av[0] = r0[0];
          av[1] = r1[0];
          av[2] = r0[4];
          av[3] = r1[4];
        },
        ring + s % TC_STAGES * TC_BK * TC_SB, wn, acc, [](int) {});
    // the previous unit's power tile through the mel (written before this
    // slice's barrier; the next write is a unit, >= 2 barriers, later)
    if (u > 0 && k0 == 0) mel(tl.u0 + u - 1);
    if (k0 + TC_BK == kp) tc_power<MI, WM>(a, acc, ptile, wm, wn, tl.nrows);
  }
  cp_async_wait<0>();
}

// The tile's features into out [batch x frames, C]. The caller has staged
// the samples in smem[0, region_a) (written, or their cp.async copies
// issued and not committed). Shared memory after them (floats, each region
// a multiple of 4; ops/kernels/mfcc.py::smem_plan mirrors it): the mel runs
// [units][num_mel][3], its nonzero weights [v.mel_nnz], the ring, the
// power tile [rows][65] and the mel sums [num_mel][rows] (rows = v.rows);
// the DCT reuses the ring.
//
// Split tiles (SPLIT and v.splits > 1, a small batch: the host's plan, on
// a tile of 16 rows or fewer): each block writes its units' mel
// contributions to v.part [tiles][units][num_mel][rows], not summed, and
// the tile's last block to finish (a counter per tile in v.done, which it
// sets back to 0) adds them in unit order, as an unsplit tile adds them to
// its sums, then runs the tail: the same bits. Returns whether this block
// stored the tile's features: false for a split tile's other blocks, which
// return early (K4 counts the stored rows, infer.cu).
template <int MI, int WM, bool SPLIT>
__device__ __forceinline__ bool tc_frames_features(const FeArgs& a, const FeVariant& v,
                                                   const TcTile& tl, float* smem, int region_a,
                                                   float* out) {
  const int nruns = v.units * a.num_mel * 3;
  int* runs = reinterpret_cast<int*>(smem + region_a);
  float* vals = reinterpret_cast<float*>(runs) + tc_up4(nruns);
  float* ring = vals + tc_up4(v.mel_nnz);
  float* ptile = ring + TC_STAGES * TC_BK * TC_SB;
  float* sums = ptile + tc_up4(v.rows * TC_SP);
  for (int i = threadIdx.x; i < nruns; i += FE_THREADS) cp_async4(runs + i, v.runs + i, true);
  tc_copy(vals, a.mel, tc_up4(v.mel_nnz) / 4);
  cp_async_commit();
  const int nsum = a.num_mel * tl.nrows;
  for (int i = threadIdx.x; i < nsum; i += FE_THREADS) sums[i] = 0.f;
  const bool split = SPLIT && v.splits > 1;
  float* part = split ? v.part + (size_t)tl.tile * v.units * a.num_mel * v.rows : sums;
  auto mel = [&](int u) {
    if (split) {
      tc_mel<true>(a, runs, vals, ptile, part + u * a.num_mel * v.rows, u, tl.nrows);
    } else {
      tc_mel(a, runs, vals, ptile, sums, u, tl.nrows);
    }
  };
  tc_frames_run<MI, WM>(a, v, tl, smem, ring, ptile, mel);
  __syncthreads();
  mel(tl.u1 - 1);
  if (split) {
    __shared__ int last;
    __threadfence();  // this block's contributions, before its count
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(v.done + tl.tile, 1) == v.splits - 1;
    __syncthreads();
    if (!last) return false;
    __threadfence();  // the other blocks' contributions, after their counts
    for (int i = threadIdx.x; i < nsum; i += FE_THREADS) {
      float s = 0.f;
      for (int u = 0; u < v.units; ++u) s += __ldcg(part + u * a.num_mel * v.rows + i);
      sums[i] = s;
    }
    if (threadIdx.x == 0) v.done[tl.tile] = 0;
  }
  __syncthreads();
  out += (size_t)tl.r0 * fe_width(a);
  if (a.num_mel * a.num_coef <= TC_STAGES * TC_BK * TC_SB) {
    tc_tail(a, sums, ring, out, tl.nrows);  // the ring is free
  } else {
    tc_tail<true>(a, sums, ring, out, tl.nrows);
  }
  return true;
}
