// K9's spectral stage on Hopper: one utterance's samples in shared memory
// -> MFCC or log-mel features through the radix-4 DIF factored rDFT.
//
// Replaces the DFT of tcresnet_tpu/ops/pallas/mfcc.py::_kernel_radix4 (and
// of frontend.py's radix4 branch): per frame, the four L-wide blocks of
// windowed samples, their butterfly u0, [u1re | u1im], u2, the stage-2
// products u0 @ M0, [u1re | u1im] @ M1, u2 @ M2, the power (the magnitude
// for log-mel), the row-permuted mel, log(mel + 1e-6) and, for MFCC, the
// DCT. Entry points: k9_mfcc (mfcc.cu) and k3_radix4 (frontend.cu).
//
// What bounds it on the H100: the stage-2 products, 6 L^2 multiply-adds a
// frame (49 frames at L = 256 for 640/320, 98 at L = 128 for 480/160), at
// the tensor cores' float32-exact rate (3xTF32, mma.sync). The constants
// M0-M2 are 1.5 MB (L = 256), too large for shared memory: a design that
// reads them from L2 once per small tile of frames (4 frames beside a
// stored [frames, 3L] power spectrum: 26 MB per utterance at L = 256) is
// bound by the L2's bandwidth instead. Beside the products, the A build,
// the fragment reads and the mel take issue slots and shared-memory
// bandwidth: PERF.md has the card's times.
//
// What the design does about it:
//  - All frames of the utterance are the M dimension of one product,
//    padded to 64 rows (frames <= 64) or 112 rows (frames <= 112), so each
//    K slice of M is read from L2 once per utterance. 8 warps as WM x WN:
//    2 x 4 with 2 m16 tiles each (64 rows), or 1 x 8 with 7 (112 rows).
//  - The product runs unit by unit: a unit is 128 columns (64 (re, im)
//    pairs) of one branch, over K slices of 32 rows. Slices of M stream
//    through a three-stage cp.async ring (two load while one computes, one
//    barrier per slice) across unit boundaries. The A slice (the butterfly
//    of every frame's 32 K positions) is built from the samples into a
//    double buffer in steps between the k8 steps of the slice before.
//  - Only live columns (ops/kernels/mfcc.py: radix4_kernel_constants): M0
//    and M2 keep k2 < L/2, as (re, im) pairs. M0's k2 = L/2 column carries
//    only the Nyquist bin, whose mel weight is zero (the host checks it), so
//    every branch is a whole number of units and a frame costs 6 L^2.
//  - No stored power spectrum: at a unit's end each warp writes the power
//    of its columns to a [frames, 64] tile, and after the next barrier the
//    block adds that tile's contribution to its (band, frame) sums. The mel
//    is sparse (a triangle per band), and within a unit the bins run
//    monotonically (4 apart), so a band meets a contiguous run of the
//    tile's rows: the host gives its [first, end) per unit and the nonzero
//    weights alone. The block keeps them, the window and the samples in
//    shared memory, copied with cp.async: read from global memory inside
//    the loop, their dependent loads held each thread for an L2 latency.
//  - 3xTF32 mma.sync m16n8k8 (dft_tc.cuh, shared with K8: the products,
//    the power tile, the mel fold and the tail), both parts of each operand
//    rounded to the nearest TF32 value (split_tf32_rn). Per k8 step a
//    tile's lo*hi, hi*lo, hi*hi are summed from zero on the tensor cores
//    and added to the unit's sums in float32: the tensor cores' own
//    accumulation rounds toward zero, and chained over a slice that bias
//    put the MFCC of loud dataset rows farther from a float64 MFCC than the
//    1e-4 gate. With dsp_matmul_dtype="bfloat16" the operands are bf16
//    values, exact in TF32: their lo parts are zero and the same products
//    give the exact bf16 products summed in float32.
//  - The bf16 rounding of the butterfly is a template parameter: selected
//    away at run time, its conversions still issued on the conversion
//    pipe.
//
// Shared memory (floats; ops/kernels/mfcc.py::smem_plan mirrors it): the
// samples [region_a], the window [4L], the mel runs and weights, the ring
// [3][32][136], the A double buffer [2][rows][36], the power tile
// [frames][65], the mel sums [num_mel][frames]; the DCT reuses the ring.
// Row strides make the fragment reads and the mel's reads of the power
// tile free of bank conflicts. About 175 KB at 640/320 and 208 KB at
// 480/160 (64 mel bands): one block per SM.
//
// Numerics: the butterfly keeps the JAX rounding sequence for bf16 (the
// windowed sample rounds, then each butterfly add). A unit's sum runs k8
// step by k8 step in K order, the mel sums unit by unit in a fixed order,
// each owned by one thread: no atomics, repeated calls give the same bits.

#pragma once

#include "dft_tc.cuh"

#define R4_SA (TC_BK + 4)       // A row stride: lanes (g, t) read banks 4g + t
#define R4_SMALL_FRAMES 64      // frames of the 64-row product
#define R4_MAX_FRAMES 112       // frames of the 112-row product

// Where a slice stream stands: unit u (columns n0.. of branch br) and its
// K rows k0..k0 + 31. Units run branch 0 (L / 128 units of L K rows), 1
// (2L / 128 of 2L), 2 (L / 128 of L); a branch has as many columns as K rows.
struct R4Slice {
  int u, br, n0, k0;
};

__device__ __forceinline__ int r4_rows(const R4Slice& c, int len) { return c.br == 1 ? 2 * len : len; }

__device__ __forceinline__ bool r4_last(const R4Slice& c, int len) {
  return c.k0 + TC_BK == r4_rows(c, len);
}

__device__ __forceinline__ void r4_advance(R4Slice& c, int len) {
  c.k0 += TC_BK;
  if (c.k0 < r4_rows(c, len)) return;
  c.k0 = 0;
  c.n0 += TC_BN;
  ++c.u;
  if (c.n0 == r4_rows(c, len)) {
    c.n0 = 0;
    ++c.br;
  }
}

// the slice's [32, 128] block of M_br ([L, L], [2L, 2L], [L, L] back to
// back, row-major) into ring stage st
__device__ __forceinline__ void r4_load_b(const FeVariant& v, float* ring, int st,
                                          const R4Slice& sl) {
  const int len = v.length;
  tc_load_b(v.w + (sl.br == 0 ? 0 : (sl.br == 1 ? len * len : 5 * len * len)),
            sl.br == 1 ? 2 * len : len, ring + st * TC_BK * TC_SB, sl.n0, sl.k0);
}

// The A slice: the butterfly of every frame (rows past the frames zero) at
// the slice's 32 K positions of branch br (K position k of branch 1 is
// u1re[k] below L, u1im[k - L] from L), 4 positions a thread with 16-byte
// loads of samples and window (hop, L and k0 are multiples of 4). A
// thread's positions are the same in every frame it builds, so it reads
// the window once; it builds in steps, frame f0 + 32 j at step j (f0 =
// threadIdx.x / 8), so that the products of the slice before run between
// them. RND (dsp_matmul_dtype "bfloat16") rounds as JAX's bf16 arrays do.
template <bool RND>
__device__ __forceinline__ float r4_round(float x) { return RND ? fe_bf16(x) : x; }

template <int ROWS, bool RND>
struct R4Build {
  static constexpr int STEP = FE_THREADS / (TC_BK / 4);  // frames a step
  static constexpr int STEPS = (ROWS + STEP - 1) / STEP;
  static_assert(STEPS <= TC_BK / 8, "one build step per k8 step of the products");
  const FeArgs& a;
  const float* xs;  // the thread's first sample of frame 0
  float* dst;       // its first A element of frame 0
  int br, below, window_left, len;
  float4 w[4];

  __device__ __forceinline__ R4Build(const FeArgs& a_, const FeVariant& v, const float* x,
                                     const float* win, float* abuf, const R4Slice& sl)
      : a(a_), br(sl.br), len(v.length) {
    const int kk = (threadIdx.x % (TC_BK / 4)) * 4;
    const int k = sl.k0 + kk;
    const int l = k < len ? k : k - len;
    below = k < len;
    window_left = a.window - l;  // block q is inside the window when q L < window_left
    xs = x + l;
    dst = abuf + kk;
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // window samples past `window` are zero
      w[q] = q * len < window_left ? *reinterpret_cast<const float4*>(win + q * len + l)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  __device__ __forceinline__ void step(int j) {
    const int f = threadIdx.x / (TC_BK / 4) + j * STEP;
    if (j >= STEPS || f >= ROWS) return;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (f < a.frames) {
      const float* xf = xs + f * a.hop;
      float b[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 xv = q * len < window_left ? *reinterpret_cast<const float4*>(xf + q * len)
                                                : make_float4(0.f, 0.f, 0.f, 0.f);
        b[q][0] = r4_round<RND>(__fmul_rn(xv.x, w[q].x));
        b[q][1] = r4_round<RND>(__fmul_rn(xv.y, w[q].y));
        b[q][2] = r4_round<RND>(__fmul_rn(xv.z, w[q].z));
        b[q][3] = r4_round<RND>(__fmul_rn(xv.w, w[q].w));
      }
      float u[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (br == 0) {
          u[i] = r4_round<RND>(__fadd_rn(b[0][i], b[1][i]));
          u[i] = r4_round<RND>(__fadd_rn(u[i], b[2][i]));
          u[i] = __fadd_rn(u[i], b[3][i]);
        } else if (br == 1) {
          u[i] = below ? __fsub_rn(b[0][i], b[2][i]) : __fsub_rn(b[3][i], b[1][i]);
        } else {
          u[i] = r4_round<RND>(__fsub_rn(b[0][i], b[1][i]));
          u[i] = r4_round<RND>(__fadd_rn(u[i], b[2][i]));
          u[i] = __fsub_rn(u[i], b[3][i]);
        }
        u[i] = r4_round<RND>(u[i]);
      }
      val = make_float4(u[0], u[1], u[2], u[3]);
    }
    *reinterpret_cast<float4*>(dst + f * R4_SA) = val;
  }
};

// The slice stream (RND: the bf16 butterfly). The tables are in shared
// memory and synchronised; on return the last unit's power tile is written
// and the ring's copies have landed, not yet synchronised.
template <int MI, int WM, bool RND>
__device__ __forceinline__ void r4_run(const FeArgs& a, const FeVariant& v, const float* x,
                                       const float* win, const int* runs, const float* vals,
                                       float* ring, float* abuf, float* ptile, float* sums) {
  using C = TcCfg<MI, WM>;
  const int len = v.length;
  const int units = 4 * (len / TC_BN);
  const int warp = threadIdx.x >> 5;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  // three cursors: the products (slice s), the A build (s + 1) and the
  // ring's loads (s + 2)
  R4Slice cur = {0, 0, 0, 0};
  R4Slice load = cur;
#pragma unroll
  for (int st = 0; st < TC_STAGES - 1; ++st) {
    r4_load_b(v, ring, st, load);
    cp_async_commit();
    r4_advance(load, len);
  }
  {
    R4Build<C::ROWS, RND> first(a, v, x, win, abuf, cur);
#pragma unroll
    for (int j = 0; j < R4Build<C::ROWS, RND>::STEPS; ++j) first.step(j);
  }
  R4Slice next = cur;
  r4_advance(next, len);
  float acc[MI][C::NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    }
  }
  for (int s = 0; cur.u < units; ++s) {
    cp_async_wait<TC_STAGES - 2>();  // slice s of M has landed
    __syncthreads();  // for every thread; A of s is written, stage and buffer of s - 1 free
    if (load.u < units) r4_load_b(v, ring, (s + TC_STAGES - 1) % TC_STAGES, load);
    cp_async_commit();
    r4_advance(load, len);
    // the products of slice s, with A of slice s + 1 built between their
    // steps; then the previous unit's power tile through the mel (written
    // before this barrier; the next write is a unit, >= 4 barriers, later)
    const bool more = next.u < units;
    R4Build<C::ROWS, RND> build(a, v, x, win, abuf + ((s + 1) & 1) * C::ROWS * R4_SA, next);
    const float* as = abuf + (s & 1) * C::ROWS * R4_SA + (wm * MI * 16 + g) * R4_SA + t;
    tc_mma<MI, WM>(
        [&](int mi, int kk, float (&av)[4]) {
          const float* ar = as + mi * 16 * R4_SA + kk;
          av[0] = ar[0];
          av[1] = ar[8 * R4_SA];
          av[2] = ar[4];
          av[3] = ar[8 * R4_SA + 4];
        },
        ring + (s % TC_STAGES) * TC_BK * TC_SB, wn, acc, [&](int j) {
          if (more) build.step(j);
        });
    if (cur.u > 0 && cur.k0 == 0) tc_mel(a, runs, vals, ptile, sums, cur.u - 1, a.frames);
    if (r4_last(cur, len)) tc_power<MI, WM>(a, acc, ptile, wm, wn, a.frames);
    cur = next;
    r4_advance(next, len);
  }
  cp_async_wait<0>();
}

// The samples are in smem[0, n), unrounded: the caller has written them or
// issued their cp.async copies, which this call waits for. The features go
// to out [frames, C]. Shared memory after the samples (floats, each region
// a multiple of 4): the window [4L], the mel runs [units][num_mel][3] and
// weights [v.mel_nnz, padded], the ring, the A double buffer, the power
// tile and the mel sums.
template <int MI, int WM>
__device__ __forceinline__ void r4_features(const FeArgs& a, const FeVariant& v, float* smem,
                                            int region_a, float* out) {
  using C = TcCfg<MI, WM>;
  const int len = v.length;
  const int units = 4 * (len / TC_BN);
  const int nruns = units * a.num_mel * 3;
  const float* x = smem;
  float* win = smem + region_a;
  int* runs = reinterpret_cast<int*>(win + 4 * len);
  float* vals = reinterpret_cast<float*>(runs) + tc_up4(nruns);
  float* ring = vals + tc_up4(v.mel_nnz);
  float* abuf = ring + TC_STAGES * TC_BK * TC_SB;
  float* ptile = abuf + 2 * C::ROWS * R4_SA;
  float* sums = ptile + a.frames * TC_SP;
  tc_copy(win, v.win, len);
  tc_copy(runs, v.runs, nruns / 4);
  tc_copy(vals, a.mel, tc_up4(v.mel_nnz) / 4);
  cp_async_commit();
  for (int i = threadIdx.x; i < a.frames * a.num_mel; i += FE_THREADS) sums[i] = 0.f;
  cp_async_wait<0>();
  __syncthreads();
  if (a.round_bf16) {
    r4_run<MI, WM, true>(a, v, x, win, runs, vals, ring, abuf, ptile, sums);
  } else {
    r4_run<MI, WM, false>(a, v, x, win, runs, vals, ring, abuf, ptile, sums);
  }
  __syncthreads();
  tc_mel(a, runs, vals, ptile, sums, units - 1, a.frames);
  __syncthreads();
  tc_tail(a, sums, ring, out, a.frames);  // the ring is free: the DCT goes there
}
