// Temporal k x 1 convolution (K7): forward, dx and dw of a TF-SAME conv
// without bias, over activations [B, C, T] and weights [Co, Ci, k].
//
// Replaces the TPU kernels tcresnet_tpu/ops/pallas/tconv.py::_fwd_kernel
// (k7_fwd), ::_dx_kernel (k7_dx) and ::_dw_kernel (k7_dw), the three
// pallas_calls behind the temporal_conv custom_vjp.
//
// With x zero outside [0, T), To = ceil(T / s) and lo the TF-SAME left pad:
//   fwd: y[b,co,o]  = sum_j sum_ci x[b,ci,o*s+j-lo] * w[co,ci,j]
//   dx:  dx[b,ci,t] = sum_j sum_co w[co,ci,j] * dy[b,co,(t+lo-j)/s]
//                     over the j with t+lo-j divisible by s, quotient in [0, To)
//   dw:  dw[co,ci,j] = sum_b sum_o dy[b,co,o] * x[b,ci,o*s+j-lo]
//
// What bounds it on the H100: TC-ResNet's convs are 16-72 channels wide,
// narrower than one wgmma tile; each pass is ~2.3 G multiply-adds per
// TCResNet8-1.0 step at batch 1536, over ~141 MB of activations, so at the
// float32-exact tensor-core rate (3xTF32, 165 TFLOP/s) a pass is bound by
// its bytes (~0.04 ms), at the FP32 FMA rate (67 TFLOP/s) by its operations.
//
// What the design does about it:
// - fwd is an implicit GEMM on the tensor cores: M = (sample, output
//   position) rows, N = output channels, K = (input channel, tap). A block
//   computes 128 rows, which pack several samples (m = n * To + o; the last
//   block of TCResNet8 has To = 13), for up to 72 output channels. It stages
//   the zero-padded input rows of the samples its rows span, not an im2col:
//   per input channel and stride phase one row of slots, so that tap j of
//   output o reads slot o + j / s of phase j % s, and a k = 9 conv copies each
//   input value once. A slot row holds only the positions the block's rows
//   read (128 rows plus each sample's halo of (k - 1) / s), whatever T is.
//   The channel stride is 8 mod 16 floats, so a fragment load (8 rows x 4
//   channels a warp) hits 32 banks. The weights come in with the input rows,
//   one slice of input channels (all taps) at a time, by cp.async (4-byte
//   copies: T and Ci * k need not be multiples of 4), laid out in smem in
//   the mma's B-fragment order. A block holds one slice: several blocks
//   share an SM (10-50 KB each at TCResNet8-1.0) and overlap one another's
//   copies; a two-stage ring measured no faster on the card.
// - 3xTF32 mma.sync m16n8k8 (async_mma.cuh), both parts of each operand
//   rounded to the nearest TF32 value. Per k8 step (8 input channels at one
//   tap) a tile's lo*hi, hi*lo, hi*hi are summed from zero on the tensor
//   cores and added to the float32 sums: the tensor cores' accumulation
//   rounds toward zero, and chained over K = 432 its bias alone reaches the
//   1e-5 gate. The three products of every tile are issued in three passes,
//   so no mma waits on the one before it. Steps run in a fixed order
//   (channel step, then tap) with no split K and no atomics: two calls give
//   the same bits.
// - dx is the same implicit GEMM over dy, one stride phase at a time. The
//   rows t with (t + lo) % s == p read only the taps j = p + s i: with t =
//   s q + p - lo, dx[t] = sum_i sum_co w[co, ci, p + s i] dy[co, q - i], a
//   stride-1 correlation of dy with ceil((k - p) / s) taps and a left halo
//   of taps - 1. So grid z is the phase, M = (sample, q) rows of that phase
//   packed 128 a block, N = input channels, K = (output channel, tap i); a
//   block stages per output channel one row of dy slots with the halo,
//   zero-filled outside [0, To), and the phase's taps of w^T in B-fragment
//   order, and stores to t, s apart. No multiply-add touches a zero the
//   stride would stuff into dy (the TPU kernel zero-stuffed dy to stay
//   within Mosaic's reshape rules). A phase with no tap (k = 1, s = 2)
//   writes its rows as zeros in the same launch. It runs fwd's k8 step and
//   store (k7_mma_step, k7_store), so arithmetic and order are fwd's:
//   3xTF32, each k8 step from zero, no split K: two calls give the same
//   bits.
// - dw is a reduction over B * To rows (150,528 for conv0 at batch 1536).
//   Blocks run in no order, so it uses no float atomics: each block sums a
//   fixed batch chunk into its own partial [Co, Ci * k] (4 x 4 outputs per
//   thread, FP32 FMA), and a second kernel adds the partials in chunk order.
//   Two calls give the same bits.
//
// How it differs from the TPU kernels: no batch tile or batch padding (the
// grid covers the batch exactly), no VMEM-resident dw carried across a
// sequential grid (partials and a fixed-order second pass instead), no
// zero-stuffed dy; fwd and dx compute in 3xTF32 where the TPU kernel used
// f32 matmuls.
//
// Build: ops/kernels/_build.py (nvcc, sm_90a, plain C entry points that
// launch on the given stream and return cudaGetLastError()).

#include <cuda_runtime.h>
#include <stdint.h>

#include "async_mma.cuh"

struct K7Args {
  const float* x;   // fwd, dw: [batch, ci, t]
  const float* w;   // fwd, dx: [co, ci, k]
  const float* dy;  // dx, dw: [batch, co, to]
  float* out;       // fwd: [batch, co, to]; dx: [batch, ci, t]; dw: [co, ci, k]
  float* partial;   // dw: [nchunks, co, ci * k] scratch
  int batch, ci, co, k, stride, t, to, lo;
  int nb;       // dw: samples staged in shared memory at once
  int chunk;    // dw: samples summed into one partial
  int nchunks;  // dw: ceil(batch / chunk)
  int smem_bytes;
  // fwd: slots per sample in a staged row (to + (k - 1) / stride), slots of
  // one phase's row; fwd, dx: floats between two channels' rows, channel
  // steps of 8 per slice, n8 tiles of output (dx: input) channels per block
  int ql, slot_len, xrow, kslice, nt;
};

#define K7_THREADS 256

#define K7F_WARPS 4
#define K7F_MT 2                            // m16 tiles per warp
#define K7F_ROWS (K7F_WARPS * K7F_MT * 16)  // output rows per fwd / dx block

// The fwd and dx blocks share their tiles, their k8 step and their store.
// Rows m = n * per + r (sample n, position r) of a block whose first row is
// (n0, first) are staged from slot (n - n0) * ql + r - first; roff is that
// slot for this thread's fragment rows g and g + 8 of its two m16 tiles
// (warp w holds rows 32 w .. 32 w + 31). Rows past the end read the last
// row's slots.
__device__ __forceinline__ void k7_row_slots(int (&roff)[K7F_MT][2], int m0, int rows, int per,
                                             int ql, int n0, int first, int warp, int g) {
#pragma unroll
  for (int mi = 0; mi < K7F_MT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = min(m0 + (warp * K7F_MT + mi) * 16 + h * 8 + g, rows - 1);
      const int n = m / per;
      roff[mi][h] = (n - n0) * ql + (m - n * per) - first;
    }
}

// One k8 step: A from the staged rows (channel tig's row at xc, channel tig
// + 4's 4 xrow floats on; this thread's rows at roff + toff), B from its
// fragments at wb (float2 (b0, b1) per lane, n8 tiles 32 apart). Each
// tile's lo*hi, hi*lo, hi*hi are summed from zero, in three passes of
// independent products, and added to acc.
template <int NT>
__device__ __forceinline__ void k7_mma_step(float (&acc)[K7F_MT][NT][4], const float* xc,
                                            int xrow, const int (&roff)[K7F_MT][2], int toff,
                                            const float2* wb) {
  uint32_t ahi[K7F_MT][4], alo[K7F_MT][4];
#pragma unroll
  for (int mi = 0; mi < K7F_MT; ++mi) {
    split_tf32_rn(xc[roff[mi][0] + toff], ahi[mi][0], alo[mi][0]);
    split_tf32_rn(xc[roff[mi][1] + toff], ahi[mi][1], alo[mi][1]);
    split_tf32_rn(xc[4 * xrow + roff[mi][0] + toff], ahi[mi][2], alo[mi][2]);
    split_tf32_rn(xc[4 * xrow + roff[mi][1] + toff], ahi[mi][3], alo[mi][3]);
  }
  uint32_t bhi[NT][2], blo[NT][2];
#pragma unroll
  for (int ni = 0; ni < NT; ++ni) {
    const float2 b = wb[ni * 32];
    split_tf32_rn(b.x, bhi[ni][0], blo[ni][0]);
    split_tf32_rn(b.y, bhi[ni][1], blo[ni][1]);
  }
  float p[K7F_MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < K7F_MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) mma_tf32_zero(p[mi][ni], alo[mi], bhi[ni]);
#pragma unroll
  for (int mi = 0; mi < K7F_MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) mma_tf32(p[mi][ni], ahi[mi], blo[ni]);
#pragma unroll
  for (int mi = 0; mi < K7F_MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) mma_tf32(p[mi][ni], ahi[mi], bhi[ni]);
#pragma unroll
  for (int mi = 0; mi < K7F_MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] += p[mi][ni][e];
}

// Stores acc, c0 and c1 at (row g, channels 2 tig, 2 tig + 1), c2 and c3 at
// row g + 8: channel c of row m to row(m)[c * cstride], for rows below
// `rows` and channels from c0 below nc.
template <int NT, class Row>
__device__ __forceinline__ void k7_store(const float (&acc)[K7F_MT][NT][4], int m0, int rows,
                                         int warp, int g, int tig, int c0, int nc, int cstride,
                                         Row row) {
#pragma unroll
  for (int mi = 0; mi < K7F_MT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + (warp * K7F_MT + mi) * 16 + h * 8 + g;
      if (m >= rows) continue;
      float* r = row(m);
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const int c = c0 + ni * 8 + 2 * tig;
        if (c < nc) r[(size_t)c * cstride] = acc[mi][ni][2 * h];
        if (c + 1 < nc) r[(size_t)(c + 1) * cstride] = acc[mi][ni][2 * h + 1];
      }
    }
}

// fwd. grid (ceil(batch * to / 128), ceil(ceil(co / 8) / NT)); a block
// computes rows [128 x, 128 x + 128) of y viewed as [batch * to, co], for the
// NT * 8 output channels from 8 NT y. Warp w holds rows 32 w .. 32 w + 31
// (two m16 tiles).
//
// Shared memory: xs[c][phase][slot] for the slice's 8 * kslice input
// channels (floats a.xrow apart), then the weights ws[(c8 * k + j) * NT + ni]
// [lane] as float2 (b0, b1): w[co, ci, j] at ci = c0 + 8 c8 + lane % 4 (+ 4
// for b1), co = co0 + 8 ni + lane / 4. Sample n0 + nl's position q of a phase
// is slot nl * ql + q - o_first, where o_first is the block's first row's
// position: 128 consecutive rows and each sample's halo fit in a.slot_len.
template <int NT>
__global__ void __launch_bounds__(K7F_WARPS * 32) k7_fwd_kernel(const K7Args a) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int k = a.k, s = a.stride;
  const int rows = a.batch * a.to;
  const int m0 = blockIdx.x * K7F_ROWS;
  const int n0 = m0 / a.to, o_first = m0 - n0 * a.to;
  const int co0 = blockIdx.y * NT * 8;
  const int phases = min(s, k);  // phases some tap reads
  const int cs = 8 * a.kslice;   // input channels per slice
  const int xs_floats = cs * a.xrow;
  const int slices = (a.ci + cs - 1) / cs;

  // slot of (row, tap 0)
  int roff[K7F_MT][2];
  k7_row_slots(roff, m0, rows, a.to, a.ql, n0, o_first, warp, g);

  // slot u holds position q of sample n0 + nl, (nl, q) = divmod(u + o_first,
  // ql): the quotient as a product with ceil(2^32 / ql), exact while
  // (u + o_first) * ql < 2^32
  const unsigned long long ql_inv = (0x100000000ull + a.ql - 1) / a.ql;
  const size_t sample = (size_t)a.ci * a.t;

  auto stage = [&](int slice) {
    const int c0 = slice * cs;
    // input rows: one (channel, phase) per warp, its slots across lanes;
    // padding, channels past ci and samples past the batch are zero-filled
    for (int r = warp; r < cs * phases; r += K7F_WARPS) {
      const int c = r / phases, ph = r - c * phases;
      const bool live = c0 + c < a.ci;
      const float* src = a.x + (size_t)(c0 + c) * a.t + ph - a.lo;
      float* dst = smem + c * a.xrow + ph * a.slot_len;
      for (int u = lane; u < a.slot_len; u += 32) {
        const unsigned v = u + o_first;
        const int nl = (int)((v * ql_inv) >> 32);
        const int q = v - nl * a.ql;
        const int tin = q * s + ph - a.lo;
        const bool valid = live && n0 + nl < a.batch && tin >= 0 && tin < a.t;
        cp_async4(dst + u, valid ? src + (n0 + nl) * sample + q * s : a.x, valid);
      }
    }
    // weights: one (channel step, tap) per warp, in fragment order
    float* ws = smem + xs_floats;
    for (int cj = warp; cj < a.kslice * k; cj += K7F_WARPS) {
      const int c8 = cj / k, j = cj - c8 * k;
      for (int i = lane; i < NT * 64; i += 32) {
        const int ni = i >> 6, l = (i >> 1) & 31;
        const int co = co0 + ni * 8 + (l >> 2);
        const int c = c0 + c8 * 8 + (l & 3) + 4 * (i & 1);
        const bool valid = co < a.co && c < a.ci;
        cp_async4(ws + cj * NT * 64 + i, valid ? a.w + ((size_t)co * a.ci + c) * k + j : a.w,
                  valid);
      }
    }
  };

  float acc[K7F_MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < K7F_MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  const float2* wfrag = reinterpret_cast<const float2*>(smem + xs_floats);
  for (int sl = 0; sl < slices; ++sl) {
    stage(sl);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const int steps = min(a.kslice, (a.ci - sl * cs + 7) / 8);  // the last slice may be short
    for (int c8 = 0; c8 < steps; ++c8) {
      const float* xc = smem + (c8 * 8 + tig) * a.xrow;
      int ph = 0, qo = 0;
      for (int j = 0; j < k; ++j) {
        k7_mma_step<NT>(acc, xc, a.xrow, roff, ph * a.slot_len + qo,
                        wfrag + (c8 * k + j) * NT * 32 + lane);
        if (++ph == s) {
          ph = 0;
          ++qo;
        }
      }
    }
    __syncthreads();  // the slice is consumed before the next one lands
  }

  k7_store<NT>(acc, m0, rows, warp, g, tig, co0, a.co, a.to, [&](int m) {
    const int n = m / a.to;
    return a.out + (size_t)n * a.co * a.to + (m - n * a.to);
  });
}

// dx. grid (ceil(batch * to / 128), ceil(ceil(ci / 8) / NT), stride): block
// z computes phase p = z, the rows t = s (q0 + r) + p - lo, r < prow, of
// every sample, viewed as [batch * prow, ci] (m = n * prow + r); block x
// its rows [128 x, 128 x + 128) (none past batch * prow: the block
// returns), block y the NT * 8 input channels from 8 NT y. Warp w holds
// rows 32 w .. 32 w + 31 (two m16 tiles), as in fwd.
//
// Shared memory: ds[c][slot] for the slice's 8 * kslice output channels
// (floats a.xrow apart): sample n0 + nl's position e, which holds dy
// position q0 + e - halo, at slot nl * ql + e - r_first (ql = prow +
// halo), so tap i of row (n, r) reads slot (n - n0) ql + r - r_first +
// halo - i. The block stages exactly the slots its rows read. Then the
// weights ws[(c8 * taps + i) * NT + ni][lane] as float2 (b0, b1): w[co,
// ci, p + s i] at co = c0 + 8 c8 + lane % 4 (+ 4 for b1), ci = ci0 + 8 ni
// + lane / 4.
template <int NT>
__global__ void __launch_bounds__(K7F_WARPS * 32) k7_dx_kernel(const K7Args a) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int s = a.stride, p = blockIdx.z;
  // the phase: its taps, its first q (t >= 0) and its rows per sample (t < T)
  const int taps = p < a.k ? (a.k - p + s - 1) / s : 0;
  const int q0 = max(0, a.lo - p + s - 1) / s;
  const int last = a.t - 1 + a.lo - p;
  const int prow = last < 0 ? 0 : max(0, last / s - q0 + 1);
  const int rows = a.batch * prow;
  const int m0 = blockIdx.x * K7F_ROWS;
  if (m0 >= rows) return;
  const int n0 = m0 / prow, r_first = m0 - n0 * prow;
  const int ci0 = blockIdx.y * NT * 8;
  const int halo = max(taps - 1, 0), ql = prow + halo;
  const int m_last = min(m0 + K7F_ROWS, rows) - 1;
  const int window = m_last - m0 + 1 + (m_last / prow - n0 + 1) * halo;  // slots read
  const int cs = 8 * a.kslice;  // output channels per slice
  const int slices = taps > 0 ? (a.co + cs - 1) / cs : 0;

  // slot of (row, tap 0) less halo
  int roff[K7F_MT][2];
  k7_row_slots(roff, m0, rows, prow, ql, n0, r_first, warp, g);

  // slot u holds position e of sample n0 + nl, (nl, e) = divmod(u +
  // r_first, ql), the quotient as in fwd
  const unsigned long long ql_inv = (0x100000000ull + ql - 1) / ql;

  auto stage = [&](int slice) {
    const int c0 = slice * cs;
    // dy rows: one output channel per warp, its slots across lanes;
    // positions outside [0, to) and channels past co are zero-filled
    for (int c = warp; c < cs; c += K7F_WARPS) {
      const bool live = c0 + c < a.co;
      float* dst = smem + c * a.xrow;
      for (int u = lane; u < window; u += 32) {
        const unsigned v = u + r_first;
        const int nl = (int)((v * ql_inv) >> 32);
        const int q = q0 + (int)(v - nl * ql) - halo;
        const bool valid = live && q >= 0 && q < a.to;
        cp_async4(dst + u, valid ? a.dy + ((size_t)(n0 + nl) * a.co + c0 + c) * a.to + q : a.dy,
                  valid);
      }
    }
    // weights: one (channel step, tap) per warp, in fragment order
    float* ws = smem + cs * a.xrow;
    for (int ct = warp; ct < a.kslice * taps; ct += K7F_WARPS) {
      const int c8 = ct / taps, j = p + s * (ct - c8 * taps);
      for (int i = lane; i < NT * 64; i += 32) {
        const int ni = i >> 6, l = (i >> 1) & 31;
        const int ci = ci0 + ni * 8 + (l >> 2);
        const int co = c0 + c8 * 8 + (l & 3) + 4 * (i & 1);
        const bool valid = co < a.co && ci < a.ci;
        cp_async4(ws + ct * NT * 64 + i, valid ? a.w + ((size_t)co * a.ci + ci) * a.k + j : a.w,
                  valid);
      }
    }
  };

  float acc[K7F_MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < K7F_MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  const float2* wfrag = reinterpret_cast<const float2*>(smem + cs * a.xrow);
  for (int sl = 0; sl < slices; ++sl) {
    stage(sl);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const int steps = min(a.kslice, (a.co - sl * cs + 7) / 8);  // the last slice may be short
    for (int c8 = 0; c8 < steps; ++c8) {
      const float* dc = smem + (c8 * 8 + tig) * a.xrow;
      for (int i = 0; i < taps; ++i)
        k7_mma_step<NT>(acc, dc, a.xrow, roff, halo - i, wfrag + (c8 * taps + i) * NT * 32 + lane);
    }
    __syncthreads();  // the slice is consumed before the next one lands
  }

  // a phase with no taps stores its zeros
  k7_store<NT>(acc, m0, rows, warp, g, tig, ci0, a.ci, a.t, [&](int m) {
    const int n = m / prow;
    return a.out + (size_t)n * a.ci * a.t + s * (q0 + m - n * prow) + p - a.lo;
  });
}

// dw, first pass. grid (nchunks, ceil(tiles / 256)); a tile is 4 output
// channels x 4 (ci, j) columns. Block x sums samples
// [x * chunk, min((x + 1) * chunk, batch)) into partial[x].
__global__ void __launch_bounds__(K7_THREADS) k7_dw_partial_kernel(const K7Args a) {
  extern __shared__ __align__(16) float smem[];
  const int cols = a.ci * a.k;
  const int tp = (a.to - 1) * a.stride + a.k;
  const int xrows = a.ci * tp, drows = a.co * a.to;
  float* xs = smem;                // [nb][ci][tp], zero-padded
  float* ds = smem + a.nb * xrows;  // [nb][co][to]
  const int col_groups = (cols + 3) / 4;
  const int tile = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = tile < ((a.co + 3) / 4) * col_groups;
  const int cg = active ? tile / col_groups : 0;
  const int mg = active ? tile % col_groups : 0;
  int xoff[4], doff[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int m = min(4 * mg + q, cols - 1);
    const int ci = m / a.k;
    xoff[q] = ci * tp + (m - ci * a.k);
    doff[q] = min(4 * cg + q, a.co - 1) * a.to;
  }
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int c0 = blockIdx.x * a.chunk, c1 = min(a.batch, c0 + a.chunk);
  for (int b = c0; b < c1; b += a.nb) {
    const int nb = min(a.nb, c1 - b);
    __syncthreads();  // the previous group is consumed
    const float* x = a.x + (size_t)b * a.ci * a.t;
    for (int i = threadIdx.x; i < nb * xrows; i += blockDim.x) {
      const int r = i / tp, p = i - r * tp - a.lo;
      xs[i] = (p >= 0 && p < a.t) ? x[(size_t)r * a.t + p] : 0.f;
    }
    const float* dy = a.dy + (size_t)b * drows;
    for (int i = threadIdx.x; i < nb * drows; i += blockDim.x) ds[i] = dy[i];
    __syncthreads();
    if (!active) continue;
    for (int n = 0; n < nb; ++n) {
      const float* xr = xs + n * xrows;
      const float* dr = ds + n * drows;
      for (int o = 0; o < a.to; ++o) {
        float d[4], v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          d[q] = dr[doff[q] + o];
          v[q] = xr[xoff[q] + o * a.stride];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(d[i], v[j], acc[i][j]);
      }
    }
  }
  if (!active) return;
  float* part = a.partial + (size_t)blockIdx.x * a.co * cols;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int co = 4 * cg + i;
    if (co >= a.co) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = 4 * mg + j;
      if (m < cols) part[(size_t)co * cols + m] = acc[i][j];
    }
  }
}

// dw, second pass: out[i] = sum over chunks c = 0, 1, ... of partial[c][i].
__global__ void __launch_bounds__(K7_THREADS) k7_dw_reduce_kernel(const K7Args a) {
  const int n = a.co * a.ci * a.k;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int c = 0; c < a.nchunks; ++c) s += a.partial[(size_t)c * n + i];
  a.out[i] = s;
}

// Launches Kernel on the stream. Above 48 KB of dynamic shared memory a
// kernel needs its limit raised first: that is done once per kernel, device
// and larger size, not on every launch.
template <void (*Kernel)(K7Args)>
static int launch(dim3 grid, int threads, const K7Args* a, void* stream) {
  static int granted[64] = {};  // per device: the bytes this kernel may use
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int& have = granted[dev & 63];
  if (a->smem_bytes > 48 * 1024 && a->smem_bytes > have) {
    e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a->smem_bytes);
    if (e != cudaSuccess) return (int)e;
    have = a->smem_bytes;
  }
  Kernel<<<grid, threads, a->smem_bytes, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int k7_fwd(const K7Args* a, void* stream) {
  const int n8 = (a->co + 7) / 8;
  const dim3 grid((a->batch * a->to + K7F_ROWS - 1) / K7F_ROWS, (n8 + a->nt - 1) / a->nt);
  const int threads = K7F_WARPS * 32;
  switch (a->nt) {
    case 1: return launch<k7_fwd_kernel<1>>(grid, threads, a, stream);
    case 2: return launch<k7_fwd_kernel<2>>(grid, threads, a, stream);
    case 3: return launch<k7_fwd_kernel<3>>(grid, threads, a, stream);
    case 4: return launch<k7_fwd_kernel<4>>(grid, threads, a, stream);
    case 5: return launch<k7_fwd_kernel<5>>(grid, threads, a, stream);
    case 6: return launch<k7_fwd_kernel<6>>(grid, threads, a, stream);
    case 7: return launch<k7_fwd_kernel<7>>(grid, threads, a, stream);
    case 8: return launch<k7_fwd_kernel<8>>(grid, threads, a, stream);
    case 9: return launch<k7_fwd_kernel<9>>(grid, threads, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int k7_dx(const K7Args* a, void* stream) {
  const int n8 = (a->ci + 7) / 8;
  const dim3 grid((a->batch * a->to + K7F_ROWS - 1) / K7F_ROWS, (n8 + a->nt - 1) / a->nt,
                  a->stride);
  const int threads = K7F_WARPS * 32;
  switch (a->nt) {
    case 1: return launch<k7_dx_kernel<1>>(grid, threads, a, stream);
    case 2: return launch<k7_dx_kernel<2>>(grid, threads, a, stream);
    case 3: return launch<k7_dx_kernel<3>>(grid, threads, a, stream);
    case 4: return launch<k7_dx_kernel<4>>(grid, threads, a, stream);
    case 5: return launch<k7_dx_kernel<5>>(grid, threads, a, stream);
    case 6: return launch<k7_dx_kernel<6>>(grid, threads, a, stream);
    case 7: return launch<k7_dx_kernel<7>>(grid, threads, a, stream);
    case 8: return launch<k7_dx_kernel<8>>(grid, threads, a, stream);
    case 9: return launch<k7_dx_kernel<9>>(grid, threads, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Both passes of dw, in order on the one stream.
extern "C" int k7_dw(const K7Args* a, void* stream) {
  const int tiles = ((a->co + 3) / 4) * ((a->ci * a->k + 3) / 4);
  const dim3 grid(a->nchunks, (tiles + K7_THREADS - 1) / K7_THREADS);
  const int rc = launch<k7_dw_partial_kernel>(grid, K7_THREADS, a, stream);
  if (rc != 0) return rc;
  const int n = a->co * a->ci * a->k;
  k7_dw_reduce_kernel<<<(n + K7_THREADS - 1) / K7_THREADS, K7_THREADS, 0,
                        (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int k7_args_size(void) { return (int)sizeof(K7Args); }

extern "C" const char* k7_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
