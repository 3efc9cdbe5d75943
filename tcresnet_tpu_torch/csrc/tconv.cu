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
// its bytes (~0.04 ms); all three compute their products that way.
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
// - dw is the implicit GEMM the other way round: M = output channels (all
//   of them in a block, up to 5 m16 tiles), N = (input channel, tap)
//   columns, an n8 tile being 8 input channels at one tap, K = the B * To
//   (sample, position) rows (150,528 for conv0 at batch 1536). A block
//   walks a fixed chunk of whole samples in windows of 128 rows, two in
//   flight by cp.async: per output channel one row of the window's dy
//   (channel stride 4 mod 8 floats: the A fragment's lanes read channel
//   g, row tig), and per input channel and stride phase one row of x slots
//   as fwd stages them (tap j reads phase j % s at slot offset j / s); a
//   thread decodes one row or slot and copies it for every channel.
//   Rows are not padded per sample: a k8 step that crosses a sample
//   boundary computes each row's slot (row + halo * its sample in the
//   window), where padding every sample to 8 rows would cost 6%, 14%, 28%
//   and 23% more products at To = 98, 49, 25 and 13. Two warps split the
//   block's column tiles and two its k8 steps (on the card this beat four
//   warps on rows, which restage dy for twice the column blocks, and four
//   on columns); each step runs fwd's arithmetic (3xTF32, lo*hi, hi*lo,
//   hi*hi from zero, added to float32 sums), and the two row warps' sums
//   are added in order at the end. Blocks run in no order, so there are no
//   float atomics: each chunk writes its own partial [Co, Ci * k], and a
//   second kernel adds the partials in chunk order (one chunk writes dw
//   itself). The chunk count (ops/kernels/tconv.py::_dw_plan) trades grid
//   fill (~2 blocks an SM) against partial traffic. Two calls give the
//   same bits.
//
// How it differs from the TPU kernels: no batch tile or batch padding (the
// grid covers the batch exactly), no VMEM-resident dw carried across a
// sequential grid (partials and a fixed-order second pass instead), no
// zero-stuffed dy; the three compute in 3xTF32 where the TPU kernel used
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
  float* partial;   // dw: [nchunks, co, ci * k] scratch (out itself when nchunks is 1)
  int batch, ci, co, k, stride, t, to, lo;
  int chunk;    // dw: samples summed into one partial
  int nchunks;  // dw: ceil(batch / chunk)
  int smem_bytes;
  // fwd: slots per sample in a staged row (to + (k - 1) / stride); fwd, dw:
  // slots of one phase's row; fwd, dx, dw: floats between two staged
  // input-channel (dx: output-channel) rows; fwd, dx: channel steps of 8
  // per slice; fwd, dx, dw: n8 tiles of columns per block
  int ql, slot_len, xrow, kslice, nt;
  // dw: m16 tiles of output channels, input-channel groups of 8 a block
  // stages at most
  int mt, groups;
};

#define K7F_WARPS 4
#define K7F_MT 2                            // m16 tiles per warp
#define K7F_ROWS (K7F_WARPS * K7F_MT * 16)  // output rows per fwd / dx block
#define K7W_ROWS (K7F_WARPS * 32)           // rows (sample, position) of a dw window
#define K7W_DROW (K7W_ROWS + 4)             // floats a dw window's dy row takes
#define K7W_WN 2  // dw warps that split a block's columns (the others split its rows)

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

// dw's k8 step for one m16 tile of A and NT n8 tiles of B, split as in
// k7_mma_step: each tile's lo*hi, hi*lo, hi*hi summed from zero, in three
// passes of independent products, and added to acc.
template <int NT>
__device__ __forceinline__ void mma3_tf32(float (&acc)[NT][4], const uint32_t (&ahi)[4],
                                          const uint32_t (&alo)[4], const uint32_t (&bhi)[NT][2],
                                          const uint32_t (&blo)[NT][2]) {
  float p[NT][4];
#pragma unroll
  for (int ni = 0; ni < NT; ++ni) mma_tf32_zero(p[ni], alo, bhi[ni]);
#pragma unroll
  for (int ni = 0; ni < NT; ++ni) mma_tf32(p[ni], ahi, blo[ni]);
#pragma unroll
  for (int ni = 0; ni < NT; ++ni) mma_tf32(p[ni], ahi, bhi[ni]);
#pragma unroll
  for (int ni = 0; ni < NT; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ni][e] += p[ni][e];
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

// dw, first pass. grid (nchunks, ceil(n8 / (2 NT))), n8 = k * ceil(ci /
// 8) column tiles: tile u is 8 input channels at one tap, (c8, j) =
// divmod(u, k). Block (x, y) sums the rows (n, o) of samples [x * chunk,
// min((x + 1) * chunk, batch)) for every output channel (MT m16 tiles)
// and the column tiles [2 NT y, 2 NT y + 2 NT), and writes them to
// partial[x]. Warp w takes the NT tiles from 2 NT y + NT (w % 2) (K7W_WN
// column warps) and k8 steps w / 2, w / 2 + 2, ... of each window; the two
// row warps' sums are added in that order at the end.
//
// A block walks its rows in windows of K7W_ROWS, two in flight (the next
// one's cp.async copies overlap this one's products). A window stage holds
// ds[co][v], dy of window row v, K7W_DROW floats a channel (4 mod 8, so a
// fragment's lanes, g = channel and tig = row, hit 32 banks; the rows of
// channels co .. 16 MT - 1 are zero), then xs[c][phase][slot] for the 8 *
// groups input channels of the block's tiles (a.xrow floats a channel, 4
// mod 8), staged as fwd stages them: window row v = (sample n0 + nl,
// position o) reads tap j at slot v + halo * nl + j / s of phase j % s, a
// slot u holding position q = (u + o_first) % ql of sample n0 + (u +
// o_first) / ql, ql = to + halo. A thread stages one row v (dy) or slot u
// (x) for every channel, so each decode is shared by the channels. Rows
// past the chunk's end are zero in ds; their x slots are clamped to the
// window's last row. Launch bounds of one block an SM leave ptxas the
// registers the widest tiles need without spilling (at (128) alone it
// held some to 96 or 128 and spilled).
template <int MT, int NT>
__global__ void __launch_bounds__(K7F_WARPS * 32, 1) k7_dw_kernel(const K7Args a) {
  constexpr int WN = K7W_WN, WK = K7F_WARPS / K7W_WN;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wn = warp % WN, wk = warp / WN;  // column warp, row warp
  const int g = lane >> 2, tig = lane & 3;
  const int k = a.k, s = a.stride, to = a.to;
  const int halo = (k - 1) / s, ql = to + halo;
  const int phases = min(s, k);  // phases some tap reads
  const int b1 = min(a.batch, (blockIdx.x + 1) * a.chunk);
  const int r0 = blockIdx.x * a.chunk * to, r1 = b1 * to;  // the chunk's rows
  const int n8 = k * ((a.ci + 7) / 8);
  const int u0 = blockIdx.y * WN * NT, u_last = min(u0 + WN * NT, n8) - 1;
  const int c80 = u0 / k;  // the first channel group staged, and the channels staged
  const int cs = min(8 * (u_last / k - c80 + 1), a.ci - 8 * c80);
  const int ds_floats = MT * 16 * K7W_DROW;
  const int stage_floats = ds_floats + 8 * a.groups * a.xrow;
  // row v's sample in the window, (v + o_first) / to, as a product with
  // ceil(2^32 / to), exact while (v + o_first) * to < 2^32
  const unsigned long long to_inv = (0x100000000ull + to - 1) / to;

  // this thread's fragment columns: channel g of tile u0 + NT wn + ni
  // (tiles past n8 read the last one and are not stored), at phase j % s,
  // slot offset j / s
  int xcol[NT];
#pragma unroll
  for (int ni = 0; ni < NT; ++ni) {
    const int u = min(u0 + wn * NT + ni, n8 - 1), c8 = u / k, j = u - c8 * k;
    xcol[ni] = ds_floats + ((c8 - c80) * 8 + g) * a.xrow + (j % s) * a.slot_len + j / s;
  }
  // the dy rows of channels past co, in both stages, are zero for good
  for (int i = a.co * K7W_DROW + threadIdx.x; i < ds_floats; i += K7F_WARPS * 32) {
    smem[i] = 0.f;
    smem[stage_floats + i] = 0.f;
  }

  auto stage = [&](int win, float* buf) {
    const int w0 = r0 + win * K7W_ROWS, live = min(K7W_ROWS, r1 - w0);
    const int n0 = w0 / to, o_first = w0 - n0 * to;
    // dy: a window row v of every output channel a thread; rows past the
    // chunk (up to the last k8 step) zero-filled
    for (int v = threadIdx.x; v < ((live + 7) & ~7); v += K7F_WARPS * 32) {
      const int nl = (v + o_first) / to;
      const bool valid = v < live;
      const float* src = a.dy + ((size_t)(n0 + nl) * a.co * to + v + o_first - nl * to);
      for (int c = 0; c < a.co; ++c)
        cp_async4(buf + c * K7W_DROW + v, valid ? src + (size_t)c * to : a.dy, valid);
    }
    // x: the slots the window's rows read, of every staged channel and
    // phase; padding, channels past ci and samples past the chunk
    // zero-filled
    const int slots = live + halo * ((live - 1 + o_first) / to + 1);
    for (int u = threadIdx.x; u < slots; u += K7F_WARPS * 32) {
      const int nl = (u + o_first) / ql, q = u + o_first - nl * ql;
      const bool in_chunk = n0 + nl < b1;
      const float* src = a.x + (((size_t)(n0 + nl) * a.ci + 8 * c80) * a.t + q * s - a.lo);
      float* dst = buf + ds_floats + u;
      for (int ph = 0; ph < phases; ++ph) {
        const int tin = q * s + ph - a.lo;
        const bool valid = in_chunk && tin >= 0 && tin < a.t;
        for (int c = 0; c < 8 * a.groups; ++c) {
          const bool ok = valid && c < cs;
          cp_async4(dst + c * a.xrow + ph * a.slot_len, ok ? src + ph + (size_t)c * a.t : a.x,
                    ok);
        }
      }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  const int windows = (r1 - r0 + K7W_ROWS - 1) / K7W_ROWS;
  stage(0, smem);
  cp_async_commit();
  for (int win = 0; win < windows; ++win) {
    if (win + 1 < windows) stage(win + 1, smem + ((win + 1) & 1) * stage_floats);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* buf = smem + (win & 1) * stage_floats;
    const int w0 = r0 + win * K7W_ROWS, live = min(K7W_ROWS, r1 - w0);
    const int o_first = w0 % to;
    for (int st = wk; st * 8 < live; st += WK) {
      // B: the x slots of this thread's rows tig and tig + 4 (clamped to
      // the last live row: its dy is zero past it)
      uint32_t bhi[NT][2], blo[NT][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int v = min(st * 8 + tig + 4 * h, live - 1);
        const int slot = v + halo * (int)(((unsigned long long)(v + o_first) * to_inv) >> 32);
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) split_tf32_rn(buf[xcol[ni] + slot], bhi[ni][h], blo[ni][h]);
      }
      // A, one m16 tile at a time: channels 16 mi + g (+ 8), rows tig (+ 4)
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const float* ar = buf + (mi * 16 + g) * K7W_DROW + st * 8 + tig;
        uint32_t ahi[4], alo[4];
        split_tf32_rn(ar[0], ahi[0], alo[0]);
        split_tf32_rn(ar[8 * K7W_DROW], ahi[1], alo[1]);
        split_tf32_rn(ar[4], ahi[2], alo[2]);
        split_tf32_rn(ar[8 * K7W_DROW + 4], ahi[3], alo[3]);
        mma3_tf32<NT>(acc[mi], ahi, alo, bhi, blo);
      }
    }
    __syncthreads();  // the window is consumed before the next stage lands on it
  }
  cp_async_wait<0>();

  // the row warps' sums, added in order, to partial[x]: channel co = 16 mi
  // + lane / 4 (+ 8 for e >= 2) and column 8 c8 + 2 (lane % 4) (+ 1 for odd
  // e) of tile u0 + NT w + ni, for column warp w
  float* red = smem;
  const int per_warp = MT * NT * 128;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[warp * per_warp + ((mi * NT + ni) * 4 + e) * 32 + lane] = acc[mi][ni][e];
  __syncthreads();
  float* part = a.partial + (size_t)blockIdx.x * a.co * a.ci * k;
  for (int i = threadIdx.x; i < WN * per_warp; i += K7F_WARPS * 32) {
    const int w = i / per_warp, r = i - w * per_warp;  // column warp w's element r
    const int l = r & 31, e = (r >> 5) & 3, tile = r >> 7;
    const int mi = tile / NT, u = u0 + w * NT + tile - mi * NT;
    const int co = mi * 16 + (l >> 2) + 8 * (e >> 1);
    const int c8 = u / k, j = u - c8 * k, ci = c8 * 8 + 2 * (l & 3) + (e & 1);
    if (co >= a.co || u >= n8 || ci >= a.ci) continue;
    float sum = red[w * per_warp + r];
#pragma unroll
    for (int q = 1; q < WK; ++q) sum += red[(q * WN + w) * per_warp + r];
    part[((size_t)co * a.ci + ci) * k + j] = sum;
  }
}

// dw, second pass: out[i] = sum over chunks c = 0, 1, ... of partial[c][i].
__global__ void __launch_bounds__(256) k7_dw_reduce_kernel(const K7Args a) {
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

// The (MT, NT) tiles a dw warp may take (ops/kernels/tconv.py::_DW_MAX_NT):
// at most 8, 6, 5, 4, 3 n8 tiles beside 1-5 m16 tiles.
#define K7_DW_TILES(X)                                                                      \
  X(1, 1) X(1, 2) X(1, 3) X(1, 4) X(1, 5) X(1, 6) X(1, 7) X(1, 8) X(2, 1) X(2, 2) X(2, 3) \
  X(2, 4) X(2, 5) X(2, 6) X(3, 1) X(3, 2) X(3, 3) X(3, 4) X(3, 5) X(4, 1) X(4, 2) X(4, 3) \
  X(4, 4) X(5, 1) X(5, 2) X(5, 3)

// Both passes of dw, in order on the one stream; one chunk needs no
// second pass (its partial is out).
extern "C" int k7_dw(const K7Args* a, void* stream) {
  const int n8 = a->k * ((a->ci + 7) / 8);
  const dim3 grid(a->nchunks, (n8 + K7W_WN * a->nt - 1) / (K7W_WN * a->nt));
  const int threads = K7F_WARPS * 32;
  int rc = (int)cudaErrorInvalidValue;
  switch (a->mt * 16 + a->nt) {
#define K7_DW_CASE(MT, NT) \
  case MT * 16 + NT: rc = launch<k7_dw_kernel<MT, NT>>(grid, threads, a, stream); break;
    K7_DW_TILES(K7_DW_CASE)
#undef K7_DW_CASE
    default: break;
  }
  if (rc != 0 || a->nchunks == 1) return rc;
  const int n = a->co * a->ci * a->k;
  k7_dw_reduce_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int k7_args_size(void) { return (int)sizeof(K7Args); }

extern "C" const char* k7_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
