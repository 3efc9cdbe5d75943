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
// - dx: a block stages a group of samples' dy rows and a 16-channel slice of
//   the weights in shared memory; each thread accumulates 4 input channels at
//   one position in FP32 registers, one float4 weight read per dy value. It
//   reads dy as it is: per input position t it sums only the taps j with
//   t + lo - j divisible by the stride. The TPU kernel zero-stuffed dy by the
//   stride to stay within Mosaic's reshape rules; here no multiply-add
//   touches a stuffed zero.
// - dw is a reduction over B * To rows (150,528 for conv0 at batch 1536).
//   Blocks run in no order, so it uses no float atomics: each block sums a
//   fixed batch chunk into its own partial [Co, Ci * k] (4 x 4 outputs per
//   thread, FP32 FMA), and a second kernel adds the partials in chunk order.
//   Two calls give the same bits.
//
// How it differs from the TPU kernels: no batch tile or batch padding (the
// grid covers the batch exactly), no VMEM-resident dw carried across a
// sequential grid (partials and a fixed-order second pass instead), no
// zero-stuffed dy; fwd computes in 3xTF32 where the TPU kernel used f32
// matmuls.
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
  int nb;       // dx, dw: samples staged in shared memory at once
  int chunk;    // dw: samples summed into one partial
  int nchunks;  // dw: ceil(batch / chunk)
  int smem_bytes;
  // fwd: slots per sample in a staged row (to + (k - 1) / stride), slots of
  // one phase's row, floats between two channels' rows, channel steps of 8
  // per slice, n8 tiles of output channels per block
  int ql, slot_len, xrow, kslice, nt;
};

#define K7_THREADS 256
#define K7_CT 16  // input channels per dx block

#define K7F_WARPS 4
#define K7F_MT 2                            // m16 tiles per warp
#define K7F_ROWS (K7F_WARPS * K7F_MT * 16)  // output rows per fwd block

__device__ __forceinline__ void fma4(float4& acc, float v, float4 w) {
  acc.x = fmaf(v, w.x, acc.x);
  acc.y = fmaf(v, w.y, acc.y);
  acc.z = fmaf(v, w.z, acc.z);
  acc.w = fmaf(v, w.w, acc.w);
}

// Writes 4 consecutive channels (rows `stride` apart) of which `valid` exist.
__device__ __forceinline__ void store4(float* p, int stride, int valid, float4 v) {
  p[0] = v.x;
  if (valid > 1) p[stride] = v.y;
  if (valid > 2) p[2 * stride] = v.z;
  if (valid > 3) p[3 * stride] = v.w;
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

  // slot of (row, tap 0) for this thread's fragment rows g and g + 8 of its
  // two m16 tiles; rows past the end read the last row's slots
  int roff[K7F_MT][2];
#pragma unroll
  for (int mi = 0; mi < K7F_MT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = min(m0 + (warp * K7F_MT + mi) * 16 + h * 8 + g, rows - 1);
      const int n = m / a.to;
      roff[mi][h] = (n - n0) * a.ql + (m - n * a.to) - o_first;
    }

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
        const int toff = ph * a.slot_len + qo;
        uint32_t ahi[K7F_MT][4], alo[K7F_MT][4];
#pragma unroll
        for (int mi = 0; mi < K7F_MT; ++mi) {
          split_tf32_rn(xc[roff[mi][0] + toff], ahi[mi][0], alo[mi][0]);
          split_tf32_rn(xc[roff[mi][1] + toff], ahi[mi][1], alo[mi][1]);
          split_tf32_rn(xc[4 * a.xrow + roff[mi][0] + toff], ahi[mi][2], alo[mi][2]);
          split_tf32_rn(xc[4 * a.xrow + roff[mi][1] + toff], ahi[mi][3], alo[mi][3]);
        }
        uint32_t bhi[NT][2], blo[NT][2];
        const float2* wb = wfrag + (c8 * k + j) * NT * 32 + lane;
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) {
          const float2 b = wb[ni * 32];
          split_tf32_rn(b.x, bhi[ni][0], blo[ni][0]);
          split_tf32_rn(b.y, bhi[ni][1], blo[ni][1]);
        }
        // three passes of independent products, each tile's three from zero
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
        if (++ph == s) {
          ph = 0;
          ++qo;
        }
      }
    }
    __syncthreads();  // the slice is consumed before the next one lands
  }

  // c0, c1 at (row g, channels 2 tig, 2 tig + 1); c2, c3 at row g + 8
#pragma unroll
  for (int mi = 0; mi < K7F_MT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + (warp * K7F_MT + mi) * 16 + h * 8 + g;
      if (m >= rows) continue;
      const int n = m / a.to;
      float* yr = a.out + (size_t)n * a.co * a.to + (m - n * a.to);
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const int co = co0 + ni * 8 + 2 * tig;
        if (co < a.co) yr[(size_t)co * a.to] = acc[mi][ni][2 * h];
        if (co + 1 < a.co) yr[(size_t)(co + 1) * a.to] = acc[mi][ni][2 * h + 1];
      }
    }
}

// dx. grid (ceil(batch / nb), ceil(ci / 16)).
template <int K>
__global__ void __launch_bounds__(K7_THREADS) k7_dx_kernel(const K7Args a) {
  extern __shared__ __align__(16) float smem[];
  const int k = K > 0 ? K : a.k;
  const int kc = a.co * k;
  const int ci0 = blockIdx.y * K7_CT;
  const int b0 = blockIdx.x * a.nb;
  const int nb = min(a.nb, a.batch - b0);
  // ws[(co * k + j) * 16 + c] = w[co, ci0 + c, j]; ds[n][co][q] = dy[b0 + n, co, q]
  const float4* ws = reinterpret_cast<const float4*>(smem);
  float* ds = smem + kc * K7_CT;
  for (int i = threadIdx.x; i < kc * K7_CT; i += blockDim.x) {
    const int c = i % K7_CT, m = i / K7_CT;
    const int co = m / k, j = m - co * k;
    smem[i] = ci0 + c < a.ci ? a.w[((size_t)co * a.ci + ci0 + c) * k + j] : 0.f;
  }
  const int rows = a.co * a.to;
  const float* dy = a.dy + (size_t)b0 * rows;
  for (int i = threadIdx.x; i < nb * rows; i += blockDim.x) ds[i] = dy[i];
  __syncthreads();
  const int last = (a.to - 1) * a.stride;  // padded position of the last tap window
  const int groups = min(K7_CT, a.ci - ci0 + 3) / 4;
  const int tasks = groups * nb * a.t;
  for (int task = threadIdx.x; task < tasks; task += blockDim.x) {
    const int t = task % a.t;
    const int n = (task / a.t) % nb;
    const int g = task / (a.t * nb);
    const int p = t + a.lo;  // position in the padded input
    const int jmin = max(0, p - last);
    const int jmax = min(k - 1, p);
    const float* dr = ds + n * rows;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    // taps with p - j = q * stride, 0 <= q < to
    for (int j = jmin + (p - jmin) % a.stride; j <= jmax; j += a.stride) {
      const int q = (p - j) / a.stride;
      const float4* wr = ws + j * (K7_CT / 4) + g;
      for (int c = 0; c < a.co; ++c) fma4(acc, dr[c * a.to + q], wr[c * k * (K7_CT / 4)]);
    }
    const int ci = ci0 + 4 * g;
    store4(a.out + ((size_t)(b0 + n) * a.ci + ci) * a.t + t, a.t, a.ci - ci, acc);
  }
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
  const dim3 grid((a->batch + a->nb - 1) / a->nb, (a->ci + K7_CT - 1) / K7_CT);
  switch (a->k) {
    case 1: return launch<k7_dx_kernel<1>>(grid, K7_THREADS, a, stream);
    case 3: return launch<k7_dx_kernel<3>>(grid, K7_THREADS, a, stream);
    case 9: return launch<k7_dx_kernel<9>>(grid, K7_THREADS, a, stream);
    default: return launch<k7_dx_kernel<0>>(grid, K7_THREADS, a, stream);
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
