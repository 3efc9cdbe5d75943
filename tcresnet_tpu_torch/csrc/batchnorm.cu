// Batch norm in training mode with an optional ReLU after it, forward and
// backward: SlimBatchNorm's training branch (models/layers.py) as six
// kernels (ops/kernels/batchnorm.py launches them from one autograd Function).
//
// Replaces no TPU kernel: the JAX package leaves batch norm to Flax and XLA,
// which fuse its elementwise work into neighbouring loops. Eager PyTorch
// composes it op by op (means, a clipped variance, broadcasts, and autograd's
// sums of the broadcast gradients back into full maps), about 35 passes over
// the activations a layer; this file makes it 8.
//
// What bounds it on the H100: bytes. The least work reads x and writes y
// (forward), reads dy and x and writes dx (backward): 5 passes over the
// activations. DS-CNN L's 11 batch norms at batch 4096 see 1.017e9 floats a
// step, 4.07 GB a pass, so 20.3 GB or 6.07 ms at 3.35 TB/s.
//
// What the design does about it. Two passes a direction, each at the
// memory's pace, a small kernel between them, and nothing full-size saved
// but x:
//   bn_stats          grid (C, S): block (c, s) walks channel c over the s-th
//                     chunk of samples (runs of `inner` elements a plane
//                     apart) and writes Σx and Σx² of its elements. A
//                     channels-last tensor (what cuDNN returns to a 2D
//                     model) is [rows, C]: block (g, s) takes 32 channels
//                     of a chunk of rows, each warp reading 32 neighbouring
//                     channels of a row (`reduce`). 16 loads in flight a
//                     thread: with 4 the reads ran at a third of the
//                     bandwidth; a cap of 32 registers (8 blocks an SM)
//                     made the channels-last bn_grad_sums 1.8x slower.
//   bn_finalize       a warp a channel: the S partials summed in a fixed
//                     order (no atomics, so runs are bit-reproducible) into
//                     mean, rstd, the variance clip's tie factor and the
//                     count, and the running statistics updated. Summing S
//                     rows in every elementwise block instead cost each
//                     block a serial prologue as long as its stream.
//   bn_normalize      flat in memory order, 16-byte vectors where aligned,
//                     a resident wave of blocks striding over the tensor:
//                     y from a [3C] table of mean, rstd * scale and shift.
//   bn_grad_sums      the walk of bn_stats: Σg and Σg (x - mean), where
//                     g = dy masked by y > 0 (y recomputed from x, bit-equal
//                     to the forward's).
//   bn_grad_finalize  a warp a channel: dx = a g + b (x - mean) + c's b and
//                     c, and dscale, dshift from this process's sums.
//   bn_grad_input     flat, as bn_normalize: dx.
// Under a process group the host all-reduces the [S, 2C] sums (summed over
// S first) before each finalize: the global batch's moments, and their
// gradients summed back over the ranks.
//
// Numerics. Sums accumulate in float64, each thread adding batches of
// BN_UNROLL elements summed in float;
// the moments then follow Flax in float32: var = max(E[x²] - E[x]², 0),
// rstd = 1 / sqrt(var + eps), y = (x - mean) * mul + shift, each operation
// rounded once (__f*_rn, no FMA contraction), as the plain version computes
// them. The gradient of the clip is jnp.maximum's: 1 above 0, 1/2 at 0 (a
// channel of zeros), 0 below. Running statistics use the biased variance
// and Flax's momentum. x, y, dy and dx are float32 or bfloat16 each (the
// temporal K7 conv hands float32 to a bfloat16 batch norm).
//
// Indices are 32-bit: the wrapper refuses tensors of 2^31 elements or more.
//
// Build: ops/kernels/_build.py (nvcc, sm_90a, plain C entry points that
// launch on the given stream and return cudaGetLastError()).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define BN_THREADS 256
constexpr int BN_UNROLL = 16;  // loads in flight a thread in the reductions

struct BnArgs {
  const void* x;         // [B, C, inner] input, or channels-last [B, inner, C] (last)
  const void* dy;        // [B, C, inner] gradient of the output (backward)
  void* out;             // [B, C, inner] y (bn_normalize) or dx (bn_grad_input)
  const float* weight;   // [C] scale, or null
  const float* bias;     // [C] shift, or null
  float* running_mean;   // [C], updated in place by bn_normalize
  float* running_var;    // [C]
  double* partials;      // [chunks, 2C] this process's sums (bn_stats: the count after them)
  const double* sums;    // [sum_rows, 2C] the sums the finalize kernels read (forward: + count)
  float* stats;          // [3C + 1] mean, rstd, tie factor, count
  float* coef;           // [2C] the backward's b and c
  float* dweight;        // [C] or null
  float* dbias;          // [C] or null
  long long batch;
  int channels, inner, chunks, sum_rows, grid, vec, last, in_bf16, out_bf16, relu;
  float momentum, one_minus_momentum, eps;
};

// n / d for n < 2^31 by a multiply and a shift (Granlund and Montgomery's
// round-up method), d fixed for a launch.
struct FastDiv {
  unsigned int magic, shift;
};

static FastDiv make_fast_div(unsigned int d) {
  FastDiv f;
  if (d == 0) d = 1;  // an empty tensor: no element is divided
  unsigned int s = 0;
  while ((1ull << s) < d) ++s;
  f.shift = s;
  f.magic = (unsigned int)((((1ull << 32) * ((1ull << s) - d)) / d) + 1);
  return f;
}

__device__ __forceinline__ unsigned int fdiv(const FastDiv& f, unsigned int n) {
  return (__umulhi(n, f.magic) + n) >> f.shift;
}

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); }

template <typename T>
__device__ __forceinline__ T to(float v);
template <>
__device__ __forceinline__ float to<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 to<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void ld4(const float* p, float v[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void ld4(const __nv_bfloat16* p, float v[4]) {
  const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  v[0] = __low2float(lo); v[1] = __high2float(lo); v[2] = __low2float(hi); v[3] = __high2float(hi);
}

__device__ __forceinline__ void st4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void st4(__nv_bfloat16* p, const float v[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 t;
  t.x = *reinterpret_cast<unsigned int*>(&lo);
  t.y = *reinterpret_cast<unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(p) = t;
}

// y before the ReLU and the cast: each operation rounded once, as the plain
// version computes it; the backward recomputes it bit for bit for the mask.
__device__ __forceinline__ float affine(float x, float mean, float mul, float shift) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, mean), mul), shift);
}

// The channel of flat element i: (i / stride) % C.
__device__ __forceinline__ int channel_of(unsigned int i, const FastDiv& by_stride,
                                          const FastDiv& by_chan, int channels) {
  const unsigned int q = fdiv(by_stride, i);
  return (int)(q - fdiv(by_chan, q) * (unsigned int)channels);
}

// Sum (a, b) over the block; thread 0 holds the result.
__device__ __forceinline__ void block_sum2(double& a, double& b) {
  __shared__ double red[2][BN_THREADS / 32];
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, o);
    b += __shfl_down_sync(0xffffffffu, b, o);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red[0][warp] = a;
    red[1][warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < BN_THREADS / 32 ? red[0][lane] : 0.0;
    b = lane < BN_THREADS / 32 ? red[1][lane] : 0.0;
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, o);
      b += __shfl_down_sync(0xffffffffu, b, o);
    }
  }
}

// The reductions' partial sums of block row s: (Σ1, Σ2) of channel c.
__device__ __forceinline__ void store_partials(const BnArgs& a, int c, double s1, double s2) {
  a.partials[(long long)blockIdx.y * 2 * a.channels + c] = s1;
  a.partials[(long long)blockIdx.y * 2 * a.channels + a.channels + c] = s2;
}

// One reduction over this block's share of the grid: op.load(offset) reads
// an element, op.add(v, f1, f2) adds it to two float sums (a zero() element
// adds nothing); each thread adds a batch of BN_UNROLL elements in float,
// then the batch's sums to its float64 ones.
//   [B, C, inner] (LAST false): block (c, s) walks channel c of samples
//     [s * per, (s + 1) * per), j over (sample, position): element j lies
//     at (b0 + j / inner, c, j % inner); the block's threads sum together.
//   channels-last, [B * inner rows, C] (LAST true): block (g, s) sums
//     channels 32 g + lane over rows [s * per, (s + 1) * per), warp w
//     taking rows w, w + 8, ...: each warp reads 32 neighbouring channels
//     of a row; the warps' sums are added in order.
template <bool LAST, typename Op>
__device__ __forceinline__ void reduce(const BnArgs& a, const Op& op, int c, FastDiv by_inner) {
  double s1 = 0.0, s2 = 0.0;
  typename Op::V v[BN_UNROLL];
  if constexpr (!LAST) {
    const long long per = (a.batch + a.chunks - 1) / a.chunks;
    const long long b0 = (long long)blockIdx.y * per;
    const long long nb = min(per, a.batch - b0);
    const long long plane = (long long)a.channels * a.inner;
    const long long base = b0 * plane + (long long)c * a.inner;
    const unsigned int n = nb > 0 ? (unsigned int)(nb * a.inner) : 0u;
    for (unsigned int j0 = threadIdx.x; j0 < n; j0 += BN_THREADS * BN_UNROLL) {
#pragma unroll
      for (int u = 0; u < BN_UNROLL; ++u) {
        const unsigned int j = j0 + u * BN_THREADS, q = fdiv(by_inner, j);
        v[u] = j < n ? op.load(base + (long long)q * plane + (j - q * (unsigned int)a.inner))
                     : op.zero();
      }
      float f1 = 0.f, f2 = 0.f;
#pragma unroll
      for (int u = 0; u < BN_UNROLL; ++u) op.add(v[u], f1, f2);
      s1 += (double)f1;
      s2 += (double)f2;
    }
    block_sum2(s1, s2);
    if (threadIdx.x == 0) store_partials(a, c, s1, s2);
  } else {
    __shared__ double red[2][BN_THREADS / 32][32];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long rows = a.batch * a.inner, per = (rows + a.chunks - 1) / a.chunks;
    const long long r0 = (long long)blockIdx.y * per, r1 = min(rows, r0 + per);
    if (c < a.channels) {
      for (long long r = r0 + warp; r < r1; r += (BN_THREADS / 32) * BN_UNROLL) {
#pragma unroll
        for (int u = 0; u < BN_UNROLL; ++u) {
          const long long rr = r + u * (BN_THREADS / 32);
          v[u] = rr < r1 ? op.load(rr * a.channels + c) : op.zero();
        }
        float f1 = 0.f, f2 = 0.f;
#pragma unroll
        for (int u = 0; u < BN_UNROLL; ++u) op.add(v[u], f1, f2);
        s1 += (double)f1;
        s2 += (double)f2;
      }
    }
    red[0][warp][lane] = s1;
    red[1][warp][lane] = s2;
    __syncthreads();
    if (warp == 0 && c < a.channels) {
      s1 = s2 = 0.0;
      for (int w = 0; w < BN_THREADS / 32; ++w) {
        s1 += red[0][w][lane];
        s2 += red[1][w][lane];
      }
      store_partials(a, c, s1, s2);
    }
  }
}

// The channel this thread reduces: the block's (LAST false) or its lane's.
template <bool LAST>
__device__ __forceinline__ int reduce_channel() {
  return LAST ? blockIdx.x * 32 + (threadIdx.x & 31) : blockIdx.x;
}

// Σx and Σx².
template <typename TI>
struct StatsOp {
  struct V {
    float x;
  };
  const TI* x;
  __device__ V load(long long off) const { return {ld(x + off)}; }
  __device__ V zero() const { return {0.f}; }
  __device__ void add(const V& v, float& s1, float& s2) const {
    s1 += v.x;
    s2 = fmaf(v.x, v.x, s2);
  }
};

// Σg and Σg (x - mean) of one channel, g = dy masked by y > 0 under relu.
template <typename TI, typename TO>
struct GradOp {
  struct V {
    float x, g;
  };
  const TI* x;
  const TO* dy;
  float mean, mul, shift;
  int relu;
  __device__ V load(long long off) const { return {ld(x + off), ld(dy + off)}; }
  __device__ V zero() const { return {0.f, 0.f}; }
  __device__ void add(const V& v, float& s1, float& s2) const {
    float g = v.g;
    if (relu && !(as_float(to<TO>(affine(v.x, mean, mul, shift))) > 0.f)) g = 0.f;
    s1 += g;
    s2 = fmaf(g, __fsub_rn(v.x, mean), s2);
  }
};

template <typename TI, bool LAST>
__global__ void __launch_bounds__(BN_THREADS) bn_stats_kernel(const BnArgs a, FastDiv by_inner) {
  reduce<LAST>(a, StatsOp<TI>{static_cast<const TI*>(a.x)}, reduce_channel<LAST>(), by_inner);
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)
    a.partials[(long long)a.chunks * 2 * a.channels] = (double)a.batch * (double)a.inner;
}

// Sum column c (of `width`) over `rows` rows of a row-major [rows, width]
// table, a warp a column, lanes over rows, then a fixed shuffle tree;
// every lane holds the result.
__device__ __forceinline__ double warp_column_sum(const double* t, int rows, long long width,
                                                  long long c) {
  double s = 0.0;
  for (int r = threadIdx.x & 31; r < rows; r += 32) s += t[r * width + c];
#pragma unroll
  for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// The moments of channel c from the summed partials (a warp a channel):
// mean, rstd, the variance clip's tie factor and the count into `stats`, and
// the running statistics updated.
__global__ void __launch_bounds__(BN_THREADS) bn_finalize_kernel(const BnArgs a) {
  const int C = a.channels, c = blockIdx.x * (BN_THREADS / 32) + (threadIdx.x >> 5);
  if (c >= C) return;
  const double s1 = warp_column_sum(a.sums, a.sum_rows, 2 * C, c);
  const double s2 = warp_column_sum(a.sums, a.sum_rows, 2 * C, C + c);
  if ((threadIdx.x & 31) != 0) return;
  const double n = a.sums[(long long)a.sum_rows * 2 * C];
  const float mean = (float)(s1 / n), mean_sq = (float)(s2 / n);
  const float d = __fsub_rn(mean_sq, __fmul_rn(mean, mean));
  const float var = d < 0.f ? 0.f : d;  // torch.maximum(d, 0): NaN stays NaN
  a.stats[c] = mean;
  a.stats[C + c] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, a.eps)));
  a.stats[2 * C + c] = d > 0.f ? 1.f : (d == 0.f ? 0.5f : 0.f);
  if (c == 0) a.stats[3 * C] = (float)n;
  a.running_mean[c] = __fadd_rn(__fmul_rn(a.momentum, a.running_mean[c]),
                                __fmul_rn(a.one_minus_momentum, mean));
  a.running_var[c] = __fadd_rn(__fmul_rn(a.momentum, a.running_var[c]),
                               __fmul_rn(a.one_minus_momentum, var));
}

// mean, mul = rstd [* scale] and shift of every channel into shared memory.
__device__ __forceinline__ void affine_table(const BnArgs& a, float* tab) {
  const int C = a.channels;
  for (int c = threadIdx.x; c < C; c += BN_THREADS) {
    const float rstd = a.stats[C + c];
    tab[c] = a.stats[c];
    tab[C + c] = a.weight ? __fmul_rn(rstd, a.weight[c]) : rstd;
    tab[2 * C + c] = a.bias ? a.bias[c] : 0.f;
  }
  __syncthreads();
}

template <typename TI, typename TO>
__global__ void __launch_bounds__(BN_THREADS)
    bn_normalize_kernel(const BnArgs a, FastDiv by_stride, FastDiv by_chan) {
  extern __shared__ float tab[];  // mean[C], mul[C], shift[C]
  const int C = a.channels;
  affine_table(a, tab);
  const TI* x = static_cast<const TI*>(a.x);
  TO* y = static_cast<TO*>(a.out);
  const unsigned int total = (unsigned int)(a.batch * C * a.inner);
  const unsigned int step = gridDim.x * BN_THREADS;
  auto one = [&](float v, unsigned int i) {
    const int c = channel_of(i, by_stride, by_chan, C);
    float r = affine(v, tab[c], tab[C + c], tab[2 * C + c]);
    if (a.relu && r < 0.f) r = 0.f;
    return r;
  };
  if (a.vec) {
    for (unsigned int i = (blockIdx.x * BN_THREADS + threadIdx.x) * 4; i < total; i += step * 4) {
      float v[4];
      ld4(x + i, v);
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = one(v[u], i + u);
      st4(y + i, v);
    }
  } else {
    for (unsigned int i = blockIdx.x * BN_THREADS + threadIdx.x; i < total; i += step)
      y[i] = to<TO>(one(ld(x + i), i));
  }
}

template <typename TI, typename TO, bool LAST>
__global__ void __launch_bounds__(BN_THREADS)
    bn_grad_sums_kernel(const BnArgs a, FastDiv by_inner) {
  const int C = a.channels, c = reduce_channel<LAST>(), k = min(c, C - 1);
  const float rstd = a.stats[C + k];
  GradOp<TI, TO> op{static_cast<const TI*>(a.x), static_cast<const TO*>(a.dy), a.stats[k],
                    a.weight ? __fmul_rn(rstd, a.weight[k]) : rstd, a.bias ? a.bias[k] : 0.f,
                    a.relu};
  reduce<LAST>(a, op, c, by_inner);
}

// The coefficients of channel c's dx = a g + b (x - mean) + c from the
// summed partials (a warp a channel), and dscale, dshift from this
// process's own partials.
__global__ void __launch_bounds__(BN_THREADS) bn_grad_finalize_kernel(const BnArgs a) {
  const int C = a.channels, c = blockIdx.x * (BN_THREADS / 32) + (threadIdx.x >> 5);
  if (c >= C) return;
  const double sg = warp_column_sum(a.sums, a.sum_rows, 2 * C, c);
  const double sx = warp_column_sum(a.sums, a.sum_rows, 2 * C, C + c);
  double lg = sg, lx = sx;
  if (a.sums != a.partials) {
    lg = warp_column_sum(a.partials, a.chunks, 2 * C, c);
    lx = warp_column_sum(a.partials, a.chunks, 2 * C, C + c);
  }
  if ((threadIdx.x & 31) != 0) return;
  const double n = a.stats[3 * C];
  const float rstd = a.stats[C + c], tie = a.stats[2 * C + c];
  const float mul = a.weight ? __fmul_rn(rstd, a.weight[c]) : rstd;
  const double r = rstd, dvar = -0.5 * r * r * r * sx * (a.weight ? (double)a.weight[c] : 1.0);
  a.coef[c] = (float)(2.0 * tie * dvar / n);
  a.coef[C + c] = (float)(-(double)mul * sg / n);
  if (a.dweight) a.dweight[c] = (float)(r * lx);
  if (a.dbias) a.dbias[c] = (float)lg;
}

template <typename TI, typename TO>
__global__ void __launch_bounds__(BN_THREADS)
    bn_grad_input_kernel(const BnArgs a, FastDiv by_stride, FastDiv by_chan) {
  extern __shared__ float tab[];  // mean[C], mul[C] (a), shift[C], b[C], c[C]
  const int C = a.channels;
  for (int c = threadIdx.x; c < C; c += BN_THREADS) {
    tab[3 * C + c] = a.coef[c];
    tab[4 * C + c] = a.coef[C + c];
  }
  affine_table(a, tab);
  const TI* x = static_cast<const TI*>(a.x);
  const TO* dy = static_cast<const TO*>(a.dy);
  TI* dx = static_cast<TI*>(a.out);
  const unsigned int total = (unsigned int)(a.batch * C * a.inner);
  const unsigned int step = gridDim.x * BN_THREADS;
  auto one = [&](float xv, float g, unsigned int i) {
    const int c = channel_of(i, by_stride, by_chan, C);
    const float mean = tab[c], mul = tab[C + c], xc = __fsub_rn(xv, mean);
    if (a.relu && !(as_float(to<TO>(affine(xv, mean, mul, tab[2 * C + c]))) > 0.f)) g = 0.f;
    return fmaf(mul, g, fmaf(tab[3 * C + c], xc, tab[4 * C + c]));
  };
  if (a.vec) {
    for (unsigned int i = (blockIdx.x * BN_THREADS + threadIdx.x) * 4; i < total; i += step * 4) {
      float xv[4], g[4];
      ld4(x + i, xv);
      ld4(dy + i, g);
#pragma unroll
      for (int u = 0; u < 4; ++u) xv[u] = one(xv[u], g[u], i + u);
      st4(dx + i, xv);
    }
  } else {
    for (unsigned int i = blockIdx.x * BN_THREADS + threadIdx.x; i < total; i += step)
      dx[i] = to<TI>(one(ld(x + i), ld(dy + i), i));
  }
}

// ---------------------------------------------------------------------------
// entry points
// ---------------------------------------------------------------------------

// The reductions' grid: a block a channel, or (LAST) a block 32 channels.
static dim3 reduce_grid(const BnArgs* a) {
  return dim3(a->last ? (a->channels + 31) / 32 : a->channels, a->chunks);
}

// The elementwise kernels' divisors: flat element i has channel
// (i / stride) % C, stride inner ([B, C, inner]) or 1 (channels-last).
static FastDiv by_stride(const BnArgs* a) { return make_fast_div(a->last ? 1u : a->inner); }

template <typename TI, typename TO>
static void normalize(const BnArgs* a, cudaStream_t s) {
  bn_normalize_kernel<TI, TO><<<a->grid, BN_THREADS, 3 * a->channels * sizeof(float), s>>>(
      *a, by_stride(a), make_fast_div(a->channels));
}

template <typename TI, typename TO>
static void grad_sums(const BnArgs* a, cudaStream_t s) {
  if (a->last)
    bn_grad_sums_kernel<TI, TO, true><<<reduce_grid(a), BN_THREADS, 0, s>>>(*a, make_fast_div(1));
  else
    bn_grad_sums_kernel<TI, TO, false><<<reduce_grid(a), BN_THREADS, 0, s>>>(
        *a, make_fast_div(a->inner));
}

template <typename TI, typename TO>
static void grad_input(const BnArgs* a, cudaStream_t s) {
  bn_grad_input_kernel<TI, TO><<<a->grid, BN_THREADS, 5 * a->channels * sizeof(float), s>>>(
      *a, by_stride(a), make_fast_div(a->channels));
}

template <typename TI>
static void stats(const BnArgs* a, cudaStream_t s) {
  if (a->last)
    bn_stats_kernel<TI, true><<<reduce_grid(a), BN_THREADS, 0, s>>>(*a, make_fast_div(1));
  else
    bn_stats_kernel<TI, false><<<reduce_grid(a), BN_THREADS, 0, s>>>(*a, make_fast_div(a->inner));
}

// One of the four (input, output) type pairs of F.
#define BN_DISPATCH(F, a, s)                                                   \
  do {                                                                         \
    if ((a)->in_bf16 && (a)->out_bf16) F<__nv_bfloat16, __nv_bfloat16>(a, s); \
    else if ((a)->in_bf16) F<__nv_bfloat16, float>(a, s);                      \
    else if ((a)->out_bf16) F<float, __nv_bfloat16>(a, s);                     \
    else F<float, float>(a, s);                                                \
  } while (0)

extern "C" int bn_stats(const BnArgs* a, void* stream) {
  if (a->in_bf16) stats<__nv_bfloat16>(a, (cudaStream_t)stream);
  else stats<float>(a, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// The finalize kernels' grid: a warp a channel.
static int finalize_blocks(const BnArgs* a) {
  return (a->channels + BN_THREADS / 32 - 1) / (BN_THREADS / 32);
}

extern "C" int bn_finalize(const BnArgs* a, void* stream) {
  bn_finalize_kernel<<<finalize_blocks(a), BN_THREADS, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int bn_grad_finalize(const BnArgs* a, void* stream) {
  bn_grad_finalize_kernel<<<finalize_blocks(a), BN_THREADS, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int bn_normalize(const BnArgs* a, void* stream) {
  BN_DISPATCH(normalize, a, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

extern "C" int bn_grad_sums(const BnArgs* a, void* stream) {
  BN_DISPATCH(grad_sums, a, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

extern "C" int bn_grad_input(const BnArgs* a, void* stream) {
  BN_DISPATCH(grad_input, a, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

extern "C" int bn_args_size(void) { return (int)sizeof(BnArgs); }

extern "C" const char* bn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
