// Depthwise 3x3 convolution in training, forward and backward, with the
// TF-SAME pad and the bias done inside the kernels: the conv of every DS-CNN
// separable block (models/layers.py::Conv2d routes it here through
// ops/kernels/dwconv.py's autograd Function).
//
// Replaces no TPU kernel: the JAX package leaves these convs to XLA
// (`feature_group_count`). Eager PyTorch copies each input through F.pad,
// runs cuDNN's depthwise fprop, adds the bias as its own kernel, and in the
// backward runs cuDNN's dgrad and wgrad, autograd's bias sum and the pad's
// slice: about five kernels a conv, and four times the bytes the conv needs.
//
// What bounds it on the H100: bytes. The least work reads x and writes y
// (forward), reads x and dy and writes dx (backward); a 3x3 tap is 2 FLOPs
// against 4-8 bytes moved. DS-CNN L's five depthwise convs at batch 4096
// move 9.86 GB a step that way, 2.94 ms at 3.35 TB/s.
//
// What the design does about it. Activations are channels-last [B, H, W, C]
// (what the card's 2D convs and batch norm hand on). A block owns a slice of
// `slice` channels and a chunk of the batch, and walks the chunk a group of
// samples at a time: it stages the group's whole maps for its slice in
// shared memory (cp.async, 4 channels a copy: 16 bytes in float32, 8 in
// bfloat16), two stages deep, so the next group's copy is in flight while
// this one is computed. DS-CNN's maps are small (25x10, 13x5), so a block
// holds whole maps and needs no halo from another block; the pad is read in
// place as zero taps outside the map, with same_padding_2d's low pad (top,
// left) and whatever the output size leaves on the high side.
//   dw_forward   y = bias + sum of the 9 taps, each thread a 4-channel
//                vector and a band of rows of an output column of a sample
//                at a time, walking down the band with the 3x3 window in
//                registers (stride 1: one new row of 3 taps an output;
//                stride 2: two). Bands give a block more threads than the
//                map has columns; the wrapper's plan cuts them where that
//                measured faster (the stride-2 backward).
//   dw_backward  the group's x and dy staged together; dx by the transposed
//                stencil (a thread a band of an input column: stride 1 slides
//                the dy window; stride 2 walks dy rows, each giving two input
//                rows and a carry into the next), then dW and db as the
//                forward walks: dy times the x window, summed in registers
//                over the whole chunk; at the end the block sums
//                its threads' rows in a fixed order and writes one
//                [10, slice] row of partial sums (9 taps, the bias).
//   dw_finalize  a warp a (tap, channel) column: the chunks' partial rows in
//                a fixed order (no atomics, so dW and db are the same bits
//                from call to call), in float64, into dW [C, 1, 3, 3] and db.
// Three launches a forward and backward, where the composition takes about
// ten; the grid is one resident wave (the wrapper asks the occupancy API).
//
// Numerics. Products and sums in float32 (fmaf), x, dy, w and the bias read
// in their dtype (float32 or bfloat16) and y, dx, dW and db rounded to it
// once. Channels past C in the last slice are staged as zeros and never
// stored. Without 4-channel alignment (C % 4 != 0, or a pointer off 16
// bytes) the staging loads element by element.
//
// Build: ops/kernels/_build.py (nvcc, sm_90a, plain C entry points that
// launch on the given stream and return cudaGetLastError()).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "async_mma.cuh"

#define DW_MAX_THREADS 256
constexpr int DW_MAX_SMEM = 227 * 1024;  // an H100 block's dynamic shared memory
constexpr int DW_TERMS = 10;             // 9 taps and the bias

struct DwArgs {
  const void* x;       // [B, H, W, C] input
  const void* weight;  // [C, 1, 3, 3]
  const void* bias;    // [C], or null
  const void* dy;      // [B, OH, OW, C] gradient of y (backward)
  void* out;           // y [B, OH, OW, C] (forward) or dx [B, H, W, C] (backward)
  float* partials;     // [chunks, 10, C] the backward's per-block sums
  void* dweight;       // [C, 1, 3, 3] (finalize)
  void* dbias;         // [C] or null (finalize)
  long long batch;
  int channels, height, width, out_height, out_width, stride_h, stride_w, pad_top, pad_left;
  int slice;      // channels a block stages, a multiple of 4
  int group;      // samples a stage holds
  int rows;       // thread rows: a block is slice / 4 * rows threads
  int band;       // output rows a work item of the forward and of dW takes
  int in_band;    // rows a work item of dx takes: input rows, dy rows at stride 2
  int chunks;     // blocks along the batch
  int per_chunk;  // sample groups a block walks, in order
  int smem;       // dynamic shared memory bytes
  int vec, bf16, want_dx;
};

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

__device__ __forceinline__ float4 fma4(float4 a, float4 b, float4 c) {
  return make_float4(fmaf(a.x, b.x, c.x), fmaf(a.y, b.y, c.y), fmaf(a.z, b.z, c.z),
                     fmaf(a.w, b.w, c.w));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 4 channels from shared memory as floats
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 lds4(const __nv_bfloat16* p) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi));
}

// 4 channels to global memory: one vector where aligned, else the first
// `valid` channels one by one
__device__ __forceinline__ void st4(float* p, float4 v, bool vec, int valid) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
  for (int i = 0; i < 4 && i < valid; ++i) p[i] = e[i];
}

__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 v, bool vec, int valid) {
  if (vec) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 t;
    t.x = *reinterpret_cast<unsigned int*>(&lo);
    t.y = *reinterpret_cast<unsigned int*>(&hi);
    *reinterpret_cast<uint2*>(p) = t;
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
  for (int i = 0; i < 4 && i < valid; ++i) p[i] = __float2bfloat16_rn(e[i]);
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 8 : 0));
}

// 4 channels global -> shared: one cp.async (zero-filled past C), or, not
// aligned, `valid` loads and zeros after them
template <typename T>
__device__ __forceinline__ void copy4(T* s, const T* g, bool vec, int valid) {
  if (vec) {
    if constexpr (sizeof(T) == 4) cp_async16(s, g, valid > 0);
    else cp_async8(s, g, valid > 0);
    return;
  }
  for (int i = 0; i < 4; ++i) s[i] = i < valid ? g[i] : from_f<T>(0.f);
}

// The thread's place in a block: its 4-channel vector v of the slice and
// its row r (threads = slice / 4 * rows), which takes every rows-th work
// item of a pass.
struct Lane {
  int v, r, c, valid;  // c = first channel; valid = channels c.. below C (may be <= 0)
};

__device__ __forceinline__ Lane lane_of(const DwArgs& a) {
  Lane l;
  const int cv = a.slice >> 2;
  l.v = threadIdx.x % cv;
  l.r = threadIdx.x / cv;
  l.c = blockIdx.x * a.slice + 4 * l.v;
  l.valid = a.channels - l.c;
  return l;
}

// Stage `nb` samples from b0 of a [B, positions, C] tensor, the block's
// slice, into dst [nb, positions, slice]: row r of the threads takes
// positions r, r + rows, ...
template <typename T>
__device__ __forceinline__ void stage(const DwArgs& a, const Lane& l, const T* src, T* dst,
                                      long long b0, int nb, int positions) {
  const int C = a.channels;
  const T* base = src + b0 * positions * C + (l.valid > 0 ? l.c : 0);
  for (int p = l.r; p < nb * positions; p += a.rows)
    copy4(dst + p * a.slice + 4 * l.v, base + (long long)p * C, a.vec, l.valid);
}

// The slice's weights as floats, [9][slice], then its bias [slice] (zeros
// without one), for every block's threads to read 4 channels at once.
template <typename T>
__device__ __forceinline__ void stage_weights(const DwArgs& a, float* ws) {
  const T* w = static_cast<const T*>(a.weight);
  const T* b = static_cast<const T*>(a.bias);
  const int c0 = blockIdx.x * a.slice;
  for (int i = threadIdx.x; i < DW_TERMS * a.slice; i += blockDim.x) {
    const int k = i / a.slice, c = c0 + i - k * a.slice;
    float v = 0.f;
    if (c < a.channels) v = k < 9 ? to_f(w[c * 9 + k]) : (b ? to_f(b[c]) : 0.f);
    ws[i] = v;
  }
}

// One stage's sample range: groups of `group`, the last maybe short.
__device__ __forceinline__ int group_samples(const DwArgs& a, long long g) {
  return (int)min((long long)a.group, a.batch - g * a.group);
}

// The three taps of a row of a staged map along w for one output column:
// the map's columns iw[kw] where they lie inside it.
struct Cols {
  int at[3];
  bool ok[3];
};

__device__ __forceinline__ Cols out_cols(const DwArgs& a, int ow) {
  Cols k;
#pragma unroll
  for (int kw = 0; kw < 3; ++kw) {
    k.at[kw] = ow * a.stride_w - a.pad_left + kw;
    k.ok[kw] = k.at[kw] >= 0 && k.at[kw] < a.width;
  }
  return k;
}

// The 3 taps of map row ih (zeros outside the map) at columns `k`.
template <typename T>
__device__ __forceinline__ void map_row(const DwArgs& a, const T* map, int ih, const Cols& k,
                                        float4 (&dst)[3]) {
  const bool in = ih >= 0 && ih < a.height;
#pragma unroll
  for (int kw = 0; kw < 3; ++kw)
    dst[kw] = in && k.ok[kw] ? lds4(map + (ih * a.width + k.at[kw]) * a.slice) : zero4();
}

// Work item j of a pass over `cols` columns of a group's samples, each
// column cut into bands of `band` of its `n_rows` rows: the sample, the
// column and the rows [r0, r1). Neighbouring thread rows take neighbouring
// columns.
struct Item {
  int n, col, r0, r1;
};

__device__ __forceinline__ int items(int nb, int cols, int band, int n_rows) {
  return nb * cols * ((n_rows + band - 1) / band);
}

__device__ __forceinline__ Item item_of(int j, int cols, int band, int n_rows) {
  const int per_sample = cols * ((n_rows + band - 1) / band);
  Item it;
  it.n = j / per_sample;
  const int rem = j - it.n * per_sample, b = rem / cols;
  it.col = rem - b * cols;
  it.r0 = b * band;
  it.r1 = min(n_rows, it.r0 + band);
  return it;
}

// The 3x3 window of output row oh, slid down from row oh - 1's (stride 1:
// one new row; stride 2: two), or loaded whole at the band's first row.
template <typename T, int SH>
__device__ __forceinline__ void slide(const DwArgs& a, const T* map, int oh, int first,
                                      const Cols& k, float4 (&win)[3][3]) {
  const int top = oh * SH - a.pad_top;
  if (oh == first) {
    map_row(a, map, top, k, win[0]);
    map_row(a, map, top + 1, k, win[1]);
    map_row(a, map, top + 2, k, win[2]);
    return;
  }
  if constexpr (SH == 1) {
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) {
      win[0][kw] = win[1][kw];
      win[1][kw] = win[2][kw];
    }
  } else {
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) win[0][kw] = win[2][kw];
    map_row(a, map, top + 1, k, win[1]);
  }
  map_row(a, map, top + 2, k, win[2]);
}

// y of one staged group: thread row r takes work items r, r + rows, ...
// (an output column's band of rows) and walks each down its rows.
template <typename T, int SH>
__device__ __forceinline__ void forward_group(const DwArgs& a, const Lane& l, const T* tile,
                                              const float* ws, long long b0, int nb) {
  if (l.valid <= 0) return;
  const int OH = a.out_height, OW = a.out_width, C = a.channels;
  float4 w[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) w[k] = lds4(ws + k * a.slice + 4 * l.v);
  const float4 bias = lds4(ws + 9 * a.slice + 4 * l.v);
  T* y = static_cast<T*>(a.out);
  for (int j = l.r; j < items(nb, OW, a.band, OH); j += a.rows) {
    const Item it = item_of(j, OW, a.band, OH);
    const Cols k = out_cols(a, it.col);
    const T* map = tile + it.n * a.height * a.width * a.slice + 4 * l.v;
    T* out = y + ((b0 + it.n) * OH * OW + it.col) * (long long)C + l.c;
    float4 win[3][3];
    for (int oh = it.r0; oh < it.r1; ++oh) {
      slide<T, SH>(a, map, oh, it.r0, k, win);
      float4 acc = bias;
#pragma unroll
      for (int kh = 0; kh < 3; ++kh)
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) acc = fma4(win[kh][kw], w[kh * 3 + kw], acc);
      st4(out + (long long)oh * OW * C, acc, a.vec, l.valid);
    }
  }
}

// dx of one staged group: thread row r takes work items r, r + rows, ...
// (an input column's band of rows). Input (ih, iw) gathers dy (oh, ow) through tap (kh, kw) where
// oh * stride_h = ih + pad_top - kh and ow * stride_w = iw + pad_left - kw.
template <typename T, int SH>
__device__ __forceinline__ void dx_group(const DwArgs& a, const Lane& l, const T* dys,
                                         const float* ws, long long b0, int nb) {
  if (l.valid <= 0) return;
  const int H = a.height, W = a.width, OH = a.out_height, OW = a.out_width, C = a.channels;
  float4 w[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) w[k] = lds4(ws + k * a.slice + 4 * l.v);
  T* dx = static_cast<T*>(a.out);
  const int dx_rows = SH == 1 ? H : OH;  // the rows a dx band walks: input, or dy at stride 2
  for (int j = l.r; j < items(nb, W, a.in_band, dx_rows); j += a.rows) {
    const Item it = item_of(j, W, a.in_band, dx_rows);
    const int n = it.n, iw = it.col;
    int ow[3];
    bool okw[3];
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) {
      const int u = iw + a.pad_left - kw;
      ow[kw] = a.stride_w == 1 ? u : u >> 1;
      okw[kw] = u >= 0 && (a.stride_w == 1 || (u & 1) == 0) && ow[kw] < OW;
    }
    const T* map = dys + n * OH * OW * a.slice + 4 * l.v;
    auto dy_row = [&](int q, float4(&dst)[3]) {
      const bool in = q >= 0 && q < OH;
#pragma unroll
      for (int kw = 0; kw < 3; ++kw)
        dst[kw] = in && okw[kw] ? lds4(map + (q * OW + ow[kw]) * a.slice) : zero4();
    };
    T* out = dx + ((b0 + n) * H * W + iw) * (long long)C + l.c;
    if constexpr (SH == 1) {
      float4 win[3][3];  // win[i]: dy row ih + pad_top - 2 + i, read by tap kh = 2 - i
      dy_row(it.r0 + a.pad_top - 2, win[0]);
      dy_row(it.r0 + a.pad_top - 1, win[1]);
      dy_row(it.r0 + a.pad_top, win[2]);
      for (int ih = it.r0; ih < it.r1; ++ih) {
        if (ih > it.r0) {
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) {
            win[0][kw] = win[1][kw];
            win[1][kw] = win[2][kw];
          }
          dy_row(ih + a.pad_top, win[2]);
        }
        float4 acc = zero4();
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) acc = fma4(win[i][kw], w[(2 - i) * 3 + kw], acc);
        st4(out + (long long)ih * W * C, acc, a.vec, l.valid);
      }
    } else {
      // stride 2: dy row q reaches input rows 2q - pad_top + kh, so walking
      // the band's dy rows, row q's taps finish input row 2q - pad_top (kh =
      // 0, after row q - 1's kh = 2, carried) and give row 2q - pad_top + 1
      // (kh = 1) and the next carry (kh = 2): each dy row read once, no
      // branch on the parity. Under TF-SAME these rows cover the map.
      float4 taps[3], carry = zero4();
      if (it.r0 > 0) {
        dy_row(it.r0 - 1, taps);
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) carry = fma4(taps[kw], w[6 + kw], carry);
      }
      for (int q = it.r0; q < it.r1; ++q) {
        dy_row(q, taps);
        float4 even = carry, odd = zero4();
        carry = zero4();
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          even = fma4(taps[kw], w[kw], even);
          odd = fma4(taps[kw], w[3 + kw], odd);
          carry = fma4(taps[kw], w[6 + kw], carry);
        }
        const int ih = 2 * q - a.pad_top;
        if (ih >= 0 && ih < H) st4(out + (long long)ih * W * C, even, a.vec, l.valid);
        if (ih + 1 >= 0 && ih + 1 < H) st4(out + (long long)(ih + 1) * W * C, odd, a.vec, l.valid);
      }
    }
  }
}

// dW and db of one staged group, added to the thread's sums: the forward's
// walk, dy (oh, ow) times the x window.
template <typename T, int SH>
__device__ __forceinline__ void dw_group(const DwArgs& a, const Lane& l, const T* xs,
                                         const T* dys, int nb, float4 (&sum)[DW_TERMS]) {
  const int OH = a.out_height, OW = a.out_width;
  for (int j = l.r; j < items(nb, OW, a.band, OH); j += a.rows) {
    const Item it = item_of(j, OW, a.band, OH);
    const Cols k = out_cols(a, it.col);
    const T* map = xs + it.n * a.height * a.width * a.slice + 4 * l.v;
    const T* g = dys + (it.n * OH * OW + it.col) * a.slice + 4 * l.v;
    float4 win[3][3];
    for (int oh = it.r0; oh < it.r1; ++oh) {
      slide<T, SH>(a, map, oh, it.r0, k, win);
      const float4 d = lds4(g + oh * OW * a.slice);
#pragma unroll
      for (int kh = 0; kh < 3; ++kh)
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) sum[kh * 3 + kw] = fma4(d, win[kh][kw], sum[kh * 3 + kw]);
      sum[9] = add4(sum[9], d);
    }
  }
}

template <typename T, int SH>
__global__ void __launch_bounds__(DW_MAX_THREADS) dw_forward_kernel(const DwArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ws = reinterpret_cast<float*>(smem);  // [10][slice]
  T* buf = reinterpret_cast<T*>(ws + DW_TERMS * a.slice);
  const Lane l = lane_of(a);
  const int positions = a.height * a.width, stage_elems = a.group * positions * a.slice;
  const T* x = static_cast<const T*>(a.x);
  const long long groups = (a.batch + a.group - 1) / a.group;
  const long long g0 = (long long)blockIdx.y * a.per_chunk;
  const long long g1 = min(groups, g0 + a.per_chunk);
  stage_weights<T>(a, ws);
  if (g0 < g1) {
    stage(a, l, x, buf, g0 * a.group, group_samples(a, g0), positions);
    cp_async_commit();
  }
  for (long long g = g0; g < g1; ++g) {
    const int i = (int)(g - g0);
    if (g + 1 < g1) {
      stage(a, l, x, buf + ((i + 1) & 1) * stage_elems, (g + 1) * a.group,
            group_samples(a, g + 1), positions);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    forward_group<T, SH>(a, l, buf + (i & 1) * stage_elems, ws, g * a.group,
                         group_samples(a, g));
    __syncthreads();
  }
}

template <typename T, int SH>
__global__ void __launch_bounds__(DW_MAX_THREADS) dw_backward_kernel(const DwArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ws = reinterpret_cast<float*>(smem);  // [10][slice]
  T* buf = reinterpret_cast<T*>(ws + DW_TERMS * a.slice);
  const Lane l = lane_of(a);
  const int positions = a.height * a.width, out_positions = a.out_height * a.out_width;
  const int x_elems = a.group * positions * a.slice;
  const int stage_elems = x_elems + a.group * out_positions * a.slice;  // x, then dy
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  const long long groups = (a.batch + a.group - 1) / a.group;
  const long long g0 = (long long)blockIdx.y * a.per_chunk;
  const long long g1 = min(groups, g0 + a.per_chunk);
  auto stage_both = [&](long long g, T* dst) {
    stage(a, l, x, dst, g * a.group, group_samples(a, g), positions);
    stage(a, l, dy, dst + x_elems, g * a.group, group_samples(a, g), out_positions);
    cp_async_commit();
  };
  float4 sum[DW_TERMS];
#pragma unroll
  for (int k = 0; k < DW_TERMS; ++k) sum[k] = zero4();
  stage_weights<T>(a, ws);
  if (g0 < g1) stage_both(g0, buf);
  for (long long g = g0; g < g1; ++g) {
    const int i = (int)(g - g0);
    if (g + 1 < g1) {
      stage_both(g + 1, buf + ((i + 1) & 1) * stage_elems);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* tile = buf + (i & 1) * stage_elems;
    const int nb = group_samples(a, g);
    if (a.want_dx) dx_group<T, SH>(a, l, tile + x_elems, ws, g * a.group, nb);
    dw_group<T, SH>(a, l, tile, tile + x_elems, nb, sum);
    __syncthreads();
  }
  // the block's sums: each row's [10][slice] in shared memory (the stages
  // are free now), then the rows summed in order into partial row blockIdx.y
  float* red = reinterpret_cast<float*>(buf);
#pragma unroll
  for (int k = 0; k < DW_TERMS; ++k)
    *reinterpret_cast<float4*>(red + (l.r * DW_TERMS + k) * a.slice + 4 * l.v) = sum[k];
  __syncthreads();
  for (int i = threadIdx.x; i < DW_TERMS * a.slice; i += blockDim.x) {
    const int k = i / a.slice, cl = i - k * a.slice, c = blockIdx.x * a.slice + cl;
    if (c >= a.channels) continue;
    float s = 0.f;
    for (int r = 0; r < a.rows; ++r) s += red[(r * DW_TERMS + k) * a.slice + cl];
    a.partials[((long long)blockIdx.y * DW_TERMS + k) * a.channels + c] = s;
  }
}

// dW [C, 1, 3, 3] and db [C] from the chunks' partial rows: a warp a
// (term, channel) column, lanes over the rows, then a fixed shuffle tree.
template <typename T>
__global__ void __launch_bounds__(256) dw_finalize_kernel(const DwArgs a) {
  const int C = a.channels, col = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (col >= DW_TERMS * C) return;
  double s = 0.0;
  for (int r = lane; r < a.chunks; r += 32)
    s += (double)a.partials[(long long)r * DW_TERMS * C + col];
#pragma unroll
  for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane != 0) return;
  const int k = col / C, c = col - k * C;
  if (k < 9) static_cast<T*>(a.dweight)[c * 9 + k] = from_f<T>((float)s);
  else if (a.dbias) static_cast<T*>(a.dbias)[c] = from_f<T>((float)s);
}

// ---------------------------------------------------------------------------
// entry points
// ---------------------------------------------------------------------------

static dim3 grid_of(const DwArgs* a) {
  return dim3((a->channels + a->slice - 1) / a->slice, a->chunks);
}

static int threads_of(const DwArgs* a) { return a->slice / 4 * a->rows; }

// The kernel a launch takes: by direction, dtype and the stride along H.
template <typename T>
static const void* kernel_t(int backward, int stride_h) {
  if (backward)
    return stride_h == 1 ? (const void*)dw_backward_kernel<T, 1>
                         : (const void*)dw_backward_kernel<T, 2>;
  return stride_h == 1 ? (const void*)dw_forward_kernel<T, 1>
                       : (const void*)dw_forward_kernel<T, 2>;
}

static const void* kernel_of(const DwArgs* a, int backward) {
  return a->bf16 ? kernel_t<__nv_bfloat16>(backward, a->stride_h)
                 : kernel_t<float>(backward, a->stride_h);
}

static int launch(const DwArgs* a, int backward, cudaStream_t s) {
  const void* k = kernel_of(a, backward);
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, DW_MAX_SMEM);
  if (e != cudaSuccess) return (int)e;
  void* params[] = {(void*)a};
  e = cudaLaunchKernel(k, grid_of(a), dim3(threads_of(a)), params, (size_t)a->smem, s);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

extern "C" int dw_forward(const DwArgs* a, void* stream) {
  return launch(a, 0, (cudaStream_t)stream);
}

extern "C" int dw_backward(const DwArgs* a, void* stream) {
  return launch(a, 1, (cudaStream_t)stream);
}

extern "C" int dw_finalize(const DwArgs* a, void* stream) {
  const int blocks = (DW_TERMS * a->channels + 7) / 8;
  if (a->bf16) dw_finalize_kernel<__nv_bfloat16><<<blocks, 256, 0, (cudaStream_t)stream>>>(*a);
  else dw_finalize_kernel<float><<<blocks, 256, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

// Blocks of the forward (backward = 0) or backward kernel an SM holds at
// once with a's threads and shared memory (0 where it holds none).
extern "C" int dw_blocks_per_sm(const DwArgs* a, int backward) {
  const void* k = kernel_of(a, backward);
  if (cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, DW_MAX_SMEM) !=
      cudaSuccess)
    return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, threads_of(a), (size_t)a->smem) !=
      cudaSuccess)
    return 0;
  return n;
}

extern "C" int dw_args_size(void) { return (int)sizeof(DwArgs); }

extern "C" const char* dw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
