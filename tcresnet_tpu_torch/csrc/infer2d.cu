// Whole-model 2D inference on Hopper (K5): features -> logits in one launch.
//
// Replaces the TPU kernel tcresnet_tpu/ops/pallas/infer2d.py::_kernel2d,
// the op-list interpreter that serves the 2D families: TCResNet2D8[Pool],
// Res8/15[Narrow], DSCNN S/M/L and the seven Google-KWS baselines. The
// host (ops/kernels/infer2d.py) folds eval-mode BatchNorm into the convs,
// builds the JAX package's op list and lowers it to this kernel's program:
// a table of K5Op, one per step, with every shape computed on the host.
// The twelve op kinds of the TPU kernel arrive as:
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
// torch.empty); at small batch it stays in the 50 MB L2. And one block per
// utterance would leave Res15 at batch 1 on one SM of 132.
//
// What bounds it on the H100. The Res family is FP32 FMA work: Res15 is
// ~0.72 G multiply-adds per utterance once the taps that fall on the zero
// padding are skipped (its 3x3 convs dilate up to 16). DS-CNN and KWS are
// a few to ~40 M multiply-adds, so at batch 1 they are bound by latency:
// one grid-wide barrier per step and the serial chains of each step. No
// tensor cores in this version: FP32 FMA throughout, no TF32.
//
// What the design does about it:
//  - One cooperative launch whose grid is as large as can be co-resident
//    (occupancy x SMs). The grid walks the program; each step's work is
//    split into (utterance, output tile) items over all threads, and a
//    grid barrier (cooperative_groups grid.sync) separates the steps. So
//    batch 1 spreads over the whole card.
//  - A conv thread computes 4 output columns x 4 output channels (16
//    accumulators): one 16-byte weight load and 4 activation loads feed
//    16 FMAs. The weights' output-channel axis is zero-padded to a
//    multiple of 4 on the host, so the loads are aligned whatever Co is
//    (45, 19, 23, 186 ...); padding channels are never stored.
//  - gap and dense are two passes: warps sum fixed chunks (lanes over
//    channels for gap, over inputs with a shuffle reduction for dense),
//    then a thread per output adds the chunks in order. Deterministic, no
//    atomics, and a 32,000-input dense layer (KWS conv) is spread over
//    many warps instead of one thread per class.
//  - Activations are read with plain loads (not __ldg): another block
//    wrote them earlier in this launch, and the grid barrier orders them.
//    Weights and the op table are read-only for the launch and go through
//    the read-only path.
//
// Numerics: float32, products accumulated with fmaf in a fixed order (per
// tap, then per input channel), so repeated calls give the same bits;
// against the plain version (per-tap matmuls) only the order of float32
// sums differs.
//
// Build: ops/kernels/_build.py (nvcc, sm_90a, plain C entry point that
// launches on the given stream and returns cudaGetLastError()).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define K5_THREADS 256
#define K5_PF 4  // output columns per conv thread

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
};
#define K5_OP_FIELDS 28
static_assert(sizeof(K5Op) == K5_OP_FIELDS * sizeof(int), "K5Op holds ints only");

struct K5Args {
  const float* feats;  // [batch, T, F]
  float* out;          // [batch, ncls]
  const float* wts;    // the folded weights, by offset
  const int* ops;      // [n_ops, K5_OP_FIELDS]
  float* ws;           // [3, batch, slot_floats]
  float* partial;      // [batch, partial_floats]: first passes of gap and dense
  int batch, n_ops, in_floats, slot_floats, partial_floats, ncls;
};

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

// ---- conv: item = (utterance, output row, 4 output columns, 4 channels) ----
__device__ void k5_conv(const K5Args& a, const K5Op& op, long long gtid, long long nthr) {
  const int nq = op.c_pad >> 2;
  const int nfg = (op.f_out + K5_PF - 1) / K5_PF;
  const long long items = (long long)a.batch * op.t_out * nfg * nq;
  const int ci_w = op.mode == MODE_DW ? 1 : op.c_in;  // weight rows per tap
  const float* w = a.wts + op.w_off;
  const float* bias = a.wts + op.b_off;
  const float* aff = op.aff_off >= 0 ? a.wts + op.aff_off : nullptr;
  for (long long it = gtid; it < items; it += nthr) {
    const int q = (int)(it % nq);
    long long r = it / nq;
    const int f0 = (int)(r % nfg) * K5_PF;
    r /= nfg;
    const int to = (int)(r % op.t_out);
    const int b = (int)(r / op.t_out);
    const float* x = k5_src(a, op.src, b);
    float acc[K5_PF][4];
#pragma unroll
    for (int p = 0; p < K5_PF; ++p) {
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[p][k] = 0.f;
    }
    for (int i = 0; i < op.kh; ++i) {
      const int row = to * op.sh + i * op.dil - op.pad_t;
      if (row < 0 || row >= op.t_in) continue;  // a tap on the zero padding
      const float* xr = x + (size_t)row * op.f_in * op.c_in;
      for (int j = 0; j < op.kw; ++j) {
        int off[K5_PF];
#pragma unroll
        for (int p = 0; p < K5_PF; ++p) {
          const int col = (f0 + p) * op.sw + j * op.dil - op.pad_f;
          off[p] = (f0 + p < op.f_out && col >= 0 && col < op.f_in) ? col * op.c_in : -1;
        }
        const float4* wt =
            reinterpret_cast<const float4*>(w + (size_t)(i * op.kw + j) * ci_w * op.c_pad) + q;
        if (op.mode == MODE_DW) {
          // output channel o reads input channel o; c_pad = c_in rounded up
          const float4 wv = __ldg(wt);
          const int left = op.c_in - 4 * q;  // >= 1
#pragma unroll
          for (int p = 0; p < K5_PF; ++p) {
            if (off[p] >= 0) {
              const float* xp = xr + off[p] + 4 * q;
              acc[p][0] = fmaf(xp[0], wv.x, acc[p][0]);
              if (left > 1) acc[p][1] = fmaf(xp[1], wv.y, acc[p][1]);
              if (left > 2) acc[p][2] = fmaf(xp[2], wv.z, acc[p][2]);
              if (left > 3) acc[p][3] = fmaf(xp[3], wv.w, acc[p][3]);
            }
          }
        } else {  // full and c1: [Ci] x [Ci, 4] per output column
#pragma unroll 4
          for (int c = 0; c < op.c_in; ++c) {
            const float4 wv = __ldg(wt + (size_t)c * nq);
#pragma unroll
            for (int p = 0; p < K5_PF; ++p) {
              const float xv = off[p] >= 0 ? xr[off[p] + c] : 0.f;
              fma4(acc[p], xv, wv);
            }
          }
        }
      }
    }
    // epilogue, in the TPU kernel's order: bias, ReLU, + shortcut, ReLU, affine
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
          float v = acc[p][k] + __ldg(bias + o);
          if (op.relu) v = fmaxf(v, 0.f);
          if (res != nullptr) {
            v += res[(size_t)fo * op.c_out + o];
            if (op.relu2) v = fmaxf(v, 0.f);
          }
          if (aff != nullptr) v = v * __ldg(aff + o) + __ldg(aff + op.c_out + o);
          y[(size_t)fo * op.c_out + o] = v;
        }
      }
    }
  }
}

// ---- pool (VALID average) and maxpool (padding taps skipped = -inf) ----
__device__ void k5_pool(const K5Args& a, const K5Op& op, long long gtid, long long nthr) {
  const int C = op.c_in;
  const long long items = (long long)a.batch * op.t_out * op.f_out * C;
  const bool avg = op.kind == K5_POOL;
  for (long long it = gtid; it < items; it += nthr) {
    const int c = (int)(it % C);
    long long r = it / C;
    const int fo = (int)(r % op.f_out);
    r /= op.f_out;
    const int to = (int)(r % op.t_out);
    const int b = (int)(r / op.t_out);
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

// ---- second pass of gap and dense: out[b, u] = sum of the chunks, in order ----
__device__ void k5_finish(const K5Args& a, const K5Op& op, int width, long long gtid,
                          long long nthr) {
  const int U = op.c_out;
  const long long items = (long long)a.batch * U;
  const bool gap = op.kind == K5_GAP;
  for (long long it = gtid; it < items; it += nthr) {
    const int u = (int)(it % U);
    const int b = (int)(it / U);
    const float* part = a.partial + (size_t)b * a.partial_floats + u;
    float s = 0.f;
    for (int ch = 0; ch < op.n_chunks; ++ch) s += part[(size_t)ch * width];
    if (gap) {
      s /= (float)(op.t_in * op.f_in);
    } else {
      if (op.b_off >= 0) s += __ldg(a.wts + op.b_off + u);
      if (op.relu) s = fmaxf(s, 0.f);
    }
    k5_dst(a, op.dst, b)[u] = s;
  }
}

// ---- gap, first pass: a warp sums `chunk` positions, lanes over channels ----
__device__ void k5_gap_partial(const K5Args& a, const K5Op& op, long long gwarp,
                               long long nwarps, int lane) {
  const int C = op.c_in;
  const int P = op.t_in * op.f_in;
  const long long units = (long long)a.batch * op.n_chunks;
  for (long long u = gwarp; u < units; u += nwarps) {
    const int ch = (int)(u % op.n_chunks);
    const int b = (int)(u / op.n_chunks);
    const float* x = k5_src(a, op.src, b);
    const int p0 = ch * op.chunk;
    const int p1 = min(p0 + op.chunk, P);
    float* part = a.partial + (size_t)b * a.partial_floats + (size_t)ch * C;
    for (int c = lane; c < C; c += 32) {
      float s = 0.f;
      for (int p = p0; p < p1; ++p) s += x[(size_t)p * C + c];
      part[c] = s;
    }
  }
}

// ---- dense, first pass: a warp takes `chunk` inputs x 4 outputs ----
__device__ void k5_dense_partial(const K5Args& a, const K5Op& op, long long gwarp,
                                 long long nwarps, int lane) {
  const int K = op.c_in;
  const int nq = op.c_pad >> 2;
  const long long units = (long long)a.batch * op.n_chunks * nq;
  for (long long u = gwarp; u < units; u += nwarps) {  // warp-uniform
    const int q = (int)(u % nq);
    const long long r = u / nq;
    const int ch = (int)(r % op.n_chunks);
    const int b = (int)(r / op.n_chunks);
    const float* x = k5_src(a, op.src, b);
    const float4* w4 = reinterpret_cast<const float4*>(a.wts + op.w_off) + q;
    const int k0 = ch * op.chunk;
    const int k1 = min(k0 + op.chunk, K);
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = k0 + lane; k < k1; k += 32) fma4(s, x[k], __ldg(w4 + (size_t)k * nq));
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i] += __shfl_xor_sync(0xffffffffu, s[i], d);
    }
    if (lane == 0) {
      float* part = a.partial + (size_t)b * a.partial_floats + (size_t)ch * op.c_pad + 4 * q;
#pragma unroll
      for (int i = 0; i < 4; ++i) part[i] = s[i];
    }
  }
}

// ---- tconv_full: x [T, F], w [kw, T, U]; item = (utterance, fo, 4 units) ----
__device__ void k5_tconv_full(const K5Args& a, const K5Op& op, long long gtid, long long nthr) {
  const int nq = op.c_pad >> 2;
  const long long items = (long long)a.batch * op.f_out * nq;
  for (long long it = gtid; it < items; it += nthr) {
    const int q = (int)(it % nq);
    const long long r = it / nq;
    const int fo = (int)(r % op.f_out);
    const int b = (int)(r / op.f_out);
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
__device__ void k5_svdf(const K5Args& a, const K5Op& op, long long gtid, long long nthr) {
  const int nq = op.c_pad >> 2;
  const long long items = (long long)a.batch * nq;
  for (long long it = gtid; it < items; it += nthr) {
    const int q = (int)(it % nq);
    const int b = (int)(it / nq);
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
  cg::grid_group grid = cg::this_grid();
  const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nthr = (long long)gridDim.x * blockDim.x;
  const long long gwarp = gtid >> 5;
  const long long nwarps = nthr >> 5;
  const int lane = threadIdx.x & 31;
  const K5Op* ops = reinterpret_cast<const K5Op*>(a.ops);
  for (int i = 0; i < a.n_ops; ++i) {
    const K5Op op = ops[i];
    switch (op.kind) {
      case K5_CONV:
        k5_conv(a, op, gtid, nthr);
        break;
      case K5_POOL:
      case K5_MAXPOOL:
        k5_pool(a, op, gtid, nthr);
        break;
      case K5_GAP:
        k5_gap_partial(a, op, gwarp, nwarps, lane);
        grid.sync();
        k5_finish(a, op, op.c_in, gtid, nthr);
        break;
      case K5_DENSE:
        k5_dense_partial(a, op, gwarp, nwarps, lane);
        grid.sync();
        k5_finish(a, op, op.c_pad, gtid, nthr);
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
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k5_kernel, K5_THREADS, 0);
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
                                                    dim3(K5_THREADS), params, 0,
                                                    (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The grid the next launch on the current device uses (for reports).
extern "C" int k5_grid_size(void) {
  int blocks = 0;
  return k5_grid_blocks(&blocks) == 0 ? blocks : -1;
}

extern "C" int k5_args_size(void) { return (int)sizeof(K5Args); }

extern "C" int k5_op_fields(void) { return (int)(sizeof(K5Op) / sizeof(int)); }

extern "C" const char* k5_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
