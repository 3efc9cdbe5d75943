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
// What bounds it on the H100: FP32 FMA issue and launch count. TC-ResNet's
// convs are 16-72 channels wide, narrower than one wgmma tile, and at batch
// 1536 a TCResNet8-1.0 step's activations (~10 MB) live in the 50 MB L2, so
// no pass is bound by HBM. Each pass is ~2.3 G multiply-adds per step.
//
// What the design does about it:
// - fwd and dx: a block stages a group of samples' input rows (zero-padded
//   for SAME in fwd) and a 16-channel slice of the weights in shared memory;
//   each thread accumulates 4 output channels at one time position in FP32
//   registers, one float4 weight read per input value.
// - dx reads dy as it is: per input position t it sums only the taps j with
//   t + lo - j divisible by the stride. The TPU kernel zero-stuffed dy by the
//   stride to stay within Mosaic's reshape rules; here no multiply-add
//   touches a stuffed zero.
// - dw is a reduction over B * To rows (150,528 for conv0 at batch 1536).
//   Blocks run in no order, so it uses no float atomics: each block sums a
//   fixed batch chunk into its own partial [Co, Ci * k] (4 x 4 outputs per
//   thread), and a second kernel adds the partials in chunk order. Two calls
//   give the same bits.
// - FP32 FMA throughout, no tensor cores: the TPU kernels ran in f32 too.
//
// How it differs from the TPU kernels: no batch tile or batch padding (the
// grid covers the batch exactly), no VMEM-resident dw carried across a
// sequential grid (partials and a fixed-order second pass instead), no
// zero-stuffed dy.
//
// Build: ops/kernels/_build.py (nvcc, sm_90a, plain C entry points that
// launch on the given stream and return cudaGetLastError()).

#include <cuda_runtime.h>

struct K7Args {
  const float* x;   // fwd, dw: [batch, ci, t]
  const float* w;   // fwd, dx: [co, ci, k]
  const float* dy;  // dx, dw: [batch, co, to]
  float* out;       // fwd: [batch, co, to]; dx: [batch, ci, t]; dw: [co, ci, k]
  float* partial;   // dw: [nchunks, co, ci * k] scratch
  int batch, ci, co, k, stride, t, to, lo;
  int nb;       // samples staged in shared memory at once
  int chunk;    // dw: samples summed into one partial
  int nchunks;  // dw: ceil(batch / chunk)
  int smem_bytes;
};

#define K7_THREADS 256
#define K7_CT 16  // output channels per block in fwd and dx

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

// fwd. grid (ceil(batch / nb), ceil(co / 16)); K = k when it is 1, 3 or 9
// (unrolled taps), else 0 and the taps come from a.k.
template <int K>
__global__ void __launch_bounds__(K7_THREADS) k7_fwd_kernel(const K7Args a) {
  extern __shared__ __align__(16) float smem[];
  const int k = K > 0 ? K : a.k;
  const int tp = (a.to - 1) * a.stride + k;  // padded input positions read
  const int kc = a.ci * k;
  const int co0 = blockIdx.y * K7_CT;
  const int b0 = blockIdx.x * a.nb;
  const int nb = min(a.nb, a.batch - b0);
  // ws[(ci * k + j) * 16 + c] = w[co0 + c, ci, j]; xs[n][ci][p] = x[b0 + n, ci, p - lo]
  const float4* ws = reinterpret_cast<const float4*>(smem);
  float* xs = smem + kc * K7_CT;
  for (int i = threadIdx.x; i < kc * K7_CT; i += blockDim.x) {
    const int c = i % K7_CT, m = i / K7_CT;
    smem[i] = co0 + c < a.co ? a.w[(size_t)(co0 + c) * kc + m] : 0.f;
  }
  const int rows = a.ci * tp;
  const float* x = a.x + (size_t)b0 * a.ci * a.t;
  for (int i = threadIdx.x; i < nb * rows; i += blockDim.x) {
    const int r = i / tp, p = i - r * tp - a.lo;  // r = n * ci + channel
    xs[i] = (p >= 0 && p < a.t) ? x[(size_t)r * a.t + p] : 0.f;
  }
  __syncthreads();
  const int groups = min(K7_CT, a.co - co0 + 3) / 4;
  const int tasks = groups * nb * a.to;
  for (int task = threadIdx.x; task < tasks; task += blockDim.x) {
    const int o = task % a.to;
    const int n = (task / a.to) % nb;
    const int g = task / (a.to * nb);
    const float* xr = xs + n * rows + o * a.stride;
    const float4* wr = ws + g;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = 0; c < a.ci; ++c) {
#pragma unroll
      for (int j = 0; j < k; ++j) fma4(acc, xr[c * tp + j], wr[(c * k + j) * (K7_CT / 4)]);
    }
    const int co = co0 + 4 * g;
    store4(a.out + ((size_t)(b0 + n) * a.co + co) * a.to + o, a.to, a.co - co, acc);
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

template <typename Kernel>
static int launch(Kernel kernel, dim3 grid, const K7Args* a, void* stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a->smem_bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, K7_THREADS, a->smem_bytes, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int k7_fwd(const K7Args* a, void* stream) {
  const dim3 grid((a->batch + a->nb - 1) / a->nb, (a->co + K7_CT - 1) / K7_CT);
  switch (a->k) {
    case 1: return launch(k7_fwd_kernel<1>, grid, a, stream);
    case 3: return launch(k7_fwd_kernel<3>, grid, a, stream);
    case 9: return launch(k7_fwd_kernel<9>, grid, a, stream);
    default: return launch(k7_fwd_kernel<0>, grid, a, stream);
  }
}

extern "C" int k7_dx(const K7Args* a, void* stream) {
  const dim3 grid((a->batch + a->nb - 1) / a->nb, (a->ci + K7_CT - 1) / K7_CT);
  switch (a->k) {
    case 1: return launch(k7_dx_kernel<1>, grid, a, stream);
    case 3: return launch(k7_dx_kernel<3>, grid, a, stream);
    case 9: return launch(k7_dx_kernel<9>, grid, a, stream);
    default: return launch(k7_dx_kernel<0>, grid, a, stream);
  }
}

// Both passes of dw, in order on the one stream.
extern "C" int k7_dw(const K7Args* a, void* stream) {
  const int tiles = ((a->co + 3) / 4) * ((a->ci * a->k + 3) / 4);
  const dim3 grid(a->nchunks, (tiles + K7_THREADS - 1) / K7_THREADS);
  const int rc = launch(k7_dw_partial_kernel, grid, a, stream);
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
