// Whole-model TC-ResNet inference on Hopper: wav -> logits in one launch.
//
// Replaces the TPU kernel tcresnet_tpu/ops/pallas/infer.py::_kernel (the
// fused wav -> MFCC -> 7..16 BN-folded temporal convs -> GAP -> fc
// program). It computes, per utterance:
//   1. the windowed real DFT of every frame (reim[f] = frame[f] @ W),
//   2. power (MFCC) or magnitude (log-mel), mel, log(mel + 1e-6), and the
//      DCT for MFCC,
//   3. the BN-folded TF-SAME k x 1 convs with their residual dataflow,
//   4. the global average pool and the fc.
//
// What bounds it on the H100. Per TCResNet8-1.0 utterance the DFT is
// ~24.7 M multiply-adds of ~28 M in total (mel 1.6 M, DCT 0.25 M, convs
// 1.5 M, fc 0.6 k), so the front end sets the kernel's time. Its bound is
// FP32 FMA throughput (no tensor cores in this first version), but on an
// H100 SXM at 700 W the front end took ~80% of the kernel's time at about
// a third of that peak (PERF.md). It is not L2 bandwidth: staging the
// DFT constant through shared memory, read once per block, made it
// slower. Latency that 8 warps per SM do not hide is the open suspect.
//
// What the design does about it.
//  - The TPU kernel kept everything in VMEM. A Hopper block has at most
//    227 KB of shared memory, and neither the hop-DFT constant (987 KB)
//    nor the hop-partial intermediate (617 KB per utterance) fits. So the
//    DFT constant stays in global memory, where it is L2-resident, and the
//    DFT runs directly on frames (frame[f] @ W[window, 2K]) - the same
//    math as the hop decomposition without a shifted-add buffer.
//  - Steps 1 and 2 are frontend.cuh's FP32 stage (K2 and K3, which
//    compute the same features, run on the tensor cores: dft_tc.cuh).
//  - The DFT is register-blocked: each thread owns 4 output columns x 14
//    frames (56 accumulators). Columns are interleaved (re_k, im_k,
//    re_k+1, im_k+1), so a thread turns its own accumulators into two
//    power bins with no exchange. Per 4 window samples a thread issues 4
//    16-byte loads of W, 14 16-byte shared loads of samples, and 224 FMAs.
//  - Each conv thread computes 4 output channels of one row: one float4
//    weight load feeds 4 independent FMA chains (channel counts are
//    multiples of 4; the wrapper checks).
//  - One block per utterance; the batch is the grid, so no batch padding
//    is needed. At batch 1 this uses one SM of 132: spreading one
//    utterance over SMs, and tensor cores for the DFT, are later work.
//  - Shared memory: region A holds the wav (later the log-mel, later the
//    three conv ping-pong / shortcut buffers), region B the power
//    spectrum (later the features), then the pooled vector. ~165 KB at
//    16 kHz / 1 s, so one block per SM.
//
// Numerics: float32 throughout, accumulated with fmaf in a fixed order;
// logf/sqrtf are the IEEE versions (built without --use_fast_math). With
// round_bf16 the samples are rounded to bf16 here and the DFT constant is
// passed already rounded, and products still accumulate in float32 (the
// JAX path's dsp_matmul_dtype="bfloat16").
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC  (ops/kernels/_build.py). The C entry
// point k4_infer launches on the given stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include "frontend.cuh"

#define K4_MAX_CONVS 32
#define K4_THREADS FE_THREADS

enum { ROLE_CONV0 = 0, ROLE_DOWN = 1, ROLE_BLOCK0 = 2, ROLE_BLOCK1 = 3 };

struct K4Conv {
  int k, stride, role, relu, ci, co, w_off, b_off;
};

struct K4Args {
  FeArgs fe;          // the shared front end (frontend.cuh)
  const float* wavs;  // [batch, n]
  float* out;         // [batch, ncls]
  const float* wts;   // folded conv weights [k*ci, co] and biases [co], by offset
  const float* fc;    // [c_last, ncls]
  int batch, n_convs, ncls, act_max, region_a, smem_bytes;
  K4Conv convs[K4_MAX_CONVS];
};

// At most one block fits an SM (shared memory), and saying so to the
// compiler (min blocks 1) gave 11% lower latency on the H100 (PERF.md).
__global__ void __launch_bounds__(K4_THREADS, 1) k4_kernel(const K4Args a) {
  extern __shared__ __align__(16) float smem[];
  float* reg_a = smem;
  float* reg_b = smem + a.region_a;
  float* pooled = reg_b + a.fe.frames * 2 * a.fe.ncg;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;

  // ---- 0. the utterance into shared memory ----
  const float* wav = a.wavs + (size_t)blockIdx.x * a.fe.n;
  for (int i = tid; i < a.fe.n; i += nthr) reg_a[i] = fe_sample(a.fe, wav[i]);
  __syncthreads();

  // ---- 1-3. front end: features [frames, C] in B ----
  fe_features(a.fe, reg_a, reg_b);
  const int n_feat = fe_width(a.fe);

  // ---- 4. conv stack (residual dataflow by role), buffers in A ----
  float* bufs[3] = {reg_a, reg_a + a.act_max, reg_a + 2 * a.act_max};
  const float* x = reg_b;
  const float* sc = nullptr;
  int t_len = a.fe.frames;
  int c_len = n_feat;
  for (int l = 0; l < a.n_convs; ++l) {
    const K4Conv cv = a.convs[l];
    if (cv.role == ROLE_BLOCK0 && sc == nullptr) sc = x;  // identity shortcut
    float* dst = bufs[0];
    for (int j = 0; j < 3; ++j) {
      if (bufs[j] != x && bufs[j] != sc) {
        dst = bufs[j];
        break;
      }
    }
    // TF-SAME: out rows ceil(T / stride), left pad total // 2
    const int to = (t_len + cv.stride - 1) / cv.stride;
    const int lo = max((to - 1) * cv.stride + cv.k - t_len, 0) / 2;
    const float* w = a.wts + cv.w_off;
    const float* bias = a.wts + cv.b_off;
    const int cq = cv.co / 4;  // 4 output channels per thread
    for (int item = tid; item < to * cq; item += nthr) {
      const int oq = item % cq;
      const int t = item / cq;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int j = 0; j < cv.k; ++j) {
        const int r = t * cv.stride + j - lo;
        if (r < 0 || r >= t_len) continue;  // zero padding
        const float* xr = x + r * cv.ci;
        const float4* wr = reinterpret_cast<const float4*>(w + (j * cv.ci) * cv.co) + oq;
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        for (int c = 0; c < cv.ci; ++c) {
          const float xv = xr[c];
          const float4 wv = __ldg(wr + c * cq);
          part[0] = fmaf(xv, wv.x, part[0]);
          part[1] = fmaf(xv, wv.y, part[1]);
          part[2] = fmaf(xv, wv.z, part[2]);
          part[3] = fmaf(xv, wv.w, part[3]);
        }
        // one partial per tap, as the per-tap matmuls sum them
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[q] += part[q];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int o = 4 * oq + q;
        float y = acc[q] + __ldg(bias + o);
        if (cv.role == ROLE_BLOCK1) {
          y = fmaxf(y + sc[t * cv.co + o], 0.f);  // no ReLU before the add
        } else if (cv.relu) {
          y = fmaxf(y, 0.f);
        }
        dst[t * cv.co + o] = y;
      }
    }
    __syncthreads();
    if (cv.role == ROLE_DOWN) {
      sc = dst;
    } else {
      x = dst;
      t_len = to;
      c_len = cv.co;
      if (cv.role == ROLE_BLOCK1) sc = nullptr;
    }
  }

  // ---- 5. global average pool + fc ----
  for (int c = tid; c < c_len; c += nthr) {
    float s = 0.f;
    for (int t = 0; t < t_len; ++t) s += x[t * c_len + c];
    pooled[c] = s / (float)t_len;
  }
  __syncthreads();
  for (int o = tid; o < a.ncls; o += nthr) {
    float s = 0.f;
    for (int c = 0; c < c_len; ++c) s = fmaf(pooled[c], __ldg(&a.fc[c * a.ncls + o]), s);
    a.out[(size_t)blockIdx.x * a.ncls + o] = s;
  }
}

// the shared-memory limit raised once per device and larger size (fe_launch)
extern "C" int k4_infer(const K4Args* args, void* stream) {
  return fe_launch<K4Args, k4_kernel>(args->batch, args->smem_bytes, *args, stream);
}

extern "C" int k4_args_size(void) { return (int)sizeof(K4Args); }

extern "C" const char* k4_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
