// The frames' stage at the host plan's 128-row tile (tc_wg_features): K2,
// K8, K3's hops and phases branches and K4's front end take it where the
// batch's frames fill every SM at least once and its plan fits a block
// (ops/kernels/mfcc.py::tc_tile_plan). The 64-row and 16-row products stay
// in dft_tc.cuh. It replaces the 128-row mma.sync product of dft_tc.cuh.
//
// What bounds it on the H100: the products, window x fft multiply-adds a
// frame at the tensor cores' float32-exact rate (3xTF32: three TF32
// products, 165 TFLOP/s of the 495), and the L2 reads of the split DFT
// constant that feed them (hi and lo, 1.97 MB a 128-row tile at 480/160).
// The mma.sync product it replaces ran at 24% of the first bound: its 8
// warps each split the same 128 rows of A into TF32 hi / lo, every block
// split the constant again, and mma.sync does not reach Hopper's rate.
//
// What the design does about it:
//  - The constant is split once, on the host (mfcc.py::tc_dft_split): its
//    TF32 hi and lo parts, each [32 K, 128 columns] slice transposed to
//    K-major (wgmma's tf32 operand) in the 128-byte swizzle, hi then lo.
//  - A producer warpgroup's thread streams them by TMA bulk copies into a
//    ring of v.stages 8 KB slots (a slice's part for half a unit), each
//    with a full and an empty mbarrier, as far ahead as the ring allows.
//  - Two consumer warpgroups take 64 rows each and run wgmma m64n64k8, A
//    from registers: each thread loads its fragment from the staged
//    samples in place (dft_tc.cuh's layout) and splits it once a half
//    unit, one thread an element (not once per warp); B, hi or lo, from the
//    ring. A unit's two halves run one after the other, each k8 step's
//    three products one wgmma group, the step before's sums added while
//    the next step's products run. No branch lies between a wgmma and its
//    wait: ptxas then waits for the wgmma (C7517) and the products
//    serialise (the slots are released by predicated arrives).
//  - Registers: ptxas holds a 384-thread block to 168 a thread (setmaxnreg
//    raised no limit it compiled to; with a unit's 64 sums and two steps'
//    products live it spilled 168-360 bytes). A half's 32 sums, two steps'
//    products (64), A's parts for two steps (16) and the mel's sums (32)
//    fit.
//  - The epilogue: a half's power to the [128, 65] tile, a unit's mel
//    summed over its runs in registers (at most WG_MAX_MEL bands), then log
//    and the DCT (tc_wg_tail: 8 independent chains a thread; dft_tc.cuh's
//    one chain a thread took a sixth of the kernel).
//  - One block a tile, one block an SM (its shared memory).
// Measured on the H100 (PERF.md): wgmma tf32 with A from registers, two
// warpgroups each waiting for every step, reached 487 TFLOP/s at N = 128
// and 411 at N = 64 alone; here the A loads and splits, the adds and the
// per-tile tail leave the product at about 40% of the 3xTF32 bound. The
// constant's L2 reads a frame stay those of a 128-row tile; a 2-block
// cluster with multicast would halve them.
//
// Numerics: the k8 step's order is dft_tc.cuh's: lo*hi (wgmma with
// scale-d 0: from zero), + hi*lo, + hi*hi, then a round-to-nearest add to
// the sums; both parts of each operand rounded to the nearest TF32 value
// (split_tf32_rn, and its host copy for the constant). An element's sum
// depends on its row's A, its column and the k order alone, and wgmma's
// in-product sums are mma.sync's (tests/test_torch_cuda.py): K3 equals
// K2(K1(x)), K2 equals K8, and a clip alone (a 16-row tile, mma.sync)
// equals its row of a large batch (wgmma), bit for bit.

#pragma once

#include "dft_tc.cuh"

#define WG_ROWS 128
#define WG_HALF (TC_BN / 2)        // columns of a half unit: one wgmma's N
#define WG_SLOT (TC_BK * WG_HALF)  // floats of a ring slot: a K slice's part of a half (8 KB)
#define WG_MAX_MEL 64              // mel bands the consumers sum in registers
#define WG_THREADS 384             // two consumer warpgroups, then the producer's
#define WG_CONSUMERS 256
#define WG_BANDS (WG_MAX_MEL / (WG_CONSUMERS / 32))  // a consumer warp's mel bands
#define WG_WAIT_CYCLES 4000000000ll  // an mbarrier wait this long is a lost phase: trap

__device__ __forceinline__ uint32_t wg_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void wg_bar() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(wg_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(wg_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// until the phase of parity `parity` has completed; a wait of seconds means
// a phase that never completes, and traps (the launch fails) rather than
// holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = wg_addr(bar);
  if (mbar_try(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(addr, parity)) {
    if (clock64() - t0 > WG_WAIT_CYCLES) __trap();
  }
}

// `bytes` from global to shared memory by TMA, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(wg_addr(dst)),
      "l"(src), "r"(bytes), "r"(wg_addr(bar))
      : "memory");
}

// a K-major [64 columns, 32 K] slot in the 128-byte swizzle: 8-row groups
// 1024 bytes apart; + 2 a k8 step (32 bytes)
__device__ __forceinline__ uint64_t wg_desc(const float* slot) {
  return (uint64_t)((wg_addr(slot) & 0x3ffff) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// d (+)= a b on the warpgroup: a the thread's [16 x 8] fragment of its
// warp's rows (mma.sync's m16n8k8 layout), b [8 K, 64 columns] from shared
// memory; scale_d 0 ignores d. d[4 j + 2 h + e] is row 16 warp + g + 8 h,
// column 8 j + 2 t + e (g = lane / 4, t = lane % 4)
__device__ __forceinline__ void wg_mma(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// one k8 step of a half unit's sums from zero: lo*hi, + hi*lo, + hi*hi,
// one wgmma group
__device__ __forceinline__ void wg_step(float (&d)[32], const uint32_t (&ahi)[4],
                                        const uint32_t (&alo)[4], uint64_t bhi, uint64_t blo) {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  wg_mma(d, alo, bhi, 0);
  wg_mma(d, ahi, blo, 1);
  wg_mma(d, ahi, bhi, 1);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// the accumulators' registers stay where the asm left them: nothing reads
// them before the wait that completes them, nor moves across it
// then acc += d, rounded to nearest
__device__ __forceinline__ void wg_add(float (&acc)[32], float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = __fadd_rn(acc[i], d[i]);
}

// mbarrier.arrive where `pred`, predicated: no branch between a wgmma and
// its wait (ptxas waits for the wgmma at a branch, C7517, serialising the
// products)
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(wg_addr(bar)),
      "r"((int)pred)
      : "memory");
}

// The tile's features into out [batch x frames, C] on the 128-row product.
// stage() runs on the consumers (threads 0-255) and writes the tile's
// samples to smem[0, region_a) (tc_stage's layout) or issues their
// cp.async copies, uncommitted.
// Shared memory (floats; ops/kernels/mfcc.py::tc_wg_plan mirrors it): the
// samples, the mel runs [units][num_mel][3] and nonzero weights, the power
// tile [128, 65] (the mel sums [num_mel, rows] at the end), then, 1024-byte
// aligned, v.stages ring slots and their full and empty barriers; the DCT
// reuses the ring. Launched on WG_THREADS threads, one block an SM.
// log(mel + 1e-6), then for MFCC the DCT, into out [rows, C], by the
// consumers; sums is band-major [num_mel][rows]. The arithmetic of
// dft_tc.cuh's tc_tail, each coefficient one fmaf chain over the bands in
// order from 0 (the same bits), with another thread mapping: an item is a
// row and 8 consecutive coefficients, 8 independent chains whose DCT
// weights are the warp's same two float4s (the DCT staged in `scratch`,
// its rows padded with zeros to a multiple of 8), not one chain a thread
// waiting on each load (that tail took a sixth of the kernel's time)
__device__ __forceinline__ void tc_wg_tail(const FeArgs& a, float* sums, float* scratch,
                                           float* out, int rows) {
  const int nm = a.num_mel, nc = a.num_coef;
  for (int i = threadIdx.x; i < rows * nm; i += WG_CONSUMERS) {
    const float lm = logf(sums[i] + 1e-6f);
    if (a.magnitude) {
      const int m = i / rows;
      out[(i - m * rows) * nm + m] = lm;
    } else {
      sums[i] = lm;
    }
  }
  if (a.magnitude) return;
  const int cp = (nc + 7) & ~7;  // the staged DCT's row stride
  for (int i = threadIdx.x; i < nm * cp; i += WG_CONSUMERS) {
    const int m = i / cp, c = i - m * cp;
    scratch[i] = c < nc ? a.dct[m * nc + c] : 0.f;
  }
  wg_bar();
  for (int item = threadIdx.x; item < cp / 8 * WG_ROWS; item += WG_CONSUMERS) {
    const int q = item / WG_ROWS, f = item - q * WG_ROWS;  // a warp's items share q
    if (f >= rows) continue;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const float4* w = reinterpret_cast<const float4*>(scratch + 8 * q);
    for (int m = 0; m < nm; ++m) {
      const float x = sums[m * rows + f];
      const float4 w0 = w[m * cp / 4], w1 = w[m * cp / 4 + 1];
      acc[0] = fmaf(x, w0.x, acc[0]);
      acc[1] = fmaf(x, w0.y, acc[1]);
      acc[2] = fmaf(x, w0.z, acc[2]);
      acc[3] = fmaf(x, w0.w, acc[3]);
      acc[4] = fmaf(x, w1.x, acc[4]);
      acc[5] = fmaf(x, w1.y, acc[5]);
      acc[6] = fmaf(x, w1.z, acc[6]);
      acc[7] = fmaf(x, w1.w, acc[7]);
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (8 * q + c < nc) out[f * nc + 8 * q + c] = acc[c];
    }
  }
}

template <class Stage>
__device__ __forceinline__ void tc_wg_features(const FeArgs& a, const FeVariant& v,
                                               const TcTile& tl, float* smem, int region_a,
                                               float* out, Stage&& stage) {
  const int nruns = v.units * a.num_mel * 3;
  int* runs = reinterpret_cast<int*>(smem + region_a);
  float* vals = reinterpret_cast<float*>(runs) + tc_up4(nruns);
  float* ptile = vals + tc_up4(v.mel_nnz);
  float* tail = ptile + tc_up4(WG_ROWS * TC_SP);
  float* ring = tail + ((1024u - (wg_addr(tail) & 1023u)) & 1023u) / 4;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + v.stages * WG_SLOT);
  uint64_t* empty = full + v.stages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < v.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, WG_CONSUMERS / 32);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= WG_CONSUMERS) {
    // the producer: slot use i is K slice i / 2's hi part (i even) or lo part
    if (threadIdx.x == WG_CONSUMERS) {
      // uses unit by unit, half by half, K slice by K slice, hi then lo;
      // the constant holds a slice's [128 columns, 32 K] part, half 0 first
      const int slices = a.window / a.hop * (v.stride - TC_PAD) / TC_BK;
      int st = 0, ph = 0, n = 0;
      for (int u = tl.u0; u < tl.u1; ++u) {
        for (int h = 0; h < 2; ++h) {
          for (int i = 0; i < 2 * slices; ++i, ++n) {
            if (n >= v.stages) mbar_wait(empty + st, ph ^ 1);  // the slot's last use released
            mbar_expect_tx(full + st, WG_SLOT * 4);
            bulk_load(ring + st * WG_SLOT,
                      v.wsplit + ((size_t)u * slices * 2 + i) * 2 * WG_SLOT + h * WG_SLOT,
                      WG_SLOT * 4, full + st);
            if (++st == v.stages) {
              st = 0;
              ph ^= 1;
            }
          }
        }
      }
    }
    return;
  }

  const int hs = v.stride - TC_PAD;      // K rows a chunk
  const int kp = a.window / a.hop * hs;  // K rows of a unit
  const int slices = kp / TC_BK;         // K slices of a unit
  stage();
  for (int i = threadIdx.x; i < nruns; i += WG_CONSUMERS) cp_async4(runs + i, v.runs + i, true);
  tc_copy(vals, a.mel, tc_up4(v.mel_nnz) / 4);
  cp_async_commit();
  cp_async_wait<0>();
  wg_bar();
  if (a.round_bf16) {  // the DFT's A operand (K3's samples are rounded already: the same bits)
    for (int i = threadIdx.x; i < region_a; i += WG_CONSUMERS) smem[i] = fe_bf16(smem[i]);
    wg_bar();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // where the fragment's rows warp 16 + g and + 8 read sample 0 of their
  // frames (+ t); rows past the tile read its last row's, dropped later
  int base[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int lr = min(warp * 16 + g + 8 * h, tl.nrows - 1);
    base[h] = lr * v.stride + ((tl.r0 + lr) / a.frames - tl.b0) * v.gap + t;
  }
  // A's fragment of K slice k0's k8 step kk (the slice lies in one chunk),
  // split into TF32 parts
  auto afrag = [&](const float* xs, int kk, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
    const float av[4] = {xs[base[0] + 8 * kk], xs[base[1] + 8 * kk], xs[base[0] + 8 * kk + 4],
                         xs[base[1] + 8 * kk + 4]};
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32_rn(av[e], hi[e], lo[e]);
  };
  // Each half unit (columns 0-63, then 64-127) runs its K slices on its
  // own: its sums (32 a thread), and two consecutive k8 steps' products,
  // each one wgmma group into p[0] or p[1], so that a step's sums are added
  // while the next step's products run. p[1] is zero where no step is in
  // flight (a half's first step), so that its add changes nothing.
  float acc[32], p[2][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = p[1][i] = 0.f;
  uint32_t ahi[2][4], alo[2][4];  // the two steps' A parts
  float mel[WG_BANDS][4];         // bands warp + 8 j, rows lane + 32 i
#pragma unroll
  for (int j = 0; j < WG_BANDS; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) mel[j][i] = 0.f;
  }
  int st = 0, ph = 0;  // the next slice's hi slot and its phase
  afrag(smem, 0, ahi[0], alo[0]);  // the first step's A
  for (int u = tl.u0; u < tl.u1; ++u) {
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      for (int s = 0; s < slices; ++s) {
        const int sl = st + 1 == v.stages ? 0 : st + 1;  // the lo part's slot
        const int pl = sl == 0 ? ph ^ 1 : ph;
        mbar_wait(full + st, ph);
        mbar_wait(full + sl, pl);
        const uint64_t dhi = wg_desc(ring + st * WG_SLOT), dlo = wg_desc(ring + sl * WG_SLOT);
        // the next slice's samples (the half's first at its end: the next
        // half's, or the next unit's, first step reads them)
        const int k0 = s * TC_BK, kn = s + 1 == slices ? 0 : k0 + TC_BK;
        const float* xs = smem + k0 + TC_PAD * (k0 / hs);  // a slice lies in one chunk
        const float* xn = smem + kn + TC_PAD * (kn / hs);
#pragma unroll
        for (int kk = 0; kk < TC_BK / 8; ++kk) {
          const int b = kk & 1;  // consecutive steps alternate buffers
          wg_step(p[b], ahi[b], alo[b], dhi + 2 * kk, dlo + 2 * kk);
          wg_wait<1>();  // the step before, and its A buffer, are done
          // the next step's A, loaded while the step before's sums are added
          if (kk + 1 < TC_BK / 8) {
            afrag(xs, kk + 1, ahi[b ^ 1], alo[b ^ 1]);
          } else {
            afrag(xn, 0, ahi[b ^ 1], alo[b ^ 1]);
          }
          wg_add(acc, p[b ^ 1]);
        }
        // this warp has read the slice before's slots (predicated, not
        // branched: a branch here would make ptxas wait for the wgmma)
        const int ps = st == 0 ? v.stages - 1 : st - 1;
        mbar_arrive_if(empty + (ps == 0 ? v.stages - 1 : ps - 1), lane == 0 && s > 0);
        mbar_arrive_if(empty + ps, lane == 0 && s > 0);
        st = sl + 1 == v.stages ? 0 : sl + 1;
        ph = st == 0 ? pl ^ 1 : pl;
      }
      wg_wait<0>();
      wg_add(acc, p[1]);
      const int ls = st == 0 ? v.stages - 1 : st - 1;  // the half's last slice's slots
      mbar_arrive_if(empty + (ls == 0 ? v.stages - 1 : ls - 1), lane == 0);
      mbar_arrive_if(empty + ls, lane == 0);

      // the half's power (magnitude) to the tile: acc[4 j + 2 e + c] is row
      // 16 warp + g + 8 e, pair 32 h + 4 j + t
      if (h == 0) wg_bar();  // the last unit's mel has read the tile
#pragma unroll
      for (int j = 0; j < WG_HALF / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = warp * 16 + g + 8 * e;
          const float re = acc[4 * j + 2 * e], im = acc[4 * j + 2 * e + 1];
          float pw = re * re + im * im;
          if (a.magnitude) pw = sqrtf(pw);
          if (row < tl.nrows) ptile[row * TC_SP + 32 * h + 4 * j + t] = pw;
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = p[1][i] = 0.f;
    }
    // the unit through the mel
    wg_bar();
    const int* ru = runs + u * a.num_mel * 3;
#pragma unroll
    for (int j = 0; j < WG_BANDS; ++j) {
      const int m = warp + 8 * j;
      if (m >= a.num_mel) continue;
      const int q0 = ru[3 * m], q1 = ru[3 * m + 1];
      const float* w = vals + ru[3 * m + 2] - q0;
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k = q0; k < q1; ++k) {
        const float wk = w[k];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int f = lane + 32 * i;
          if (f < tl.nrows) part[i] = fmaf(ptile[f * TC_SP + k], wk, part[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) mel[j][i] += part[i];
    }
  }

  // the sums band-major [num_mel, rows] over the power tile, then the tail
  wg_bar();
  float* sums = ptile;
#pragma unroll
  for (int j = 0; j < WG_BANDS; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = warp + 8 * j, f = lane + 32 * i;
      if (m < a.num_mel && f < tl.nrows) sums[m * tl.nrows + f] = mel[j][i];
    }
  }
  wg_bar();
  tc_wg_tail(a, sums, ring, out + (size_t)tl.r0 * fe_width(a), tl.nrows);  // the ring is free
}
