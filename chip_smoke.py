#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving and training paths on one CUDA card.

    python3 chip_smoke.py

Drives tcresnet_tpu_torch (never JAX) at full width (TCResNet8-1.0: 16
kHz, 1 s clips, MFCC-40, channels 16/24/32/48, 12 classes; the 2D
presets at theirs) with weights and data made from seeds, in phases that
print their lines:

  1. device   the card, as nvidia-smi reports its name and power limit
  2. build    every kernel source built with nvcc, one process each, all
              started together; the ptxas line of each K4 instantiation
              (csrc/infer.cu: K2's stage in its 16-, 64- and 128-row
              tiles, then the conv stack), none of which may spill
  3. kernel   K4 against its plain PyTorch version on the card (TF32 off),
              TCResNet8-1.0, TCResNet14-1.5, log-mel and the bf16 DFT x
              batch 1, 3, 8, 64, 256, 1024 (every tile size of K2's stage);
              two calls equal bit for bit, and one utterance's batch-1
              logits equal to its row of the 1024 batch bit for bit
  4. golden   K4's softmax against the JAX package's, stored in
              tcresnet_tpu_torch/testdata/tcresnet8_golden.npz
  5. serve    build_inference_fn(backend="auto"): 20 single-utterance
              requests (fused kernel) and one batch of 64 (plain path),
              checked against backend="xla", precision="highest"; the
              kernel's launch count shows the requests went through it
  6. times    kernel and plain path at batch 1 and 1024, host clock and
              CUDA events, beside the card's name and power limit; K4 and
              the `xla` model (wav -> softmax, TF32 off, as a CUDA graph) on
              one clock behind a device sleep at batch 1, 8, 32, 64, 256
              and 1024 (tcresnet_tpu_torch/tools/infer_times.py), K4's two
              paths forced beside (the conv stacks in the stage's blocks,
              and in a kernel of their own), the batch from which the
              graph is faster, K4's bound at each batch (the DFT at the
              3xTF32 rate), the FP32 design's times beside (quoted,
              FP32_K4_MS)
  7. build    the training slice's kernels: augment.cu (K1, K6), mfcc.cu
              (K2), frontend.cu (K3), with their ptxas lines
  8. augment  K1 and K6 against their plain version on the 24,100 x 16,000
              synthetic dataset, batch 1, 8, 1536, both crop modes and
              both background-mix versions: bit-exact (max |err| 0)
  9. front    K2 against the plain front end (TF32 off), MFCC and log-mel,
              batch 1, 64, 1536, atol 1e-4; the bf16 DFT at 5e-3; K3
              against K1-plain -> K2-plain with the same draws, atol 1e-4
 10. train    the main path: Trainer at batch 1536, bf16, one leg with
              frontend_fuse="on" (K3) and one "off" (K1 + K2); launch
              counts equal the step counts, no batch leaves the kernels
              (mfcc.plain_routes stays 0), the loss falls, the
              train-stream eval and the audio summary (K6) run; a float32
              batch-100 preset leg; resume from a checkpoint is exact
 11. times    each new kernel against its plain version at batch 1536;
              ms/step, utt/s and the device's busy share of the step for
              the input legs at batch 1536 and 4096
 12. build    tconv.cu (K7: fwd, dx, dw), the ptxas line of each kernel
              (fwd's and dx's by their n8-tile width, dw's by its m16 and
              n8 tiles); fails if a fwd, dx or dw tile spills
 13. kernel   K7 against its plain version (TF32 off) at TCResNet8-1.0's ten
              conv geometries, TCResNet14-1.5's and an even k at stride 3,
              batch 1, 8, 1536, f32 and bf16-rounded inputs; launch
              counters; fwd, dx and dw identical on two calls
 14. train    the main path through K7: Trainer with conv_backend="pallas"
              at batch 1536 in bf16, 30 steps, a checkpoint every 10; K7
              launches per step (10 fwd, 9 dx, 10 dw) and per train-stream
              eval (10 fwd); the loss falls; resume is exact; a float32
              batch-100 preset leg "pallas" against "xla" over 5 steps
 15. evaluate the loop evaluator (tools/evaluate.py) over that run on the
              synthetic valid split: each checkpoint scored once through
              K7's forward, the best promoted and re-scored identically;
              "pallas" against "xla" on one checkpoint
 16. times    K7 fwd, dx and dw and cuDNN (TF32 off) over one step's ten
              convs at batch 1536 and per conv, CUDA events behind a device
              sleep (tools/tconv_times.py; a drained launch queue is named
              in the line), dx also over the nine convs a step launches it
              for, the eager readings (host gaps included) and the plain
              versions beside; the FP32-FMA fwd, dx and dw designs'
              times quoted; K7 beside cuDNN f32 and bf16 (the `xla`
              step's call) by torch.profiler; the host's enqueue of the
              ten fwd calls; the train step "pallas" against "xla", with
              its device time by kind and its costliest kernels; eval utt/s
 17. build    infer2d.cu (K5, the 2D families' op-list kernel), its ptxas
              line and its cooperative grid
 18. kernel   K5 against its plain version (TF32 off) for every 2D preset
              (TCResNet2D8[Pool], Res8/15[Narrow], DSCNN S/M/L) and all 7 KWS
              architectures at batch 1, 3, 8, 64, and the four timed presets
              at 1024, launch counter checked, two calls equal bit for bit;
              K2 at 640/320 (MFCC-10 and MFCC-40) against the plain front
              end, atol 1e-4; K5's softmax against the JAX golden
              tcresnet_tpu_torch/testdata/infer2d_golden.npz
 19. serve    the 2D main path: build_inference_fn(backend="auto") for
              Res15, DSCNNL and KWSfpool3, 20 single requests each through
              K2 + K5 (launches counted, plain_routes 0) and one batch of 64
              on the plain path, against backend="xla", precision="highest"
 20. times    TCResNet2D8-1.0, Res15, DSCNNL, KWSfpool3 at batch 1 and 1024:
              K5, its plain version and the model on cuDNN (TF32 off, as a
              CUDA graph) over the same features on one clock, CUDA events
              behind a device-side sleep (K5 and cuDNN must not be paced by
              the host; the line names the plain version if it was); one
              eager cuDNN model call under torch.profiler as a second line;
              K5's bound at the 3xTF32 rate and the earlier FP32-FMA design's
              times beside; K5 per
              step for Res15 and KWSfpool3 (the program cut after each
              step); the served request (K2 + K5, and "xla") on the host
              clock
 21. build    mfcc.cu (K2 and K8 one entry point, K9) and frontend.cu (K3
              hops and phases one entry point, radix4) rebuilt, the ptxas line of every kernel (K2's and
              K8's shared stage, "hops+phases", in its 16-, 64- and
              128-row tiles, K9's in its 64-row and 112-row products); the
              hops and K8 tiles must not spill, nor K9's 112-row product
              more than before (K9_SPILL_BYTES)
 22. kernel   K2 (hops), K8 (phases) and K9 (radix4) against their plain
              versions (TF32 off) at 480/160 MFCC-40, 640/320 MFCC-10 and
              MFCC-40, and K2 at 400/200 and 320/160 MFCC-40, MFCC and
              log-mel, batch 1, 8, 1536, atol 1e-4, and with the bf16 DFT at
              5e-3, two calls equal bit for bit, K2 and K8 of one clip equal
              to its row of the batch bit for bit, K2 equal to K8; K3 in
              the hops (also at 400/200 and 320/160), phases and radix4
              variants against K1-plain
              followed by the variant's plain version, the same draws, at
              the JAX package's tolerance for features of dataset rows
              (DATASET_FEATURE_TOL: atol 2e-4, rtol 1e-5; MFCCs up to ~160),
              the kernel within atol 1e-4 of the same augmented rows in
              float64 (the plain version's distance printed beside), and
              bit-equal to K2 / K8 / K9 over K1 (held to float64 there
              too); the per-variant launch counters; dsp_backend="pallas"
              at 400/160, not hop-decomposable (the JAX package's fallback
              too): the plain feature within 1e-5, no launch,
              mfcc.plain_routes up by one; a radix4 clip past K9's frames
              (2.56 s at 480/160, 254 frames), MFCC and log-mel, through
              fused_mfcc (batch 1, 8, 256) and K3 (batch 8): K2's stage,
              within 1e-4 of the plain radix4 feature, K3 equal to K2(K1),
              the hops counters up by one, radix4 launches and
              plain_routes unchanged
 23. train    the 2D main path: the DSCNNL preset (MFCC-10 at 40/20 ms,
              batch 100, float32, adam) with dft_variant="radix4" and
              frontend_fuse="on", 30 steps, a checkpoint every 10: K3-radix4
              launches equal the steps, the loss falls, resuming from step 20
              reproduces steps 21-30 exactly; the loop evaluator scores the
              three checkpoints through K9 (dsp_backend="pallas"); legs of 5
              steps: Res15 (adam, 480/160) with "phases" through K3-phases,
              TCResNet2D8-1.0 (mom), KWSfpool3 (adam, dropout), DSCNNS with
              rmsprop; build_inference_fn(backend="auto") for the trained
              DSCNNL (radix4) and Res15 (phases) serves 20 single requests
              each through K9 + K5 and K8 + K5, against "xla", "highest";
              plain_routes stays 0
 24. times    K2, K8, K9, their plain versions and dsp.preprocess on cuBLAS
              (TF32 off, the library time) at batch 1536 for both
              geometries, eager; K8 and K3-phases behind a device sleep on
              one clock with the library call as a CUDA graph, at batch 1536
              (both geometries; frontend_times.hops_times, as phase 25), K8 and K9 with it at batch 1; K8's and
              K9's bounds at the 3xTF32 rate and PR 5's K8 and K9 times
              beside (quoted); K3 in its variants; ms/step, utt/s and the
              device's busy share of the DSCNNL and Res15 train steps at
              their preset batch
 25. times    K2 and K3-hops at batch 1536 and K2 at batch 1, at 480/160,
              640/320 and 400/200, behind a device sleep on one clock with
              dsp.preprocess on cuBLAS as a CUDA graph
              (tcresnet_tpu_torch/tools/frontend_times.py), their bounds at
              the 3xTF32 rate, the FP32 design's times beside (quoted,
              FP32_HOPS_MS); the summary's K2 and K3 times
 26. dataset  the Speech Commands path on a tree made from a seed (2,400
              one-second wavs over 10 keywords and 4 other words, speaker-
              hashed names, and six noise clips of 60-95 s): the port's
              prepare_dataset --extracted; train, valid and test loaded with
              the C++ decoder (fails where numpy decoded), twice, the cache
              hit equal to the decode; K1 bit-exact to its plain version on
              the 6 x 1,520,000 noise bank with rows drawn through
              sample_row, K3 and K7 at the run's batch; tools/train.py's
              main at TCResNet8-1.0, batch 100, float32, oversampling on,
              K3 and K7, 30 steps, a checkpoint every 10, --eval-split test:
              launches equal the steps, plain_routes 0, the loss falls; a
              warm start from it with fc excluded and only fc trained (K1 +
              K2), every other param bit-equal to the source, fc moved; its
              resume under relative_schedule, the first learning rate the
              shifted one; tools/evaluate.py --split test re-scores the
              promoted best identically; the decode per 1,000 wavs (C++ and
              numpy), the upload, and the tree-backed step against the
              synthetic one at batch 100
 27. deploy   tools/run_experiment.py at TCResNet8-1.0 (batch 100, float32,
              K3 and K7, 30 steps, a checkpoint every 10; trainer and loop
              evaluator on the card): rc 0, a promoted best, step 30 scored,
              the final test eval; tools/export.py on that run (best
              accuracy, --fused-kernel, TF32 off, --output, --benchmark):
              its three 1e-5 gates, K4 launched, plain_routes 0; the same
              CLI on a seeded DSCNNL checkpoint through K2 + K5;
              compile_inference's CUDA graph at batch 1 and 1024 against the
              uncaptured call (1e-5), another batch raising, and the times
              of both; an artifact exported on the CPU loaded onto the card
              against its xla path (TF32 off, 1e-5); K4 at width 1.25
              (TCResNet8 and TCResNet14, widths padded to 4) against its
              plain version at batch 1, 8, 1024; streaming SVDF (2,560
              filters, 49 x MFCC-40) fed in chunks of 1 and 7 against the
              full window (1e-4) and the batch model (1e-5), its µs per chunk
              and real-time factor; the adaptive benchmark_on_device at
              batch 1 for K4 and the xla path
 28. dp       data parallelism (parallel/mesh.py, tools/dp_check.py), the
              ranks spawned after every kernel was built, each returning
              its readings and launch counters: 28.1 two gloo ranks sharing
              the card against one process, TCResNet8-1.0 at batch 256 in
              float32, K3 + K7 and K1 + K2 + K7, 3 steps (losses within
              1e-5, params within 1e-5 of max|p|, params and BN statistics
              bit-equal on both ranks, every kernel launched on every
              rank); 28.2 the evaluator over the 3,012 valid rows on 2 ranks
              (accuracy equal, loss within 1e-6); 28.3 one NCCL rank, the
              bf16 step at batch 1536, 20 steps, ms/step and utt/s beside
              the step without a mesh; 28.4 the parity and the step's
              times (1536 rows in all, and 1536 a card) over NCCL across 2
              and 4 cards where the machine has them (a line that says so
              where not); 28.5 graft_entry.entry() (K4, softmax
              within 1e-5 of the xla path) and dryrun_multichip(2) on the
              card (two cards over NCCL, else two gloo ranks sharing one)
 29. tools    the preset sweep (tools/benchmark.py::bench_preset) at
              TCResNet8-1.0 (batch 1536, bf16, conv_backend "pallas") and
              DSCNNL (batch 100, float32): every field finite, the device
              latency at most the host's, K1 launched once a step and K7
              dx / dw 9 / 10 times, the step's FLOP count (the meta
              device's, utils/profiling.py::step_flops) equal to the count
              of the Trainer's plain step on the card at the same batch, and
              its rate below the card's peak for the dtype; the stage profiler (tools/profile_scaling.py) at
              batch 1536 and 2048 with dsp_backend "pallas", all eight
              stages, n1 5 and n2 20: every time positive, each stage's
              launches exactly those of the kernels it names (K6, K1, K2;
              the step K1 + K2, and K3 from 2048); Res15's device-bound
              step at batch 1024 in bf16: host clock, CUDA events and the
              device's time by kind (torch.profiler)
 30. bn       batch norm in training mode + ReLU (csrc/batchnorm.cu): the
              ptxas line; at DS-CNN L's layers at batch 4096 ([276, 13, 5]
              and [276, 25, 10] channels-last, as cuDNN returns them, and
              [276, 13, 5] contiguous; shift, relu) and TCResNet8-1.0's
              four layer shapes at batch 8192 ([16, 98] to [48, 13]
              contiguous; scale and shift, relu on and off) y, dx,
              dscale, dshift and both running statistics against the
              plain version within 1e-4 of their max (the backward from
              the kernels' statistics), 6 launches a forward and
              backward; the fused forward + backward timed against its
              5-pass byte bound, the plain version and F.batch_norm
              [+ F.relu] under autograd (CUDA events)

then the kernel summary as one JSON line (each kernel with its launches on
its main path, its max error against its plain version, its time, the
plain version's, the least time the card could take for the same work and
what bounds it, and the time of one PyTorch call that computes the same
function where there is one; K1, K2, K3 and K7 also their launches in
phase 26, `launches_dataset`, K4 its launches in phase 27,
`launches_deploy`, its max error including width 1.25), and last
{"ok": true, "device": {...}}. Any failed check raises and the script
exits non-zero without that line. There is no CPU fallback: without a
CUDA device it exits 1.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from tcresnet_tpu_torch.ops.kernels import launch_counts, reset_launch_counts  # noqa: E402
from tcresnet_tpu_torch.tools.frontend_times import graph_of, hops_times, queued_ms  # noqa: E402
from tcresnet_tpu_torch.tools.infer_times import crossover, k4_times  # noqa: E402
from tcresnet_tpu_torch.tools.tconv_times import conv_cases, conv_geometries, conv_ops  # noqa: E402
from tcresnet_tpu_torch.tools.tconv_times import conv_work, k7_times  # noqa: E402

# logits / softmax tolerances of the JAX package's kernel test
# (tests/test_pallas_infer.py): kernel and plain version differ by
# float32 summation order only
LOGIT_ATOL, LOGIT_RTOL, SOFTMAX_ATOL = 5e-4, 1e-4, 1e-5
# dsp_matmul_dtype="bfloat16": both round operands to bf16 and sum in
# float32, in different orders (the JAX package's bf16 tolerance)
BF16_TOL = 5e-3
# features: the JAX package's front-end kernel tolerance
# (tests/test_pallas_frontend.py): float32 sums in another order
FEATURE_ATOL = 1e-4
# features of int16 dataset rows (loud tones, MFCC up to ~160, where
# float32 steps are 1.5e-5) through a kernel against the plain path: the
# JAX package's tolerance for the same comparison
# (tests/test_pallas_frontend.py::test_fused_frontend_eval_mode). Against
# a float64 evaluation of the same rows the K3 kernels are within
# FEATURE_ATOL and the plain path (cuBLAS) is the farther side, ~1e-4
DATASET_FEATURE_TOL = dict(atol=2e-4, rtol=1e-5)
# K7 fwd and dx: the JAX package's kernel test (tests/test_pallas_tconv.py):
# float32 sums in another order
TCONV_FWD_TOL = dict(atol=1e-5, rtol=1e-5)
TCONV_DX_TOL = dict(atol=2e-4, rtol=1e-4)
# K7 dw: each entry sums up to B * To = 150,528 products (conv0, batch 1536)
# in another order than the plain einsum; relative to max|dw|
TCONV_DW_REL = 1e-5
# "pallas" against "xla" (cuDNN, TF32 off), float32, same weights and draws:
# the first step's loss differs by the convs' summation order alone. A
# later step can differ more: an activation within ~1e-6 of a ReLU's zero
# can land on either side in the two backends, and the step's gradient then
# differs in one BN by a sizeable share. On the CPU one such element of
# 62,400 (a silence row) moved the step-5 loss by 1.9e-3 relative; on the
# H100 the legs agreed within 2e-7 (PERF.md)
FIRST_STEP_RTOL, TRAIN_LEG_RTOL = 1e-5, 1e-2
SOURCES = ("infer", "augment", "mfcc", "frontend", "tconv", "infer2d", "batchnorm")
# the H100 SXM's published peaks: float32
# outside the tensor cores, and HBM
FP32_FLOPS, HBM_BYTES_PER_S = 67e12, 3.35e12
# the H100 SXM's published dense bf16 tensor-core peak (phase 29's ceiling
# for a bf16 step's FLOP rate; a float32 step's is FP32_FLOPS, TF32 off)
BF16_FLOPS = 989e12
# K5's, K7's, K8's and K9's bound rate: the float32-exact tensor-core rate.
# K5 computes its convs and dense layers, K7 its three passes, K8 and K9
# their DFT products, as 3xTF32 (three TF32 products per float32 product,
# at the 495 TFLOP/s TF32 peak), so FP32_FLOPS is no longer the least time
# the card could take for that work; every other kernel keeps FP32_FLOPS
TF32X3_FLOPS = 495e12 / 3
# K5's earlier design (per-thread FP32 FMA, no K split) and the cuDNN model
# beside it, quoted from PERF.md (PR 5's run; ms; NVIDIA H100 80GB HBM3,
# 700.00 W; K5 by CUDA events behind a device sleep, cuDNN one call under
# torch.profiler): printed as quoted beside this run's times, never in the
# kernels summary
PR5_K5_MS = {("TCResNet2D8-1.0", 1): (0.3007, 0.2433), ("TCResNet2D8-1.0", 1024): (4.5128, 7.4011),
             ("Res15", 1): (0.8173, 1.7687), ("Res15", 1024): (123.65, 122.46),
             ("DSCNNL", 1): (0.2853, 0.2206), ("DSCNNL", 1024): (7.6675, 8.598),
             ("KWSfpool3", 1): (0.3826, 0.1272), ("KWSfpool3", 1024): (9.1015, 3.1126)}
# K9's earlier design (per-thread FP32 FMA over 4- or 8-frame tiles) at batch
# 1536, quoted from PERF.md (PR 5's run; ms; NVIDIA H100 80GB HBM3, 700.00 W;
# CUDA-event medians): (k9_mfcc, k3_radix4), printed beside this run's times
PR5_K9_MS = {"640/320 MFCC-10": (6.2600, 6.2280), "480/160 MFCC-40": (4.0636, 3.9814)}
# K8's earlier design (per-thread FP32 FMA over per-phase frame tiles, one
# block per utterance) at batch 1536, the same source: (K8, K3-phases)
PR5_K8_MS = {"640/320 MFCC-10": (4.9868, 4.9938), "480/160 MFCC-40": (4.3885, 4.4048)}
# K7 fwd's earlier design (per-thread FP32 FMA, 4 output channels a thread)
# over the ten convs of a TCResNet8-1.0 step at batch 1536, behind a device
# sleep as phase 16 times it (ms; NVIDIA H100 80GB HBM3, 700.00 W): printed
# beside this run's time, never in the kernels summary
FP32_K7_FWD_MS = 0.6834
# K7 dx's earlier design (per-thread FP32 FMA, 4 input channels a thread)
# the same way, timed by tools/tconv_times.py on a checkout of that design
# (ms; NVIDIA H100 80GB HBM3, 700.00 W; PERF.md): printed beside this
# run's time, never in the kernels summary
FP32_K7_DX_MS = 0.9222
# K7 dw's earlier design (per-thread FP32 FMA, 4 x 4 outputs a thread) the
# same way, timed by tools/tconv_times.py on a checkout of that design
# (ms, the lesser of its readings; NVIDIA H100 80GB HBM3, 700.00 W;
# PERF.md): printed beside this run's time, never in the kernels summary
FP32_K7_DW_MS = 1.1089
# K2's and K3-hops' earlier design (per-thread FP32 FMA, one block per
# utterance), timed by tcresnet_tpu_torch/tools/frontend_times.py on a
# checkout of that design (ms; NVIDIA H100 80GB HBM3, 700.00 W; behind a
# device sleep, the lesser of two readings; PERF.md): (k2_mfcc,
# k3_frontend) at batch 1536 and k2_mfcc at batch 1, printed beside this
# run's times, never in the kernels summary
FP32_HOPS_MS = {"480/160": (3.2100, 3.2153, 0.2538), "640/320": (4.4008, 4.3727, 0.3503),
                "400/200": (2.5914, 2.5948, 0.2029), "320/160": (2.7965, 2.7985, 0.2194)}
# K4's earlier design (one block per utterance, its front end on FP32 FMA)
# serving TCResNet8-1.0 wav -> logits, behind a device sleep as phase 6
# times it (ms at batch 1 and 1024; NVIDIA H100 80GB HBM3, 700.00 W;
# PERF.md): printed beside this run's times, never in the kernels summary
FP32_K4_MS = {1: 0.3283, 1024: 2.7409}
# the spill stores ptxas reports for K9's 112-row product (mfcc.cu,
# frontend.cu) since it shares dft_tc.cuh's tc_mma: phase 21 fails if they
# grow
K9_SPILL_BYTES = {"mfcc": 52, "frontend": 12}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def seeded_wavs(seed: int, batch: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-1, 1, (batch, n)).astype(np.float32)


def bound(flops: float, nbytes: float, rate: float = FP32_FLOPS) -> dict:
    """The least time the card could take for work of `flops` float32
    operations at `rate` FLOP/s that must move `nbytes` bytes, and which of
    the two bounds it."""
    t_ops, t_bytes = flops / rate, nbytes / HBM_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def enqueue_us(fn, runs: int = 50) -> float:
    """Median host µs of enqueueing fn(), each run after a synchronize, so
    the launch queue is empty and nothing waits on the device."""
    times = []
    for _ in range(runs + 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return float(np.median(times[3:])) * 1e6


def mfcc_float64(wavs: torch.Tensor, audio) -> torch.Tensor:
    """MFCC of float32 wavs evaluated in float64 from the front end's float32
    constants: frames @ windowed DFT -> power -> mel -> log -> DCT. Every DFT
    variant computes this function; only its rounding differs."""
    from tcresnet_tpu_torch.ops import dsp

    win, hop = audio.window_size_samples, audio.window_stride_samples
    fft = dsp.fft_length_for(win)
    bins = fft // 2 + 1
    frames = dsp.num_frames_for(wavs.shape[-1], win, hop)
    idx = torch.tensor(np.arange(frames)[:, None] * hop + np.arange(win)[None, :],
                       device=wavs.device)
    const = lambda a: torch.tensor(a, dtype=torch.float64, device=wavs.device)  # noqa: E731
    reim = wavs.double()[:, idx] @ const(dsp.windowed_rdft_matrix(win, fft))
    power = reim[..., :bins] ** 2 + reim[..., bins:] ** 2
    log_mel = torch.log(power @ const(dsp.linear_to_mel_weight_matrix(*dsp.mel_args(audio)))
                        + 1e-6)
    return log_mel @ const(dsp.dct_ii_matrix(audio.num_mel_bins, audio.num_mfccs))


def ptxas_line(name: str) -> str:
    """ptxas's registers and spills of csrc/<name>.cu, each labelled with
    its kernel (K7's by name and template arguments; the front ends' by DFT
    variant, the tensor-core products with their rows: <MI, WM> is WM * MI *
    16 rows; the *_wg_kernel ones the 128-row wgmma product)."""
    from tcresnet_tpu_torch.ops.kernels import _build

    log = _build.library_path(name).with_suffix(".log")
    variants = {"frames_kernel": "hops+phases", "k3_frames_kernel": "hops+phases",
                "frames_wg_kernel": "hops+phases", "k3_frames_wg_kernel": "hops+phases",
                "k9_kernel": "radix4", "k3_radix4_kernel": "radix4", "k4_kernel": "k4",
                "k4_wg_kernel": "k4", "k4_conv_kernel": "k4 convs"}
    entry, parts = "", []
    for line in log.read_text().splitlines() if log.exists() else []:
        fn = re.search(r"_Z(\d+)(\w+)", line)
        if "Compiling entry function" in line and fn:
            kernel = fn.group(2)[:int(fn.group(1))]
            params = [int(p) for p in re.findall(r"Li(\d+)E", fn.group(2)[len(kernel):])]
            if kernel.startswith("k7_"):
                entry = f"{kernel}<{','.join(map(str, params))}>: " if params else f"{kernel}: "
            elif kernel in variants:
                rows = f" {params[1] * params[0] * 16}-row" if params else ""
                if kernel.endswith("_wg_kernel"):  # the 128-row product (dft_wgmma.cuh)
                    rows = " 128-row"
                entry = f"{variants[kernel]}{rows}: "
            else:
                entry = ""
        elif "registers" in line or "spill" in line:
            parts.append(entry + line.split("ptxas info    :")[-1].strip())
    return " ".join(parts) or "cached build"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1

    from tcresnet_tpu_torch.config import get_preset
    from tcresnet_tpu_torch.ops.kernels import _build
    from tcresnet_tpu_torch.ops.kernels import infer as k4
    from tcresnet_tpu_torch.serve.benchmark import benchmark_compiled, benchmark_on_device
    from tcresnet_tpu_torch.serve.export import build_inference_fn
    from tcresnet_tpu_torch.utils.device import card_description

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. device ----
    card = card_description()
    print(card)
    print(f"[device] {torch.cuda.get_device_name(0)} | count {torch.cuda.device_count()} "
          f"| capability {torch.cuda.get_device_capability(0)} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    # ---- 2. build: every source at once ----
    t0 = time.perf_counter()
    _build.build_all(SOURCES)
    k4.build_kernels()
    build_s = time.perf_counter() - t0
    line = ptxas_line("infer")
    print(f"[build] infer.cu for sm_90a in {build_s:.1f} s | {line}")
    tiles = [(int(r), int(b)) for r, b in re.findall(
        r"k4 (\d+)-row: \d+ bytes stack frame, (\d+) bytes spill stores", line)]
    convs = re.findall(r"k4 convs: \d+ bytes stack frame, (\d+) bytes spill stores", line)
    check(sorted({r for r, _ in tiles}) == [16, 64, 128] and all(b == 0 for _, b in tiles)
          and convs == ["0"],
          f"infer.cu: K4's instantiations missing from the ptxas line or spilling: {tiles}, "
          f"conv kernel {convs}")

    def variables_for(cfg, seed):
        return seeded_variables_on(cfg, seed, dev)

    # ---- 3. kernel vs plain version ----
    flagship = get_preset("TCResNet8-1.0")
    log_mel = dataclasses.replace(
        flagship, audio=dataclasses.replace(flagship.audio, preprocess_method="log_mel_spectrogram"))
    bf16 = dataclasses.replace(
        flagship, audio=dataclasses.replace(flagship.audio, dsp_matmul_dtype="bfloat16"))
    cases = [("TCResNet8-1.0", flagship, False), ("TCResNet14-1.5", get_preset("TCResNet14-1.5"), False),
             ("TCResNet8-1.0 log-mel", log_mel, False), ("TCResNet8-1.0 bf16-dft", bf16, True)]
    max_err = 0.0
    for label, cfg, is_bf16 in cases:
        v = variables_for(cfg, seed=0)
        plan = k4.build_fused_infer(cfg.model, cfg.audio, v["params"], v["batch_stats"], device=dev)
        errs = []
        for batch in (1, 3, 8, 64, 256, 1024):
            wavs = torch.tensor(seeded_wavs(100 + batch, batch, cfg.audio.desired_samples), device=dev)
            before = k4.launches
            got = k4.fused_infer(wavs, plan)
            again = k4.fused_infer(wavs, plan)
            torch.cuda.synchronize()
            check(k4.launches == before + 2, f"{label} B={batch}: kernel not launched")
            check(torch.equal(got, again), f"{label} B={batch}: two calls differ")
            plan.force_two_kernels = not plan.two_kernels(batch)  # the other path: the same bits
            other = k4.fused_infer(wavs, plan)
            plan.force_two_kernels = None
            check(torch.equal(got, other), f"{label} B={batch}: K4's two paths differ")
            want = k4.fused_infer_reference(wavs, plan)
            check(got.shape == want.shape == (batch, cfg.model.num_classes), f"{label}: shape")
            check(bool(torch.isfinite(got).all()), f"{label} B={batch}: non-finite logits")
            err = (got - want).abs().max().item()
            sm_err = (torch.softmax(got, -1) - torch.softmax(want, -1)).abs().max().item()
            if is_bf16:
                check(torch.allclose(got, want, atol=BF16_TOL, rtol=BF16_TOL),
                      f"{label} B={batch}: logits differ by {err}")
                check(bool((got.argmax(-1) == want.argmax(-1)).all()), f"{label}: argmax")
            else:
                check(torch.allclose(got, want, atol=LOGIT_ATOL, rtol=LOGIT_RTOL),
                      f"{label} B={batch}: logits differ by {err}")
                check(sm_err <= SOFTMAX_ATOL, f"{label} B={batch}: softmax differs by {sm_err}")
                max_err = max(max_err, err)
            errs.append(f"B={batch} {err:.2e}/{sm_err:.2e}")
        # one utterance alone against its row of the 1024 batch (the last `wavs`)
        rows = (0, 1, 97, 500, 1023)
        alone = torch.cat([k4.fused_infer(wavs[r:r + 1].contiguous(), plan) for r in rows])
        check(torch.equal(alone, got[list(rows)]),
              f"{label}: batch-1 logits differ from their rows of the 1024 batch")
        check(not plan.count.any() and not plan.done.any(), f"{label}: a counter is not 0")
        print(f"[kernel] {label}: max |logit| / |softmax| err vs plain: " + ", ".join(errs)
              + "; two calls and the two paths (conv stacks in the stage's blocks, and in a "
              f"kernel of their own) bit-equal at every batch; rows {rows} alone equal to "
              "their rows of B=1024 bit for bit")

    # ---- 4. against the JAX reference ----
    golden_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "tcresnet_tpu_torch", "testdata", "tcresnet8_golden.npz")
    golden = np.load(golden_path)
    gcfg = get_preset(str(golden["preset"]))
    gv = variables_for(gcfg, seed=int(golden["param_seed"]))
    gwavs = torch.tensor(seeded_wavs(int(golden["wav_seed"]), int(golden["batch"]),
                                     gcfg.audio.desired_samples), device=dev)
    gplan = k4.build_fused_infer(gcfg.model, gcfg.audio, gv["params"], gv["batch_stats"], device=dev)
    gsm = torch.softmax(k4.fused_infer(gwavs, gplan), -1).cpu().numpy()
    gerr = float(np.abs(gsm - golden["softmax"]).max())
    check(gerr <= SOFTMAX_ATOL, f"golden: kernel softmax differs from JAX by {gerr}")
    print(f"[golden] {golden['preset']} B={int(golden['batch'])}: kernel softmax vs JAX "
          f"max err {gerr:.2e} (limit {SOFTMAX_ATOL})")

    # ---- 5. serve: the main path ----
    v8 = variables_for(flagship, seed=0)
    n = flagship.audio.desired_samples
    auto = build_inference_fn(flagship, v8, backend="auto", device=dev)
    ref = build_inference_fn(flagship, v8, backend="xla", precision="highest", device=dev)
    requests = [torch.tensor(seeded_wavs(1000 + i, 1, n), device=dev) for i in range(20)]
    big = torch.tensor(seeded_wavs(2000, 64, n), device=dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    answers = [auto(x) for x in requests]
    big_answer = auto(big)
    torch.cuda.synchronize()
    serve_ms = (time.perf_counter() - t0) * 1e3
    main_launches = k4.launches
    check(main_launches == len(requests),
          f"serve: {main_launches} kernel launches for {len(requests)} single requests")
    serve_err = 0.0
    for x, y in [*zip(requests, answers), (big, big_answer)]:
        check(y.shape == (x.shape[0], flagship.model.num_classes), "serve: output shape")
        check(bool(torch.isfinite(y).all()), "serve: non-finite softmax")
        check(bool(torch.allclose(y.sum(-1), torch.ones_like(y[:, 0]), atol=1e-5)),
              "serve: softmax rows do not sum to 1")
        serve_err = max(serve_err, (y - ref(x)).abs().max().item())
    check(serve_err <= SOFTMAX_ATOL, f"serve: auto vs xla/highest differ by {serve_err}")
    print(f"[serve] auto: 20 x B=1 (fused, {main_launches} launches) + 1 x B=64 (plain) in "
          f"{serve_ms:.1f} ms; max softmax err vs xla/highest {serve_err:.2e}")

    # ---- 6. times ----
    plan8 = k4.build_fused_infer(flagship.model, flagship.audio, v8["params"], v8["batch_stats"],
                                 device=dev)
    plain_default = build_inference_fn(flagship, v8, backend="xla", device=dev)
    fused_fn = build_inference_fn(flagship, v8, backend="fused", device=dev)
    times = {}
    for batch in (1, 1024):
        x = torch.tensor(seeded_wavs(3000 + batch, batch, n), device=dev)
        for name, fn in (("kernel", plan8), ("kernel_plain_version", lambda w: k4.fused_infer_reference(w, plan8)),
                         ("serve_fused", fused_fn), ("serve_xla_highest", ref),
                         ("serve_xla_default", plain_default)):
            host = benchmark_compiled(fn, x)
            devt = benchmark_on_device(fn, x)
            times[(name, batch)] = devt["median"]
            print(f"[times] {name} B={batch}: host avg {host['avg']:.1f} us (min {host['min']:.1f}) | "
                  f"device median {devt['median']:.1f} us (min {devt['min']:.1f}, max {devt['max']:.1f}) | "
                  f"{devt['median'] / batch:.3f} us/utt | {card}")

    # K4's bound: the front end's DFT at the 3xTF32 rate (window x fft a
    # frame, its products on the tensor cores), its mel (the nonzero
    # weights) and DCT, the convs' taps that meet the map and the fc at the
    # FP32 rate; the wav, the constants and the logits at HBM's rate
    from tcresnet_tpu_torch.models.layers import same_padding
    from tcresnet_tpu_torch.ops.kernels.infer2d import valid_taps

    g = plan8.geom.fe
    dft_macs = g.frames * g.window * g.fft_length
    fp32_macs = (variant_macs(flagship.audio, "hops") - dft_macs
                 + flagship.model.num_classes * 48)
    for k, stride, ci, co, t in conv_geometries(flagship.model, g.frames, g.width):
        to, lo, _ = same_padding(t, k, stride)
        fp32_macs += valid_taps(to, t, k, stride, lo) * ci * co
    fe8 = plan8.fe
    consts = sum(a.numel() for a in (plan8.wts, plan8.fc, fe8.dft, fe8.mel, fe8.dct, fe8.runs))

    def k4_bound(b: int) -> dict:
        t_ops = 2 * b * (dft_macs / TF32X3_FLOPS + fp32_macs / FP32_FLOPS)
        t_bytes = 4 * (b * n + consts + b * flagship.model.num_classes) / HBM_BYTES_PER_S
        return {"bound_ms": max(t_ops, t_bytes) * 1e3,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes"}

    # the library yardstick: the `xla` model (wav -> softmax, TF32 off) as
    # a CUDA graph, so that its launches do not pace the reading, and K4 on
    # the same clock, behind a device sleep (tools/infer_times.py)
    k4_batches = (1, 8, 32, 64, 256, 1024)
    k4_t = k4_times(dev, k4_batches, paths=True)
    k4_lib = {}
    for batch in k4_batches:
        t = k4_t[batch]
        (a, d), c = t["k4"], t["xla"]
        check(t["queue_full"], f"K4 B={batch}: a K4 or xla time is host-paced")
        k4_lib[batch] = dict(ms=min(a, d), library_ms=c, **k4_bound(batch))
        bnd = k4_lib[batch]
        old = f"; the FP32 design (quoted, not this run): {FP32_K4_MS[batch]} ms" if (
            batch in FP32_K4_MS) else ""
        print(f"[times] K4 B={batch}: kernel {a:.4f} / {d:.4f} ms, the xla model wav -> softmax "
              f"(TF32 off) as a CUDA graph {c:.4f} ms (device, mean of 20 behind a device "
              f"sleep; order kernel, xla, kernel); the graph takes {c / min(a, d):.2f}x K4's "
              f"time; bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}, DFT at 3xTF32, "
              f"{bnd['bound_ms'] / min(a, d):.1%} of it); K4's paths forced, conv stacks in "
              f"the stage's blocks {t['fused'][0]:.4f} / {t['fused'][1]:.4f} ms, in a kernel "
              f"of their own {t['two_kernels'][0]:.4f} / {t['two_kernels'][1]:.4f} ms (order "
              f"fused, two, two, fused; the rule takes "
              f"{'two kernels' if plan8.two_kernels(batch) else 'the fused path'}){old} | {card}")
    print(f"[times] K4 against the xla graph: the graph is faster from batch "
          f"{crossover(k4_t)} on (None: K4 is faster at every batch timed, "
          f"{', '.join(map(str, k4_batches))}) | {card}")

    train_kernels, ds = training_phases(dev, card)
    tconv_kernels = tconv_phases(dev, card, ds)
    infer2d_kernels = infer2d_phases(dev, card)
    variant_kernels, hops_checks = dft_variant_phases(dev, card, ds)
    hops = hops_phase(dev, card, ds)
    for e in train_kernels:  # phases 22 and 25 for K2 and K3-hops
        if e["name"] in hops:
            err = max(e["max_abs_err"], hops_checks[e["name"]].pop("max_abs_err"))
            e.update(hops[e["name"]], max_abs_err=err, **hops_checks[e["name"]])
    dataset = dataset_phase(dev, card, ds)
    for e in train_kernels + tconv_kernels:  # phase 26's launches beside the main path's
        if e["name"] in dataset:
            e["launches_dataset"] = dataset[e["name"]]
    deploy = deploy_phase(dev, card)
    dp_phase(dev, card)
    tools_phase(dev, card, ds)
    bn_kernels = batchnorm_phase(dev, card)

    summary = {"kernels": [{
        "name": "k4_infer", "route": "cuda",
        "source": "tcresnet_tpu_torch/csrc/infer.cu",
        "replaces": "tcresnet_tpu/ops/pallas/infer.py:170",
        "launches": main_launches,
        "launches_deploy": deploy["launches"],
        "max_abs_err": max(max_err, deploy["max_abs_err"]),
        "ms": times[("kernel", 1)] / 1e3,
        "plain_ms": times[("kernel_plain_version", 1)] / 1e3,
        "bound_ms": k4_lib[1]["bound_ms"],
        "bound_by": k4_lib[1]["bound_by"],
        "library_ms": k4_lib[1]["library_ms"],
        "ms_queued": k4_lib[1]["ms"],
        "ms_b1024": times[("kernel", 1024)] / 1e3,
        "plain_ms_b1024": times[("kernel_plain_version", 1024)] / 1e3,
        "bound_ms_b1024": k4_lib[1024]["bound_ms"],
        "bound_by_b1024": k4_lib[1024]["bound_by"],
        "library_ms_b1024": k4_lib[1024]["library_ms"],
        "ms_queued_b1024": k4_lib[1024]["ms"],
        "crossover_batch": crossover(k4_t),
    }] + train_kernels + tconv_kernels + infer2d_kernels + variant_kernels + bn_kernels}
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def smoke_train_cfg(flagship, batch, fuse, dtype="bfloat16", conv_backend="xla", **kw):
    """The training legs' config: batch, compute dtype, the input kernels
    forced on (K3 with fuse "on", K1 + K2 with "off"), conv_backend, and
    cadences of 10 steps (no checkpoints unless `kw` asks)."""
    train = dict(max_step=10**9, step_save_checkpoint=10**6, step_evaluation=10,
                 summary_step_verbose=10, summary_step_default=10)
    train.update(kw)
    return flagship.replace(
        train=dataclasses.replace(flagship.train, batch_size=batch, compute_dtype=dtype, **train),
        model=dataclasses.replace(flagship.model, conv_backend=conv_backend),
        audio=dataclasses.replace(flagship.audio, dsp_backend="pallas", frontend_fuse=fuse),
        augment=dataclasses.replace(flagship.augment, backend="pallas"),
        data=dataclasses.replace(flagship.data, use_synthetic=True,
                                 synthetic_num_samples=24_100))


def train_records(trainer) -> list:
    lines = (trainer.workdir / "train_metrics.jsonl").read_text().splitlines()
    return [json.loads(x) for x in lines]


def device_ms(fn, runs: int = 20) -> float:
    """Median CUDA-event time of fn() in ms over one block of calls (5
    warm-up calls)."""
    from tcresnet_tpu_torch.serve.benchmark import benchmark_on_device

    probe = torch.empty(1, device="cuda")
    return benchmark_on_device(lambda _: fn(), probe, warmup_runs=5, num_runs=runs, repeats=1,
                               max_repeats=1)["median"] / 1e3


def device_spans(fn) -> list:
    """(name, time range) of every device activity of fn(), kernels and
    copies, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range) for e in prof.events() if e.device_type == DeviceType.CUDA]


def device_times_ms(fn) -> tuple:
    """(summed device-activity time of fn() in ms, kernels and copies, which
    do not overlap on the one stream the port uses; the span from the first
    activity's start to the last one's end; the number of activities), from
    torch.profiler; NaN when the profiler reports no device time. Device
    times are not inflated by the profiler's host overhead, so the sum over
    an unprofiled CUDA-event span of the same work is the device's busy
    share."""
    spans = [r for _, r in device_spans(fn)]
    busy_us = sum(s.elapsed_us() for s in spans)
    if busy_us <= 0:
        return float("nan"), float("nan"), 0
    return (busy_us / 1e3, (max(s.end for s in spans) - min(s.start for s in spans)) / 1e3,
            len(spans))


# a train step's device activities by kind, matched in this order on the
# lower-cased name (phase 16)
STEP_KINDS = (("K7", ("k7_",)), ("copies and casts", ("copy", "memcpy", "memset")),
              ("cuDNN and cuBLAS", ("cudnn", "xmma", "conv", "gemm", "cutlass", "sm90_")))


def step_kernels(spans, steps: int) -> tuple:
    """From the `device_spans` of `steps` train steps: ({kind: [ms,
    launches] a step}, [(ms, launches, name) a step, most time first])."""
    by_name = {}
    for name, r in spans:
        t, n = by_name.get(name, (0.0, 0))
        by_name[name] = (t + r.elapsed_us() / 1e3 / steps, n + 1 / steps)
    kinds = {kind: [0.0, 0.0] for kind, _ in STEP_KINDS + (("other", ()),)}
    for name, (t, n) in by_name.items():
        low = name.lower()
        kind = next((k for k, keys in STEP_KINDS if any(key in low for key in keys)), "other")
        kinds[kind][0] += t
        kinds[kind][1] += n
    return kinds, sorted(((t, n, name) for name, (t, n) in by_name.items()), reverse=True)


def device_busy_ms(fn) -> float:
    """Summed device-activity time of fn() in ms (`device_times_ms`)."""
    return device_times_ms(fn)[0]


def training_phases(dev: torch.device, card: str):
    """Phases 7-11: the training slice's kernels and its main path;
    (kernel summary entries, the device dataset)."""
    import tempfile

    from tcresnet_tpu_torch.config import get_preset
    from tcresnet_tpu_torch.data.device_data import DeviceDataset
    from tcresnet_tpu_torch.data.synthetic import make_synthetic_dataset
    from tcresnet_tpu_torch.ops import augment as aug
    from tcresnet_tpu_torch.ops import dsp
    from tcresnet_tpu_torch.ops.kernels import augment as k16
    from tcresnet_tpu_torch.ops.kernels import frontend as k3
    from tcresnet_tpu_torch.ops.kernels import mfcc as k2
    from tcresnet_tpu_torch.train.trainer import Trainer

    # ---- 7. build (compiled in phase 2, all sources at once) ----
    for name in ("augment", "mfcc", "frontend"):
        print(f"[build] {name}.cu for sm_90a | {ptxas_line(name)}")
    k16.build_kernels()
    k2.build_kernels()
    k3.build_kernels()

    flagship = get_preset("TCResNet8-1.0")
    n = flagship.audio.desired_samples
    t0 = time.perf_counter()
    host = make_synthetic_dataset(num_samples=24_100, num_classes=12, desired_samples=n, seed=0)
    ds = DeviceDataset(host, dev)
    print(f"[data] synthetic {ds.wavs.shape[0]} x {ds.wavs.shape[1]} int16 on the card "
          f"({ds.wavs.numel() * 2 / 1e6:.0f} MB) in {time.perf_counter() - t0:.1f} s")
    noise = ds.noise_bank
    gen = torch.Generator(device=dev)

    def draw(batch, seed, cfg, training=True):
        gen.manual_seed(seed)
        idx, _, silent = DeviceDataset.sample_indices(ds.arrays, gen, batch)
        return idx, aug.draw_scalars(gen, silent, cfg, noise, n, training)

    # ---- 8. augment: K1 and K6 bit-exact against the plain version ----
    aug_err = 0.0
    for naive in (True, False):
        for quantize in (False, True):
            cfg = dataclasses.replace(flagship.augment, naive_background_mix=naive,
                                      noise_crop_quantize=quantize)
            errs = []
            for batch in (1, 8, 1536):
                idx, sc = draw(batch, 10 + batch, cfg)
                b1, b6 = k16.k1_launches, k16.k6_launches
                got1 = k16.fused_gather_augment(ds.wavs, idx, sc, noise, n, quantize)
                decoded = DeviceDataset.decode_rows(ds.wavs, idx, n)
                got6 = k16.fused_augment(decoded, sc, noise, quantize)
                torch.cuda.synchronize()
                check((k16.k1_launches, k16.k6_launches) == (b1 + 1, b6 + 1),
                      "augment: kernels not launched")
                want = k16.augment_reference(ds.wavs, idx, sc, noise, n, quantize)
                err = max((got1 - want).abs().max().item(), (got6 - want).abs().max().item())
                check(torch.equal(got1, want) and torch.equal(got6, want),
                      f"augment naive={naive} quantize={quantize} B={batch}: max err {err}")
                aug_err = max(aug_err, err)
                errs.append(f"B={batch} {err:.1e}")
            print(f"[augment] K1/K6 vs plain, naive_mix={naive} crop_quantize={quantize}: "
                  + ", ".join(errs))

    # ---- 9. front end: K2 and K3 against their plain versions ----
    mfcc_err = front_err = 0.0
    bf16_audio = dataclasses.replace(flagship.audio, dsp_matmul_dtype="bfloat16")
    log_mel = dataclasses.replace(flagship.audio, preprocess_method="log_mel_spectrogram")
    for label, audio, tol in (("mfcc", flagship.audio, (FEATURE_ATOL, 0.0)),
                              ("log-mel", log_mel, (FEATURE_ATOL, 0.0)),
                              ("mfcc bf16-dft", bf16_audio, (BF16_TOL, BF16_TOL))):
        errs = []
        for batch in (1, 64, 1536):
            wavs = torch.tensor(seeded_wavs(500 + batch, batch, n), device=dev)
            before = k2.launches
            got = k2.fused_mfcc(wavs, audio)
            torch.cuda.synchronize()
            check(k2.launches == before + 1, "K2 not launched")
            want = dsp.preprocess(wavs, dataclasses.replace(audio, dsp_backend="xla"))[..., 0]
            check(got.shape == want.shape == (batch, 98, dsp.feature_width(audio)), "K2 shape")
            check(bool(torch.isfinite(got).all()), "K2: non-finite features")
            err = (got - want).abs().max().item()
            check(torch.allclose(got, want, atol=tol[0], rtol=tol[1]),
                  f"K2 {label} B={batch}: max err {err}")
            if tol[1] == 0.0:
                mfcc_err = max(mfcc_err, err)
            errs.append(f"B={batch} {err:.2e}")
        print(f"[front] K2 {label} vs plain (TF32 off): " + ", ".join(errs))
    errs = []
    for batch in (1, 64, 1536):
        idx, sc = draw(batch, 900 + batch, flagship.augment)
        before = k3.launches
        got = k3.frontend_features(ds.wavs, idx, sc, noise, flagship.audio, n)
        torch.cuda.synchronize()
        check(k3.launches == before + 1, "K3 not launched")
        want = k3.frontend_reference(ds.wavs, idx, sc, noise, flagship.audio, n)
        err = (got - want).abs().max().item()
        check(torch.allclose(got, want, atol=FEATURE_ATOL, rtol=0), f"K3 B={batch}: max err {err}")
        two = k2.fused_mfcc(k16.fused_gather_augment(ds.wavs, idx, sc, noise, n), flagship.audio)
        front_err = max(front_err, err)
        errs.append(f"B={batch} {err:.2e} (vs K2(K1) {(got - two).abs().max().item():.1e})")
    print("[front] K3 vs K1-plain -> K2-plain: " + ", ".join(errs))

    # ---- 10. train: the main path ----
    workdir = tempfile.mkdtemp(prefix="chip_smoke_train_")

    def train_cfg(batch, fuse, dtype="bfloat16", **kw):
        return smoke_train_cfg(flagship, batch, fuse, dtype, **kw)

    steps = 30
    reset_launch_counts()
    legs = {}
    for fuse in ("on", "off"):
        before = (k16.k1_launches, k2.launches, k3.launches, k16.k6_launches)
        t0 = time.perf_counter()
        trainer = Trainer(train_cfg(1536, fuse), ds, workdir=f"{workdir}/{fuse}",
                          steps_per_call=10)
        trainer.train(steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        delta = tuple(a - b for a, b in zip(
            (k16.k1_launches, k2.launches, k3.launches, k16.k6_launches), before))
        records = train_records(trainer)
        losses = [r["total_loss"] for r in records if "total_loss" in r]
        evals = [r for r in records if "train_stream/accuracy" in r]
        legs[fuse] = (delta, losses, evals, wall)
        want = (0, 0, steps) if fuse == "on" else (steps, steps, 0)
        check(delta[:3] == want, f"train {fuse}: K1/K2/K3 launches {delta[:3]}, want {want}")
        check(delta[3] > 0, f"train {fuse}: the audio summary (K6) did not run")
        check(int(trainer.state.step) == steps, f"train {fuse}: step {int(trainer.state.step)}")
        check(all(np.isfinite(x) for x in losses) and losses[-1] < losses[0],
              f"train {fuse}: loss did not fall: {losses}")
        check(len(evals) == steps // 10, f"train {fuse}: {len(evals)} train-stream evals")
        print(f"[train] B=1536 bf16 frontend_fuse={fuse}: {steps} steps in {wall:.1f} s, "
              f"launches K1 {delta[0]} K2 {delta[1]} K3 {delta[2]} K6 {delta[3]}; loss "
              + " -> ".join(f"{x:.4f}" for x in losses)
              + f"; train-stream acc {evals[-1]['train_stream/accuracy']:.3f}")
    main_launches = {"k1": k16.k1_launches, "k2": k2.launches, "k3": k3.launches,
                     "k6": k16.k6_launches}
    check(k2.plain_routes == 0, f"train: {k2.plain_routes} batches left the front-end kernels")

    preset = flagship.replace(train=dataclasses.replace(flagship.train, max_step=10**9))
    trainer = Trainer(preset, ds, workdir=f"{workdir}/preset", steps_per_call=5)
    trainer.train(5)
    losses = [r["total_loss"] for r in train_records(trainer) if "total_loss" in r]
    check(all(np.isfinite(x) for x in losses), f"preset leg: losses {losses}")
    print(f"[train] preset TCResNet8-1.0 (B=100 f32, backends auto): 5 steps, loss "
          + " -> ".join(f"{x:.4f}" for x in losses))

    # resume: save at step 4, restore in a fresh Trainer, compare 3 more steps
    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        cfg = train_cfg(1536, "on")
        first = Trainer(cfg, ds, workdir=f"{workdir}/resume", steps_per_call=2)
        first.train(4)
        straight = [float(first.train_steps(1, start=4 + i)["total_loss"]) for i in range(3)]
        second = Trainer(cfg, ds, workdir=f"{workdir}/resume", steps_per_call=2)
        check(second.maybe_restore() == 4, "resume: not restored at step 4")
        resumed = [float(second.train_steps(1, start=4 + i)["total_loss"]) for i in range(3)]
    finally:
        torch.backends.cudnn.deterministic = cudnn_det
    check(resumed == straight, f"resume: {resumed} != {straight}")
    print(f"[train] resume at step 4: steps 5-7 losses {resumed} equal the uninterrupted run's")

    # ---- 11. times ----
    ms = {}
    for batch in (1536,):
        idx, sc = draw(batch, 77, flagship.augment)
        decoded = DeviceDataset.decode_rows(ds.wavs, idx, n)
        wavs = k16.augment_reference(ds.wavs, idx, sc, noise, n)
        xla = dataclasses.replace(flagship.audio, dsp_backend="xla")
        pairs = {
            "k1": (lambda: k16.fused_gather_augment(ds.wavs, idx, sc, noise, n),
                   lambda: k16.augment_reference(ds.wavs, idx, sc, noise, n)),
            "k6": (lambda: k16.fused_augment(decoded, sc, noise),
                   lambda: k16.augment_reference(decoded, None, sc, noise, n)),
            "k2": (lambda: k2.fused_mfcc(wavs, flagship.audio),
                   lambda: dsp.preprocess(wavs, xla)),
            "k3": (lambda: k3.frontend_features(ds.wavs, idx, sc, noise, flagship.audio, n),
                   lambda: k3.frontend_reference(ds.wavs, idx, sc, noise, flagship.audio, n)),
        }
        for name, (kernel, plain) in pairs.items():
            a, b, c, d = (device_ms(kernel), device_ms(plain), device_ms(plain), device_ms(kernel))
            ms[name] = (min(a, d), min(b, c))
            print(f"[times] {name} B={batch}: kernel {a:.4f} / {d:.4f} ms, plain {b:.4f} / "
                  f"{c:.4f} ms (CUDA events, median of 20; order kernel, plain, plain, "
                  f"kernel) | {card}")

    # input legs of the train step, each timed twice in the order A B C C B A
    step_legs = {"on (K3)": ("on", "pallas"), "off (K1 + K2)": ("off", "pallas"),
                 "off (K1 + plain MFCC)": ("off", "xla")}
    n_steps = 20
    for batch in (1536, 4096):
        trainers, spans = {}, {label: [] for label in step_legs}
        for label, (fuse, dsp_backend) in step_legs.items():
            cfg = train_cfg(batch, fuse)
            cfg = cfg.replace(audio=dataclasses.replace(cfg.audio, dsp_backend=dsp_backend))
            trainers[label] = Trainer(cfg, ds, workdir=f"{workdir}/t{batch}{fuse}{dsp_backend}")
            trainers[label].train_steps(3, start=0)
        order = list(step_legs) + list(reversed(step_legs))
        for visit, label in enumerate(order):
            trainer = trainers[label]
            torch.cuda.synchronize()
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            ev0.record()
            trainer.train_steps(n_steps, start=3 + visit * n_steps)
            ev1.record()
            torch.cuda.synchronize()
            spans[label].append(((time.perf_counter() - t0) * 1e3 / n_steps,
                                 ev0.elapsed_time(ev1) / n_steps))
        for label, trainer in trainers.items():
            busy_ms = device_busy_ms(lambda: trainer.train_steps(3, start=500)) / 3
            host_ms = sum(h for h, _ in spans[label]) / 2
            dev_ms = sum(d for _, d in spans[label]) / 2
            print(f"[times] train step B={batch} frontend {label}: "
                  + " / ".join(f"{h:.3f}" for h, _ in spans[label]) + " ms/step host, "
                  + " / ".join(f"{d:.3f}" for _, d in spans[label]) + " ms/step CUDA events "
                  f"(two visits of {n_steps} steps), {batch / host_ms * 1e3:,.0f} utt/s, "
                  f"device busy {busy_ms:.3f} ms/step = {busy_ms / dev_ms:.1%} of the step "
                  f"| {card}")

    # bounds at batch 1536: K1 reads the int16 rows and, for the rows this
    # draw mixes, a noise window, and writes f32; K6 reads f32 instead; K2
    # and K3 are the front end's live multiply-adds at the 3xTF32 rate (K3
    # also reads int16 rows)
    kb = 1536  # phase 11's batch, and `sc` its draw
    mixed = int((sc.vols != 0).sum())
    wav_out, feats_out = 4 * kb * n, 4 * kb * 98 * dsp.feature_width(flagship.audio)
    fe_flops = 2 * kb * variant_macs(flagship.audio, "hops")
    bounds = {"k1": bound(0, 2 * kb * n + 4 * mixed * n + wav_out),
              "k6": bound(0, 4 * kb * n + 4 * mixed * n + wav_out),
              "k2": bound(fe_flops, 4 * kb * n + feats_out, TF32X3_FLOPS),
              "k3": bound(fe_flops, 2 * kb * n + 4 * mixed * n + feats_out, TF32X3_FLOPS)}
    # one PyTorch call computing the front end: dsp.preprocess on cuBLAS
    # (K2's plain version is that call; K3's is K1's plain version before
    # it); phase 25 puts K2's and K3's times and the library call's on one
    # clock in their place
    library = {"k1": None, "k6": None, "k2": ms["k2"][1], "k3": ms["k2"][1]}

    def entry(name, source, replaces, err, key):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": main_launches[key], "max_abs_err": err,
                "ms": ms[key][0], "plain_ms": ms[key][1], **bounds[key],
                "library_ms": library[key]}

    return [
        entry("k1_gather_augment", "tcresnet_tpu_torch/csrc/augment.cu",
              "tcresnet_tpu/ops/pallas/augment.py:258", aug_err, "k1"),
        entry("k6_augment", "tcresnet_tpu_torch/csrc/augment.cu",
              "tcresnet_tpu/ops/pallas/augment.py:159", aug_err, "k6"),
        entry("k2_mfcc", "tcresnet_tpu_torch/csrc/mfcc.cu",
              "tcresnet_tpu/ops/pallas/mfcc.py:410", mfcc_err, "k2"),
        entry("k3_frontend", "tcresnet_tpu_torch/csrc/frontend.cu",
              "tcresnet_tpu/ops/pallas/frontend.py:108", front_err, "k3"),
    ], ds


def tconv_phases(dev: torch.device, card: str, ds) -> list:
    """Phases 12-16: K7 and the paths through it, training and evaluation."""
    import tempfile

    from tcresnet_tpu_torch.config import get_preset
    from tcresnet_tpu_torch.data.device_data import DeviceDataset
    from tcresnet_tpu_torch.evaluation.evaluator import Evaluator
    from tcresnet_tpu_torch.ops.kernels import tconv as k7
    from tcresnet_tpu_torch.tools import evaluate as evaluate_cli
    from tcresnet_tpu_torch.tools.train import load_run_config, load_split
    from tcresnet_tpu_torch.train.checkpoint import CheckpointManager
    from tcresnet_tpu_torch.train.trainer import Trainer

    # ---- 12. build (compiled in phase 2, all sources at once) ----
    line = ptxas_line("tconv")
    print(f"[build] tconv.cu for sm_90a | {line}")
    k7.build_kernels()
    # fwd and dx at n8 widths 1-9, dw at its 26 (m16, n8) tile pairs
    tiles = re.findall(r"k7_(fwd|dx|dw)_kernel<([\d,]+)>: \d+ bytes stack frame, (\d+) bytes "
                       r"spill stores", line)
    check(len(tiles) == 18 + 26 and all(b == "0" for *_, b in tiles),
          f"tconv.cu: K7 fwd / dx / dw tiles missing from the ptxas line or spilling: {tiles}")

    # ---- 13. K7 against its plain version ----
    flagship = get_preset("TCResNet8-1.0")
    geoms = conv_geometries(flagship.model, 98, 40)
    geoms14 = conv_geometries(get_preset("TCResNet14-1.5").model, 98, 40)
    gen = torch.Generator(device=dev).manual_seed(1234)

    def conv_inputs(batch, geom, bf16=False):
        k, s, ci, co, t = geom
        x = torch.randn(batch, ci, t, device=dev, generator=gen)
        w = torch.randn(co, ci, k, device=dev, generator=gen) * 0.1
        dy = torch.randn(batch, co, -(-t // s), device=dev, generator=gen)
        if bf16:
            x, w, dy = (a.to(torch.bfloat16).to(torch.float32) for a in (x, w, dy))
        return x, w, dy

    errs = {"fwd": 0.0, "dx": 0.0, "dw": 0.0}
    # an even tap count at stride 3 over 36 channels (tests/test_torch_cuda.py)
    odd = [(4, 3, 36, 36, 98)]
    cases = [(label, b, gs) for b in (1, 8, 1536)
             for label, gs in (("TCResNet8-1.0", geoms), ("TCResNet14-1.5", geoms14),
                               ("k=4 stride 3", odd))]
    for label, batch, gs in cases:
        for bf16 in (False, True):
            worst = {"fwd": 0.0, "dx": 0.0, "dw": 0.0, "dw_rel": 0.0}
            for geom in gs:
                k, s, _, _, t = geom
                x, w, dy = conv_inputs(batch, geom, bf16)
                before = (k7.fwd_launches, k7.dx_launches, k7.dw_launches)
                y, y_again = k7.tconv_fwd(x, w, s), k7.tconv_fwd(x, w, s)
                dx, dx_again = k7.tconv_dx(dy, w, t, s), k7.tconv_dx(dy, w, t, s)
                dw, dw_again = k7.tconv_dw(x, dy, k, s), k7.tconv_dw(x, dy, k, s)
                torch.cuda.synchronize()
                check((k7.fwd_launches, k7.dx_launches, k7.dw_launches)
                      == (before[0] + 2, before[1] + 2, before[2] + 2),
                      f"K7 {geom} B={batch}: launch counters did not advance by one per call")
                check(torch.equal(y, y_again), f"K7 fwd {geom} B={batch}: two calls differ")
                check(torch.equal(dx, dx_again), f"K7 dx {geom} B={batch}: two calls differ")
                want_y = k7.tconv_fwd_reference(x, w, s)
                want_dx = k7.tconv_dx_reference(dy, w, t, s)
                want_dw = k7.tconv_dw_reference(x, dy, k, s)
                check(torch.allclose(y, want_y, **TCONV_FWD_TOL), f"K7 fwd {geom} B={batch}")
                check(torch.allclose(dx, want_dx, **TCONV_DX_TOL), f"K7 dx {geom} B={batch}")
                dw_err = (dw - want_dw).abs().max().item()
                check(dw_err <= TCONV_DW_REL * want_dw.abs().max().item(),
                      f"K7 dw {geom} B={batch}: max err {dw_err}")
                check(torch.equal(dw, dw_again), f"K7 dw {geom} B={batch}: two calls differ")
                worst["fwd"] = max(worst["fwd"], (y - want_y).abs().max().item())
                worst["dx"] = max(worst["dx"], (dx - want_dx).abs().max().item())
                worst["dw"] = max(worst["dw"], dw_err)
                worst["dw_rel"] = max(worst["dw_rel"], dw_err / want_dw.abs().max().item())
            for op in errs:
                errs[op] = max(errs[op], worst[op])
            print(f"[kernel] K7 {label} B={batch} {'bf16-rounded' if bf16 else 'f32'} inputs, "
                  f"{len(gs)} convs: max |err| fwd {worst['fwd']:.2e}, dx {worst['dx']:.2e}, "
                  f"dw {worst['dw']:.2e} ({worst['dw_rel']:.1e} of max|dw|); fwd, dx and dw "
                  f"bit-identical on two calls")

    # ---- 14. train through K7: the main path ----
    workdir = tempfile.mkdtemp(prefix="chip_smoke_k7_")
    run = f"{workdir}/run"
    steps = 30
    cfg = smoke_train_cfg(flagship, 1536, "on", conv_backend="pallas", step_save_checkpoint=10)
    reset_launch_counts()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, ds, workdir=run, steps_per_call=10)
    trainer.train(steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    main_launches = {"fwd": k7.fwd_launches, "dx": k7.dx_launches, "dw": k7.dw_launches}
    records = train_records(trainer)
    losses = [r["total_loss"] for r in records if "total_loss" in r]
    evals = [r for r in records if "train_stream/accuracy" in r]
    # 10 convs: 10 fwd, 10 dw and 9 dx per step (the features need no dx),
    # and 10 fwd per train-stream eval
    want = {"fwd": 10 * steps + 10 * len(evals), "dx": 9 * steps, "dw": 10 * steps}
    check(len(evals) == steps // 10, f"train K7: {len(evals)} train-stream evals")
    check(main_launches == want, f"train K7: launches {main_launches}, want {want}")
    check(all(np.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"train K7: loss did not fall: {losses}")
    check(trainer.ckpt.all_steps() == [10, 20, 30], f"train K7: checkpoints {trainer.ckpt.all_steps()}")
    print(f"[train] B=1536 bf16 conv_backend=pallas: {steps} steps in {wall:.1f} s, K7 launches "
          f"fwd {main_launches['fwd']} dx {main_launches['dx']} dw {main_launches['dw']} "
          f"(per step 10/9/10, per train-stream eval 10 fwd); loss "
          + " -> ".join(f"{x:.4f}" for x in losses)
          + f"; checkpoints {trainer.ckpt.all_steps()}")

    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        first = Trainer(cfg, ds, workdir=f"{workdir}/resume", steps_per_call=2)
        first.train(4)
        straight = [float(first.train_steps(1, start=4 + i)["total_loss"]) for i in range(3)]
        second = Trainer(cfg, ds, workdir=f"{workdir}/resume", steps_per_call=2)
        check(second.maybe_restore() == 4, "resume K7: not restored at step 4")
        resumed = [float(second.train_steps(1, start=4 + i)["total_loss"]) for i in range(3)]
    finally:
        torch.backends.cudnn.deterministic = cudnn_det
    check(resumed == straight, f"resume K7: {resumed} != {straight}")
    print(f"[train] K7 resume at step 4: steps 5-7 losses {resumed} equal the uninterrupted run's")

    preset = flagship.replace(train=dataclasses.replace(flagship.train, max_step=10**9))
    leg = {}
    for backend in ("pallas", "xla"):
        legcfg = preset.replace(model=dataclasses.replace(preset.model, conv_backend=backend))
        tr = Trainer(legcfg, ds, workdir=f"{workdir}/preset_{backend}")
        leg[backend] = [float(tr.train_steps(1, start=i)["total_loss"]) for i in range(5)]
    rels = [abs(a - b) / abs(b) for a, b in zip(leg["pallas"], leg["xla"])]
    rel = max(rels)
    check(rels[0] <= FIRST_STEP_RTOL and rel <= TRAIN_LEG_RTOL,
          f"preset leg: pallas {leg['pallas']} vs xla {leg['xla']}")
    print(f"[train] preset TCResNet8-1.0 (B=100 f32), same weights and draws, 5 steps: pallas "
          + " ".join(f"{x:.6f}" for x in leg["pallas"]) + " | xla (TF32 off) "
          + " ".join(f"{x:.6f}" for x in leg["xla"]) + " | rel diff "
          + " ".join(f"{x:.1e}" for x in rels)
          + f" (limits {FIRST_STEP_RTOL} at step 1, {TRAIN_LEG_RTOL} over 5)")

    # ---- 15. evaluate: the loop evaluator over the run ----
    run_cfg = load_run_config(run)
    reset_launch_counts()
    t0 = time.perf_counter()
    evaluate_cli.main(["--train-dir", run, "--synthetic", "--split", "valid",
                       "--valid-type", "loop", "--cfg", "mesh.data=1"])
    torch.cuda.synchronize()
    eval_wall = time.perf_counter() - t0
    eval_launches = k7.fwd_launches
    scored = {r["step"]: r for r in map(json.loads,
                                        open(f"{run}/valid_metrics.jsonl").read().splitlines())}
    n_valid = max(24_100 // 8, 128)
    batches = -(-n_valid // run_cfg.data.eval_batch_size)
    check(sorted(scored) == [10, 20, 30] and all(r["num_samples"] == n_valid
                                                  for r in scored.values()),
          f"evaluate: scored steps {sorted(scored)}")
    check((eval_launches, k7.dx_launches, k7.dw_launches) == (10 * batches * 3, 0, 0),
          f"evaluate: K7 launches fwd {eval_launches} dx {k7.dx_launches} dw {k7.dw_launches}")
    best_step = CheckpointManager(f"{run}/best/valid/accuracy").latest_step()
    check(best_step in scored, f"evaluate: best/valid/accuracy holds {best_step}")
    again = evaluate_cli.main(["--train-dir", run, "--synthetic", "--split", "valid",
                               "--valid-type", "once", "--best-metric", "accuracy",
                               "--cfg", "mesh.data=1"])
    for key in ("accuracy", "loss", "mAP_macro"):
        check(again[key] == scored[best_step][key],
              f"evaluate once: {key} {again[key]} != {scored[best_step][key]}")
    print(f"[evaluate] loop over {run}: checkpoints {sorted(scored)} scored once each on "
          f"{n_valid} valid rows ({batches} batches of {run_cfg.data.eval_batch_size}, the last "
          f"padded) in {eval_wall:.1f} s, K7 fwd launches {eval_launches} = 10 x {batches} x 3; "
          "accuracy " + " ".join(f"{scored[s]['accuracy']:.4f}" for s in sorted(scored))
          + f"; best/valid/accuracy = step {best_step}, re-scored identically "
          f"(accuracy {again['accuracy']:.4f}, loss {again['loss']:.6f})")

    valid = DeviceDataset(load_split(run_cfg, "valid"), dev)
    saved = torch.load(CheckpointManager(f"{run}/ckpt").path(30), map_location="cpu",
                       weights_only=True)
    f32 = run_cfg.replace(train=dataclasses.replace(run_cfg.train, compute_dtype="float32"))
    res = {}
    for backend in ("pallas", "xla"):
        ev = Evaluator(f32.replace(model=dataclasses.replace(f32.model, conv_backend=backend)),
                       valid)
        res[backend] = ev.evaluate(saved["params"], saved["batch_stats"], include_report=False)
    # loss within 1e-5, relative once it exceeds 1 (after 30 steps the BN
    # running statistics are still mostly their initial values, so the
    # eval-mode loss can be large)
    dloss = abs(res["pallas"]["loss"] - res["xla"]["loss"]) / max(1.0, abs(res["xla"]["loss"]))
    dacc = abs(res["pallas"]["accuracy"] - res["xla"]["accuracy"]) * n_valid
    check(dloss <= 1e-5 and dacc <= 1 + 1e-6,
          f"evaluate pallas vs xla: loss differs by {dloss}, accuracy by {dacc} samples")
    print(f"[evaluate] step 30, float32, pallas vs xla (TF32 off): loss "
          f"{res['pallas']['loss']:.7f} vs {res['xla']['loss']:.7f} (rel diff {dloss:.1e}), accuracy "
          f"{res['pallas']['accuracy']:.5f} vs {res['xla']['accuracy']:.5f} ({dacc:.0f} samples)")

    # ---- 16. times ----
    batch = 1536
    convs = conv_cases(dev, geoms, batch, gen)
    ops = conv_ops()

    def ten(f):
        return lambda: [f(c) for c in convs]

    # behind a device sleep (CUDA events time the device's work, not the
    # host's launches; tools/tconv_times.py), in the order kernel, cuDNN,
    # cuDNN, kernel; the eager reading beside it counts the gaps the host
    # leaves between the launches
    queued = k7_times(convs)
    quoted = {"fwd": FP32_K7_FWD_MS, "dx": FP32_K7_DX_MS, "dw": FP32_K7_DW_MS}
    ms = {}
    for op, (kernel, plain, cudnn) in ops.items():
        (a, d), (b, c), full = (queued[op]["ten"][key] for key in ("kernel", "cudnn", "queue_full"))
        ek, ep, ec = device_ms(ten(kernel)), device_ms(ten(plain)), device_ms(ten(cudnn))
        ms[op] = dict(ms=min(a, d), library_ms=min(b, c), plain_ms=ep, ms_eager=ek,
                      library_ms_eager=ec, queue_full=full)
        fp32 = (f"; the FP32-FMA design (quoted, not this run): {quoted[op]} ms, "
                f"{quoted[op] / min(a, d):.2f}x this run's" if op in quoted else "")
        print(f"[times] K7 {op} B={batch}, the ten convs of one step, behind a device sleep: "
              f"kernel {a:.4f} / {d:.4f} ms, cuDNN f32 (TF32 off) {b:.4f} / {c:.4f} ms (mean of "
              f"20; order kernel, cuDNN, cuDNN, kernel; "
              + ("queue full" if full else "a queue DRAINED: host-paced") + ") | eager (host gaps "
              f"included, median of 20): kernel {ek:.4f} ms, plain {ep:.4f} ms, cuDNN {ec:.4f} ms"
              f"{fp32} | {card}")
    nine = queued["dx"]["nine"]
    (a, d), (b, c) = nine["kernel"], nine["cudnn"]
    ms["dx"].update(ms_nine=min(a, d), library_ms_nine=min(b, c))
    print(f"[times] K7 dx B={batch}, the nine convs a step launches dx for (not conv 0: its input, "
          f"the features, needs no gradient), behind a device sleep: kernel {a:.4f} / {d:.4f} ms, "
          f"cuDNN f32 {b:.4f} / {c:.4f} ms ({min(a, d) / min(b, c):.2f}x; "
          + ("queue full" if nine["queue_full"] else "a queue DRAINED: host-paced") + f") | {card}")
    # the library calls a bf16 `xla` step makes: cuDNN on bf16 tensors (K7
    # computes in float32, 3xTF32, so its yardstick above is cuDNN f32);
    # the device time torch.profiler sums over 5 runs, which the host's
    # pace does not inflate
    convs16 = [{**c, **{key: c[key].to(torch.bfloat16) for key in ("x", "w", "dy", "xp")}}
               for c in convs]
    for op, (kernel, _, cudnn) in ops.items():
        t16, t32, tk = (device_times_ms(lambda f=f, cs=cs: [f(c) for _ in range(5) for c in cs])[0] / 5
                        for f, cs in ((cudnn, convs16), (cudnn, convs), (kernel, convs)))
        ms[op]["cudnn_bf16_ms"] = t16
        print(f"[times] K7 {op} B={batch}, the ten convs of one step, summed device time "
              f"(torch.profiler, 5 runs): kernel {tk:.4f} ms, cuDNN f32 {t32:.4f} ms, cuDNN bf16 on "
              f"bf16 tensors (the `xla` step's call under bf16 compute) {t16:.4f} ms "
              f"({tk / t16:.2f}x) | {card}")
    for i, conv in enumerate(convs):
        parts = []
        for op in ops:
            r = queued[op]["per_conv"][i]
            parts.append(f"{op} {r['kernel']:.4f} / cuDNN {r['cudnn']:.4f} ms "
                         f"({r['kernel'] / r['cudnn']:.2f}x)"
                         + ("" if r["queue_full"] else " (a queue DRAINED)"))
        print(f"[times] K7 conv {i} (k, s, Ci, Co, T) = {conv['geom']} B={batch}, behind a device "
              f"sleep: " + ", ".join(parts) + f" | {card}")
    # the host's cost of launching the ten fwd convs (the enqueue alone)
    enqueue = {name: enqueue_us(ten(f)) for name, f in (("kernel", ops["fwd"][0]),
                                                         ("cuDNN", ops["fwd"][2]))}
    ms["fwd"]["host_enqueue_us"] = enqueue["kernel"]
    print(f"[times] K7 fwd, host enqueue of the ten convs: kernel {enqueue['kernel']:.1f} us, cuDNN "
          f"{enqueue['cuDNN']:.1f} us (median of 50 enqueues, each after a synchronize) | {card}")

    trainers, spans = {}, {"pallas": [], "xla": []}
    for backend in spans:
        tcfg = smoke_train_cfg(flagship, batch, "on", conv_backend=backend)
        trainers[backend] = Trainer(tcfg, ds, workdir=f"{workdir}/t_{backend}")
        trainers[backend].train_steps(3, start=0)
    n_steps = 20
    for visit, backend in enumerate(["pallas", "xla", "xla", "pallas"]):
        torch.cuda.synchronize()
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        ev0.record()
        trainers[backend].train_steps(n_steps, start=3 + visit * n_steps)
        ev1.record()
        torch.cuda.synchronize()
        spans[backend].append(((time.perf_counter() - t0) * 1e3 / n_steps,
                               ev0.elapsed_time(ev1) / n_steps))
    for backend, trainer in trainers.items():
        activities = device_spans(lambda: trainer.train_steps(3, start=500))
        busy_ms = sum(r.elapsed_us() for _, r in activities) / 3e3 or float("nan")
        host_ms = sum(h for h, _ in spans[backend]) / 2
        dev_ms = sum(d for _, d in spans[backend]) / 2
        print(f"[times] train step B={batch} bf16 conv_backend={backend} (K3 input): "
              + " / ".join(f"{h:.3f}" for h, _ in spans[backend]) + " ms/step host, "
              + " / ".join(f"{d:.3f}" for _, d in spans[backend]) + " ms/step CUDA events "
              f"(two visits of {n_steps} steps), {batch / host_ms * 1e3:,.0f} utt/s, device busy "
              f"{busy_ms:.3f} ms/step = {busy_ms / dev_ms:.1%} of the step | {card}")
        # where the busy time goes: the step's device activities by kind and
        # the costliest by name (torch.profiler over the same 3 steps)
        kinds, top = step_kernels(activities, 3)
        print(f"[times] train step B={batch} bf16 conv_backend={backend}, device time a step by "
              "kind: " + ", ".join(f"{kind} {t:.3f} ms ({n:.0f} launches)"
                                   for kind, (t, n) in kinds.items()) + f" | {card}")
        for t, n, name in top[:12]:
            print(f"[times]   {backend}: {t:.4f} ms, {n:.0f} launches a step: {name[:120]}")

    evaluators = {backend: Evaluator(run_cfg.replace(model=dataclasses.replace(
        run_cfg.model, conv_backend=backend)), valid) for backend in ("pallas", "xla")}
    eval_s = {backend: [] for backend in evaluators}
    for backend in evaluators:
        evaluators[backend].evaluate(saved["params"], saved["batch_stats"], include_report=False)
    for backend in ("pallas", "xla", "xla", "pallas"):
        t0 = time.perf_counter()
        scores = evaluators[backend].evaluate(saved["params"], saved["batch_stats"],
                                              include_report=False)
        eval_s[backend].append((time.perf_counter() - t0, scores["batch_infer_time"]))
    eval_batch = run_cfg.data.eval_batch_size
    for backend, runs in eval_s.items():
        print(f"[times] eval bf16 conv_backend={backend}: {n_valid} valid rows in "
              + " / ".join(f"{s * 1e3:.1f}" for s, _ in runs) + " ms (host clock, two runs), "
              f"{n_valid / min(s for s, _ in runs):,.0f} utt/s; one synchronised batch of "
              f"{eval_batch} " + " / ".join(f"{b * 1e3:.2f}" for _, b in runs) + " ms, "
              f"{eval_batch / min(b for _, b in runs):,.0f} utt/s | {card}")

    # bounds over the ten convs at batch 1536 (tools/tconv_times.py::conv_work)
    k7_flops, k7_bytes = (sum(w) for w in zip(*(conv_work(g, batch) for g in geoms)))

    def entry(op, line):
        return {"name": f"k7_tconv_{op}", "route": "cuda",
                "source": "tcresnet_tpu_torch/csrc/tconv.cu",
                "replaces": f"tcresnet_tpu/ops/pallas/tconv.py:{line}",
                "launches": main_launches[op], "max_abs_err": errs[op],
                **ms[op], **bound(k7_flops, k7_bytes, TF32X3_FLOPS),
                "cudnn_ms": ms[op]["library_ms"]}

    return [entry("fwd", 63), entry("dx", 68), entry("dw", 99)]


def infer2d_phases(dev: torch.device, card: str) -> list:
    """Phases 17-20: K5 and the 2D families' serving path through it."""
    from tcresnet_tpu_torch.config import get_preset
    from tcresnet_tpu_torch.models import build_model
    from tcresnet_tpu_torch.models.convert import seeded_variables, variables_from_jax
    from tcresnet_tpu_torch.models.kws import KWS_ARCHITECTURES
    from tcresnet_tpu_torch.ops import dsp
    from tcresnet_tpu_torch.ops.kernels import _build
    from tcresnet_tpu_torch.ops.kernels import infer2d as k5
    from tcresnet_tpu_torch.ops.kernels import mfcc as k2
    from tcresnet_tpu_torch.serve.benchmark import benchmark_compiled
    from tcresnet_tpu_torch.serve.export import build_inference_fn

    # ---- 17. build (compiled in phase 2, all sources at once) ----
    k5.build_kernels()
    print(f"[build] infer2d.cu for sm_90a | {ptxas_line('infer2d')} | cooperative grid "
          f"{k5.grid_blocks(dev)} blocks x 256 threads")

    def cfg_of(preset, arch=None):
        cfg = get_preset(preset)
        if arch is not None:
            cfg = cfg.replace(model=dataclasses.replace(cfg.model, kws_architecture=arch))
        return cfg

    def variables_for(cfg, seed):
        v = variables_from_jax(cfg.model, **seeded_variables(
            cfg.model, dsp.feature_shape(cfg.audio), seed))
        return {k: {name: t.to(dev) for name, t in d.items()} for k, d in v.items()}

    def plan_for(cfg, seed=0):
        v = variables_for(cfg, seed)
        return k5.build_fused_infer2d(cfg.model, cfg.audio, v["params"], v["batch_stats"],
                                      device=dev)

    def wavs_for(cfg, seed, batch):
        return torch.tensor(seeded_wavs(seed, batch, cfg.audio.desired_samples), device=dev)

    # ---- 18. K5 against its plain version, K2 at 640/320, the golden ----
    presets = ["TCResNet2D8-1.0", "TCResNet2D8Pool-1.0", "Res8", "Res8Narrow", "Res15",
               "Res15Narrow", "DSCNNS", "DSCNNM", "DSCNNL"]
    cases = [(p, None) for p in presets] + [("KWSfpool3", a) for a in KWS_ARCHITECTURES]
    timed_presets = ("TCResNet2D8-1.0", "Res15", "DSCNNL", "KWSfpool3")
    k5_err = 0.0
    for preset, arch in cases:
        cfg = cfg_of(preset, arch)
        plan = plan_for(cfg)
        errs = []
        big = (1024,) if arch is None and preset in timed_presets else ()
        for batch in (1, 3, 8, 64) + big:
            feats = k2.fused_mfcc(wavs_for(cfg, 700 + batch, batch), cfg.audio)
            before = k5.launches
            got, again = k5.fused_infer2d(feats, plan), k5.fused_infer2d(feats, plan)
            torch.cuda.synchronize()
            check(k5.launches == before + 2, f"K5 {preset} {arch} B={batch}: not launched")
            check(torch.equal(got, again), f"K5 {preset} {arch} B={batch}: two calls differ")
            want = k5.fused_infer2d_reference(feats, plan)
            check(got.shape == want.shape == (batch, cfg.model.num_classes), f"K5 {preset}: shape")
            check(bool(torch.isfinite(got).all()), f"K5 {preset} {arch} B={batch}: non-finite")
            err = (got - want).abs().max().item()
            sm_err = (torch.softmax(got, -1) - torch.softmax(want, -1)).abs().max().item()
            check(torch.allclose(got, want, atol=LOGIT_ATOL, rtol=LOGIT_RTOL),
                  f"K5 {preset} {arch} B={batch}: logits differ by {err}")
            check(sm_err <= SOFTMAX_ATOL, f"K5 {preset} {arch} B={batch}: softmax {sm_err}")
            k5_err = max(k5_err, err)
            errs.append(f"B={batch} {err:.2e}/{sm_err:.2e}")
        label = preset if arch is None else f"KWS {arch}"
        print(f"[kernel] K5 {label} ({len(plan.program)} steps, "
              f"{plan.macs_per_utterance():,} multiply-adds/utt): max |logit| / |softmax| err "
              f"vs plain: " + ", ".join(errs) + "; two calls equal bit for bit")

    for label, preset in (("MFCC-10 (DS-CNN, 49x10)", "DSCNNS"),
                          ("MFCC-40 (KWS, 49x40)", "KWSfpool3")):
        audio = get_preset(preset).audio
        errs = []
        for batch in (1, 64, 1536):
            wavs = torch.tensor(seeded_wavs(800 + batch, batch, audio.desired_samples), device=dev)
            before = k2.launches
            got = k2.fused_mfcc(wavs, audio)
            torch.cuda.synchronize()
            check(k2.launches == before + 1, "K2 not launched")
            want = dsp.preprocess(wavs, dataclasses.replace(audio, dsp_backend="xla"))[..., 0]
            check(got.shape == want.shape == (batch,) + dsp.feature_shape(audio)[:2], "K2 shape")
            err = (got - want).abs().max().item()
            check(torch.allclose(got, want, atol=FEATURE_ATOL, rtol=0),
                  f"K2 640/320 {label} B={batch}: max err {err}")
            errs.append(f"B={batch} {err:.2e}")
        print(f"[front] K2 at 640/320 {label} vs plain (TF32 off): " + ", ".join(errs))

    golden = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "tcresnet_tpu_torch", "testdata", "infer2d_golden.npz"))
    gerrs = []
    for i, preset in enumerate(str(p) for p in golden["presets"]):
        cfg = cfg_of(preset)
        plan = plan_for(cfg, int(golden["param_seed"]))
        wavs = wavs_for(cfg, int(golden["wav_seed"]), int(golden["batch"]))
        gsm = torch.softmax(plan(wavs), -1).cpu().numpy()
        gerr = float(np.abs(gsm - golden["softmax"][i]).max())
        check(gerr <= SOFTMAX_ATOL, f"golden {preset}: K2 + K5 softmax differs from JAX by {gerr}")
        gerrs.append(f"{preset} {gerr:.2e}")
    print(f"[golden] K2 + K5 softmax vs JAX (B={int(golden['batch'])}, limit {SOFTMAX_ATOL}): "
          + ", ".join(gerrs))

    # ---- 19. serve: the 2D main path ----
    served = {}
    for preset in ("Res15", "DSCNNL", "KWSfpool3"):
        cfg = cfg_of(preset)
        v = variables_for(cfg, seed=0)
        served[preset] = (cfg, build_inference_fn(cfg, v, backend="auto", device=dev),
                          build_inference_fn(cfg, v, backend="xla", precision="highest",
                                             device=dev))
    requests = {p: [wavs_for(c, 1100 + i, 1) for i in range(20)] + [wavs_for(c, 2100, 64)]
                for p, (c, _, _) in served.items()}
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    answers = {p: [auto(x) for x in requests[p]] for p, (_, auto, _) in served.items()}
    torch.cuda.synchronize()
    serve_ms = (time.perf_counter() - t0) * 1e3
    main_launches, k2_main = k5.launches, k2.launches
    n_single = 20 * len(served)
    check(main_launches == k2_main == n_single and k2.plain_routes == 0,
          f"serve 2D: K5 {main_launches} / K2 {k2_main} launches for {n_single} single requests, "
          f"{k2.plain_routes} plain routes")
    serve_err = {}
    for preset, (cfg, _, ref) in served.items():
        worst = 0.0
        for x, y in zip(requests[preset], answers[preset]):
            check(y.shape == (x.shape[0], cfg.model.num_classes), f"serve {preset}: shape")
            check(bool(torch.isfinite(y).all()), f"serve {preset}: non-finite softmax")
            worst = max(worst, (y - ref(x)).abs().max().item())
        check(worst <= SOFTMAX_ATOL, f"serve {preset}: auto vs xla/highest differ by {worst}")
        serve_err[preset] = worst
    print(f"[serve] auto, Res15 / DSCNNL / KWSfpool3: 20 x B=1 each (K2 + K5, {main_launches} "
          f"K5 and {k2_main} K2 launches) + 1 x B=64 each (plain) in {serve_ms:.1f} ms; max "
          "softmax err vs xla/highest " + ", ".join(f"{p} {e:.2e}" for p, e in serve_err.items()))

    # ---- 20. times ----
    # K5, its plain version and the cuDNN model (TF32 off) on one clock:
    # CUDA events around calls the host enqueues behind a device sleep. The
    # cuDNN model runs as a CUDA graph (one launch a call): eager, its ~100
    # launches a call fill the launch queue behind the sleep within 10 calls
    # and the host then waits (no call of the path synchronises: tests/
    # test_torch_cuda.py::test_xla_serving_path_does_not_synchronise). The
    # library time is the least of the graph, eager and profiler readings
    def k5_prefix(plan, feats, n_ops):
        """K5 on the program's first n_ops steps (the last kept step writes
        its slot, not the logits): for per-step attribution."""
        out = torch.empty((feats.shape[0], plan.ncls), device=dev)
        ws, partial = plan.buffers(feats.shape[0])
        args = plan.kernel_args(feats, out, ws, partial)
        args.n_ops = n_ops
        buffers = (out, ws, partial)  # alive as long as the launcher is
        return lambda: _build.launch(k5._library(), "k5_infer2d", "k5_error_string", args,
                                     buffers[0].device)

    times, steps = {}, {}
    for preset in timed_presets:
        cfg = cfg_of(preset)
        v = variables_for(cfg, seed=0)
        plan = k5.build_fused_infer2d(cfg.model, cfg.audio, v["params"], v["batch_stats"],
                                      device=dev)
        model = build_model(cfg.model, dsp.feature_shape(cfg.audio), device=dev)
        model.load_state_dict({**v["params"], **v["batch_stats"]})
        fused_fn = build_inference_fn(cfg, v, backend="fused", device=dev)
        xla_fn = build_inference_fn(cfg, v, backend="xla", precision="highest", device=dev)
        for batch in (1, 1024):
            wavs = wavs_for(cfg, 3000 + batch, batch)
            feats = k2.fused_mfcc(wavs, cfg.audio)
            feats4 = feats[..., None]
            heavy = batch > 1 and plan.macs_per_utterance() > 1e8
            runs = 3 if heavy else 20
            with torch.no_grad():
                replay, graph_out = graph_of(lambda: model(feats4))
                replay()
                torch.cuda.synchronize()
                check(torch.allclose(graph_out, model(feats4), atol=1e-6, rtol=0),
                      f"{preset} B={batch}: the cuDNN graph differs from the model")
                timed = [queued_ms(fn, runs) for fn in (
                    lambda: k5.fused_infer2d(feats, plan),
                    lambda: k5.fused_infer2d_reference(feats, plan),
                    replay, replay,
                    lambda: k5.fused_infer2d(feats, plan))]
                # more readings of the cuDNN model: eager calls on the same
                # clock (5 calls, so that their launches fit the queue, and
                # one call alone, beside one K5 call alone; a host-paced
                # reading is dropped), and under torch.profiler one eager
                # call's device time and five back-to-back calls' device
                # time and span (per call), with the device activities each
                # saw (a one-call reading that saw fewer than a fifth of the
                # five calls' is dropped)
                eager, eager_full = queued_ms(lambda: model(feats4), 5)
                eager1, eager1_full = queued_ms(lambda: model(feats4), 1)
                k5_one = queued_ms(lambda: k5.fused_infer2d(feats, plan), 1)[0]
                busy_lib, _, n_one = device_times_ms(lambda: model(feats4))
                busy5, span5, n_five = device_times_ms(lambda: [model(feats4) for _ in range(5)])
                busy5, span5 = busy5 / 5, span5 / 5
                if preset in ("Res15", "KWSfpool3"):
                    cum = [queued_ms(k5_prefix(plan, feats, n), runs)[0]
                           for n in range(1, len(plan.program) + 1)]
                    steps[(preset, batch)] = [
                        (op.kind if op.kind != "conv" else f"conv-{op.mode}",
                         f"{op.t_out}x{op.f_out}x{op.c_out}", t)
                        for op, t in zip(plan.program, [cum[0]] + [
                            b - a for a, b in zip(cum, cum[1:])])]
            (a, b, c, c2, d), full = zip(*timed)
            for name, ok in zip(("K5", "cuDNN graph", "cuDNN graph", "K5"),
                                (full[0], full[2], full[3], full[4])):
                check(ok, f"{preset} B={batch}: the {name} time is host-paced")
            host_fused = benchmark_compiled(fused_fn, wavs, warmup_runs=2, num_runs=runs)
            host_xla = benchmark_compiled(xla_fn, wavs, warmup_runs=2, num_runs=runs)
            flops = 2 * batch * plan.macs_per_utterance()
            nbytes = 4 * (feats.numel() + plan.wts.numel() + batch * plan.ncls)
            # the library yardstick: the fastest reading of the cuDNN model
            lib_readings = ([c, c2, busy5] + ([busy_lib] if 5 * n_one >= n_five else [])
                            + ([eager] if eager_full else []) + ([eager1] if eager1_full else []))
            times[(preset, batch)] = dict(
                ms=min(a, d), plain_ms=b, one_call_ms=k5_one,
                library_ms=min(x for x in lib_readings if not math.isnan(x)),
                library_graph_ms=min(c, c2), library_eager_ms=eager if eager_full else None,
                library_one_call_ms=eager1 if eager1_full else None,
                library_profiler_ms=busy_lib, **bound(flops, nbytes, TF32X3_FLOPS))
            t = times[(preset, batch)]
            paced = "plain" if not full[1] else "none"
            pr5_k5, pr5_lib = PR5_K5_MS[(preset, batch)]
            print(f"[times] K5 {preset} B={batch}: kernel {a:.4f} / {d:.4f} ms, plain {b:.4f} ms, "
                  f"cuDNN model f32 (TF32 off) as a CUDA graph {c:.4f} / {c2:.4f} ms (device, mean "
                  f"of {runs} behind a device sleep; order kernel, plain, cuDNN, cuDNN, kernel; "
                  f"host-paced: {paced}); bound {t['bound_ms']:.4f} ms ({t['bound_by']} at "
                  f"3xTF32 {TF32X3_FLOPS / 1e12:.0f} TFLOP/s, {t['bound_ms'] / t['ms']:.1%} of it)"
                  f"; PR 5 (quoted, not this run): kernel {pr5_k5} ms, cuDNN {pr5_lib} ms | {card}")
            print(f"[times] K5 {preset} B={batch}: the cuDNN model eager behind a device sleep, "
                  f"5 calls {eager:.4f} ms (host-paced: {'no' if eager_full else 'yes, dropped'}), "
                  f"1 call {eager1:.4f} ms (host-paced: {'no' if eager1_full else 'yes, dropped'})"
                  f" against 1 K5 call {k5_one:.4f} ms; one eager call's device time "
                  f"(torch.profiler) {busy_lib:.4f} ms over {n_one} device activities"
                  f"{'' if 5 * n_one >= n_five else ' (dropped: too few)'}, five "
                  f"back-to-back calls' {busy5:.4f} ms and span {span5:.4f} ms per call over "
                  f"{n_five} (torch.profiler); library "
                  f"{t['library_ms']:.4f} ms (the least reading); served request wav -> softmax "
                  f"host avg fused (K2 + K5) {host_fused['avg'] / 1e3:.4f} ms, xla "
                  f"{host_xla['avg'] / 1e3:.4f} ms | {card}")
            if (preset, batch) in steps:
                print(f"[times] K5 {preset} B={batch} per step (the program cut after each step, "
                      f"successive differences, ms): " + " | ".join(
                          f"{kind} {shape} {ms:.4f}" for kind, shape, ms in steps[(preset, batch)]))

    main = times[("Res15", 1)]
    return [{
        "name": "k5_infer2d", "route": "cuda",
        "source": "tcresnet_tpu_torch/csrc/infer2d.cu",
        "replaces": "tcresnet_tpu/ops/pallas/infer2d.py:666",
        "launches": main_launches, "max_abs_err": k5_err,
        "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "timed": "Res15, batch 1",
        "by_preset": {f"{p} B={b}": t for (p, b), t in times.items()},
        "steps_ms": {f"{p} B={b}": [[k, sh, ms] for k, sh, ms in st]
                     for (p, b), st in steps.items()},
    }]


def variant_macs(audio, variant: str) -> int:
    """Multiply-adds one clip needs in a DFT variant: K2's and K8's every
    frame's window against the bins below the Nyquist bin, whose mel weight
    is zero (window x fft a frame: the live rows of W_p; the zero rows, and
    the stage's rows past the hop in each chunk, need no work), and the
    mel's nonzero weights (`mfcc.tc_mel_constants`); K9's its factored products over their live
    columns (M0's and M2's k2 < L/2: L x L each; M1: 2L x 2L; 6L^2 per
    frame: the zeroed columns need no work, nor M0's k2 = L/2, the Nyquist
    bin) and the mel's nonzero weights (`mfcc.radix4_kernel_constants`);
    all with the DCT for MFCC."""
    from tcresnet_tpu_torch.ops import dsp
    from tcresnet_tpu_torch.ops.kernels import mfcc

    g = mfcc.front_end_geometry(audio, audio.desired_samples)
    dct = 0 if g.magnitude else g.frames * g.num_mel * g.width
    if variant in ("hops", "phases"):
        nnz = mfcc.tc_mel_constants(*dsp.mel_args(audio))[1].size
        return g.frames * (g.window * g.fft_length + nnz) + dct
    length = g.fft_length // 4
    nnz = mfcc.radix4_kernel_constants(*dsp.radix4_mel_args(audio))[2].size
    return g.frames * (6 * length * length + nnz) + dct


def dft_variant_phases(dev: torch.device, card: str, ds) -> list:
    """Phases 21-24: K8 and K9 (the MFCC kernel's and K3's phases and
    radix4 entry points) and the 2D families' training path through them."""
    import tempfile

    from tcresnet_tpu_torch.config import get_preset
    from tcresnet_tpu_torch.data.device_data import DeviceDataset
    from tcresnet_tpu_torch.ops import augment as aug
    from tcresnet_tpu_torch.ops import dsp
    from tcresnet_tpu_torch.ops.kernels import augment as k16
    from tcresnet_tpu_torch.ops.kernels import frontend as k3
    from tcresnet_tpu_torch.ops.kernels import infer2d as k5
    from tcresnet_tpu_torch.ops.kernels import mfcc as k2
    from tcresnet_tpu_torch.serve.export import build_inference_fn
    from tcresnet_tpu_torch.tools import evaluate as evaluate_cli
    from tcresnet_tpu_torch.train.trainer import Trainer

    # ---- 21. build (compiled in phase 2, all sources at once) ----
    k2.build_kernels()
    k3.build_kernels()
    for name in ("mfcc", "frontend"):
        line = ptxas_line(name)
        print(f"[build] {name}.cu for sm_90a, entry points by DFT variant | {line}")
        spills = re.findall(r"(hops\+phases|radix4) (\d+)-row: \d+ bytes stack frame, (\d+) "
                            r"bytes spill stores", line)
        tiles = [(int(r), int(b)) for v, r, b in spills if v == "hops+phases"]
        check(sorted(r for r, _ in tiles) == [16, 64, 128] and all(b == 0 for _, b in tiles),
              f"{name}.cu: the hops / K8 tiles spill: {tiles}")
        k9 = [int(b) for v, r, b in spills if v == "radix4" and r == "112"]
        check(len(k9) == 1 and k9[0] <= K9_SPILL_BYTES[name],
              f"{name}.cu: K9's 112-row product spills {k9} bytes, more than "
              f"{K9_SPILL_BYTES[name]}")

    def counts(module):
        return (module.launches, module.phases_launches, module.radix4_launches)

    def one(variant):
        return tuple(int(v == variant) for v in ("hops", "phases", "radix4"))

    kname = {"hops": "K2", "phases": "K8", "radix4": "K9"}

    # ---- 22. K8 and K9 against their plain versions ----
    n = 16000
    flagship_audio = get_preset("TCResNet8-1.0").audio
    geoms = {"480/160 MFCC-40": flagship_audio,
             "640/320 MFCC-10": get_preset("DSCNNL").audio,
             "640/320 MFCC-40": get_preset("KWSfpool3").audio,
             # K2 alone: a hop and a window that are no multiples of 32
             # (chunks of 224 samples, the constant's rows past 200 zero)
             "400/200 MFCC-40": dataclasses.replace(flagship_audio, window_size_ms=25.0,
                                                    window_stride_ms=12.5),
             "320/160 MFCC-40": dataclasses.replace(flagship_audio, window_size_ms=20.0)}
    errs = {"hops": 0.0, "phases": 0.0, "radix4": 0.0}
    for label, audio in geoms.items():
        for variant in ("hops",) if label[:3] in ("400", "320") else ("hops", "phases", "radix4"):
            base = dataclasses.replace(audio, dft_variant=variant)
            for feat, cfg, tol in (
                    ("mfcc", base, (FEATURE_ATOL, 0.0)),
                    ("log-mel", dataclasses.replace(base, preprocess_method="log_mel_spectrogram"),
                     (FEATURE_ATOL, 0.0)),
                    ("mfcc bf16-dft", dataclasses.replace(base, dsp_matmul_dtype="bfloat16"),
                     (BF16_TOL, BF16_TOL))):
                check(k2.resolve_dft_variant(cfg, n) == variant, f"{label} {variant}: resolves")
                line = []
                for batch in (1, 8, 1536):
                    wavs = torch.tensor(seeded_wavs(4000 + batch, batch, n), device=dev)
                    before = counts(k2)
                    got = k2.fused_mfcc(wavs, cfg)
                    torch.cuda.synchronize()
                    delta = tuple(a - b for a, b in zip(counts(k2), before))
                    check(delta == one(variant), f"{kname[variant]} {label}: launches {delta}")
                    want = k2.fused_mfcc_reference(wavs, cfg, variant)
                    check(got.shape == want.shape == (batch,) + dsp.feature_shape(cfg)[:2],
                          f"{kname[variant]} {label} {feat}: shape {tuple(got.shape)}")
                    check(torch.equal(got, k2.fused_mfcc(wavs, cfg)),
                          f"{kname[variant]} {label} {feat} B={batch}: two calls differ")
                    if variant != "radix4" and batch > 1:
                        # a row's sum does not depend on the tile it lands in
                        check(torch.equal(k2.fused_mfcc(wavs[:1], cfg), got[:1]),
                              f"{kname[variant]} {label} {feat}: batch 1 differs from row 0 of "
                              f"B={batch}")
                    if variant == "hops" and label[:3] not in ("400", "320"):
                        # K2 and K8 are one stage
                        check(torch.equal(got, k2.fused_mfcc(wavs, dataclasses.replace(
                            cfg, dft_variant="phases"))), f"K2 {label} {feat}: differs from K8")
                    check(bool(torch.isfinite(got).all()), f"{kname[variant]} {label}: non-finite")
                    err = (got - want).abs().max().item()
                    check(torch.allclose(got, want, atol=tol[0], rtol=tol[1]),
                          f"{kname[variant]} {label} {feat} B={batch}: max err {err}")
                    if tol[1] == 0.0:
                        errs[variant] = max(errs[variant], err)
                    line.append(f"B={batch} {err:.2e}")
                print(f"[kernel] {kname[variant]} ({variant}) {label} {feat} vs plain (TF32 off, "
                      f"atol {tol[0]}): " + ", ".join(line) + "; two calls equal bit for bit"
                      + ("; batch 1 equal to row 0 of batch 8 and 1536 bit for bit"
                         if variant != "radix4" else "")
                      + ("; equal to K8 bit for bit"
                         if variant == "hops" and label[:3] not in ("400", "320") else ""))

    gen = torch.Generator(device=dev)
    augment_cfg = get_preset("TCResNet8-1.0").augment

    def draw(batch, seed):
        gen.manual_seed(seed)
        idx, _, silent = DeviceDataset.sample_indices(ds.arrays, gen, batch)
        return idx, aug.draw_scalars(gen, silent, augment_cfg, ds.noise_bank, n, True)

    k3_errs = {"hops": 0.0, "phases": 0.0, "radix4": 0.0}
    k3_f64 = {"hops": (0.0, 0.0), "phases": (0.0, 0.0), "radix4": (0.0, 0.0)}
    for label in geoms:
        if label == "640/320 MFCC-40":
            continue
        for variant in ("hops",) if label[:3] in ("400", "320") else ("hops", "phases", "radix4"):
            cfg = dataclasses.replace(geoms[label], dft_variant=variant)
            line = []
            for batch in (1, 8, 1536):
                idx, sc = draw(batch, 950 + batch)
                before = counts(k3)
                got = k3.frontend_features(ds.wavs, idx, sc, ds.noise_bank, cfg, n)
                torch.cuda.synchronize()
                delta = tuple(a - b for a, b in zip(counts(k3), before))
                check(delta == one(variant), f"K3-{variant} {label}: launches {delta}")
                want = k3.frontend_reference(ds.wavs, idx, sc, ds.noise_bank, cfg, n)
                err = (got - want).abs().max().item()
                check(torch.allclose(got, want, **DATASET_FEATURE_TOL),
                      f"K3-{variant} {label} B={batch}: max err {err}")
                two = k2.fused_mfcc(k16.fused_gather_augment(ds.wavs, idx, sc, ds.noise_bank, n),
                                    cfg)
                check(torch.equal(got, two), f"K3-{variant} {label}: differs from "
                      f"{kname[variant]}(K1)")
                check(torch.equal(got, k3.frontend_features(ds.wavs, idx, sc, ds.noise_bank, cfg,
                                                            n)), f"K3-{variant}: two calls differ")
                # both sides against the same augmented rows in float64
                f64 = mfcc_float64(k16.augment_reference(ds.wavs, idx, sc, ds.noise_bank, n), cfg)
                e64, p64, m64 = ((x.double() - f64).abs().max().item() for x in (got, want, two))
                check(e64 <= FEATURE_ATOL, f"K3-{variant} {label} B={batch}: {e64} from float64")
                check(m64 <= FEATURE_ATOL,
                      f"{kname[variant]}(K1) {label} B={batch}: {m64} from float64")
                k3_errs[variant] = max(k3_errs[variant], err)
                k3_f64[variant] = (max(k3_f64[variant][0], e64), max(k3_f64[variant][1], p64))
                line.append(f"B={batch} {err:.2e} (kernel / plain / {kname[variant]}(K1) vs "
                            f"float64 {e64:.2e} / {p64:.2e} / {m64:.2e}, max |MFCC| "
                            f"{f64.abs().max().item():.1f})")
            print(f"[kernel] K3-{variant} {label} vs K1-plain -> {kname[variant]}-plain (same "
                  f"draws, atol 2e-4 rtol 1e-5): " + ", ".join(line)
                  + f"; equal to {kname[variant]}(K1) bit for bit, two calls equal")

    # a geometry that is not hop-decomposable (a 25 ms window at a 10 ms
    # hop: 400 % 160 != 0) through dsp_backend="pallas": the plain feature,
    # as in JAX, and no launch
    wavs = torch.tensor(seeded_wavs(4100, 8, n), device=dev)
    line = []
    for method in ("mfcc", "log_mel_spectrogram"):
        cfg = dataclasses.replace(flagship_audio, window_size_ms=25.0, preprocess_method=method,
                                  dsp_backend="pallas")
        before = counts(k2), k2.plain_routes
        got = dsp.preprocess(wavs, cfg)
        torch.cuda.synchronize()
        check(counts(k2) == before[0] and k2.plain_routes == before[1] + 1,
              f"400/160 {method}: launches {counts(k2)} (before {before[0]}), plain routes "
              f"{k2.plain_routes - before[1]}")
        err = (got - dsp.preprocess(wavs, dataclasses.replace(cfg, dsp_backend="xla"))).abs().max()
        check(err.item() <= 1e-5, f"400/160 {method}: {err.item()} from the plain feature")
        line.append(f"{method} {err.item():.1e}")
    print("[kernel] dsp_backend=pallas at 400/160 (not hop-decomposable): the plain feature, no "
          "launch, plain_routes +1; max |err| vs dsp_backend=xla " + ", ".join(line))

    # a radix4 clip past K9's largest product (2.56 s at 480/160: 254
    # frames), which the JAX package runs in its radix4 kernel: K2's stage,
    # chosen from the geometry (mfcc.kernel_variant), in fused_mfcc and K3
    n_long, rows = 40960, 64
    gen_long = torch.Generator(device=dev).manual_seed(4300)
    data = torch.randint(-32768, 32768, (rows, n_long), generator=gen_long, device=dev,
                         dtype=torch.int32).to(torch.int16)
    noise = torch.rand((3, 2 * n_long), generator=gen_long, device=dev) - 0.5
    idx = torch.randint(0, rows, (8,), generator=gen_long, device=dev, dtype=torch.int32)
    sc = aug.draw_scalars(gen_long, torch.rand(8, generator=gen_long, device=dev) < 0.25,
                          augment_cfg, noise, n_long, True)
    for method in ("mfcc", "log_mel_spectrogram"):
        cfg = dataclasses.replace(flagship_audio, preprocess_method=method, dft_variant="radix4",
                                  clip_duration_ms=n_long // 16)
        check(k2.resolve_dft_variant(cfg, n_long) == "radix4"
              and k2.kernel_variant(cfg, n_long) == "hops", f"radix4 2.56 s {method}: stage")
        line = []
        for batch in (1, 8, 256):
            wavs = torch.tensor(seeded_wavs(4200 + batch, batch, n_long), device=dev)
            before = counts(k2), k2.plain_routes
            got = k2.fused_mfcc(wavs, cfg)
            torch.cuda.synchronize()
            check(counts(k2) == (before[0][0] + 1, *before[0][1:])
                  and k2.plain_routes == before[1],
                  f"radix4 2.56 s {method}: launches {counts(k2)} (before {before[0]}), plain "
                  f"routes {k2.plain_routes - before[1]}")
            want = k2.fused_mfcc_reference(wavs, cfg)
            err = (got - want).abs().max().item()
            check(got.shape == want.shape == (batch, 254, dsp.feature_width(cfg))
                  and err <= FEATURE_ATOL, f"radix4 2.56 s {method} B={batch}: max err {err}")
            line.append(f"B={batch} {err:.2e}")
        before = counts(k3), k2.plain_routes
        got = k3.frontend_features(data, idx, sc, noise, cfg, n_long)
        torch.cuda.synchronize()
        check(counts(k3) == (before[0][0] + 1, *before[0][1:]) and k2.plain_routes == before[1],
              f"K3 radix4 2.56 s {method}: launches {counts(k3)} (before {before[0]})")
        want = k3.frontend_reference(data, idx, sc, noise, cfg, n_long)
        err = (got - want).abs().max().item()
        check(err <= FEATURE_ATOL, f"K3 radix4 2.56 s {method}: max err {err}")
        two = k2.fused_mfcc(k16.fused_gather_augment(data, idx, sc, noise, n_long), cfg)
        check(torch.equal(got, two), f"K3 radix4 2.56 s {method}: differs from K2(K1)")
        print(f"[kernel] dft_variant=radix4, 2.56 s at 480/160 (254 frames, past K9's 112) "
              f"{method}: K2's stage (launches +1, radix4 launches and plain_routes +0) vs the "
              f"plain radix4 feature (atol {FEATURE_ATOL}): " + ", ".join(line)
              + f"; K3 B=8 {err:.2e}, equal to K2(K1) bit for bit | {card}")

    # ---- 23. train the 2D families: the main path ----
    workdir = tempfile.mkdtemp(prefix="chip_smoke_2d_")

    def preset_cfg(name, variant="auto", **optim):
        cfg = get_preset(name)
        return cfg.replace(
            audio=dataclasses.replace(cfg.audio, dft_variant=variant, frontend_fuse="on",
                                      dsp_backend="pallas"),
            augment=dataclasses.replace(cfg.augment, backend="pallas"),
            optim=dataclasses.replace(cfg.optim, **optim),
            train=dataclasses.replace(cfg.train, max_step=10**9, step_save_checkpoint=10,
                                      step_evaluation=10, summary_step_verbose=10,
                                      summary_step_default=10),
            data=dataclasses.replace(cfg.data, use_synthetic=True, synthetic_num_samples=24_100))

    reset_launch_counts()
    path_launches = {}
    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # exact resume
    try:
        steps = 30
        dcfg = preset_cfg("DSCNNL", "radix4")
        run = f"{workdir}/dscnnl"
        t0 = time.perf_counter()
        trainer = Trainer(dcfg, ds, workdir=run, steps_per_call=10)
        trainer.train(steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        path_launches["k9_frontend"] = k3.radix4_launches
        check(counts(k3) == (0, 0, steps), f"train DSCNNL: K3 launches {counts(k3)}, want "
              f"{steps} radix4")
        records = train_records(trainer)
        losses = [r["total_loss"] for r in records if "total_loss" in r]
        check(all(np.isfinite(x) for x in losses) and losses[-1] < losses[0],
              f"train DSCNNL: loss did not fall: {losses}")
        check(trainer.ckpt.all_steps() == [10, 20, 30],
              f"train DSCNNL: checkpoints {trainer.ckpt.all_steps()}")
        print(f"[train] DSCNNL (MFCC-10 40/20 ms, B=100, f32, adam, radix4, frontend_fuse=on): "
              f"{steps} steps in {wall:.1f} s, K3-radix4 launches "
              f"{path_launches['k9_frontend']}; loss "
              + " -> ".join(f"{x:.4f}" for x in losses)
              + f"; checkpoints {trainer.ckpt.all_steps()}")

        second = Trainer(dcfg, ds, workdir=f"{workdir}/dscnnl_resume", steps_per_call=10)
        trainer.ckpt.restore(second.state, 20)
        resumed = float(second.train_steps(10, start=20)["total_loss"])
        want30 = [r["total_loss"] for r in records if r["step"] == 30 and "total_loss" in r][0]
        check(resumed == want30, f"resume DSCNNL: steps 21-30 mean loss {resumed} != {want30}")
        for field in ("params", "batch_stats", "opt_state"):
            mine, theirs = getattr(trainer.state, field), getattr(second.state, field)
            check(all(torch.equal(mine[k], theirs[k]) for k in mine),
                  f"resume DSCNNL: {field} differ at step 30")
        print(f"[train] DSCNNL resumed at step 20 (params, BN statistics, adam's mu, nu and "
              f"count {int(second.state.opt_state['count'])}): steps 21-30 mean loss "
              f"{resumed!r} and the state at 30 equal the uninterrupted run's bit for bit")

        before = k2.radix4_launches
        t0 = time.perf_counter()
        evaluate_cli.main(["--train-dir", run, "--synthetic", "--split", "valid",
                           "--valid-type", "loop", "--cfg", "mesh.data=1"])
        torch.cuda.synchronize()
        eval_wall = time.perf_counter() - t0
        eval_launches = k2.radix4_launches - before
        scored = {r["step"]: r for r in map(
            json.loads, open(f"{run}/valid_metrics.jsonl").read().splitlines())}
        n_valid = max(24_100 // 8, 128)
        batches = -(-n_valid // dcfg.data.eval_batch_size)
        check(sorted(scored) == [10, 20, 30], f"evaluate DSCNNL: scored {sorted(scored)}")
        check(eval_launches == 3 * batches, f"evaluate DSCNNL: K9 launches {eval_launches}")
        print(f"[evaluate] loop over the DSCNNL run: checkpoints {sorted(scored)} scored once "
              f"each on {n_valid} valid rows in {eval_wall:.1f} s through K9 (dsp_backend="
              f"pallas, {eval_launches} launches = {batches} x 3), the model on cuDNN; accuracy "
              + " ".join(f"{scored[s]['accuracy']:.4f}" for s in sorted(scored)))

        legs = {}
        for label, name, variant, optim in (
                ("Res15 (adam, 480/160, phases)", "Res15", "phases", {}),
                ("TCResNet2D8-1.0 (mom)", "TCResNet2D8-1.0", "auto", {}),
                ("KWSfpool3 (adam, dropout)", "KWSfpool3", "auto", {}),
                ("DSCNNS (rmsprop)", "DSCNNS", "auto", {"optimizer": "rmsprop"})):
            before = counts(k3)
            tr = Trainer(preset_cfg(name, variant, **optim), ds, workdir=f"{workdir}/{name}")
            leg_losses = [float(tr.train_steps(1, start=i)["total_loss"]) for i in range(5)]
            delta = tuple(a - b for a, b in zip(counts(k3), before))
            want = tuple(5 * x for x in one("phases" if variant == "phases" else "hops"))
            check(delta == want, f"leg {label}: K3 launches {delta}, want {want}")
            check(all(np.isfinite(x) for x in leg_losses), f"leg {label}: losses {leg_losses}")
            legs[name] = tr
            print(f"[train] leg {label}, preset batch {tr.cfg.train.batch_size}: 5 steps, K3 "
                  f"launches (hops, phases, radix4) {delta}; loss "
                  + " -> ".join(f"{x:.4f}" for x in leg_losses))
        path_launches["k8_frontend"] = k3.phases_launches
    finally:
        torch.backends.cudnn.deterministic = cudnn_det

    served = {}
    for label, tr in (("DSCNNL (radix4)", trainer), ("Res15 (phases)", legs["Res15"])):
        scfg = tr.cfg.replace(audio=dataclasses.replace(tr.cfg.audio, dsp_backend="xla"))
        v = {"params": tr.state.params, "batch_stats": tr.state.batch_stats}
        served[label] = (build_inference_fn(scfg, v, backend="auto", device=dev),
                         build_inference_fn(scfg, v, backend="xla", precision="highest",
                                            device=dev),
                         [torch.tensor(seeded_wavs(5000 + i, 1, n), device=dev)
                          for i in range(20)])
    torch.cuda.synchronize()
    before_k2, before_k5 = counts(k2), k5.launches
    t0 = time.perf_counter()
    answers = {label: [auto(x) for x in reqs] for label, (auto, _, reqs) in served.items()}
    torch.cuda.synchronize()
    serve_ms = (time.perf_counter() - t0) * 1e3
    delta = tuple(a - b for a, b in zip(counts(k2), before_k2))
    check(delta == (0, 20, 20) and k5.launches - before_k5 == 40,
          f"serve 2D variants: K2/K8/K9 launches {delta}, K5 {k5.launches - before_k5}")
    path_launches["k8_mfcc"] = k2.phases_launches
    path_launches["k9_mfcc"] = k2.radix4_launches
    serve_err = {}
    for label, (_, ref, reqs) in served.items():
        worst = 0.0
        for x, y in zip(reqs, answers[label]):
            check(bool(torch.isfinite(y).all()) and y.shape == (1, 12), f"serve {label}: output")
            worst = max(worst, (y - ref(x)).abs().max().item())
        check(worst <= SOFTMAX_ATOL, f"serve {label}: auto vs xla/highest differ by {worst}")
        serve_err[label] = worst
    print(f"[serve] auto, trained DSCNNL (radix4) and Res15 (phases): 20 x B=1 each in "
          f"{serve_ms:.1f} ms, K8 {delta[1]} / K9 {delta[2]} / K5 {k5.launches - before_k5} "
          "launches; max softmax err vs xla/highest "
          + ", ".join(f"{k} {e:.2e}" for k, e in serve_err.items()))
    check(k2.plain_routes == 0, f"phase 23: {k2.plain_routes} batches left the front-end kernels")
    print(f"[train] phase 23 launches: " + ", ".join(f"{k} {v}" for k, v in path_launches.items())
          + "; plain routes 0")

    # ---- 24. times ----
    xla_hops = {label: dataclasses.replace(a, dsp_backend="xla", dft_variant="hops")
                for label, a in geoms.items()}
    ms, k3_ms = {}, {}
    batch = 1536
    rate = {"hops": TF32X3_FLOPS, "phases": TF32X3_FLOPS, "radix4": TF32X3_FLOPS}
    # K8 and K3-phases behind a device sleep, on one clock with the library
    # call as a CUDA graph (as phase 25 times K2 and K3-hops)
    queued = hops_times(dev, ("480/160", "640/320"), (batch,), ds, variant="phases")
    for label in ("480/160 MFCC-40", "640/320 MFCC-10"):
        wavs = torch.tensor(seeded_wavs(77, batch, n), device=dev)
        library = device_ms(lambda: dsp.preprocess(wavs, xla_hops[label]))
        q = queued[(label[:7], batch)]
        check(q["queue_full"], f"{label} B={batch}: a K8, K3-phases or library time is host-paced")
        for variant in ("hops", "phases", "radix4"):
            cfg = dataclasses.replace(geoms[label], dft_variant=variant)
            a, b, c, d = (device_ms(lambda: k2.fused_mfcc(wavs, cfg)),
                          device_ms(lambda: k2.fused_mfcc_reference(wavs, cfg, variant)),
                          device_ms(lambda: k2.fused_mfcc_reference(wavs, cfg, variant)),
                          device_ms(lambda: k2.fused_mfcc(wavs, cfg)))
            bnd = bound(2 * batch * variant_macs(cfg, variant),
                        4 * batch * (n + np.prod(dsp.feature_shape(cfg)[:2])), rate[variant])
            ms[(variant, label)] = dict(ms=min(a, d), plain_ms=min(b, c), library_ms=library,
                                        **bnd)
            print(f"[times] {kname[variant]} ({variant}) {label} B={batch}: kernel {a:.4f} / "
                  f"{d:.4f} ms, plain {b:.4f} / {c:.4f} ms, dsp.preprocess on cuBLAS (TF32 off, "
                  f"dense) {library:.4f} ms; bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}"
                  f" at 3xTF32, {bnd['bound_ms'] / min(a, d):.1%}"
                  f" of it) (CUDA events, median of 20; order kernel, plain, plain, kernel)"
                  + (f"; PR 5 (quoted, not this run): {PR5_K9_MS[label][0]} ms"
                     if variant == "radix4" else "") + f" | {card}")
            if variant == "phases":
                (a, d), c = q["k2"], q["library"]
                ms[(variant, label)].update(ms=min(a, d), library_ms=c)
                print(f"[times] K8 (phases) {label} B={batch}, behind a device sleep: kernel "
                      f"{a:.4f} / {d:.4f} ms, dsp.preprocess on cuBLAS as a CUDA graph {c:.4f} "
                      f"ms (device, mean of 20; order kernel, library, kernel); the library "
                      f"takes {c / min(a, d):.2f}x K8's time, {bnd['bound_ms'] / min(a, d):.1%} "
                      f"of its bound; PR 5 (quoted, not this run): {PR5_K8_MS[label][0]} ms"
                      f" | {card}")
        # the served request's front end: K9, K8 and the library call at
        # batch 1 on one clock, behind a device sleep
        one = wavs[:1].contiguous()
        lib_one, lib_out = graph_of(lambda: dsp.preprocess(one, xla_hops[label]))
        lib_one()
        torch.cuda.synchronize()
        check(torch.equal(lib_out, dsp.preprocess(one, xla_hops[label])),
              f"{label}: the library graph differs from the call")
        cfg9, cfg8 = (dataclasses.replace(geoms[label], dft_variant=v)
                      for v in ("radix4", "phases"))
        (a9, f1), (a8, f2), (c, f3), (d8, f4), (d9, f5) = (queued_ms(fn) for fn in (
            lambda: k2.fused_mfcc(one, cfg9), lambda: k2.fused_mfcc(one, cfg8), lib_one,
            lambda: k2.fused_mfcc(one, cfg8), lambda: k2.fused_mfcc(one, cfg9)))
        check(f1 and f2 and f3 and f4 and f5, f"{label} B=1: a K8, K9 or library time is "
              "host-paced")
        for variant, cfg, a, d in (("radix4", cfg9, a9, d9), ("phases", cfg8, a8, d8)):
            bnd = bound(2 * variant_macs(cfg, variant),
                        4 * (n + np.prod(dsp.feature_shape(cfg)[:2])), TF32X3_FLOPS)
            ms[(variant, label)].update(ms_b1=min(a, d), library_ms_b1=c,
                                        bound_ms_b1=bnd["bound_ms"])
            print(f"[times] {kname[variant]} ({variant}) {label} B=1: kernel {a:.4f} / {d:.4f} "
                  f"ms, dsp.preprocess on cuBLAS (TF32 off, dense) as a CUDA graph {c:.4f} ms "
                  f"(device, mean of 20 behind a device sleep; order K9, K8, library, K8, K9); "
                  f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']} at 3xTF32) | {card}")
        idx, sc = draw(batch, 77)
        mixed = int((sc.vols != 0).sum())
        for variant in ("hops", "phases", "radix4"):
            cfg = dataclasses.replace(geoms[label], dft_variant=variant)
            a, b, c, d = (
                device_ms(lambda: k3.frontend_features(ds.wavs, idx, sc, ds.noise_bank, cfg, n)),
                device_ms(lambda: k3.frontend_reference(ds.wavs, idx, sc, ds.noise_bank, cfg, n)),
                device_ms(lambda: k3.frontend_reference(ds.wavs, idx, sc, ds.noise_bank, cfg, n)),
                device_ms(lambda: k3.frontend_features(ds.wavs, idx, sc, ds.noise_bank, cfg, n)))
            bnd = bound(2 * batch * variant_macs(cfg, variant),
                        2 * batch * n + 4 * mixed * n
                        + 4 * batch * np.prod(dsp.feature_shape(cfg)[:2]), rate[variant])
            k3_ms[(variant, label)] = dict(ms=min(a, d), plain_ms=min(b, c), library_ms=library,
                                           **bnd)
            print(f"[times] K3 ({variant}) {label} B={batch}: kernel {a:.4f} / {d:.4f} ms, plain "
                  f"(K1-plain -> {kname[variant]}-plain) {b:.4f} / {c:.4f} ms; bound "
                  f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']} at 3xTF32)"
                  + (f"; PR 5 (quoted, not this run): {PR5_K9_MS[label][1]} ms"
                     if variant == "radix4" else "") + f" | {card}")
            if variant == "phases":
                # the same draw as `sc` (seed 77), so the bound above holds
                check(q["k3_mixed"] == mixed, f"{label}: K3-phases timed another draw")
                (a, d), c = q["k3"], q["library"]
                k3_ms[(variant, label)].update(ms=min(a, d), library_ms=c)
                print(f"[times] K3 (phases) {label} B={batch}, behind a device sleep: kernel "
                      f"{a:.4f} / {d:.4f} ms, dsp.preprocess on cuBLAS as a CUDA graph (no "
                      f"augment) {c:.4f} ms (device, mean of 20; order K8, library, K8, "
                      f"K3-phases, K3-phases); {bnd['bound_ms'] / min(a, d):.1%} of its bound; "
                      f"PR 5 (quoted, not this run): {PR5_K8_MS[label][1]} ms | {card}")

    for label, tr, variant in (("DSCNNL B=100 f32 adam, K3-radix4", trainer, "radix4"),
                               ("Res15 B=64 f32 adam, K3-phases", legs["Res15"], "phases")):
        tr.train_steps(3, start=100)
        spans = []
        for visit in range(2):
            torch.cuda.synchronize()
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            ev0.record()
            tr.train_steps(20, start=200 + 20 * visit)
            ev1.record()
            torch.cuda.synchronize()
            spans.append(((time.perf_counter() - t0) * 1e3 / 20, ev0.elapsed_time(ev1) / 20))
        busy = device_busy_ms(lambda: tr.train_steps(3, start=500)) / 3
        host_ms = sum(h for h, _ in spans) / 2
        dev_ms = sum(d for _, d in spans) / 2
        bsz = tr.cfg.train.batch_size
        print(f"[times] train step {label}: " + " / ".join(f"{h:.3f}" for h, _ in spans)
              + " ms/step host, " + " / ".join(f"{d:.3f}" for _, d in spans) + " ms/step CUDA "
              f"events (two runs of 20 steps), {bsz / host_ms * 1e3:,.0f} utt/s, device busy "
              f"{busy:.3f} ms/step = {busy / dev_ms:.1%} of the step | {card}")

    def entry(name, source, replaces, key, err, timed, label):
        t = timed[(key, label)]
        other = [g for g in ("480/160 MFCC-40", "640/320 MFCC-10") if g != label][0]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": path_launches[name], "max_abs_err": err, "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"], "timed": f"{label}, batch {batch}",
                **{k: t[k] for k in ("ms_b1", "library_ms_b1", "bound_ms_b1") if k in t},
                "other_geometry": {other: timed[(key, other)]}}

    return [
        entry("k8_mfcc", "tcresnet_tpu_torch/csrc/mfcc.cu", "tcresnet_tpu/ops/pallas/mfcc.py:438",
              "phases", errs["phases"], ms, "480/160 MFCC-40"),
        {**entry("k8_frontend", "tcresnet_tpu_torch/csrc/frontend.cu",
                 "tcresnet_tpu/ops/pallas/frontend.py:164", "phases", k3_errs["phases"], k3_ms,
                 "480/160 MFCC-40"), "float64_err": dict(zip(("kernel", "plain"),
                                                             k3_f64["phases"]))},
        entry("k9_mfcc", "tcresnet_tpu_torch/csrc/mfcc.cu", "tcresnet_tpu/ops/pallas/mfcc.py:422",
              "radix4", errs["radix4"], ms, "640/320 MFCC-10"),
        {**entry("k9_frontend", "tcresnet_tpu_torch/csrc/frontend.cu",
                 "tcresnet_tpu/ops/pallas/frontend.py:175", "radix4", k3_errs["radix4"], k3_ms,
                 "640/320 MFCC-10"), "float64_err": dict(zip(("kernel", "plain"),
                                                             k3_f64["radix4"]))},
    ], {"k2_mfcc": {"max_abs_err": errs["hops"]},
        "k3_frontend": {"max_abs_err": k3_errs["hops"],
                        "float64_err": dict(zip(("kernel", "plain"), k3_f64["hops"]))}}


def hops_phase(dev: torch.device, card: str, ds) -> dict:
    """Phase 25: K2 and K3-hops (the hops front ends, on K8's tensor-core
    stage) behind a device sleep, each on one clock with the library call
    as a CUDA graph (tcresnet_tpu_torch/tools/frontend_times.py), the FP32
    design's times quoted beside; {kernel name: its summary fields}."""
    from tcresnet_tpu_torch.ops import dsp
    from tcresnet_tpu_torch.tools.frontend_times import geometry_cfg

    # ---- 25. times of the hops front ends ----
    n = 16000
    labels = ("480/160", "640/320", "400/200")
    times = hops_times(dev, labels, (1536, 1), ds)
    k2_t, k3_t = {}, {}
    for label in labels:
        cfg = geometry_cfg(label)
        feats = int(np.prod(dsp.feature_shape(cfg)[:2]))
        macs = variant_macs(cfg, "hops")
        k2_fp32, k3_fp32, b1_fp32 = FP32_HOPS_MS[label]
        for batch in (1536, 1):
            t = times[(label, batch)]
            check(t["queue_full"], f"K2 / K3-hops {label} B={batch}: a reading is host-paced")
            a, d = t["k2"]
            bnd = bound(2 * batch * macs, 4 * batch * (n + feats), TF32X3_FLOPS)
            k2_t[(label, batch)] = dict(ms=min(a, d), library_ms=t["library"], **bnd)
            print(f"[times] K2 (hops) {label} B={batch}, behind a device sleep: kernel {a:.4f} / "
                  f"{d:.4f} ms, dsp.preprocess on cuBLAS (TF32 off, dense) as a CUDA graph "
                  f"{t['library']:.4f} ms (device, mean of 20; order kernel, library, kernel); "
                  f"the library takes {t['library'] / min(a, d):.2f}x K2's time; bound "
                  f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']} at 3xTF32, "
                  f"{bnd['bound_ms'] / min(a, d):.1%} of it); the FP32 design (quoted, not this "
                  f"run): {k2_fp32 if batch > 1 else b1_fp32} ms | {card}")
            if "k3" in t:
                a, d = t["k3"]
                bnd = bound(2 * batch * macs,
                            2 * batch * n + 4 * t["k3_mixed"] * n + 4 * batch * feats,
                            TF32X3_FLOPS)
                k3_t[label] = dict(ms=min(a, d), library_ms=t["library"], **bnd)
                print(f"[times] K3-hops {label} B={batch}, behind a device sleep: kernel {a:.4f} "
                      f"/ {d:.4f} ms (the library graph above, no augment, "
                      f"{t['library']:.4f} ms); bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}"
                      f" at 3xTF32, {bnd['bound_ms'] / min(a, d):.1%} of it); the FP32 design "
                      f"(quoted, not this run): {k3_fp32} ms | {card}")
    main, others = "480/160", ("640/320", "400/200")
    return {
        "k2_mfcc": {**k2_t[(main, 1536)], "timed": f"{main} MFCC-40, batch 1536, behind a "
                    "device sleep", "ms_b1": k2_t[(main, 1)]["ms"],
                    "library_ms_b1": k2_t[(main, 1)]["library_ms"],
                    "bound_ms_b1": k2_t[(main, 1)]["bound_ms"],
                    "other_geometry": {f"{g} B={b}": k2_t[(g, b)]
                                       for g in others for b in (1536, 1)}},
        "k3_frontend": {**k3_t[main], "timed": f"{main} MFCC-40, batch 1536, behind a device "
                        "sleep", "other_geometry": {g: k3_t[g] for g in others}},
    }


# Speech Commands v1's _background_noise_ clips and their lengths in seconds
# (the bank pads them to the longest: 95 s, 1,520,000 samples a row)
GSC_NOISE_CLIPS = {"doing_the_dishes": 95, "dude_miaowing": 61, "exercise_bike": 61,
                   "pink_noise": 60, "running_tap": 61, "white_noise": 61}


def write_gsc_like_tree(raw: str, seed: int) -> int:
    """A Speech Commands v1-like source made from `seed`: <raw>/<word>/
    <speaker>_nohash_<j>.wav, one second at 16 kHz, 200 files for each of
    the 10 keywords and 100 for each of 4 other words (the "unknown" class
    after prepare_dataset), speakers drawn from 600 hashed ids; each word a
    tone of its own with random phase, amplitude, vibrato and a noise floor;
    and the six noise clips. Returns the number of word files."""
    from tcresnet_tpu_torch.data import wav as wavlib
    from tcresnet_tpu_torch.tools.prepare_dataset import BACKGROUND_DIR, KEYWORDS

    rng = np.random.default_rng(seed)
    n, rate = 16000, 16000
    t = np.arange(n) / rate
    speakers = [f"{int(x):08x}" for x in rng.integers(0, 2**32, 600)]
    words = [(w, 200) for w in KEYWORDS] + [(w, 100) for w in ("bed", "bird", "cat", "dog")]
    total = 0
    for k, (word, count) in enumerate(words):
        f0 = 220.0 * 2.0 ** (k / 6.0)
        phase, amp = rng.uniform(0, 2 * np.pi, (count, 1)), rng.uniform(0.2, 0.6, (count, 1))
        vib = 1.0 + 0.01 * np.sin(2 * np.pi * rng.uniform(2, 6, (count, 1)) * t)
        sig = amp * np.sin(2 * np.pi * f0 * vib * t + phase)
        sig += 0.3 * amp * np.sin(2 * np.pi * 2 * f0 * t + phase)
        sig += rng.normal(0, 0.01, (count, n))
        used = {}
        for row in sig:
            spk = speakers[int(rng.integers(0, len(speakers)))]
            j = used[spk] = used.get(spk, -1) + 1
            wavlib.write_wav_pcm16(f"{raw}/{word}/{spk}_nohash_{j}.wav", row)
        total += count
    for name, seconds in GSC_NOISE_CLIPS.items():
        scale = rng.uniform(0.05, 0.3)
        wavlib.write_wav_pcm16(f"{raw}/{BACKGROUND_DIR}/{name}.wav",
                               rng.normal(0, scale, seconds * rate).clip(-1, 1))
    return total


def dataset_phase(dev: torch.device, card: str, synthetic) -> dict:
    """Phase 26: the Speech Commands path through the entry points a user
    calls, on a tree made from a seed; {kernel name: its launches there}."""
    import shutil
    import tempfile
    from pathlib import Path

    from tcresnet_tpu_torch.data import native_loader
    from tcresnet_tpu_torch.data import wav as wavlib
    from tcresnet_tpu_torch.data.device_data import DeviceDataset
    from tcresnet_tpu_torch.ops import augment as aug
    from tcresnet_tpu_torch.ops.kernels import augment as k16
    from tcresnet_tpu_torch.ops.kernels import frontend as k3
    from tcresnet_tpu_torch.tools import evaluate as evaluate_cli
    from tcresnet_tpu_torch.tools import prepare_dataset
    from tcresnet_tpu_torch.tools import train as train_cli
    from tcresnet_tpu_torch.tools.train import load_run_config, load_split
    from tcresnet_tpu_torch.train.checkpoint import CheckpointManager
    from tcresnet_tpu_torch.train.trainer import Trainer

    # ---- 26. dataset: a Speech Commands tree, from the wavs to the test score ----
    root = tempfile.mkdtemp(prefix="chip_smoke_gsc_")
    raw, tree, cache = f"{root}/raw", f"{root}/tree", f"{root}/cache"
    t0 = time.perf_counter()
    n_words = write_gsc_like_tree(raw, seed=26)
    write_s = time.perf_counter() - t0
    prepare_dataset.main(["--extracted", raw, "--out", tree])
    sizes = {s: len(list(Path(tree, s).glob("*/*.wav"))) - len(GSC_NOISE_CLIPS)
             for s in ("train", "valid", "test")}
    check(sum(sizes.values()) < n_words and min(sizes.values()) > 0,
          f"dataset: prepare_dataset placed {sizes} of {n_words} word files")

    # the run's config: TCResNet8-1.0 at batch 100 in float32, oversampling on,
    # K3 (frontend_fuse on; K1 + K2 with off), K7 (conv_backend pallas), on
    # one card in this process whatever the machine has (phase 28 drives the
    # mesh)
    base = ["--dataset-root", tree, "--cache-dir", cache, "--batch-size", "100",
            "--compute-dtype", "float32", "--seed", "0",
            "--cfg", "augment.backend=pallas", "--cfg", "audio.dsp_backend=pallas",
            "--cfg", "model.conv_backend=pallas", "--cfg", "data.oversampling_ratio=0.5",
            "--cfg", "train.step_evaluation=10", "--cfg", "mesh.data=1"]
    cfg = train_cli.build_config(train_cli.parse_args(base + ["--cfg", "audio.frontend_fuse=on"]))
    check(native_loader.available(), "dataset: the C++ wav decoder did not build or load")
    hosts, load_s = {}, {}
    for split in ("train", "valid", "test"):
        native_loader.files_decoded = 0
        t0 = time.perf_counter()
        hosts[split] = load_split(cfg, split)
        load_s[split] = time.perf_counter() - t0
        check(native_loader.files_decoded == sizes[split],
              f"dataset {split}: {native_loader.files_decoded} of {sizes[split]} files decoded "
              "by the C++ decoder")
        native_loader.files_decoded = 0
        hit = load_split(cfg, split)
        check(native_loader.files_decoded == 0, f"dataset {split}: a cache hit decoded files")
        a = hosts[split]
        same = all(np.array_equal(getattr(a, f), getattr(hit, f))
                   for f in ("wavs", "labels", "is_silent", "noise_bank"))
        same &= a.label_names == hit.label_names and (
            (a.sample_row is None and hit.sample_row is None)
            or np.array_equal(a.sample_row, hit.sample_row))
        check(same, f"dataset {split}: the cache hit differs from the decode")
        check(a.num_classes == 12 and a.noise_bank.shape == (6, 95 * 16000),
              f"dataset {split}: {a.num_classes} classes, noise bank {a.noise_bank.shape}")
    train_host = hosts["train"]
    check(train_host.sample_row is not None and train_host.num_logical_samples
          > train_host.num_samples, "dataset: oversampling did not build sample_row")
    print(f"[dataset] tree of {n_words} one-second wavs over 14 words + 6 noise clips of 60-95 s "
          f"written in {write_s:.1f} s; prepare_dataset --extracted: train {sizes['train']}, "
          f"valid {sizes['valid']}, test {sizes['test']} files; loaded with the C++ decoder in "
          + ", ".join(f"{s} {load_s[s]:.2f} s ({hosts[s].num_samples} rows with silence)"
                      for s in load_s)
          + f"; train oversampled to {train_host.num_logical_samples} logical rows; each cache "
          "hit equal to the decode")

    # decode per 1,000 wavs (files in the page cache), C++ and numpy, and the upload
    files = [f for f in sorted(map(str, Path(tree, "train").glob("*/*.wav")))
             if "/_background_noise_/" not in f]
    decode_ms = {"native": [], "numpy": []}
    for route in ("native", "numpy", "numpy", "native"):
        t0 = time.perf_counter()
        if route == "native":
            native_loader.decode_batch(files, 16000, expected_rate=16000)
        else:
            for f in files:
                wavlib.decode_wav_int16(f, 16000, expected_rate=16000)
        decode_ms[route].append((time.perf_counter() - t0) * 1e3 * 1000 / len(files))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tds = DeviceDataset(train_host, dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    nbytes = sum(t.numel() * t.element_size() for t in (tds.wavs, tds.noise_bank, tds.sample_row))
    print(f"[times] dataset decode per 1,000 wavs of 16,000 samples ({len(files)} train files, in "
          "the page cache): C++ decoder " + " / ".join(f"{x:.1f}" for x in decode_ms["native"])
          + " ms, numpy " + " / ".join(f"{x:.1f}" for x in decode_ms["numpy"])
          + f" ms (order C++, numpy, numpy, C++); upload of the train split "
          f"({nbytes / 1e6:.1f} MB: rows, noise bank, sample_row) {upload_s * 1e3:.1f} ms "
          f"(host clock to a synchronize) | {card}")

    # K1 and K3 on this tree: its 1.52 M-sample noise bank, rows drawn through sample_row
    n = cfg.audio.desired_samples
    gen = torch.Generator(device=dev)
    k1_err = k3_err = 0.0
    for naive in (True, False):
        for quantize in (False, True):
            acfg = dataclasses.replace(cfg.augment, naive_background_mix=naive,
                                       noise_crop_quantize=quantize)
            for batch in (1, 100, 1536):
                gen.manual_seed(2600 + batch)
                idx, _, silent = DeviceDataset.sample_indices(tds.arrays, gen, batch,
                                                              tds.sample_row)
                sc = aug.draw_scalars(gen, silent, acfg, tds.noise_bank, n, True)
                before = k16.k1_launches
                got = k16.fused_gather_augment(tds.wavs, idx, sc, tds.noise_bank, n, quantize)
                want = k16.augment_reference(tds.wavs, idx, sc, tds.noise_bank, n, quantize)
                torch.cuda.synchronize()
                check(k16.k1_launches == before + 1, "dataset: K1 not launched")
                err = (got - want).abs().max().item()
                check(torch.equal(got, want), f"dataset K1 naive={naive} quantize={quantize} "
                      f"B={batch}: max err {err}")
                k1_err = max(k1_err, err)
    for batch in (100, 1536):
        gen.manual_seed(2700 + batch)
        idx, _, silent = DeviceDataset.sample_indices(tds.arrays, gen, batch, tds.sample_row)
        sc = aug.draw_scalars(gen, silent, cfg.augment, tds.noise_bank, n, True)
        before = k3.launches
        got = k3.frontend_features(tds.wavs, idx, sc, tds.noise_bank, cfg.audio, n)
        want = k3.frontend_reference(tds.wavs, idx, sc, tds.noise_bank, cfg.audio, n)
        torch.cuda.synchronize()
        check(k3.launches == before + 1, "dataset: K3 not launched")
        err = (got - want).abs().max().item()
        check(torch.allclose(got, want, **DATASET_FEATURE_TOL), f"dataset K3 B={batch}: {err}")
        k3_err = max(k3_err, err)
    # K7 at the main path's batch (100), float32, TCResNet8-1.0's ten convs
    k7_err = {"fwd": 0.0, "dx": 0.0, "dw": 0.0}
    tols = {"fwd": TCONV_FWD_TOL, "dx": TCONV_DX_TOL}
    for c in conv_cases(dev, conv_geometries(cfg.model, 98, 40), 100, gen.manual_seed(2800)):
        for op, (kernel, plain, _) in conv_ops().items():
            got, want = kernel(c), plain(c)
            err = (got - want).abs().max().item()
            ok = (err <= TCONV_DW_REL * want.abs().max().item() if op == "dw"
                  else torch.allclose(got, want, **tols[op]))
            check(ok, f"dataset K7 {op} {c['geom']} B=100: max err {err}")
            k7_err[op] = max(k7_err[op], err)
    print(f"[dataset] K1 against its plain version on the 6 x {tds.noise_bank.shape[1]:,} noise "
          f"bank, rows through sample_row, both crop modes and mix versions, B=1/100/1536: max "
          f"|err| {k1_err:.1e} (bit-exact); K3 B=100/1536 {k3_err:.2e} (atol "
          f"{DATASET_FEATURE_TOL['atol']}); K7 at B=100, ten convs: fwd {k7_err['fwd']:.2e}, dx "
          f"{k7_err['dx']:.2e}, dw {k7_err['dw']:.2e}")

    def counts():
        c = launch_counts()
        return {"k1": c["k1"], "k2": c["k2"], "k3": c["k3"], "k6": c["k6"], "fwd": c["k7_fwd"],
                "dx": c["k7_dx"], "dw": c["k7_dw"], "plain_routes": c["plain_routes"]}

    zero = reset_launch_counts

    # ---- the main path: tools/train.py's main on the tree, scored on test ----
    run, steps = f"{root}/run", 30
    zero()
    t0 = time.perf_counter()
    trainer = train_cli.main(base + [
        "--cfg", "audio.frontend_fuse=on", "--train-dir", run, "--max-step", str(steps),
        "--step-save-checkpoint", "10", "--steps-per-call", "10", "--eval-split", "test"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    main_counts = counts()
    records = train_records(trainer)
    losses = [r["total_loss"] for r in records if "total_loss" in r]
    evals = [r for r in records if "train_stream/accuracy" in r]
    scored = [json.loads(x) for x in Path(run, "test_metrics.jsonl").read_text().splitlines()]
    n_test = hosts["test"].num_samples
    test_batches = -(-n_test // cfg.data.eval_batch_size)
    want = {"k1": 0, "k2": test_batches, "k3": steps, "k6": 0,
            "fwd": 10 * steps + 10 * len(evals) + 10 * test_batches, "dx": 9 * steps,
            "dw": 10 * steps, "plain_routes": 0}
    check(int(trainer.state.step) == steps and len(evals) == steps // 10,
          f"dataset train: step {int(trainer.state.step)}, {len(evals)} train-stream evals")
    check(main_counts == want, f"dataset train: launches {main_counts}, want {want}")
    check(all(np.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"dataset train: loss did not fall: {losses}")
    check(trainer.ckpt.all_steps() == [10, 20, 30],
          f"dataset train: checkpoints {trainer.ckpt.all_steps()}")
    check(len(scored) == 1 and scored[0]["step"] == steps and scored[0]["num_samples"] == n_test
          and np.isfinite(scored[0]["loss"]) and 0.0 <= scored[0]["accuracy"] <= 1.0,
          f"dataset train: the test eval {scored}")
    print(f"[train] tools/train.py --dataset-root (TCResNet8-1.0, B=100 f32, oversampling 0.5, "
          f"K3 + K7): {steps} steps in {wall:.1f} s, launches K3 {main_counts['k3']} K7 fwd "
          f"{main_counts['fwd']} dx {main_counts['dx']} dw {main_counts['dw']} (per step 1 K3, "
          f"10/9/10 K7; per train-stream eval 10 fwd; the test eval {test_batches} K2 + "
          f"{10 * test_batches} fwd), plain_routes 0; loss "
          + " -> ".join(f"{x:.4f}" for x in losses)
          + f"; checkpoints {trainer.ckpt.all_steps()}; --eval-split test at step {steps}: "
          f"{n_test} rows, accuracy {scored[0]['accuracy']:.4f}, loss {scored[0]['loss']:.4f}")

    # ---- a warm start: fc excluded and the only params trained, K1 + K2 ----
    fine = f"{root}/fine"
    warm_args = base + [
        "--cfg", "audio.frontend_fuse=off", "--train-dir", fine, "--step-save-checkpoint",
        "10", "--steps-per-call", "5", "--eval-split", "", "--checkpoint-path", f"{run}/ckpt",
        "--checkpoint-exclude-scopes", "fc", "--cfg", 'optim.trainable_scopes=["fc"]',
        "--cfg", "optim.lr_list=[0.1,0.01]", "--cfg", "optim.boundaries=[5]",
        "--cfg", "train.summary_step_default=5"]
    zero()
    warm = train_cli.main(warm_args + ["--max-step", "10"])
    torch.cuda.synchronize()
    warm_counts = counts()
    warm_evals = len([r for r in train_records(warm) if "train_stream/accuracy" in r])
    want = {"k1": 10, "k2": 10, "k3": 0, "k6": 0, "fwd": 100 + 10 * warm_evals, "dx": 90,
            "dw": 100, "plain_routes": 0}
    check(warm_counts == want, f"dataset warm start: launches {warm_counts}, want {want}")
    source = CheckpointManager(f"{run}/ckpt").restore_raw(steps)["params"]
    fresh = Trainer(load_run_config(fine), tds, workdir=f"{root}/fresh").state.params
    for k, v in warm.state.params.items():
        v = v.detach().cpu()
        if k.startswith("fc."):
            check(not torch.equal(v, source[k]) and not torch.equal(v, fresh[k].cpu()),
                  f"dataset warm start: {k} did not move")
        else:
            check(torch.equal(v, source[k]), f"dataset warm start: frozen {k} differs from "
                  "the source run's")
    check(set(warm.state.opt_state) == {k for k in warm.state.params if k.startswith("fc.")},
          f"dataset warm start: optimizer state {sorted(warm.state.opt_state)}")

    # ---- its resume under the relative LR shift ----
    zero()
    resumed = train_cli.main(warm_args + ["--max-step", "20",
                                          "--cfg", "optim.relative_schedule=true"])
    torch.cuda.synchronize()
    resume_counts = counts()
    lrs = {r["step"]: r["learning_rate"] for r in train_records(resumed)
           if "learning_rate" in r}
    check(int(resumed.state.step) == 20 and resume_counts["k1"] == resume_counts["k2"] == 10,
          f"dataset resume: step {int(resumed.state.step)}, launches {resume_counts}")
    check(warm.lr_schedule(10) == 0.01 and resumed.lr_schedule(10) == 0.1
          and lrs.get(15) == 0.1 and lrs.get(20) == 0.01,
          f"dataset resume: learning rates {lrs} (want 0.1 at step 15, 0.01 at 20)")
    print(f"[train] warm start from step {steps} (--checkpoint-exclude-scopes fc, "
          f"trainable_scopes fc, K1 + K2 + K7): 10 steps, launches K1 {warm_counts['k1']} K2 "
          f"{warm_counts['k2']} K7 fwd {warm_counts['fwd']} dx {warm_counts['dx']} dw "
          f"{warm_counts['dw']}; every non-fc param bit-equal to the source, fc moved, optimizer "
          f"state fc only; resumed at step 10 with relative_schedule: boundary 5 -> 15, "
          f"learning rate {lrs.get(15)} over steps 11-15 (unshifted: {warm.lr_schedule(10)}), "
          f"{lrs.get(20)} over 16-20")

    # ---- score the promoted best on test with tools/evaluate.py ----
    zero()
    again = evaluate_cli.main(["--train-dir", run, "--split", "test", "--valid-type", "once",
                               "--best-metric", "accuracy", "--best-split", "test",
                               "--cfg", "mesh.data=1"])
    torch.cuda.synchronize()
    eval_counts = counts()
    for key in ("accuracy", "loss", "mAP_macro"):
        check(again[key] == scored[0][key], f"dataset evaluate: {key} {again[key]} != "
              f"{scored[0][key]}")
    check(eval_counts["fwd"] == 10 * test_batches and eval_counts["k2"] == test_batches,
          f"dataset evaluate: launches {eval_counts}")
    print(f"[evaluate] tools/evaluate.py --split test --best-metric accuracy --best-split test: "
          f"step {steps} re-scored identically (accuracy {again['accuracy']:.4f}, loss "
          f"{again['loss']:.6f}), K2 {eval_counts['k2']} K7 fwd {eval_counts['fwd']}")

    # ---- times: the tree-backed step against the synthetic one, batch 100 ----
    run_cfg = load_run_config(run)
    trainers = {"tree": Trainer(run_cfg, tds, workdir=f"{root}/t_tree"),
                "synthetic": Trainer(run_cfg, synthetic, workdir=f"{root}/t_synthetic")}
    for tr in trainers.values():
        tr.train_steps(3, start=0)
    spans, n_steps = {label: [] for label in trainers}, 20
    for visit, label in enumerate(["tree", "synthetic", "synthetic", "tree"]):
        torch.cuda.synchronize()
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        ev0.record()
        trainers[label].train_steps(n_steps, start=3 + visit * n_steps)
        ev1.record()
        torch.cuda.synchronize()
        spans[label].append(((time.perf_counter() - t0) * 1e3 / n_steps,
                             ev0.elapsed_time(ev1) / n_steps))
    for label, runs in spans.items():
        data = trainers[label].data
        print(f"[times] train step B=100 f32 K3 + K7 on the {label} split ({data.num_samples} "
              f"rows, noise bank {tuple(data.noise_bank.shape)}): "
              + " / ".join(f"{h:.3f}" for h, _ in runs) + " ms/step host, "
              + " / ".join(f"{d:.3f}" for _, d in runs) + f" ms/step CUDA events (two visits of "
              f"{n_steps} steps; order tree, synthetic, synthetic, tree) | {card}")
    shutil.rmtree(root, ignore_errors=True)
    return {"k1_gather_augment": warm_counts["k1"], "k2_mfcc": warm_counts["k2"],
            "k3_frontend": main_counts["k3"], "k7_tconv_fwd": main_counts["fwd"],
            "k7_tconv_dx": main_counts["dx"], "k7_tconv_dw": main_counts["dw"]}


# phase 28's parity bounds: a DP step against one process's, the same draws,
# in float32: the losses, and the params relative to the largest |p| of
# any param (the sums over ranks and over the batch in another order)
DP_LOSS_ATOL = 1e-5
DP_PARAM_REL = 1e-5


def dp_parity(label: str, ranks: list, one: dict, route: tuple) -> str:
    """Phase 28's checks of a DP run's ranks against one process: losses
    and params within the bounds, params and BN statistics bit-equal on
    every rank, every kernel of `route` launched on every rank and no
    batch routed to the plain feature; the line's readings."""
    loss_err = max(abs(a - b) for r in ranks for a, b in zip(r["losses"], one["losses"]))
    check(loss_err <= DP_LOSS_ATOL, f"{label}: losses differ from one process by {loss_err}")
    scale = max(float(np.abs(want).max()) for want in one["params"].values())
    rel = max(float(np.abs(ranks[0]["params"][k] - want).max())
              for k, want in one["params"].items()) / scale
    check(rel <= DP_PARAM_REL, f"{label}: params differ from one process by {rel} of max|p|")
    for r in ranks[1:]:
        for field in ("params", "batch_stats"):
            for k, v in r[field].items():
                check(np.array_equal(v, ranks[0][field][k]),
                      f"{label}: {field} {k} differs between ranks")
    for i, r in enumerate(ranks):
        check(all(r["launches"][k] > 0 for k in route),
              f"{label}: rank {i} launched {r['launches']}, not every one of {route}")
        check(r["launches"]["plain_routes"] == 0, f"{label}: rank {i} took the plain feature")
    counts = "; ".join(f"rank {i} " + " ".join(f"{k} {r['launches'][k]}" for k in route)
                       for i, r in enumerate(ranks))
    return (f"losses {['%.6f' % x for x in ranks[0]['losses']]} (one process "
            f"{['%.6f' % x for x in one['losses']]}, max diff {loss_err:.1e}, limit "
            f"{DP_LOSS_ATOL}); params within {rel:.1e} of max|p| of one process (limit "
            f"{DP_PARAM_REL}); params and BN statistics bit-equal on every rank; {counts}")


def dp_phase(dev: torch.device, card: str) -> None:
    """Phase 28: data parallelism on the card (parallel/mesh.py), the
    ranks spawned after every kernel was built (phase 2), each returning
    its readings and launch counters."""
    import tempfile

    from tcresnet_tpu_torch import graft_entry
    from tcresnet_tpu_torch.ops.kernels import infer as k4
    from tcresnet_tpu_torch.parallel import mesh as meshlib
    from tcresnet_tpu_torch.serve.export import build_inference_fn
    from tcresnet_tpu_torch.tools import dp_check

    # ---- 28.1 two gloo ranks sharing the card against one process ----
    one_k3 = None
    for fuse, route in (("on", ("k3", "k7_fwd", "k7_dx", "k7_dw")),
                        ("off", ("k1", "k2", "k7_fwd", "k7_dx", "k7_dw"))):
        cfg = dp_check.train_cfg(256, fuse, "float32", data=2)
        label = f"28.1 B=256 f32 {'K3' if fuse == 'on' else 'K1 + K2'} + K7"
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            ranks = meshlib.launch(dp_check.parity_rank, cfg, 3, f"{tmp}/dp", cfg=cfg.mesh,
                                   devices=[dev, dev], timeout=600)
            took = time.perf_counter() - t0
            one = dp_check.parity_rank(None, cfg, 3, f"{tmp}/one", device=dev)
        one_k3 = one_k3 or one
        print(f"[dp] {label}, 2 gloo ranks on {dev} (collectives staged through the host) "
              f"against one process, 3 steps: {dp_parity(label, ranks, one, route)}; the "
              f"launch in {took:.1f} s | {card}")

    # ---- 28.2 the sharded evaluator ----
    cfg = dp_check.train_cfg(256, "on", "float32", data=2)
    variables = {"params": one_k3["params"], "batch_stats": one_k3["batch_stats"]}
    ranks = meshlib.launch(dp_check.evaluate_rank, cfg, variables, cfg=cfg.mesh,
                           devices=[dev, dev], timeout=600)
    want = dp_check.evaluate_rank(None, cfg, variables, device=dev)
    for i, got in enumerate(ranks):
        check(got["accuracy"] == want["accuracy"],
              f"28.2: rank {i} accuracy {got['accuracy']} != one process {want['accuracy']}")
        check(abs(got["loss"] - want["loss"]) <= 1e-6,
              f"28.2: rank {i} loss {got['loss']} vs one process {want['loss']}")
        check(got["num_samples"] == want["num_samples"] == 3012, "28.2: rows scored")
        check(got["launches"]["k2"] > 0 and got["launches"]["k7_fwd"] > 0,
              f"28.2: rank {i} launches {got['launches']}")
    print(f"[dp] 28.2 the evaluator over 2 ranks on {dev}: {int(want['num_samples'])} valid "
          f"rows in batches of {cfg.data.eval_batch_size} split 2 ways, accuracy "
          f"{ranks[0]['accuracy']:.6f} (one process {want['accuracy']:.6f}), loss "
          f"{ranks[0]['loss']:.8f} (one process {want['loss']:.8f}, limit 1e-6); launches a "
          f"rank K2 {ranks[0]['launches']['k2']} K7 fwd {ranks[0]['launches']['k7_fwd']} "
          f"| {card}")

    # ---- 28.3 NCCL, one rank: what the collectives and BN reductions cost ----
    cfg = dp_check.train_cfg(1536, "on", "bfloat16", data=1)
    with tempfile.TemporaryDirectory() as tmp:
        t = meshlib.launch(dp_check.step_times_rank, cfg, 20, tmp, True, cfg=cfg.mesh,
                           devices=[dev], timeout=600)[0]
    dp_ms, plain_ms = t["dp"]["ms_per_step"], t["plain"]["ms_per_step"]
    print(f"[dp] 28.3 NCCL, 1 rank on {dev}, TCResNet8-1.0 B=1536 bf16 K3 + K7, 20 steps a "
          f"reading (host clock, synchronised; turns plain, DP, DP, plain): DP "
          f"{dp_ms:.3f} ms/step {t['dp']['utt_per_s']:,.0f} utt/s (readings "
          f"{['%.3f' % x for x in t['dp']['readings_ms']]}), no mesh {plain_ms:.3f} ms/step "
          f"{t['plain']['utt_per_s']:,.0f} utt/s (readings "
          f"{['%.3f' % x for x in t['plain']['readings_ms']]}); the collectives and BN "
          f"reductions add {dp_ms - plain_ms:.3f} ms/step; a step dispatches (torch.profiler) "
          f"DP {t['dp']['counts']} against no mesh {t['plain']['counts']} | {card}")

    # ---- 28.4 NCCL across cards ----
    dp_across_cards(card, one_k3, plain_ms)

    # ---- 28.5 graft_entry ----
    cfg, variables = graft_entry.flagship_variables()
    forward, (wavs,) = graft_entry.entry(dev)
    before = k4.launches
    probs = forward(wavs)
    torch.cuda.synchronize()
    launched = k4.launches - before
    ref = build_inference_fn(cfg, variables, backend="xla", precision="highest", device=dev)
    err = (probs - ref(wavs)).abs().max().item()
    check(launched == 1, f"28.5: entry() launched K4 {launched} times")
    check(probs.shape == (8, 12) and err <= SOFTMAX_ATOL,
          f"28.5: entry() softmax differs from xla/highest by {err}")
    print(f"[dp] 28.5 entry() on {dev}: B=8 through K4 ({launched} launch), softmax within "
          f"{err:.2e} of the xla path at precision highest (limit {SOFTMAX_ATOL}) | {card}")
    t0 = time.perf_counter()
    res = graft_entry.dryrun_multichip(2, device="cuda", timeout=600)
    check(all(d.startswith("cuda") for d in res["devices"]),
          f"28.5: the dry run ran on {res['devices']}")
    print(f"[dp] 28.5 dryrun_multichip(2) on {', '.join(res['devices'])} ({res['backend']}"
          f"{', collectives staged through the host' if res['backend'] == 'gloo' else ''}), "
          f"the four legs in {time.perf_counter() - t0:.1f} s | {card}")


def dp_across_cards(card: str, one: dict, plain_ms: float) -> None:
    """Phase 28.4: over NCCL on 2 and 4 cards where the machine has them,
    the 28.1 parity (B=256 f32 K3 + K7, 3 steps, against one process's
    `one`) and the B=1536 bf16 step's times at a fixed global batch (1536
    over the cards) and at 1536 rows a card, beside one card's step with
    no mesh (`plain_ms`)."""
    import tempfile

    from tcresnet_tpu_torch.parallel import mesh as meshlib
    from tcresnet_tpu_torch.tools import dp_check

    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"[dp] 28.4 NCCL across cards needs 2 cards; this machine has {cards} | {card}")
    for n in (2, 4):
        if cards < n:
            continue
        devices = [torch.device("cuda", i) for i in range(n)]
        cfg = dp_check.train_cfg(256, "on", "float32", data=n)
        label = f"28.4 {n} cards B=256 f32 K3 + K7"
        with tempfile.TemporaryDirectory() as tmp:
            ranks = meshlib.launch(dp_check.parity_rank, cfg, 3, f"{tmp}/dp", cfg=cfg.mesh,
                                   devices=devices, timeout=600)
        print(f"[dp] {label}, NCCL, against one process: "
              f"{dp_parity(label, ranks, one, ('k3', 'k7_fwd', 'k7_dx', 'k7_dw'))} | {card}")
        for batch in (1536, 1536 * n):
            cfg = dp_check.train_cfg(batch, "on", "bfloat16", data=n)
            with tempfile.TemporaryDirectory() as tmp:
                t = meshlib.launch(dp_check.step_times_rank, cfg, 20, tmp, cfg=cfg.mesh,
                                   devices=devices, timeout=600)[0]
            print(f"[dp] 28.4 NCCL, {n} cards, B={batch} bf16 K3 + K7 ({batch // n} rows a "
                  f"card, 20 steps a reading): {t['dp']['ms_per_step']:.3f} ms/step "
                  f"{t['dp']['utt_per_s']:,.0f} utt/s (readings "
                  f"{['%.3f' % x for x in t['dp']['readings_ms']]}); one card at B=1536 with "
                  f"no mesh {plain_ms:.3f} ms/step {1536 / plain_ms * 1e3:,.0f} utt/s | {card}")


def seeded_variables_on(cfg, seed: int, dev: torch.device) -> dict:
    """The port's variables of `cfg`'s model made from a seed, on `dev`."""
    from tcresnet_tpu_torch.models.convert import seeded_variables, variables_from_jax
    from tcresnet_tpu_torch.ops import dsp

    v = variables_from_jax(cfg.model,
                           **seeded_variables(cfg.model, dsp.feature_shape(cfg.audio), seed))
    return {k: {n: t.to(dev) for n, t in d.items()} for k, d in v.items()}


def deploy_phase(dev: torch.device, card: str) -> dict:
    """Phase 27: the composed run and deployment through the entry points a
    user calls; K4's largest logit error at width 1.25 and its launches."""
    import shutil
    import subprocess
    import tempfile
    from pathlib import Path

    from tcresnet_tpu_torch.config import ModelConfig, get_preset
    from tcresnet_tpu_torch.models import build_model
    from tcresnet_tpu_torch.models.tc_resnet import scaled_channels
    from tcresnet_tpu_torch.ops import dsp
    from tcresnet_tpu_torch.ops.kernels import infer as k4
    from tcresnet_tpu_torch.ops.kernels import infer2d as k5
    from tcresnet_tpu_torch.ops.kernels import mfcc as k2
    from tcresnet_tpu_torch.serve import streaming
    from tcresnet_tpu_torch.serve.benchmark import benchmark_compiled, benchmark_on_device
    from tcresnet_tpu_torch.serve.export import (
        _with_matmul_precision, build_inference_fn, compile_inference, export_serialized,
        load_serialized)
    from tcresnet_tpu_torch.tools import export as export_cli
    from tcresnet_tpu_torch.train.checkpoint import CheckpointManager
    from tcresnet_tpu_torch.train.state import TrainState

    root = tempfile.mkdtemp(prefix="chip_smoke_deploy_")
    here = os.path.dirname(os.path.abspath(__file__))
    k4_launches, plain_before = k4.launches, k2.plain_routes

    # ---- 27.1 the composed run: trainer, loop evaluator, final test eval ----
    run = f"{root}/run"
    cmd = [sys.executable, "-m", "tcresnet_tpu_torch.tools.run_experiment",
           "--preset", "TCResNet8-1.0", "--synthetic", "--batch-size", "100",
           "--compute-dtype", "float32", "--max-step", "30", "--step-save-checkpoint", "10",
           "--cfg", "model.conv_backend=pallas", "--cfg", "audio.frontend_fuse=on",
           "--cfg", "mesh.data=1", "--eval-poll-timeout", "120", "--train-dir", run]
    env = {**os.environ, "PYTHONPATH": here + os.pathsep + os.environ.get("PYTHONPATH", "")}
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=400)
    run_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"run_experiment: rc {proc.returncode}\n{proc.stderr[-4000:]}")
    best = Path(run, "best", "valid", "accuracy")
    valid_steps = [json.loads(line)["step"]
                   for line in Path(run, "valid_metrics.jsonl").read_text().splitlines()]
    check(bool(list(best.glob("ckpt_*.pt"))), "run_experiment: no promoted best/valid/accuracy")
    check(30 in valid_steps, f"run_experiment: the loop evaluator scored steps {valid_steps}")
    check(Path(run, "test_metrics.jsonl").is_file(), "run_experiment: no final test eval")
    test_rec = json.loads(Path(run, "test_metrics.jsonl").read_text().splitlines()[-1])
    print(f"[deploy] run_experiment TCResNet8-1.0 B=100 f32, K3 + K7, 30 steps, trainer and "
          f"loop evaluator both on the card: rc 0 in {run_s:.1f} s; valid steps {valid_steps}; "
          f"best {sorted(p.name for p in best.glob('ckpt_*.pt'))}; test from the best: "
          f"accuracy {test_rec.get('accuracy', float('nan')):.4f} | {card}")

    # ---- 27.2 the export CLI on that run (K4), then DSCNNL (front end + K5) ----
    before = k4.launches
    res = export_cli.main(["--train-dir", run, "--best-metric", "accuracy", "--fused-kernel",
                           "--parity-precision", "highest", "--output", f"{root}/tc8.pt2",
                           "--benchmark"])
    tc8_k4 = k4.launches - before
    check(tc8_k4 > 0, "export CLI: --fused-kernel did not launch K4")
    check(k2.plain_routes == plain_before, "export CLI: a batch took the plain front end")
    print(f"[deploy] tools/export.py TCResNet8-1.0 best-accuracy B=1: compiled (CUDA graph) vs "
          f"build_inference_fn {res['compiled_err']:.2e}, fused (K4) vs xla TF32 off "
          f"{res['fused_err_highest']:.2e}, artifact ({res['artifact_bytes']} bytes) reloaded "
          f"vs xla TF32 off {res['artifact_err']:.2e} (limit 1e-5); K4 launches {tc8_k4}; "
          f"compiled host avg {res['compiled_host_us']['avg']:.1f} us, device avg (median of "
          f"{res['xla_device_us']['repeats']:.0f} blocks, converged "
          f"{bool(res['xla_device_us']['converged'])}) xla {res['xla_device_us']['avg']:.1f} "
          f"us, fused {res['fused_device_us']['avg']:.1f} us ({res['fused_device_us']['repeats']:.0f}"
          f" blocks, converged {bool(res['fused_device_us']['converged'])}) | {card}")

    ds = get_preset("DSCNNL")
    ds_dir = Path(root, "dscnnl")
    (ds_dir / "ckpt").mkdir(parents=True)
    (ds_dir / "config.json").write_text(ds.to_json())
    dv = seeded_variables_on(ds, 27, torch.device("cpu"))
    CheckpointManager(ds_dir / "ckpt").save(0, TrainState(
        step=torch.zeros((), dtype=torch.int64), params=dv["params"],
        batch_stats=dv["batch_stats"], opt_state={}))
    counts = (k2.launches + k2.phases_launches + k2.radix4_launches, k5.launches)
    res2 = export_cli.main(["--train-dir", str(ds_dir), "--fused-kernel",
                            "--parity-precision", "highest"])
    fe_n = k2.launches + k2.phases_launches + k2.radix4_launches - counts[0]
    k5_n = k5.launches - counts[1]
    check(fe_n > 0 and k5_n > 0, f"export CLI DSCNNL: front end {fe_n}, K5 {k5_n} launches")
    check(k2.plain_routes == plain_before, "export CLI DSCNNL: the plain front end ran")
    print(f"[deploy] tools/export.py DSCNNL ({ds.audio.dft_variant} front end + K5, seeded "
          f"checkpoint) B=1: compiled vs build_inference_fn {res2['compiled_err']:.2e}, fused vs "
          f"xla TF32 off {res2['fused_err_highest']:.2e} (limit 1e-5); front-end launches {fe_n}, "
          f"K5 {k5_n} | {card}")

    # ---- 27.3 compile_inference on the card; a CPU artifact loaded onto it ----
    flagship = get_preset("TCResNet8-1.0")
    v8 = seeded_variables_on(flagship, 0, dev)
    n = flagship.audio.desired_samples
    eager = build_inference_fn(flagship, v8, device=dev)
    hi = build_inference_fn(flagship, v8, precision="highest", device=dev)
    graph_times = {}
    for batch in (1, 1024):
        compiled, shape = compile_inference(flagship, v8, batch, device=dev)
        x = torch.tensor(seeded_wavs(2700 + batch, batch, n), device=dev)
        err = (compiled(x) - eager(x)).abs().max().item()
        check(err <= SOFTMAX_ATOL, f"compile_inference B={batch}: graph vs eager {err}")
        try:
            compiled(torch.zeros(batch + 1, n, device=dev))
            check(False, f"compile_inference B={batch}: another batch was accepted")
        except ValueError:
            pass
        stats = {name: (benchmark_compiled(fn, x), benchmark_on_device(fn, x))
                 for name, fn in (("graph", compiled), ("eager", eager))}
        graph_times[batch] = stats
        print(f"[deploy] compile_inference B={batch} (CUDA graph, TF32 off): vs the uncaptured "
              f"call {err:.2e}; another batch raises; "
              + "; ".join(f"{name} host avg {h['avg']:.1f} us, device avg {d['avg']:.1f} us "
                          f"({d['repeats']:.0f} blocks of {d['count']:.0f}, converged "
                          f"{bool(d['converged'])})" for name, (h, d) in stats.items())
              + f" | {card}")
    data = export_serialized(flagship, seeded_variables_on(flagship, 0, torch.device("cpu")), 1,
                             device="cpu")
    moved = _with_matmul_precision(load_serialized(data, device=dev), "highest")
    x = torch.tensor(seeded_wavs(2701, 1, n), device=dev)
    art_err = (moved(x) - hi(x)).abs().max().item()
    check(art_err <= SOFTMAX_ATOL, f"a CPU artifact loaded onto the card: {art_err}")
    print(f"[deploy] export_serialized on the CPU ({len(data)} bytes) -> "
          f"load_serialized(device='cuda'): vs the card's xla path TF32 off {art_err:.2e} "
          f"(limit 1e-5) | {card}")

    # ---- 27.4 K4 at width 1.25 against its plain version ----
    w_err = 0.0
    for name in ("TCResNet8", "TCResNet14"):
        cfg = get_preset(f"{name}-1.0")
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, width_multiplier=1.25))
        vw = seeded_variables_on(cfg, 0, dev)
        plan = k4.build_fused_infer(cfg.model, cfg.audio, vw["params"], vw["batch_stats"],
                                    device=dev)
        errs = []
        for batch in (1, 8, 1024):
            wavs = torch.tensor(seeded_wavs(1250 + batch, batch, n), device=dev)
            before = k4.launches
            got, again = k4.fused_infer(wavs, plan), k4.fused_infer(wavs, plan)
            torch.cuda.synchronize()
            check(k4.launches == before + 2, f"K4 {name}-1.25 B={batch}: launches")
            check(torch.equal(got, again), f"K4 {name}-1.25 B={batch}: two calls differ")
            want = k4.fused_infer_reference(wavs, plan)
            err = (got - want).abs().max().item()
            sm_err = (torch.softmax(got, -1) - torch.softmax(want, -1)).abs().max().item()
            check(torch.allclose(got, want, atol=LOGIT_ATOL, rtol=LOGIT_RTOL),
                  f"K4 {name}-1.25 B={batch}: logits differ by {err}")
            check(sm_err <= SOFTMAX_ATOL, f"K4 {name}-1.25 B={batch}: softmax {sm_err}")
            w_err = max(w_err, err)
            errs.append(f"B={batch} {err:.2e}/{sm_err:.2e}")
        print(f"[deploy] K4 {name}-1.25 (widths {list(scaled_channels(name, 1.25))}, the "
              f"convs' padded to {[c.w.shape[1] for c in plan.convs]}): max |logit| / |softmax| "
              f"err vs plain: {', '.join(errs)}; two calls bit-equal | {card}")

    # ---- 27.5 streaming SVDF at full size ----
    kws = get_preset("KWSfpool3")
    scfg = kws.replace(model=ModelConfig(name="KWS", kws_architecture="low_latency_svdf",
                                         num_classes=kws.model.num_classes))
    shape = dsp.feature_shape(scfg.audio)
    sv = seeded_variables_on(scfg, 5, dev)
    model = build_model(scfg.model, shape, device=dev)
    model.load_state_dict({**sv["params"], **sv["batch_stats"]})
    frames = torch.tensor(np.random.default_rng(5).normal(size=shape[:2]).astype(np.float32),
                          device=dev)
    with torch.no_grad():
        batch_probs = torch.softmax(model(frames[None, :, :, None])[0], -1)
    t = shape[0]
    full, _ = streaming.streaming_step(sv["params"], streaming.init_state(t, device=dev), frames)
    full_err = (full - batch_probs).abs().max().item()
    check(full_err <= SOFTMAX_ATOL, f"streaming: full window vs the batch model {full_err}")
    chunk_errs = {}
    for chunk in (1, 7):
        mem = streaming.init_state(t, device=dev)
        for i in range(0, t, chunk):
            probs, mem = streaming.streaming_step(sv["params"], mem, frames[i:i + chunk])
        chunk_errs[chunk] = (probs - full).abs().max().item()
        check(chunk_errs[chunk] <= 1e-4, f"streaming: chunks of {chunk} vs full {chunk_errs}")
    stride_us = scfg.audio.window_stride_ms * 1e3
    mem = streaming.init_state(t, device=dev)
    step_times = {chunk: benchmark_on_device(
        lambda x: streaming.streaming_step(sv["params"], mem, x), frames[:chunk].contiguous())
        for chunk in (1, 7)}
    print(f"[deploy] streaming SVDF ({mem.shape[0]} filters x {t} frames, MFCC-{shape[1]} at "
          f"{scfg.audio.window_stride_ms:g} ms stride): full window vs batch model "
          f"{full_err:.2e} (limit 1e-5); chunks of 1 / 7 vs full {chunk_errs[1]:.2e} / "
          f"{chunk_errs[7]:.2e} (limit 1e-4); "
          + "; ".join(f"{c} frame(s) a chunk {d['avg']:.1f} us device avg ({d['repeats']:.0f} "
                      f"blocks, converged {bool(d['converged'])}), real-time factor "
                      f"{d['avg'] / (c * stride_us):.4f}" for c, d in step_times.items())
          + f" | {card}")

    # ---- 27.6 the adaptive device protocol at batch 1: K4 and the xla path ----
    fused = build_inference_fn(flagship, v8, backend="fused", device=dev)
    x = torch.tensor(seeded_wavs(2706, 1, n), device=dev)
    for name, fn in (("K4 (fused)", fused), ("xla", eager)):
        d = benchmark_on_device(fn, x)
        print(f"[deploy] benchmark_on_device TCResNet8-1.0 B=1 {name}: avg {d['avg']:.1f} us "
              f"(median of {d['repeats']:.0f} blocks of {d['count']:.0f}), trimmed min "
              f"{d['min']:.1f} max {d['max']:.1f} std {d['std']:.2f}, converged "
              f"{bool(d['converged'])} | {card}")
    shutil.rmtree(root, ignore_errors=True)
    return {"max_abs_err": w_err, "launches": k4.launches - k4_launches}

def finite_fields(row: dict) -> bool:
    """Every number of a sweep row, nested ones too, finite."""
    nums = [v for v in row.values() if isinstance(v, (int, float)) and not isinstance(v, bool)]
    for v in row.values():
        if isinstance(v, dict):
            nums += [x for x in v.values() if isinstance(x, (int, float))]
    return bool(nums) and all(math.isfinite(x) for x in nums)


def tools_phase(dev: torch.device, card: str, ds) -> None:
    """Phase 29: the preset sweep (tools/benchmark.py) and the stage
    profiler (tools/profile_scaling.py) on the card, over the 24,100-row
    synthetic dataset of phase 10, with every launch counter set to 0
    before each leg and read after it."""
    import tempfile

    from tcresnet_tpu_torch.config import get_preset, plain_config
    from tcresnet_tpu_torch.tools import benchmark, profile_scaling
    from torch.utils.flop_counter import FlopCounterMode

    from tcresnet_tpu_torch.ops.kernels import launches_since
    from tcresnet_tpu_torch.train.trainer import Trainer
    from tcresnet_tpu_torch.utils.profiling import _ConvCount

    check(ds.device == dev, f"29: the dataset is on {ds.device}, not {dev}")
    t_phase = time.perf_counter()
    # ---- 29.1 the sweep: bench_preset, the card's FLOP rate and latency ----
    spc = 10
    steps = spc * (1 + benchmark.TIMED_CALLS)
    legs = (("TCResNet8-1.0", 1536, "bfloat16", "pallas", BF16_FLOPS),
            ("DSCNNL", 100, "float32", None, FP32_FLOPS))
    for name, batch, dtype, conv, peak in legs:
        reset_launch_counts()
        row = benchmark.bench_preset(name, batch, spc, dtype, ds, conv)
        got = {k: v for k, v in launch_counts().items() if v}
        check(finite_fields(row) and row["device_us"] is not None,
              f"29.1 {name}: a field is not finite: {row}")
        check(row["device_us"]["median"] <= row["host_e2e_us"]["median"],
              f"29.1 {name}: device_us {row['device_us']['median']} > host_e2e_us "
              f"{row['host_e2e_us']['median']}")
        check(got.get("k1") == steps, f"29.1 {name}: K1 launched {got.get('k1')}, not {steps}")
        if conv == "pallas":
            check(got.get("k7_dx") == 9 * steps and got.get("k7_dw") == 10 * steps
                  and got.get("k7_fwd", 0) >= 10 * steps,
                  f"29.1 {name}: K7 launched {got}, {steps} steps")
        # the count the row took on the meta device is that of the step run
        # here: the Trainer's step on the plain path, on the card at this
        # batch, counted as compiled_flops counts but for batch norm's
        # kernels, which a step on a card launches on the plain path too
        # (elementwise work and sums, which the count takes as nothing)
        cfg = get_preset(name)
        plain = plain_config(cfg).replace(train=dataclasses.replace(
            cfg.train, batch_size=batch, max_step=10**9, compute_dtype=dtype))
        with tempfile.TemporaryDirectory() as tmp:
            trainer = Trainer(plain, ds, workdir=tmp)
            before = launch_counts()
            with FlopCounterMode(display=False, custom_mapping=_ConvCount().mapping()) as fc:
                trainer.train_steps(1)
            launched = launches_since(before)
        check(set(launched) == {"bn"},
              f"29.1 {name}: the plain step launched {launched}, not batch norm's kernels alone")
        counted = int(fc.get_total_flops())
        check(row["flops_per_step"] == counted,
              f"29.1 {name}: step_flops {row['flops_per_step']:,} on the meta device, the "
              f"Trainer's plain step on the card {counted:,}")
        check(0 < row["train_tflops_per_sec"] < peak / 1e12,
              f"29.1 {name}: {row['train_tflops_per_sec']} TFLOP/s, the peak is {peak / 1e12}")
        rate = row["train_tflops_per_sec"]
        print(f"[tools] 29.1 sweep {name} B={batch} {dtype} conv {conv or 'preset'}: "
              f"{row['train_ms_per_step']:.3f} ms/step {row['train_utt_per_sec']:,.0f} utt/s "
              f"(host clock, 3 calls of {spc} steps), {row['flops_per_step']:,} FLOPs/step "
              f"(the meta device's count of the plain path, equal to the count of the "
              f"Trainer's plain step on the card) = "
              f"{rate:.3f} TFLOP/s ({rate * 1e12 / peak:.2%} "
              f"of the {peak / 1e12:g} TFLOP/s peak); batch-1 compiled serving host_e2e_us "
              f"median {row['host_e2e_us']['median']:.1f}, device_us median "
              f"{row['device_us']['median']:.1f} avg {row['device_us']['avg']:.1f}; launches "
              f"{got} | {card}")

    # ---- 29.2 the stage profiler, dsp_backend pallas, every stage ----
    n1, n2 = 5, 20
    args = profile_scaling.parse_args([
        "--batches", "1536", "2048", "--dsp-backend", "pallas", "--n1", str(n1),
        "--n2", str(n2), "--dataset-size", str(ds.num_samples),
        "--stages", *profile_scaling.STAGES])
    reset_launch_counts()
    rows = profile_scaling.run(args, ds)
    iters = 2 + n1 + n2
    step_iters = (1 + 1 + profile_scaling.STEP_CALLS) * profile_scaling.STEP_STEPS
    expect = {"sample": {}, "augment": {"k6": iters}, "augment_xla": {},
              "mfcc": {"k6": iters, "k2": iters}, "mfcc_pallas": {"k6": iters, "k2": iters},
              "gather_augment": {"k1": iters}, "gather_augment_mfcc": {"k1": iters, "k2": iters}}
    for r in rows:
        want = expect.get(r["stage"]) if r["stage"] != "step" else (
            {"k3": step_iters} if r["batch"] >= 2048 else {"k1": step_iters, "k2": step_iters})
        if "k2" in want or "k3" in want:  # 1536 and 2048 clips take the 128-row product
            want = {**want, "dft_wgmma": want.get("k2", 0) + want.get("k3", 0)}
        if r["stage"] == "step":  # TCResNet8-1.0's ten batch norms, six kernels each a step
            want = {**want, "bn": 6 * 10 * step_iters}
        check(r["us_per_iter"] > 0 and r["host_us_per_iter"] > 0 and r["enqueue_us_per_iter"] > 0,
              f"29.2: {r['stage']} at {r['batch']}: a time is not positive: {r}")
        check(r["launches"] == want,
              f"29.2: {r['stage']} at {r['batch']} launched {r['launches']}, not {want}")
    print(f"[tools] 29.2 profile_scaling B=1536, 2048, dsp pallas, n1 {n1} n2 {n2}: every "
          f"row positive, launches as each stage names (K6 augment, K1 gather, K2 mfcc, "
          f"the step K1 + K2 / K3, each K2 / K3 launch on the 128-row product) | {card}")

    # ---- 29.3 where a device-bound step's time goes: Res15, B=1024 bf16 ----
    cfg = get_preset("Res15")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=1024, max_step=10**9,
                                                compute_dtype="bfloat16"))
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(cfg, ds, workdir=tmp, steps_per_call=3)
        float(trainer.train_steps(3)["total_loss"])
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        float(trainer.train_steps(3)["total_loss"])
        end.record()
        torch.cuda.synchronize()
        host_ms, event_ms = (time.perf_counter() - t0) / 3 * 1e3, start.elapsed_time(end) / 3
        kinds, top = step_kernels(device_spans(lambda: float(trainer.train_steps(3)["total_loss"])),
                                  3)
    busy = sum(ms for ms, _ in kinds.values())
    print(f"[tools] 29.3 Res15 B=1024 bf16 step: {host_ms:.3f} ms/step host clock, "
          f"{event_ms:.3f} CUDA events, device busy {busy:.3f} ms/step "
          f"({busy / event_ms:.1%}; torch.profiler over 3 steps); by kind "
          + ", ".join(f"{k} {ms:.3f} ms / {n:.0f}" for k, (ms, n) in kinds.items())
          + "; costliest " + "; ".join(f"{name[:48]} {ms:.3f} ms x{n:.0f}"
                                       for ms, n, name in top[:5]) + f" | {card}")
    print(f"[tools] phase 29 in {time.perf_counter() - t_phase:.1f} s | {card}")



# (shape, channels-last, scale, relu) of the batch norms the benchmarked
# steps run. DS-CNN L's at batch 4096, shift only, each before a ReLU,
# channels-last as cuDNN's 2D convs return them on the card: its ten
# [276, 13, 5] maps and its first conv's [276, 25, 10] one; and [276, 13, 5]
# contiguous. TCResNet8-1.0's at batch 8192, contiguous [B, C, T] maps with
# scale and shift: its ten layers are four shapes, each before a ReLU
# (conv0, a block's conv0 and down) and without one (a block's conv1).
# [8192, 16, 98] plans 196 sample chunks of 42, the last one of 2 samples.
BN_CASES = (((4096, 276, 13, 5), True, False, True), ((4096, 276, 25, 10), True, False, True),
            ((4096, 276, 13, 5), False, False, True)) + tuple(
    ((8192, c, t), False, True, relu)
    for c, t in ((16, 98), (24, 49), (32, 25), (48, 13)) for relu in (True, False))
BN_REL = 1e-4


def batchnorm_phase(dev: torch.device, card: str) -> list:
    """Phase 30: the batch-norm kernels against their plain version and
    timed at DS-CNN L's and TCResNet8-1.0's layers; (kernel summary
    entries)."""
    import torch.nn.functional as F

    from tcresnet_tpu_torch.ops.kernels import batchnorm as kb
    from tcresnet_tpu_torch.ops.kernels import launch_counts, launches_since

    def rel(a, b) -> float:
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    print(f"[build] batchnorm.cu for sm_90a | {ptxas_line('batchnorm')}")
    entries = []
    for shape, last, scaled, relu in BN_CASES:
        gen = torch.Generator(device=dev).manual_seed(30)
        x = torch.randn(shape, device=dev, generator=gen) * 2 + 0.5
        x[:, 7] = 0.0  # a dead channel: the variance's tie
        dy = torch.randn(shape, device=dev, generator=gen)
        if last:
            x = x.contiguous(memory_format=torch.channels_last)
            dy = dy.contiguous(memory_format=torch.channels_last)
        c = shape[1]
        weight = torch.randn(c, device=dev, generator=gen) if scaled else None
        bias = torch.randn(c, device=dev, generator=gen)

        def fused(run):
            y, st = kb.kernel_forward(x, weight, bias, *run, 0.96, relu, torch.float32, None)
            return y, st, kb.kernel_backward(dy, x, weight, bias, st, relu, None)

        def plain(run):
            y, st = kb.plain_forward(x, weight, bias, *run, 0.96, relu, torch.float32, None)
            return y, st, kb.plain_backward(dy, x, weight, bias, st, relu, None)

        scale = weight if scaled else torch.ones(c, device=dev)  # cuDNN's backward wants one

        def library():  # the timing helper runs under no_grad
            with torch.enable_grad():
                xx = x.detach().requires_grad_(True)
                ww = scale.detach().requires_grad_(scaled)
                bb = bias.detach().requires_grad_(True)
                y = F.batch_norm(xx, None, None, ww, bb, True, 0.04, kb.EPS)
                y = F.relu(y) if relu else y
                return torch.autograd.grad(y, (xx, bb, ww) if scaled else (xx, bb), dy)

        def fresh():
            return torch.zeros(c, device=dev), torch.ones(c, device=dev)

        run_k, run_p = fresh(), fresh()
        before = launch_counts()
        y_k, st_k, (dx_k, dw_k, db_k) = fused(run_k)
        torch.cuda.synchronize()
        launched = launches_since(before)
        check(launched == {"bn": 6}, f"batch norm {shape}: launches {launched}, not 6 bn")
        y_p, _, _ = plain(run_p)
        # the backward from the kernels' statistics
        dx_p, dw_p, db_p = kb.plain_backward(dy, x, weight, bias, st_k, relu, None)
        errs = {"y": float((y_k - y_p).abs().max()) / max(1.0, float(y_p.abs().max())),
                "dx": rel(dx_k, dx_p), "dshift": rel(db_k, db_p),
                "running_mean": rel(run_k[0], run_p[0]), "running_var": rel(run_k[1], run_p[1])}
        if scaled:
            errs["dscale"] = rel(dw_k, dw_p)
        # float64 sums against torch's float32 ones over 266,240 to
        # 1,024,000 elements a channel: the last bits of mean and rstd, and
        # of dscale and dshift, sums of terms of both signs that cancel to
        # ~1% of their size
        check(all(e <= BN_REL for e in errs.values()) and float(st_k[2 * c + 7]) == 0.5,
              f"batch norm {shape} scale {scaled} relu {relu}: "
              + ", ".join(f"{k} {e:.3g}" for k, e in errs.items())
              + f" of their max (limit {BN_REL}), tie {float(st_k[2 * c + 7])}")
        del y_k, dx_k, y_p, dx_p
        ms_k = device_ms(lambda: fused(fresh()))
        ms_p = device_ms(lambda: plain(fresh()))
        ms_l = device_ms(library)
        nbytes = 5 * 4 * x.numel()
        bnd = bound(0, nbytes)
        layout = "channels-last" if last else "contiguous"
        what = ("scale, shift" if scaled else "shift") + (", relu" if relu else "")
        print(f"[bn] {list(shape)} {layout} f32, {what}: fused forward + backward "
              f"{ms_k:.4f} ms, plain {ms_p:.4f} ms, F.batch_norm{' + F.relu' if relu else ''} "
              f"under autograd {ms_l:.4f} ms; bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}, "
              f"x, y, dy, x, dx once: {bnd['bound_ms'] / ms_k:.1%} of it, "
              f"{nbytes / ms_k / 1e6:.0f} GB/s); {kb._plan(x)}; max |err| of max: "
              + ", ".join(f"{k} {e:.3g}" for k, e in errs.items()) + f" | {card}")
        entries.append({"name": f"bn_train_{'x'.join(map(str, shape[1:]))}"
                                + ("_nhwc" if last else "") + ("_scale" if scaled else "")
                                + ("" if relu else "_norelu"),
                        "route": "cuda", "source": "tcresnet_tpu_torch/csrc/batchnorm.cu",
                        "replaces": None, "batch": shape[0], "launches": launched["bn"],
                        "max_abs_err": max(errs.values()), "ms": ms_k,
                        "plain_ms": ms_p, **bnd, "library_ms": ms_l})
        del x, dy
        torch.cuda.empty_cache()
    return entries

if __name__ == "__main__":
    sys.exit(main())
