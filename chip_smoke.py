#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving and training paths on one CUDA card.

    python3 chip_smoke.py

Drives tcresnet_tpu_torch (never JAX) at full width (TCResNet8-1.0: 16
kHz, 1 s clips, MFCC-40, channels 16/24/32/48, 12 classes; the 2D
presets at theirs) with weights and data made from seeds: the build, the
long runs of the main paths, and the kernels' times. Each timing phase
also holds every kernel it times against its plain version on the inputs
it times; the wide sweeps of geometries, batches and dtypes,
the JAX goldens and the serving routes' edge cases are the card tests'
(the `cuda` marker):

    python -m pytest tests/test_torch_cuda.py tests/test_torch_batchnorm.py -m cuda -q \
        --noconftest -p no:cacheprovider

The phases print their lines; their numbers are kept where others went:

  1. device   the card, as nvidia-smi reports its name and power limit
  2. build    every kernel source built with nvcc, one process each, all
              started together; the ptxas line of each K4 instantiation
              (csrc/infer.cu: K2's stage in its 16-, 64- and 128-row tiles,
              then the conv stack), none of which may spill
  6. times    20 single requests through backend "auto" (K4), within 1e-5 of
              "xla" at "highest"; at batch 1 and 1024 K4 against its plain
              version and "fused" against "xla", each timed (host clock, CUDA
              events); K4 and the `xla` model (wav -> softmax, TF32 off, a
              CUDA graph) on one clock behind a device sleep at batch 1 to
              1024 (tools/infer_times.py), K4's two paths forced beside, the
              crossover batch, K4's bound (the DFT at 3xTF32)
  7. build    the training slice's kernels: augment.cu (K1, K6), mfcc.cu (K2),
              frontend.cu (K3), with their ptxas lines
 10. train    the main path: Trainer at batch 1536, bf16, one leg with
              frontend_fuse="on" (K3) and one "off" (K1 + K2); launch counts
              equal the step counts, no batch leaves the kernels
              (mfcc.plain_routes stays 0), the loss falls, the train-stream
              eval and the audio summary (K6) run; a float32 batch-100 preset
              leg; resume from a checkpoint is exact
 11. times    K1, K6 (bit-exact), K2 and K3 against their plain versions at
              batch 1536, each timed beside it; ms/step, utt/s and the
              device's busy share of the step for the input legs at batch 1536
              and 4096
 12. build    tconv.cu (K7: fwd, dx, dw), the ptxas line of each kernel (fwd's
              and dx's by their n8-tile width, dw's by its m16 and n8 tiles);
              fails if a fwd, dx or dw tile spills
 14. train    the main path through K7: Trainer with conv_backend="pallas" at
              batch 1536 in bf16, 30 steps, a checkpoint every 10; K7 launches
              per step (10 fwd, 9 dx, 10 dw) and per train-stream eval (10
              fwd); the loss falls; resume is exact; a float32 batch-100
              preset leg "pallas" against "xla" over 5 steps
 15. evaluate the loop evaluator (tools/evaluate.py) over that run on the
              synthetic valid split: each checkpoint scored once through K7's
              forward, the best promoted and re-scored identically; "pallas"
              against "xla" on one checkpoint
 16. times    each conv's K7 fwd, dx and dw against its plain version at batch
              1536; then K7 and cuDNN (TF32 off) over one step's ten convs and
              per conv, CUDA events behind a device sleep
              (tools/tconv_times.py; a drained queue is named), dx also over
              the nine convs a step launches it for, the eager readings (host
              gaps included) and the plain versions beside; K7 beside cuDNN
              f32 and bf16 (the `xla` step's call) by torch.profiler; the
              host's enqueue of the ten fwd calls; the train step "pallas"
              against "xla", its device time by kind and costliest kernels;
              eval utt/s
 17. build    infer2d.cu (K5, the 2D families' op-list kernel), its ptxas line
              and its cooperative grid
 20. times    TCResNet2D8-1.0, Res15, DSCNNL, KWSfpool3 at batch 1 and 1024:
              K5, its plain version and the model on cuDNN (TF32 off, as a
              CUDA graph) over the same features on one clock, CUDA events
              behind a device-side sleep (K5 and cuDNN must not be paced by
              the host; the line names the plain version if it was); one eager
              cuDNN model call under torch.profiler as a second line; K5's
              bound at the 3xTF32 rate; K5 per step for Res15 and KWSfpool3
              (the program cut after each step); the served request (K2 + K5,
              and "xla") on the host clock; K5 against its plain version at
              both batches, the served "fused" request against "xla" at batch
              1
 21. build    mfcc.cu (K2 and K8 one entry point, K9) and frontend.cu (K3 hops
              and phases one entry point, radix4) rebuilt, the ptxas line of
              every kernel (K2's and K8's shared stage, "hops+phases", in its
              16-, 64- and 128-row tiles, K9's in its 64-row and 112-row
              products); the hops and K8 tiles must not spill, nor K9's
              112-row product more than before (K9_SPILL_BYTES)
 23. train    the 2D main path: the DSCNNL preset (MFCC-10 at 40/20 ms, batch
              100, float32, adam) with dft_variant="radix4" and
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
              (TF32 off, the library time) at batch 1536 for both geometries,
              eager; K8 and K3-phases behind a device sleep on one clock with
              the library call as a CUDA graph, at batch 1536 (both
              geometries; frontend_times.hops_times, as phase 25), K8 and K9
              with it at batch 1; K8's and K9's bounds at the 3xTF32 rate; K3
              in its variants; each kernel first held against its plain
              version on the inputs timed; ms/step, utt/s and the device's
              busy share of the DSCNNL and Res15 train steps at their preset
              batch
 25. times    K2 and K3-hops at batch 1536 and K2 at batch 1, at 480/160,
              640/320 and 400/200, behind a device sleep on one clock with
              dsp.preprocess on cuBLAS as a CUDA graph
              (tcresnet_tpu_torch/tools/frontend_times.py), their bounds at
              the 3xTF32 rate; the summary's K2 and K3 times; both kernels
              held against their plain versions on the same draws
 26. dataset  the Speech Commands path on a tree made from a seed (2,400
              one-second wavs over 10 keywords and 4 other words, speaker-
              hashed names, and six noise clips of 60-95 s): the port's
              prepare_dataset --extracted; train, valid and test loaded with
              the C++ decoder (fails where numpy decoded), twice, the cache
              hit equal to the decode; K1 bit-exact to its plain version on
              the 6 x 1,520,000 noise bank with rows drawn through sample_row,
              K3 and K7 at the run's batch; tools/train.py's main at
              TCResNet8-1.0, batch 100, float32, oversampling on, K3 and K7,
              30 steps, a checkpoint every 10, --eval-split test: launches
              equal the steps, plain_routes 0, the loss falls; a warm start
              from it with fc excluded and only fc trained (K1 + K2), every
              other param bit-equal to the source, fc moved; its resume under
              relative_schedule, the first learning rate the shifted one;
              tools/evaluate.py --split test re-scores the promoted best
              identically; the decode per 1,000 wavs (C++ and numpy), the
              upload, and the tree-backed step against the synthetic one at
              batch 100
 27. deploy   tools/run_experiment.py at TCResNet8-1.0 (batch 100, float32, K3
              and K7, 30 steps, a checkpoint every 10; trainer and loop
              evaluator on the card): rc 0, a promoted best, step 30 scored,
              the final test eval; tools/export.py on that run (best accuracy,
              --fused-kernel, TF32 off, --output, --benchmark): its three 1e-5
              gates, K4 launched, plain_routes 0; the same CLI on a seeded
              DSCNNL checkpoint through K2 + K5 (27.1, 27.2);
              compile_inference's CUDA graph at batch 1 against the uncaptured
              call, another batch refused, a CPU artifact loaded onto the card
              against its xla path (27.3); K4 at width 1.25, TCResNet8 and
              TCResNet14 at batch 8, against its plain version (27.4);
              streaming SVDF, the full window against the batch model, chunks
              of 7 against it (27.5); the adaptive benchmark_on_device at
              batch 1 for K4 and the xla path (27.6)
 28. dp       data parallelism (parallel/mesh.py, tools/dp_check.py), the
              ranks spawned after every kernel was built, each returning its
              readings and launch counters: 28.1 two gloo ranks sharing the
              card against one process, TCResNet8-1.0 at batch 256 in float32,
              K3 + K7 and K1 + K2 + K7, 3 steps (losses within 1e-5, params
              within 1e-5 of max|p|, params and BN statistics bit-equal on
              both ranks, every kernel launched on every rank); 28.2 the
              evaluator over the 3,012 valid rows on 2 ranks (accuracy equal,
              loss within 1e-6); 28.3 one NCCL rank, the bf16 step at batch
              1536, 20 steps, ms/step and utt/s beside the step without a
              mesh; 28.4 the parity and the step's times (1536 rows in all,
              and 1536 a card) over NCCL across 2 and 4 cards where the
              machine has them (a line that says so where not); 28.5
              graft_entry.entry() (K4, softmax within 1e-5 of the xla path)
              and dryrun_multichip(2) on the card (two cards over NCCL, else
              two gloo ranks sharing one)
 29. tools    the preset sweep (tools/benchmark.py::bench_preset) at
              TCResNet8-1.0 (batch 1536, bf16, conv_backend "pallas") and
              DSCNNL (batch 100, float32): every field finite, the device
              latency at most the host's, K1 launched once a step and K7 dx /
              dw 9 / 10 times, the step's FLOP count (the meta device's,
              utils/profiling.py::step_flops) equal to the count of the
              Trainer's plain step on the card at the same batch, and its rate
              below the card's peak for the dtype; the stage profiler
              (tools/profile_scaling.py) at batch 1536 and 2048 with
              dsp_backend "pallas", all eight stages, n1 5 and n2 20: every
              time positive, each stage's launches exactly those of the
              kernels it names (K6, K1, K2; the step K1 + K2, and K3 from
              2048); Res15's device-bound step at batch 1024 in bf16: host
              clock, CUDA events and the device's time by kind
              (torch.profiler)
 30. bn       batch norm in training mode + ReLU (csrc/batchnorm.cu): the
              ptxas line; at DS-CNN L's layers at batch 4096 (shift, relu;
              [276, 13, 5] and [276, 25, 10] channels-last, as cuDNN returns
              them, [276, 13, 5] contiguous) and TCResNet8-1.0's four at 8192
              (scale and shift, relu on and off): the fused forward + backward
              (6 launches) within 1e-4 of the plain version's max in every
              output and running statistic, a dead channel's tie, timed
              against its 5-pass byte bound, the plain version and
              F.batch_norm [+ F.relu] under autograd (CUDA events)

then the kernel summary as one JSON line (each kernel with its launches on
its main path, its time, the plain version's, the least time the card
could take for the same work and what bounds it, and the time of one
PyTorch call that computes the same function where there is one; K4's
launches are phase 6's, K5's phase 23's; K1, K2, K3 and K7 also their
launches in phase 26, `launches_dataset`, K4 its launches in phase 27,
`launches_deploy`), and last {"ok": true, "device": {...}}. Any failed
check raises and the script exits non-zero without that line. There is no
CPU fallback: without a CUDA device it exits 1.
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

# kernel against plain version in the timing phases: the card tests'
# tolerances (tests/test_torch_cuda.py), the JAX package's kernel tests'
LOGIT_TOL = dict(atol=5e-4, rtol=1e-4)
SOFTMAX_ATOL = 1e-5
FEATURE_TOL = dict(atol=1e-4, rtol=0)
# batch norm: float64 sums against float32 ones over up to 1,024,000
# elements a channel, relative to the output's max
BN_REL = 1e-4
# features of int16 dataset rows (loud tones, MFCC up to ~160, where
# float32 steps are 1.5e-5) through a kernel against the plain path: the
# JAX package's tolerance for the same comparison
# (tests/test_pallas_frontend.py::test_fused_frontend_eval_mode)
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
# the H100 SXM's published peaks: float32 outside the tensor cores, and HBM
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
# the spill stores ptxas reports for K9's 112-row product (mfcc.cu,
# frontend.cu) since it shares dft_tc.cuh's tc_mma: phase 21 fails if they
# grow
K9_SPILL_BYTES = {"mfcc": 52, "frontend": 12}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def held(got: torch.Tensor, want: torch.Tensor, what: str, atol: float, rtol: float) -> float:
    """max |got - want|, after checking got within atol + rtol |want| of it."""
    err = (got - want).abs().max().item()
    check(bool(torch.allclose(got, want, atol=atol, rtol=rtol)), f"{what}: max err {err}")
    return err


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

    # ---- 6. times ----
    flagship = get_preset("TCResNet8-1.0")
    v8 = seeded_variables_on(flagship, 0, dev)
    n = flagship.audio.desired_samples
    plan8 = k4.build_fused_infer(flagship.model, flagship.audio, v8["params"], v8["batch_stats"],
                                 device=dev)
    ref = build_inference_fn(flagship, v8, backend="xla", precision="highest", device=dev)
    plain_default = build_inference_fn(flagship, v8, backend="xla", device=dev)
    fused_fn = build_inference_fn(flagship, v8, backend="fused", device=dev)
    # the served main path: 20 single requests through backend "auto" (K4)
    auto = build_inference_fn(flagship, v8, backend="auto", device=dev)
    requests = [torch.tensor(seeded_wavs(1000 + i, 1, n), device=dev) for i in range(20)]
    before = k4.launches
    answers = [auto(x) for x in requests]
    torch.cuda.synchronize()
    k4_served = k4.launches - before
    check(k4_served == len(requests), f"serve auto: {k4_served} K4 launches for 20 requests")
    err = max(held(y, ref(x), "serve auto B=1", SOFTMAX_ATOL, 0.0)
              for x, y in zip(requests, answers))
    print(f"[serve] auto TCResNet8-1.0: 20 x B=1 through K4 ({k4_served} launches); max "
          f"softmax err vs xla/highest {err:.2e} | {card}")
    times = {}
    for batch in (1, 1024):
        x = torch.tensor(seeded_wavs(3000 + batch, batch, n), device=dev)
        got, want = plan8(x), k4.fused_infer_reference(x, plan8)
        errs = (held(got, want, f"K4 B={batch} logits", **LOGIT_TOL),
                held(torch.softmax(got, -1), torch.softmax(want, -1), f"K4 B={batch} softmax",
                     SOFTMAX_ATOL, 0.0),
                held(fused_fn(x), ref(x), f"serve fused B={batch}", SOFTMAX_ATOL, 0.0))
        print(f"[kernel] K4 B={batch} vs plain: logits {errs[0]:.2e}, softmax {errs[1]:.2e}; "
              f"served fused vs xla/highest {errs[2]:.2e}")
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
        print(f"[times] K4 B={batch}: kernel {a:.4f} / {d:.4f} ms, the xla model wav -> softmax "
              f"(TF32 off) as a CUDA graph {c:.4f} ms (device, mean of 20 behind a device "
              f"sleep; order kernel, xla, kernel); the graph takes {c / min(a, d):.2f}x K4's "
              f"time; bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}, DFT at 3xTF32, "
              f"{bnd['bound_ms'] / min(a, d):.1%} of it); K4's paths forced, conv stacks in "
              f"the stage's blocks {t['fused'][0]:.4f} / {t['fused'][1]:.4f} ms, in a kernel "
              f"of their own {t['two_kernels'][0]:.4f} / {t['two_kernels'][1]:.4f} ms (order "
              f"fused, two, two, fused; the rule takes "
              f"{'two kernels' if plan8.two_kernels(batch) else 'the fused path'}) | {card}")
    print(f"[times] K4 against the xla graph: the graph is faster from batch "
          f"{crossover(k4_t)} on (None: K4 is faster at every batch timed, "
          f"{', '.join(map(str, k4_batches))}) | {card}")

    train_kernels, ds = training_phases(dev, card)
    tconv_kernels = tconv_phases(dev, card, ds)
    infer2d_kernels = infer2d_phases(dev, card)
    variant_kernels, k5_served = dft_variant_phases(dev, card, ds)
    infer2d_kernels[0]["launches"] = k5_served  # phase 23's auto requests through K5
    hops = hops_phase(dev, card, ds)
    for e in train_kernels:  # phase 25 for K2 and K3-hops
        if e["name"] in hops:
            e.update(hops[e["name"]])
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
        "launches": k4_served,
        "launches_deploy": deploy["launches"],
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
    """Phases 7, 10 and 11: the training slice's kernels and its main path;
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
        # K1 and K6 bit-exact; K2 and K3 on dataset rows
        exact = dict(atol=0.0, rtol=0.0)
        tols = {"k1": exact, "k6": exact, "k2": DATASET_FEATURE_TOL, "k3": DATASET_FEATURE_TOL}
        for name, (kernel, plain) in pairs.items():
            got = kernel()
            err = held(got, plain().reshape(got.shape), f"{name} B={batch}", **tols[name])
            a, b, c, d = (device_ms(kernel), device_ms(plain), device_ms(plain), device_ms(kernel))
            ms[name] = (min(a, d), min(b, c))
            print(f"[times] {name} B={batch}: kernel {a:.4f} / {d:.4f} ms, plain {b:.4f} / "
                  f"{c:.4f} ms (CUDA events, median of 20; order kernel, plain, plain, "
                  f"kernel); vs plain {err:.2e} | {card}")

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

    def entry(name, source, replaces, key):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": main_launches[key], "ms": ms[key][0], "plain_ms": ms[key][1],
                **bounds[key], "library_ms": library[key]}

    return [
        entry("k1_gather_augment", "tcresnet_tpu_torch/csrc/augment.cu",
              "tcresnet_tpu/ops/pallas/augment.py:258", "k1"),
        entry("k6_augment", "tcresnet_tpu_torch/csrc/augment.cu",
              "tcresnet_tpu/ops/pallas/augment.py:159", "k6"),
        entry("k2_mfcc", "tcresnet_tpu_torch/csrc/mfcc.cu",
              "tcresnet_tpu/ops/pallas/mfcc.py:410", "k2"),
        entry("k3_frontend", "tcresnet_tpu_torch/csrc/frontend.cu",
              "tcresnet_tpu/ops/pallas/frontend.py:108", "k3"),
    ], ds


def tconv_phases(dev: torch.device, card: str, ds) -> list:
    """Phases 12 and 14-16: K7 and the paths through it, training and
    evaluation."""
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

    # ---- 14. train through K7: the main path ----
    flagship = get_preset("TCResNet8-1.0")
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
    geoms = conv_geometries(flagship.model, 98, 40)
    convs = conv_cases(dev, geoms, batch, torch.Generator(device=dev).manual_seed(1234))
    ops = conv_ops()
    k7_err = {}
    for op, (kernel, plain, _) in ops.items():
        errs = []
        for c in convs:
            got, want = kernel(c), plain(c)
            tol = {"fwd": TCONV_FWD_TOL, "dx": TCONV_DX_TOL,
                   "dw": dict(atol=TCONV_DW_REL * want.abs().max().item(), rtol=0.0)}[op]
            errs.append(held(got, want, f"K7 {op} {c['geom']} B={batch}", **tol))
        k7_err[op] = max(errs)

    def ten(f):
        return lambda: [f(c) for c in convs]

    # behind a device sleep (CUDA events time the device's work, not the
    # host's launches; tools/tconv_times.py), in the order kernel, cuDNN,
    # cuDNN, kernel; the eager reading beside it counts the gaps the host
    # leaves between the launches
    queued = k7_times(convs)
    ms = {}
    for op, (kernel, plain, cudnn) in ops.items():
        (a, d), (b, c), full = (queued[op]["ten"][key] for key in ("kernel", "cudnn", "queue_full"))
        ek, ep, ec = device_ms(ten(kernel)), device_ms(ten(plain)), device_ms(ten(cudnn))
        ms[op] = dict(ms=min(a, d), library_ms=min(b, c), plain_ms=ep, ms_eager=ek,
                      library_ms_eager=ec, queue_full=full)
        print(f"[times] K7 {op} B={batch}, the ten convs of one step, behind a device sleep: "
              f"kernel {a:.4f} / {d:.4f} ms, cuDNN f32 (TF32 off) {b:.4f} / {c:.4f} ms (mean of "
              f"20; order kernel, cuDNN, cuDNN, kernel; "
              + ("queue full" if full else "a queue DRAINED: host-paced") + ") | eager (host gaps "
              f"included, median of 20): kernel {ek:.4f} ms, plain {ep:.4f} ms, cuDNN {ec:.4f} ms"
              f"; vs plain {k7_err[op]:.2e} | {card}")
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
                "launches": main_launches[op],
                **ms[op], **bound(k7_flops, k7_bytes, TF32X3_FLOPS),
                "cudnn_ms": ms[op]["library_ms"]}

    return [entry("fwd", 63), entry("dx", 68), entry("dw", 99)]


def infer2d_phases(dev: torch.device, card: str) -> list:
    """Phases 17 and 20: K5 and the 2D families' serving path through it,
    timed."""
    from tcresnet_tpu_torch.config import get_preset
    from tcresnet_tpu_torch.models import build_model
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
    for preset in ("TCResNet2D8-1.0", "Res15", "DSCNNL", "KWSfpool3"):
        cfg = get_preset(preset)
        v = seeded_variables_on(cfg, 0, dev)
        plan = k5.build_fused_infer2d(cfg.model, cfg.audio, v["params"], v["batch_stats"],
                                      device=dev)
        model = build_model(cfg.model, dsp.feature_shape(cfg.audio), device=dev)
        model.load_state_dict({**v["params"], **v["batch_stats"]})
        fused_fn = build_inference_fn(cfg, v, backend="fused", device=dev)
        xla_fn = build_inference_fn(cfg, v, backend="xla", precision="highest", device=dev)
        for batch in (1, 1024):
            wavs = torch.tensor(seeded_wavs(3000 + batch, batch, cfg.audio.desired_samples),
                                device=dev)
            feats = k2.fused_mfcc(wavs, cfg.audio)
            feats4 = feats[..., None]
            got, want = k5.fused_infer2d(feats, plan), k5.fused_infer2d_reference(feats, plan)
            errs = [held(got, want, f"K5 {preset} B={batch} logits", **LOGIT_TOL),
                    held(torch.softmax(got, -1), torch.softmax(want, -1),
                         f"K5 {preset} B={batch} softmax", SOFTMAX_ATOL, 0.0)]
            if batch == 1:  # the served request: K2 + K5 against the xla path
                errs.append(held(fused_fn(wavs), xla_fn(wavs), f"serve fused {preset}",
                                 SOFTMAX_ATOL, 0.0))
            print(f"[kernel] K5 {preset} B={batch} vs plain: logits {errs[0]:.2e}, softmax "
                  f"{errs[1]:.2e}" + (f"; served fused (K2 + K5) vs xla/highest {errs[2]:.2e}"
                                      if batch == 1 else ""))
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
            print(f"[times] K5 {preset} B={batch}: kernel {a:.4f} / {d:.4f} ms, plain {b:.4f} ms, "
                  f"cuDNN model f32 (TF32 off) as a CUDA graph {c:.4f} / {c2:.4f} ms (device, mean "
                  f"of {runs} behind a device sleep; order kernel, plain, cuDNN, cuDNN, kernel; "
                  f"host-paced: {paced}); bound {t['bound_ms']:.4f} ms ({t['bound_by']} at "
                  f"3xTF32 {TF32X3_FLOPS / 1e12:.0f} TFLOP/s, {t['bound_ms'] / t['ms']:.1%} of it)"
                  f" | {card}")
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
    """Phases 21, 23 and 24: K8 and K9 (the MFCC kernel's and K3's phases
    and radix4 entry points) and the 2D families' training path through
    them; (kernel summary entries, K5's launches for phase 23's requests)."""
    import tempfile

    from tcresnet_tpu_torch.config import get_preset
    from tcresnet_tpu_torch.data.device_data import DeviceDataset
    from tcresnet_tpu_torch.ops import augment as aug
    from tcresnet_tpu_torch.ops import dsp
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

    n = 16000
    geoms = {"480/160 MFCC-40": get_preset("TCResNet8-1.0").audio,
             "640/320 MFCC-10": get_preset("DSCNNL").audio}
    gen = torch.Generator(device=dev)
    augment_cfg = get_preset("TCResNet8-1.0").augment

    def draw(batch, seed):
        gen.manual_seed(seed)
        idx, _, silent = DeviceDataset.sample_indices(ds.arrays, gen, batch)
        return idx, aug.draw_scalars(gen, silent, augment_cfg, ds.noise_bank, n, True)

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
    k5_served = k5.launches - before_k5
    check(delta == (0, 20, 20) and k5_served == 40,
          f"serve 2D variants: K2/K8/K9 launches {delta}, K5 {k5_served}")
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
          f"{serve_ms:.1f} ms, K8 {delta[1]} / K9 {delta[2]} / K5 {k5_served} "
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
            err = held(k2.fused_mfcc(wavs, cfg), k2.fused_mfcc_reference(wavs, cfg, variant),
                       f"{kname[variant]} {label} B={batch}", **FEATURE_TOL)
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
                  f" of it) (CUDA events, median of 20; order kernel, plain, plain, kernel); "
                  f"vs plain {err:.2e} | {card}")
            if variant == "phases":
                (a, d), c = q["k2"], q["library"]
                ms[(variant, label)].update(ms=min(a, d), library_ms=c)
                print(f"[times] K8 (phases) {label} B={batch}, behind a device sleep: kernel "
                      f"{a:.4f} / {d:.4f} ms, dsp.preprocess on cuBLAS as a CUDA graph {c:.4f} "
                      f"ms (device, mean of 20; order kernel, library, kernel); the library "
                      f"takes {c / min(a, d):.2f}x K8's time, {bnd['bound_ms'] / min(a, d):.1%} "
                      f"of its bound | {card}")
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
            err = held(k2.fused_mfcc(one, cfg), k2.fused_mfcc_reference(one, cfg, variant),
                       f"{kname[variant]} {label} B=1", **FEATURE_TOL)
            bnd = bound(2 * variant_macs(cfg, variant),
                        4 * (n + np.prod(dsp.feature_shape(cfg)[:2])), TF32X3_FLOPS)
            ms[(variant, label)].update(ms_b1=min(a, d), library_ms_b1=c,
                                        bound_ms_b1=bnd["bound_ms"])
            print(f"[times] {kname[variant]} ({variant}) {label} B=1: kernel {a:.4f} / {d:.4f} "
                  f"ms, dsp.preprocess on cuBLAS (TF32 off, dense) as a CUDA graph {c:.4f} ms "
                  f"(device, mean of 20 behind a device sleep; order K9, K8, library, K8, K9); "
                  f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']} at 3xTF32); vs plain "
                  f"{err:.2e} | {card}")
        idx, sc = draw(batch, 77)
        mixed = int((sc.vols != 0).sum())
        for variant in ("hops", "phases", "radix4"):
            cfg = dataclasses.replace(geoms[label], dft_variant=variant)
            err = held(k3.frontend_features(ds.wavs, idx, sc, ds.noise_bank, cfg, n),
                       k3.frontend_reference(ds.wavs, idx, sc, ds.noise_bank, cfg, n),
                       f"K3-{variant} {label} B={batch}", **DATASET_FEATURE_TOL)
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
                  f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']} at 3xTF32); vs plain {err:.2e}"
                  f" | {card}")
            if variant == "phases":
                # the same draw as `sc` (seed 77), so the bound above holds
                check(q["k3_mixed"] == mixed, f"{label}: K3-phases timed another draw")
                (a, d), c = q["k3"], q["library"]
                k3_ms[(variant, label)].update(ms=min(a, d), library_ms=c)
                print(f"[times] K3 (phases) {label} B={batch}, behind a device sleep: kernel "
                      f"{a:.4f} / {d:.4f} ms, dsp.preprocess on cuBLAS as a CUDA graph (no "
                      f"augment) {c:.4f} ms (device, mean of 20; order K8, library, K8, "
                      f"K3-phases, K3-phases); {bnd['bound_ms'] / min(a, d):.1%} of its bound"
                      f" | {card}")

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

    def entry(name, source, replaces, key, timed, label):
        t = timed[(key, label)]
        other = [g for g in ("480/160 MFCC-40", "640/320 MFCC-10") if g != label][0]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": path_launches[name], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"], "timed": f"{label}, batch {batch}",
                **{k: t[k] for k in ("ms_b1", "library_ms_b1", "bound_ms_b1") if k in t},
                "other_geometry": {other: timed[(key, other)]}}

    return [
        entry("k8_mfcc", "tcresnet_tpu_torch/csrc/mfcc.cu", "tcresnet_tpu/ops/pallas/mfcc.py:438",
              "phases", ms, "480/160 MFCC-40"),
        entry("k8_frontend", "tcresnet_tpu_torch/csrc/frontend.cu",
              "tcresnet_tpu/ops/pallas/frontend.py:164", "phases", k3_ms, "480/160 MFCC-40"),
        entry("k9_mfcc", "tcresnet_tpu_torch/csrc/mfcc.cu", "tcresnet_tpu/ops/pallas/mfcc.py:422",
              "radix4", ms, "640/320 MFCC-10"),
        entry("k9_frontend", "tcresnet_tpu_torch/csrc/frontend.cu",
              "tcresnet_tpu/ops/pallas/frontend.py:175", "radix4", k3_ms, "640/320 MFCC-10"),
    ], k5_served


def hops_phase(dev: torch.device, card: str, ds) -> dict:
    """Phase 25: K2 and K3-hops (the hops front ends, on K8's tensor-core
    stage) behind a device sleep, each on one clock with the library call
    as a CUDA graph (tcresnet_tpu_torch/tools/frontend_times.py); {kernel
    name: its summary fields}."""
    from tcresnet_tpu_torch.config import get_preset
    from tcresnet_tpu_torch.data.device_data import DeviceDataset
    from tcresnet_tpu_torch.ops import augment as aug
    from tcresnet_tpu_torch.ops import dsp
    from tcresnet_tpu_torch.ops.kernels import frontend as k3
    from tcresnet_tpu_torch.ops.kernels import mfcc as k2
    from tcresnet_tpu_torch.tools.frontend_times import geometry_cfg

    # ---- 25. times of the hops front ends ----
    n = 16000
    labels = ("480/160", "640/320", "400/200")
    times = hops_times(dev, labels, (1536, 1), ds)
    k2_t, k3_t = {}, {}
    gen = torch.Generator(device=dev).manual_seed(77)  # hops_times' draw at batch 1536
    idx, _, silent = DeviceDataset.sample_indices(ds.arrays, gen, 1536)
    sc = aug.draw_scalars(gen, silent, get_preset("TCResNet8-1.0").augment, ds.noise_bank, n,
                          True)
    for label in labels:
        cfg = geometry_cfg(label)
        feats = int(np.prod(dsp.feature_shape(cfg)[:2]))
        macs = variant_macs(cfg, "hops")
        errs = []  # K2 and K3-hops against their plain versions on hops_times' inputs
        for batch in (1536, 1):
            wavs = torch.tensor(seeded_wavs(77, batch, n), device=dev)
            errs.append(held(k2.fused_mfcc(wavs, cfg), k2.fused_mfcc_reference(wavs, cfg,
                                                                               "hops"),
                             f"K2 {label} B={batch}", **FEATURE_TOL))
        errs.append(held(k3.frontend_features(ds.wavs, idx, sc, ds.noise_bank, cfg, n),
                         k3.frontend_reference(ds.wavs, idx, sc, ds.noise_bank, cfg, n),
                         f"K3-hops {label} B=1536", **DATASET_FEATURE_TOL))
        print(f"[kernel] {label}: K2 vs plain B=1536 {errs[0]:.2e}, B=1 "
              f"{errs[1]:.2e}; K3-hops vs plain B=1536 {errs[2]:.2e}")
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
                  f"{bnd['bound_ms'] / min(a, d):.1%} of it) | {card}")
            if "k3" in t:
                a, d = t["k3"]
                bnd = bound(2 * batch * macs,
                            2 * batch * n + 4 * t["k3_mixed"] * n + 4 * batch * feats,
                            TF32X3_FLOPS)
                k3_t[label] = dict(ms=min(a, d), library_ms=t["library"], **bnd)
                print(f"[times] K3-hops {label} B={batch}, behind a device sleep: kernel {a:.4f} "
                      f"/ {d:.4f} ms (the library graph above, no augment, "
                      f"{t['library']:.4f} ms); bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}"
                      f" at 3xTF32, {bnd['bound_ms'] / min(a, d):.1%} of it) | {card}")
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
    user calls; K4's launches there."""
    import shutil
    import subprocess
    import tempfile
    from pathlib import Path

    from tcresnet_tpu_torch.config import ModelConfig, get_preset
    from tcresnet_tpu_torch.models import build_model
    from tcresnet_tpu_torch.ops import dsp
    from tcresnet_tpu_torch.ops.kernels import infer as k4
    from tcresnet_tpu_torch.ops.kernels import infer2d as k5
    from tcresnet_tpu_torch.ops.kernels import mfcc as k2
    from tcresnet_tpu_torch.serve import streaming
    from tcresnet_tpu_torch.serve.benchmark import benchmark_on_device
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
    compiled, _ = compile_inference(flagship, v8, 1, device=dev)
    x = torch.tensor(seeded_wavs(2701, 1, n), device=dev)
    graph_err = held(compiled(x), eager(x), "compile_inference B=1", SOFTMAX_ATOL, 0.0)
    try:
        compiled(torch.zeros(2, n, device=dev))
        check(False, "compile_inference B=1: another batch was accepted")
    except ValueError:
        pass
    data = export_serialized(flagship, seeded_variables_on(flagship, 0, torch.device("cpu")), 1,
                             device="cpu")
    moved = _with_matmul_precision(load_serialized(data, device=dev), "highest")
    hi = build_inference_fn(flagship, v8, precision="highest", device=dev)
    art_err = held(moved(x), hi(x), "a CPU artifact loaded onto the card", SOFTMAX_ATOL, 0.0)
    print(f"[deploy] compile_inference B=1 (CUDA graph) vs the uncaptured call {graph_err:.2e}, "
          f"another batch raises; export_serialized on the CPU ({len(data)} bytes) loaded onto "
          f"the card vs its xla path {art_err:.2e} (limit 1e-5) | {card}")

    # ---- 27.4 K4 at width 1.25 against its plain version ----
    for name in ("TCResNet8", "TCResNet14"):
        cfg = get_preset(f"{name}-1.0")
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, width_multiplier=1.25))
        vw = seeded_variables_on(cfg, 0, dev)
        plan = k4.build_fused_infer(cfg.model, cfg.audio, vw["params"], vw["batch_stats"],
                                    device=dev)
        wavs, before = torch.tensor(seeded_wavs(1258, 8, n), device=dev), k4.launches
        got, want = k4.fused_infer(wavs, plan), k4.fused_infer_reference(wavs, plan)
        check(k4.launches == before + 1, f"K4 {name}-1.25: launches")
        errs = (held(got, want, f"K4 {name}-1.25 B=8 logits", **LOGIT_TOL),
                held(torch.softmax(got, -1), torch.softmax(want, -1), f"K4 {name}-1.25 softmax",
                     SOFTMAX_ATOL, 0.0))
        print(f"[deploy] K4 {name}-1.25 B=8 vs plain: logits {errs[0]:.2e}, softmax "
              f"{errs[1]:.2e} | {card}")

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
    full, _ = streaming.streaming_step(sv["params"], streaming.init_state(shape[0], device=dev),
                                       frames)
    mem = streaming.init_state(shape[0], device=dev)
    for i in range(0, shape[0], 7):
        probs, mem = streaming.streaming_step(sv["params"], mem, frames[i:i + 7])
    errs = (held(full, batch_probs, "streaming: full window vs the batch model",
                 SOFTMAX_ATOL, 0.0),
            held(probs, full, "streaming: chunks of 7 vs the full window", 1e-4, 0.0))
    print(f"[deploy] streaming SVDF ({shape[0]} frames, MFCC-{shape[1]}): full window vs the "
          f"batch model {errs[0]:.2e} (limit 1e-5), chunks of 7 vs it {errs[1]:.2e} (1e-4) | {card}")

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
    return {"launches": k4.launches - k4_launches}

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


def batchnorm_phase(dev: torch.device, card: str) -> list:
    """Phase 30: the batch-norm kernels against their plain version and
    timed at DS-CNN L's and TCResNet8-1.0's layers; (kernel summary
    entries)."""
    import torch.nn.functional as F

    from tcresnet_tpu_torch.ops.kernels import batchnorm as kb
    from tcresnet_tpu_torch.ops.kernels import launches_since

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
              f"{nbytes / ms_k / 1e6:.0f} GB/s); {kb._plan(x)}; launches {launched}; max |err| "
              "of max: " + ", ".join(f"{k} {e:.3g}" for k, e in errs.items()) + f" | {card}")
        entries.append({"name": f"bn_train_{'x'.join(map(str, shape[1:]))}"
                                + ("_nhwc" if last else "") + ("_scale" if scaled else "")
                                + ("" if relu else "_norelu"),
                        "route": "cuda", "source": "tcresnet_tpu_torch/csrc/batchnorm.cu",
                        "replaces": None, "batch": shape[0], "launches": launched["bn"],
                        "ms": ms_k, "plain_ms": ms_p, **bnd, "library_ms": ms_l})
        del x, dy
        torch.cuda.empty_cache()
    return entries

if __name__ == "__main__":
    sys.exit(main())
