#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving and training paths on one CUDA card.

    python3 chip_smoke.py

Drives tcresnet_tpu_torch (never JAX) at full TCResNet8-1.0 width
(16 kHz, 1 s clips, MFCC-40, channels 16/24/32/48, 12 classes) with
weights and data made from seeds, in phases that print their lines:

  1. device   the card, as nvidia-smi reports its name and power limit
  2. build    every kernel source built with nvcc, one process each, all
              started together; K4's line (csrc/infer.cu)
  3. kernel   K4 against its plain PyTorch version on the card (TF32 off),
              three models x batch 1, 3, 8, 64
  4. golden   K4's softmax against the JAX package's, stored in
              tcresnet_tpu_torch/testdata/tcresnet8_golden.npz
  5. serve    build_inference_fn(backend="auto"): 20 single-utterance
              requests (fused kernel) and one batch of 64 (plain path),
              checked against backend="xla", precision="highest"; the
              kernel's launch count shows the requests went through it
  6. times    kernel and plain path at batch 1 and 1024, host clock and
              CUDA events, beside the card's name and power limit
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
              counts equal the step counts, the loss falls, the
              train-stream eval and the audio summary (K6) run; a float32
              batch-100 preset leg; resume from a checkpoint is exact
 11. times    each new kernel against its plain version at batch 1536;
              ms/step, utt/s and the device's busy share of the step for
              the input legs at batch 1536 and 4096
 12. build    tconv.cu (K7: fwd, dx, dw), its ptxas line
 13. kernel   K7 against its plain version (TF32 off) at TCResNet8-1.0's ten
              conv geometries, batch 1, 8, 1536, f32 and bf16-rounded
              inputs, and TCResNet14-1.5's at batch 1536; launch counters;
              dw identical on two calls
 14. train    the main path through K7: Trainer with conv_backend="pallas"
              at batch 1536 in bf16, 30 steps, a checkpoint every 10; K7
              launches per step (10 fwd, 9 dx, 10 dw) and per train-stream
              eval (10 fwd); the loss falls; resume is exact; a float32
              batch-100 preset leg "pallas" against "xla" over 5 steps
 15. evaluate the loop evaluator (tools/evaluate.py) over that run on the
              synthetic valid split: each checkpoint scored once through
              K7's forward, the best promoted and re-scored identically;
              "pallas" against "xla" on one checkpoint
 16. times    K7 against its plain version and cuDNN over one step's ten
              convs at batch 1536; the train step "pallas" against "xla";
              eval utt/s

then the kernel summary as one JSON line, and last
{"ok": true, "device": {...}}. Any failed check raises and the script
exits non-zero without that line. There is no CPU fallback: without a
CUDA device it exits 1.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

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
SOURCES = ("infer", "augment", "mfcc", "frontend", "tconv")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def seeded_wavs(seed: int, batch: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-1, 1, (batch, n)).astype(np.float32)


def ptxas_line(name: str) -> str:
    from tcresnet_tpu_torch.ops.kernels import _build

    log = _build.library_path(name).with_suffix(".log")
    return " ".join(
        line.split("ptxas info    :")[-1].strip()
        for line in (log.read_text().splitlines() if log.exists() else [])
        if "registers" in line or "spill" in line
    ) or "cached build"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1

    from tcresnet_tpu.config import get_preset
    from tcresnet_tpu_torch.models.convert import seeded_variables, variables_from_jax
    from tcresnet_tpu_torch.ops import dsp
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
    print(f"[build] infer.cu for sm_90a in {build_s:.1f} s | {ptxas_line('infer')}")

    def variables_for(cfg, seed):
        v = variables_from_jax(**seeded_variables(cfg.model, dsp.feature_shape(cfg.audio), seed))
        return {k: {n: t.to(dev) for n, t in d.items()} for k, d in v.items()}

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
        for batch in (1, 3, 8, 64):
            wavs = torch.tensor(seeded_wavs(100 + batch, batch, cfg.audio.desired_samples), device=dev)
            before = k4.launches
            got = k4.fused_infer(wavs, plan)
            torch.cuda.synchronize()
            check(k4.launches == before + 1, f"{label} B={batch}: kernel not launched")
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
        print(f"[kernel] {label}: max |logit| / |softmax| err vs plain: " + ", ".join(errs))

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
    k4.launches = 0
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

    train_kernels, ds = training_phases(dev, card)
    tconv_kernels = tconv_phases(dev, card, ds)

    summary = {"kernels": [{
        "name": "k4_infer", "route": "cuda",
        "source": "tcresnet_tpu_torch/csrc/infer.cu",
        "replaces": "tcresnet_tpu/ops/pallas/infer.py:170",
        "launches": main_launches,
        "max_abs_err": max_err,
        "ms": times[("kernel", 1)] / 1e3,
        "plain_ms": times[("kernel_plain_version", 1)] / 1e3,
        "ms_b1024": times[("kernel", 1024)] / 1e3,
        "plain_ms_b1024": times[("kernel_plain_version", 1024)] / 1e3,
    }] + train_kernels + tconv_kernels}
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
    """Median CUDA-event time of fn() in ms (5 warm-up calls)."""
    from tcresnet_tpu_torch.serve.benchmark import benchmark_on_device

    probe = torch.empty(1, device="cuda")
    return benchmark_on_device(lambda _: fn(), probe, warmup_runs=5, num_runs=runs)["median"] / 1e3


def device_busy_ms(fn) -> float:
    """Summed device-activity time of fn() in ms (kernels and copies, which
    do not overlap on the one stream the port uses), from torch.profiler;
    NaN when the profiler reports no device time. Device times are not
    inflated by the profiler's host overhead, so this over an unprofiled
    CUDA-event span of the same work is the device's busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
    return dev_us / 1e3 if dev_us > 0 else float("nan")


def training_phases(dev: torch.device, card: str):
    """Phases 7-11: the training slice's kernels and its main path;
    (kernel summary entries, the device dataset)."""
    import tempfile

    from tcresnet_tpu.config import get_preset
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
    k16.k1_launches = k16.k6_launches = k2.launches = k3.launches = 0
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

    def entry(name, source, replaces, err, key):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": main_launches[key], "max_abs_err": err,
                "ms": ms[key][0], "plain_ms": ms[key][1]}

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


def conv_geometries(model_cfg, t: int, in_channels: int) -> list:
    """(k, stride, Ci, Co, T) of every conv of a TC-ResNet, in forward order."""
    from tcresnet_tpu_torch.models.tc_resnet import block_plan, scaled_channels

    channels = scaled_channels(model_cfg.name, model_cfg.width_multiplier)
    out, prev = [(3, 1, in_channels, channels[0], t)], channels[0]
    for _, n, down in block_plan(channels):
        if down:
            out += [(1, 2, prev, n, t), (9, 2, prev, n, t)]
            t = -(-t // 2)
        else:
            out.append((9, 1, prev, n, t))
        out.append((9, 1, n, n, t))
        prev = n
    return out


def tconv_phases(dev: torch.device, card: str, ds) -> list:
    """Phases 12-16: K7 and the paths through it, training and evaluation."""
    import tempfile

    import torch.nn.functional as F

    from tcresnet_tpu.config import get_preset
    from tcresnet_tpu_torch.data.device_data import DeviceDataset
    from tcresnet_tpu_torch.evaluation.evaluator import Evaluator
    from tcresnet_tpu_torch.models.layers import same_padding
    from tcresnet_tpu_torch.ops.kernels import tconv as k7
    from tcresnet_tpu_torch.tools import evaluate as evaluate_cli
    from tcresnet_tpu_torch.tools.train import load_run_config, load_split
    from tcresnet_tpu_torch.train.checkpoint import CheckpointManager
    from tcresnet_tpu_torch.train.trainer import Trainer

    # ---- 12. build (compiled in phase 2, all sources at once) ----
    print(f"[build] tconv.cu for sm_90a | {ptxas_line('tconv')}")
    k7.build_kernels()

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
    cases = [("TCResNet8-1.0", b, geoms) for b in (1, 8, 1536)] + [("TCResNet14-1.5", 1536, geoms14)]
    for label, batch, gs in cases:
        for bf16 in (False, True):
            worst = {"fwd": 0.0, "dx": 0.0, "dw": 0.0, "dw_rel": 0.0}
            for geom in gs:
                k, s, _, _, t = geom
                x, w, dy = conv_inputs(batch, geom, bf16)
                before = (k7.fwd_launches, k7.dx_launches, k7.dw_launches)
                y, dx = k7.tconv_fwd(x, w, s), k7.tconv_dx(dy, w, t, s)
                dw, dw_again = k7.tconv_dw(x, dy, k, s), k7.tconv_dw(x, dy, k, s)
                torch.cuda.synchronize()
                check((k7.fwd_launches, k7.dx_launches, k7.dw_launches)
                      == (before[0] + 1, before[1] + 1, before[2] + 2),
                      f"K7 {geom} B={batch}: launch counters did not advance by one per call")
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
                  f"dw {worst['dw']:.2e} ({worst['dw_rel']:.1e} of max|dw|); dw bit-identical "
                  f"on two calls")

    # ---- 14. train through K7: the main path ----
    workdir = tempfile.mkdtemp(prefix="chip_smoke_k7_")
    run = f"{workdir}/run"
    steps = 30
    cfg = smoke_train_cfg(flagship, 1536, "on", conv_backend="pallas", step_save_checkpoint=10)
    k7.fwd_launches = k7.dx_launches = k7.dw_launches = 0
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
    k7.fwd_launches = k7.dx_launches = k7.dw_launches = 0
    t0 = time.perf_counter()
    evaluate_cli.main(["--train-dir", run, "--synthetic", "--split", "valid",
                       "--valid-type", "loop"])
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
                               "--valid-type", "once", "--best-metric", "accuracy"])
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
    sets = []
    for geom in geoms:
        k, s, ci, co, t = geom
        x, w, dy = conv_inputs(batch, geom)
        _, lo, hi = same_padding(t, k, s)
        sets.append((k, s, t, lo, hi, x, w, dy, F.pad(x, (lo, hi))))
    ops = {
        "fwd": (lambda: [k7.tconv_fwd(x, w, s) for k, s, t, lo, hi, x, w, dy, xp in sets],
                lambda: [k7.tconv_fwd_reference(x, w, s) for k, s, t, lo, hi, x, w, dy, xp in sets],
                lambda: [F.conv1d(xp, w, stride=s) for k, s, t, lo, hi, x, w, dy, xp in sets]),
        "dx": (lambda: [k7.tconv_dx(dy, w, t, s) for k, s, t, lo, hi, x, w, dy, xp in sets],
               lambda: [k7.tconv_dx_reference(dy, w, t, s) for k, s, t, lo, hi, x, w, dy, xp in sets],
               lambda: [torch.nn.grad.conv1d_input(xp.shape, w, dy, stride=s)[..., lo:lo + t]
                        for k, s, t, lo, hi, x, w, dy, xp in sets]),
        "dw": (lambda: [k7.tconv_dw(x, dy, k, s) for k, s, t, lo, hi, x, w, dy, xp in sets],
               lambda: [k7.tconv_dw_reference(x, dy, k, s) for k, s, t, lo, hi, x, w, dy, xp in sets],
               lambda: [torch.nn.grad.conv1d_weight(xp, w.shape, dy, stride=s)
                        for k, s, t, lo, hi, x, w, dy, xp in sets]),
    }
    ms = {}
    for op, (kernel, plain, cudnn) in ops.items():
        a, b, c, d = device_ms(kernel), device_ms(plain), device_ms(plain), device_ms(kernel)
        e = device_ms(cudnn)
        ms[op] = (min(a, d), min(b, c), e)
        print(f"[times] K7 {op} B={batch}, the ten convs of one step: kernel {a:.4f} / {d:.4f} ms, "
              f"plain {b:.4f} / {c:.4f} ms, cuDNN f32 (TF32 off) {e:.4f} ms (CUDA events, median "
              f"of 20; order kernel, plain, plain, kernel, cuDNN) | {card}")

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
        busy_ms = device_busy_ms(lambda: trainer.train_steps(3, start=500)) / 3
        host_ms = sum(h for h, _ in spans[backend]) / 2
        dev_ms = sum(d for _, d in spans[backend]) / 2
        print(f"[times] train step B={batch} bf16 conv_backend={backend} (K3 input): "
              + " / ".join(f"{h:.3f}" for h, _ in spans[backend]) + " ms/step host, "
              + " / ".join(f"{d:.3f}" for _, d in spans[backend]) + " ms/step CUDA events "
              f"(two visits of {n_steps} steps), {batch / host_ms * 1e3:,.0f} utt/s, device busy "
              f"{busy_ms:.3f} ms/step = {busy_ms / dev_ms:.1%} of the step | {card}")

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

    def entry(op, line):
        return {"name": f"k7_tconv_{op}", "route": "cuda",
                "source": "tcresnet_tpu_torch/csrc/tconv.cu",
                "replaces": f"tcresnet_tpu/ops/pallas/tconv.py:{line}",
                "launches": main_launches[op], "max_abs_err": errs[op],
                "ms": ms[op][0], "plain_ms": ms[op][1], "cudnn_ms": ms[op][2]}

    return [entry("fwd", 63), entry("dx", 68), entry("dw", 99)]


if __name__ == "__main__":
    sys.exit(main())
