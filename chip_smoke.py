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
SOURCES = ("infer", "augment", "mfcc", "frontend")


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

    train_kernels = training_phases(dev, card)

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
    }] + train_kernels}
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


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


def training_phases(dev: torch.device, card: str) -> list:
    """Phases 7-11: the training slice's kernels and its main path."""
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
        return flagship.replace(
            train=dataclasses.replace(flagship.train, batch_size=batch, compute_dtype=dtype,
                                      max_step=10**9, step_save_checkpoint=10**6,
                                      step_evaluation=10, summary_step_verbose=10,
                                      summary_step_default=10, **kw),
            audio=dataclasses.replace(flagship.audio, dsp_backend="pallas", frontend_fuse=fuse),
            augment=dataclasses.replace(flagship.augment, backend="pallas"))

    def metrics(trainer):
        lines = (trainer.workdir / "train_metrics.jsonl").read_text().splitlines()
        return [json.loads(x) for x in lines]

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
        records = metrics(trainer)
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
    losses = [r["total_loss"] for r in metrics(trainer) if "total_loss" in r]
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
    ]


if __name__ == "__main__":
    sys.exit(main())
