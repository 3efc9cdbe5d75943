"""The serving kind: one client in a closed loop calls the port's serving
entry, `build_inference_fn(cfg, variables, backend="auto")`, with a batch of
clips and waits for the softmax on the host before it sends the next.

A traffic file of this kind sets the batch sizes (`batch`: a log-uniform
grid of `grid` sizes over [min, max], shuffled by the seed afresh each time
it is used up, so that every seed sends the same sizes in another order),
`pool_clips` (float32 clips made on the card; a request of B clips is a
slice at an offset drawn from the seed), `check_per_route` (requests
checked per route, drawn from the seed among those completed, with the
largest added), `trace_requests` (timed on the host clock and with CUDA
events) and `profile_requests` (under the profiler).

Set-up sends one request of every size, so that nothing is built in the
window.
"""

from __future__ import annotations

import json
import time
from typing import List, Tuple

import numpy as np
import torch

from portbench.harness import compare, flops, synth
from portbench.harness.trace import profile_twice
from portbench.reference import frontend, strict
from portbench.reference import serve as ref_serve


def batch_grid(spec: dict) -> np.ndarray:
    """`grid` sizes at the quantiles of a log-uniform law over [min, max]:
    B = floor(exp(u ln(max + 1))) at u = (j + 1/2) / grid, clipped to the range."""
    lo, hi, n = spec["min"], spec["max"], spec["grid"]
    u = (np.arange(n) + 0.5) / n
    sizes = np.floor(np.exp(np.log(lo) + u * (np.log(hi + 1) - np.log(lo))))
    return np.clip(sizes, lo, hi).astype(np.int64)


class Schedule:
    """Request i -> (offset, size), the same for one seed on every run."""

    def __init__(self, spec: dict, pool: int, seed: int):
        self.grid = batch_grid(spec)
        self.pool = pool
        self.rng = np.random.default_rng(synth.derive(seed, "schedule"))
        self.sizes: List[int] = []
        self.offsets: List[int] = []

    def __getitem__(self, i: int) -> Tuple[int, int]:
        while i >= len(self.sizes):
            sizes = self.rng.permutation(self.grid)
            self.sizes.extend(int(b) for b in sizes)
            self.offsets.extend(int(self.rng.integers(0, self.pool - b + 1)) for b in sizes)
        return self.offsets[i], self.sizes[i]


class Driver:
    def __init__(self, run):
        self.r = run
        self.cfg = dict(run.cell.config)
        self.t = run.cell.traffic
        self.geom = frontend.Geometry.from_audio(self.cfg["audio"])

    def setup(self) -> None:
        from tcresnet_tpu_torch.config import ExperimentConfig
        from tcresnet_tpu_torch.serve.export import auto_fused_max_batch, build_inference_fn

        r, cfg, t = self.r, self.cfg, self.t
        prec = cfg["precision"]
        torch.backends.cudnn.allow_tf32 = prec["cudnn_allow_tf32"]
        torch.backends.cuda.matmul.allow_tf32 = prec["matmul_allow_tf32"]
        r.mark("imports")
        self.pool = synth.clip_pool(cfg["dataset"], t["pool_clips"], r.seed, r.device)
        weights = synth.glorot_weights(cfg["architecture"], self.geom.coeffs, r.seed, r.device)
        calib = self.pool[:cfg["weights"]["calibration_clips"]]
        with strict():
            self.weights = synth.calibrate(cfg, weights, calib, cfg["weights"]["logit_std"])
        variables = {"params": {k: v for k, v in self.weights.items() if "running" not in k},
                     "batch_stats": {k: v for k, v in self.weights.items() if "running" in k}}
        pcfg = ExperimentConfig.from_json(json.dumps(cfg))
        self.fused_max = auto_fused_max_batch(pcfg.model.name)
        r.sync()
        r.mark("pool_and_weights")
        self.fn = build_inference_fn(pcfg, variables, include_preprocess=True, backend="auto",
                                     device=r.device)
        r.mark("entry")
        self.schedule = Schedule(t["batch"], t["pool_clips"], r.seed)
        for b in sorted(set(int(x) for x in self.schedule.grid)):
            self.fn(self.pool[:b]).cpu()
        self.next = 0
        self.done: List[Tuple[int, int, torch.Tensor]] = []  # (offset, size, softmax on host)
        r.sync()
        r.mark("warmup")

    def _request(self):
        off, b = self.schedule[self.next]
        self.next += 1
        return off, b, self.pool[off:off + b]

    def window(self, seconds: float) -> dict:
        lat, utts = [], 0
        self.r.sync()
        w0 = time.perf_counter()
        while True:
            off, b, x = self._request()
            t0 = time.perf_counter()
            probs = self.fn(x).cpu()
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            utts += b
            self.done.append((off, b, probs))
            if t1 - w0 >= seconds:
                break
        elapsed = time.perf_counter() - w0
        half = len(lat) // 2
        self.r.notes["window_halves_ms"] = [round(1e3 * sum(lat[:half]), 3),
                                            round(1e3 * sum(lat[half:]), 3)]
        return {"serve_utt_per_s": utts / elapsed,
                "serve_p95_ms": 1e3 * float(np.percentile(np.array(lat), 95)),
                "attempted": len(lat), "failed": 0}

    def traced(self, seconds: float) -> None:
        from tcresnet_tpu_torch.ops.kernels import launch_counts, launches_since

        r, o = self.r, self.r.obs
        before = launch_counts()
        cuda = r.device.type == "cuda"
        enqueue = total = device = flops_done = 0.0
        utts, work = 0, []
        n = self.t["trace_requests"]
        w_bytes = sum(4 * v.numel() for v in self.weights.values())
        r.sync()
        for _ in range(n):
            off, b, x = self._request()
            if cuda:
                ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                ev[0].record()
            t0 = time.perf_counter()
            out = self.fn(x)
            t1 = time.perf_counter()
            if cuda:
                ev[1].record()
            probs = out.cpu()
            t2 = time.perf_counter()
            if cuda:
                device += ev[0].elapsed_time(ev[1]) * 1e-3
            enqueue += t1 - t0
            total += t2 - t0
            utts += b
            flops_done += flops.infer_flops(self.cfg, 1) * b
            work.append((flops.fewest_infer_flops(self.cfg, 1) * b,
                         b * self.geom.samples * 4 + probs.numel() * 4 + w_bytes))
            self.done.append((off, b, probs))
        launched = launches_since(before)
        r.notes["launches_per_request"] = {k: v / n for k, v in launched.items()}
        r.notes["plain_routes"] = launched.get("plain_routes", 0)
        o.update({"serve.enqueue_s": enqueue, "serve.timed_s": total, "serve.requests": n,
                  "serve.utts": utts, "serve.flops": flops_done, "attempted": n, "failed": 0})
        r.notes["serve.work"] = work
        if cuda:
            o["serve.device_s"] = device
        def block():
            for _ in range(self.t["profile_requests"]):
                off, b, x = self._request()
                self.done.append((off, b, self.fn(x).cpu()))

        r.breakdown = profile_twice(r.device, block, o)

    def release(self) -> None:
        self.fn = None
        if self.r.device.type == "cuda":
            torch.cuda.empty_cache()

    def checked(self) -> List[int]:
        """Indices of the checked requests: `check_per_route` drawn from the
        seed among each route's completed requests, and the largest."""
        rng = np.random.default_rng(synth.derive(self.r.seed, "check"))
        picked = set()
        for small in (True, False):
            idx = [i for i, (_, b, _) in enumerate(self.done) if (b <= self.fused_max) == small]
            k = min(self.t["check_per_route"], len(idx))
            picked.update(int(i) for i in rng.choice(idx, size=k, replace=False)) if k else None
        if self.done:
            picked.add(max(range(len(self.done)), key=lambda i: self.done[i][1]))
        return sorted(picked)

    def check(self) -> dict:
        """Per route, the largest gap between a checked request's softmax
        and the reference's on the same clips (float32, TF32 off)."""
        self.ref = {i: self._reference(i, torch.float32) for i in self.checked()}
        return self._gaps({i: self.done[i][2] for i in self.ref})

    def _reference(self, i: int, dtype) -> torch.Tensor:
        off, b, _ = self.done[i]
        with strict():
            return ref_serve.softmax(self.cfg, self.weights, self.pool[off:off + b], dtype).cpu()

    def _gaps(self, answers: dict) -> dict:
        small = {i: self.done[i][1] <= self.fused_max for i in self.ref}
        route = {name: [i for i in self.ref if small[i] == want]
                 for name, want in (("gap_fused_route", True), ("gap_xla_route", False))}
        return {name: compare.prob_gap([answers[i] for i in idx], [self.ref[i] for i in idx])
                for name, idx in route.items()}

    def control(self) -> dict:
        """The numbers of the control: the reference in bfloat16 in the
        program's place, on the same checked requests (after `check`)."""
        return self._gaps({i: self._reference(i, torch.bfloat16) for i in self.ref})

    def faults(self) -> dict:
        return {}
