"""The training kind: `Trainer.train_steps` of the port in calls of a fixed
step count, each ended by reading its loss.

A traffic file of this kind sets `steps_per_call`, `warmup_calls`,
`check_steps` (the steps the reference follows), `trace_calls` (timed on
the host clock, then as many calls of one step, each after the queue has
drained), `profile_calls` (under the profiler) and `probe_iters` (calls of
the input path and of the model timed alone with CUDA events).

Set-up builds one Trainer on the configuration's synthetic split, loads the
weights the benchmark made, runs the checked steps through `train_steps`,
records the loss of each, the first gradient as the optimizer got it (read
back from the optimizer's state after the first step by the reference
optimizer's `first_grad`) and the weights' change after the last, then
warms up. The window continues from there with the same Trainer.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import tempfile
import time

import torch

from portbench.harness import compare, flops, synth
from portbench.harness.trace import profile_twice
from portbench.reference import frontend, strict
from portbench.reference import train as ref_train


class Driver:
    def __init__(self, run):
        self.r = run
        self.cfg = dict(run.cell.config)
        self.t = run.cell.traffic
        self.batch = int(self.cfg["train"]["batch_size"])
        self.geom = frontend.Geometry.from_audio(self.cfg["audio"])

    # ------------------------------------------------------------------
    def setup(self) -> None:
        from tcresnet_tpu_torch.config import ExperimentConfig
        from tcresnet_tpu_torch.data.device_data import DeviceDataset
        from tcresnet_tpu_torch.data.speech_commands import HostDataset
        from tcresnet_tpu_torch.train.trainer import Trainer

        r, cfg = self.r, self.cfg
        prec = cfg["precision"]
        torch.backends.cudnn.allow_tf32 = prec["cudnn_allow_tf32"]
        torch.backends.cuda.matmul.allow_tf32 = prec["matmul_allow_tf32"]
        self.train_seed = synth.derive(r.seed, "trainer") & 0x7FFFFFFF
        r.mark("imports")
        self.data = synth.tone_dataset(cfg["dataset"], r.seed, r.device)
        r.sync()
        r.mark("dataset")
        names = ("__null__",) + tuple(f"tone{k}" for k in range(1, cfg["dataset"]["classes"]))
        host = HostDataset(wavs=self.data["wavs"].cpu().numpy(),
                           labels=self.data["labels"].int().cpu().numpy(),
                           is_silent=self.data["silent"].cpu().numpy(), label_names=names,
                           noise_bank=self.data["noise"].cpu().numpy(), split="train")
        dataset = DeviceDataset(host, r.device)
        del host
        r.mark("upload")
        self.weights = synth.glorot_weights(cfg["architecture"], self.geom.coeffs, r.seed,
                                            r.device)
        pcfg = ExperimentConfig.from_json(json.dumps(cfg))
        pcfg = pcfg.replace(train=dataclasses.replace(pcfg.train, seed=self.train_seed))
        self.workdir = tempfile.mkdtemp(prefix="portbench-train-")
        self.trainer = Trainer(pcfg, dataset, workdir=self.workdir,
                               steps_per_call=self.t["steps_per_call"])
        self._load_weights()
        r.mark("trainer")
        self.step = 0
        n_check = self.t["check_steps"]
        self.losses = []
        opt = ref_train.optimizer(cfg["optim"])
        for _ in range(n_check):
            self.losses.append(float(self._call(1)["total_loss"]))
            if self.step == 1:
                state = self.trainer.state.opt_state
                self.first_grad = {k: opt.first_grad(state, k).detach().clone()
                                   for k in self._trained()}
        params = self.trainer.state.params
        self.change = {k: (params[k].detach() - self.weights[k]).clone() for k in self._trained()}
        r.mark("checked_steps")
        for _ in range(self.t["warmup_calls"]):
            float(self._call(self.t["steps_per_call"])["total_loss"])
        r.sync()
        r.mark("warmup")

    def _trained(self):
        return ref_train.trained_names(self.cfg["architecture"], self.geom.coeffs)

    def _load_weights(self) -> None:
        state = self.trainer.state
        mine = {**state.params, **state.batch_stats}
        if set(mine) != set(self.weights):
            raise ValueError(f"the program's weights {sorted(set(mine) ^ set(self.weights))} "
                             "differ from the reference's")
        with torch.no_grad():
            for k, t in mine.items():
                if tuple(t.shape) != tuple(self.weights[k].shape):
                    raise ValueError(f"{k}: program {tuple(t.shape)}, reference "
                                     f"{tuple(self.weights[k].shape)}")
                t.copy_(self.weights[k])

    def _call(self, n: int):
        out = self.trainer.train_steps(n, start=self.step)
        self.step += n
        return out

    # ------------------------------------------------------------------
    def window(self, seconds: float) -> dict:
        n, steps, calls, enqueued = self.t["steps_per_call"], 0, [], []
        self.r.sync()
        t0 = time.perf_counter()
        while True:
            out = self._call(n)
            enqueued.append(time.perf_counter() - t0)
            float(out["total_loss"])
            steps += n
            elapsed = time.perf_counter() - t0
            calls.append(elapsed)
            if elapsed >= seconds:
                break
        self.r.notes["window_calls_ms"] = _call_summary(calls, enqueued)
        return {"train_utt_per_s": self.batch * steps / elapsed,
                "attempted": steps, "failed": 0}

    def traced(self, seconds: float) -> None:
        from tcresnet_tpu_torch.ops.kernels import launch_counts, launches_since

        r, n, o = self.r, self.t["steps_per_call"], self.r.obs
        before = launch_counts()
        total = 0.0
        steps = 0
        r.sync()
        for _ in range(self.t["trace_calls"]):
            t0 = time.perf_counter()
            float(self._call(n)["total_loss"])
            total += time.perf_counter() - t0
            steps += n
        launched = launches_since(before)
        r.notes["launches_per_step"] = {k: v / steps for k, v in launched.items()}
        r.notes["plain_routes"] = launched.get("plain_routes", 0)
        one = []
        for _ in range(self.t["trace_calls"]):  # one step onto an empty queue
            t0 = time.perf_counter()
            out = self._call(1)
            one.append(time.perf_counter() - t0)
            float(out["total_loss"])
        o.update({"train.enqueue_one_s": sorted(one)[len(one) // 2], "train.timed_s": total,
                  "train.steps": steps, "attempted": steps + len(one), "failed": 0})

        def block():
            for _ in range(self.t["profile_calls"]):
                float(self._call(n)["total_loss"])

        r.breakdown = profile_twice(r.device, block, o)
        o["trace.steps"] = self.t["profile_calls"] * n
        self._probe()

    def _probe(self) -> None:
        """The input path and the model's forward and backward, each timed
        alone over `probe_iters` calls on the step's own draws."""
        from tcresnet_tpu_torch.data.device_data import DeviceDataset

        r, tr, iters = self.r, self.trainer, self.t["probe_iters"]
        if r.device.type != "cuda":
            return
        gen = tr.generator(self.step, batch=self.batch)
        idx, labels, silent = DeviceDataset.sample_indices(tr.data.arrays, gen, self.batch,
                                                           tr.data.sample_row)
        state = gen.get_state()

        def input_path():
            gen.set_state(state)
            return tr._input_features(idx, silent, gen)

        feats = input_path()
        params = tr.state.params
        names = list(params)

        def model_step():
            gen.set_state(state)
            total = tr._loss(tr.model(feats, generator=gen), labels)[0]
            return torch.autograd.grad(total, [params[k] for k in names])

        r.obs["input_path.device_s"] = timed(input_path, iters, r.device)
        r.obs["model.device_s"] = timed(model_step, iters, r.device)

    # ------------------------------------------------------------------
    def release(self) -> None:
        self.trainer = None
        shutil.rmtree(self.workdir, ignore_errors=True)
        if self.r.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """The numbers compared with the reference, which follows the
        checked steps from the same weights, data and seed in float32 with
        TF32 off."""
        self.ref = self._reference(torch.float32)
        return compare.training(self.losses, self.first_grad, self.change, self.ref)

    def detail(self) -> dict:
        """The readings that are not compared, of the program and of the
        control where it ran (after `check`)."""
        out = {"program": compare.training_detail(self.losses, self.first_grad, self.change,
                                                  self.ref)}
        if getattr(self, "ctl", None) is not None:
            out["control"] = compare.training_detail(self.ctl["losses"], self.ctl["first_grad"],
                                                     self.ctl["change"], self.ref)
        return out

    def _reference(self, dtype, **fault) -> dict:
        with strict():
            return ref_train.run_steps(self.cfg, self.weights, self.data, self.train_seed,
                                       len(self.losses), self.batch, dtype, **fault)

    def control(self) -> dict:
        """The numbers of the control: the reference in bfloat16 in the
        program's place (after `check`)."""
        self.ctl = self._reference(torch.bfloat16)
        return compare.training(self.ctl["losses"], self.ctl["first_grad"], self.ctl["change"],
                                self.ref)

    def faults(self) -> dict:
        """The numbers of the faults planted in the reference put in the
        program's place (after `check`): half of each batch left out, the
        mean taken over the rest; the learning rate 5% high. A step that
        leaves the state unchanged reads 1 on `change_median_gap` with no run."""
        out = {}
        for name, fault in (("half_batch", {"rows_kept": self.batch // 2}),
                            ("lr_high", {"lr_scale": 1.05})):
            f = self._reference(torch.float32, **fault)
            out[name] = compare.training(f["losses"], f["first_grad"], f["change"], self.ref)
        return out

    # ------------------------------------------------------------------
    def counts(self) -> dict:
        """What the readers count: operations and bytes of a step, of its
        input path and of its model (the counts are cached by `flops`)."""
        g, b = self.geom, self.batch
        ds = self.cfg["dataset"]
        rows = b * g.samples * 2
        noise = ds["noise_clips"] * ds["noise_samples"] * 4
        feats = b * g.frames * g.coeffs * 4
        weight_bytes = sum(4 * v.numel() for v in self.weights.values())
        return {
            "step_flops": flops.step_flops(self.cfg, b),
            "input_flops": b * frontend.fewest_flops(g),
            "input_bytes": rows + noise + feats,
            "model_flops": flops.model_step_flops(self.cfg, b),
            "model_bytes": feats + 2 * weight_bytes + b * 8,
        }


def _call_summary(ends, enqueued) -> dict:
    """The first calls' times, the median and the median enqueue (from the
    call's start to its return, before its loss is read), in ms, from the
    times at which each call returned and ended."""
    starts = [0.0] + ends[:-1]
    ms = [1e3 * (b - a) for a, b in zip(starts, ends)]
    enq = sorted(1e3 * (e - a) for a, e in zip(starts, enqueued))
    return {"calls": len(ms), "first": [round(x, 3) for x in ms[:3]],
            "median": round(sorted(ms)[len(ms) // 2], 3), "max": round(max(ms), 3),
            "enqueue_median": round(enq[len(enq) // 2], 3)}


def timed(fn, iters: int, device) -> float:
    """Seconds a call of `fn` keeps the device, from CUDA events around
    `iters` calls after one warm call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) * 1e-3 / iters

