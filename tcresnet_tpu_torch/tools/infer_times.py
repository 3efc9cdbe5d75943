"""Device times of the whole-model serving kernel, K4 (wav -> logits),
beside the `xla` model (wav -> softmax, TF32 off) replayed as a CUDA
graph, on one clock, on one CUDA card.

    python -m tcresnet_tpu_torch.tools.infer_times
    python -m tcresnet_tpu_torch.tools.infer_times --batches 1 1024 --preset TCResNet14-1.5

For each batch: CUDA events around 20 calls that the host enqueues behind
a device-side sleep (`frontend_times.queued_ms`), in the order kernel,
`xla` graph, kernel; with --paths also K4's two paths forced (the conv
stacks in the stage's blocks, "fused", and in a kernel of their own,
"two_kernels"), in the order fused, two, two, fused. Weights and wavs are
made from seeds. Prints one JSON line, with the card's name and power
limit and the batch from which the graph is the faster (the crossover;
null if K4 is faster at every batch timed). Without --paths it uses only
the package's public serving calls, so run by its path it also times
another checkout of the package put first on PYTHONPATH (the line names
the module it timed).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

BATCHES = (1, 8, 32, 64, 256, 1024)


def k4_times(dev: torch.device, batches=BATCHES, preset: str = "TCResNet8-1.0",
             seed: int = 0, wav_seed: int = 3000, paths: bool = False) -> dict:
    """{batch: {"k4": (ms, ms), "xla": ms, "queue_full": every reading's}}
    for `preset` with weights from `seed` (the serving phases' model); with
    `paths` also "fused" and "two_kernels": (ms, ms), each path forced."""
    from tcresnet_tpu_torch.config import get_preset
    from tcresnet_tpu_torch.models.convert import seeded_variables, variables_from_jax
    from tcresnet_tpu_torch.ops import dsp
    from tcresnet_tpu_torch.ops.kernels import infer as k4
    from tcresnet_tpu_torch.serve.export import build_inference_fn
    from tcresnet_tpu_torch.tools.frontend_times import graph_of, queued_ms

    cfg = get_preset(preset)
    v = variables_from_jax(cfg.model, **seeded_variables(cfg.model, dsp.feature_shape(cfg.audio),
                                                          seed))
    v = {k: {name: t.to(dev) for name, t in d.items()} for k, d in v.items()}
    plan = k4.build_fused_infer(cfg.model, cfg.audio, v["params"], v["batch_stats"], device=dev)
    xla = build_inference_fn(cfg, v, backend="xla", precision="highest", device=dev)
    n = cfg.audio.desired_samples
    out = {}
    for batch in batches:
        x = torch.tensor(np.random.default_rng(wav_seed + batch).uniform(-1, 1, (batch, n)),
                         dtype=torch.float32, device=dev)
        with torch.no_grad():
            replay, graph_out = graph_of(lambda: xla(x))
            replay()
            torch.cuda.synchronize()
            if not torch.allclose(graph_out, xla(x), atol=1e-6, rtol=0):
                raise AssertionError(f"B={batch}: the xla graph differs from the call")
            (a, fa), (c, fc), (d, fd) = (queued_ms(fn) for fn in (
                lambda: k4.fused_infer(x, plan), replay, lambda: k4.fused_infer(x, plan)))
            out[batch] = {"k4": (a, d), "xla": c, "queue_full": fa and fc and fd}
            if paths:
                readings = []
                for force in (False, True, True, False):
                    plan.force_two_kernels = force
                    readings.append(queued_ms(lambda: k4.fused_infer(x, plan)))
                plan.force_two_kernels = None
                (f0, q0), (t0, q1), (t1, q2), (f1, q3) = readings
                out[batch].update(fused=(f0, f1), two_kernels=(t0, t1),
                                  queue_full=out[batch]["queue_full"] and q0 and q1 and q2 and q3)
    return out


def crossover(times: dict):
    """The least batch timed from which the `xla` graph is faster than K4
    at that batch and every larger one timed; None if there is none."""
    batches = sorted(times)
    for i, batch in enumerate(batches):
        if all(times[b]["xla"] < min(times[b]["k4"]) for b in batches[i:]):
            return batch
    return None


def main(argv=None) -> int:
    from tcresnet_tpu_torch.ops.kernels import infer as k4
    from tcresnet_tpu_torch.utils.device import card_description

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batches", nargs="+", type=int, default=list(BATCHES))
    parser.add_argument("--preset", default="TCResNet8-1.0")
    parser.add_argument("--paths", action="store_true",
                        help="also time K4's two paths, each forced")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("infer_times: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    times = k4_times(torch.device("cuda", 0), args.batches, args.preset, paths=args.paths)
    print(json.dumps({"card": card_description(), "module": k4.__file__, "preset": args.preset,
                      "crossover": crossover(times),
                      "times_ms": {f"B={b}": t for b, t in times.items()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
