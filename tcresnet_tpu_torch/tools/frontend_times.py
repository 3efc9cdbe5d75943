"""Device times of the front-end kernels, K2 and K3-hops (or another DFT
variant's), beside one PyTorch call that computes the same function, on
one CUDA card.

    python -m tcresnet_tpu_torch.tools.frontend_times
    python -m tcresnet_tpu_torch.tools.frontend_times --geometries 400/200 --batches 1536
    python -m tcresnet_tpu_torch.tools.frontend_times --variant phases

For each geometry (window / hop in samples at 16 kHz, 1 s clips) and
batch: the MFCC kernel (`ops.kernels.mfcc.fused_mfcc`, dft_variant "hops":
K2, or --variant's) and, at the largest batch, K3 in the same variant
(`ops.kernels.frontend.frontend_features` over a synthetic int16 dataset
on the card), each on one clock with the library
call, `dsp.preprocess` on cuBLAS (TF32 off, the dense DFT) replayed as a
CUDA graph: CUDA events around 20 calls that the host enqueues behind a
device-side sleep (`queued_ms`), in the order kernel, library, kernel.
Inputs are made from seeds. Prints one JSON line, with the card's name
and power limit. It uses only the package's public front-end calls, so it
also times another checkout of the package put first on PYTHONPATH.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

# label -> (preset whose audio config it takes, window ms, hop ms)
GEOMETRIES = {
    "480/160": ("TCResNet8-1.0", 30.0, 10.0),
    "640/320": ("DSCNNL", 40.0, 20.0),
    "400/200": ("TCResNet8-1.0", 25.0, 12.5),
    "320/160": ("TCResNet8-1.0", 20.0, 10.0),
}


# readings taken of a run whose launch queue drained, the last one kept
QUEUE_ATTEMPTS = 3


def queued_ms(fn, runs: int = 20) -> tuple:
    """(device ms per call of fn(), whether the queue stayed full): CUDA
    events around `runs` calls that the host enqueues behind a device-side
    sleep, so the events time the device work and not the host's enqueue
    (at batch 1 the host is the slower). The queue stayed full when the
    host finished enqueueing before the sleep ended; a call that waits for
    the device on the host drains it, and the time is then host-paced. A
    reading whose queue drained is taken again, QUEUE_ATTEMPTS times in
    all (a host shared with other work can stall one enqueue past the
    sleep); the last reading is returned with its own flag."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    host_s = time.perf_counter() - t0  # the enqueue alone
    torch.cuda.synchronize()
    for _ in range(QUEUE_ATTEMPTS):
        ev_sleep, ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        ev_sleep.record()
        # ~2 GHz SM clock; four times the first enqueue, and at least 20 ms,
        # so that the host's own noise does not outlast it
        torch.cuda._sleep(int(2e9 * max(4 * host_s, 20e-3)))
        ev0.record()
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        ev1.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        full = enqueue_ms < ev_sleep.elapsed_time(ev0)
        if full:
            break
    return ev0.elapsed_time(ev1) / runs, full


def graph_of(fn):
    """fn() captured as a CUDA graph: (replay, its output). One launch per
    replay, so a run of replays behind a device sleep never fills the
    launch queue (a 2D model's eager call is ~100 launches, and 10 of them
    behind a sleep block the host until the sleep ends)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph.replay, out


def geometry_cfg(label: str, variant: str = "hops"):
    """The audio config of a GEOMETRIES label in a DFT variant."""
    from tcresnet_tpu_torch.config import get_preset

    preset, window_ms, hop_ms = GEOMETRIES[label]
    return dataclasses.replace(get_preset(preset).audio, window_size_ms=window_ms,
                               window_stride_ms=hop_ms, dft_variant=variant)


def hops_times(dev: torch.device, labels, batches, ds=None, seed: int = 77,
               variant: str = "hops") -> dict:
    """{(label, batch): {"k2": (ms, ms), "library": ms, "queue_full": every
    reading's, and at the largest batch "k3": (ms, ms) and "k3_mixed", the
    rows its draw mixes with noise}}: K2 and K3-hops at 16 kHz, 1 s, and
    the library graph on one clock (order kernel, library, kernel, then K3
    twice). `ds`: a `DeviceDataset` for K3 (made from a seed if None);
    `variant`: the kernels' DFT variant (the library call is always the
    dense DFT)."""
    from tcresnet_tpu_torch.config import get_preset
    from tcresnet_tpu_torch.data.device_data import DeviceDataset
    from tcresnet_tpu_torch.data.synthetic import make_synthetic_dataset
    from tcresnet_tpu_torch.ops import augment as aug
    from tcresnet_tpu_torch.ops import dsp
    from tcresnet_tpu_torch.ops.kernels import frontend as k3
    from tcresnet_tpu_torch.ops.kernels import mfcc as k2

    n = 16000
    if ds is None:
        ds = DeviceDataset(make_synthetic_dataset(num_samples=4000, num_classes=12,
                                                  desired_samples=n, seed=0), dev)
    gen = torch.Generator(device=dev)
    out = {}
    for label in labels:
        cfg = geometry_cfg(label, variant)
        assert k2.resolve_dft_variant(cfg, n) == variant, (label, variant)
        xla = dataclasses.replace(cfg, dsp_backend="xla", dft_variant="hops")
        for batch in batches:
            wavs = torch.tensor(np.random.default_rng(seed).uniform(-1, 1, (batch, n)),
                                dtype=torch.float32, device=dev)
            library, _ = graph_of(lambda: dsp.preprocess(wavs, xla))
            (a, fa), (c, fc), (d, fd) = (queued_ms(fn) for fn in (
                lambda: k2.fused_mfcc(wavs, cfg), library, lambda: k2.fused_mfcc(wavs, cfg)))
            t = {"k2": (a, d), "library": c, "queue_full": fa and fc and fd}
            if batch == max(batches):
                gen.manual_seed(seed)
                idx, _, silent = DeviceDataset.sample_indices(ds.arrays, gen, batch)
                sc = aug.draw_scalars(gen, silent, get_preset("TCResNet8-1.0").augment,
                                      ds.noise_bank, n, True)
                (a, fa), (d, fd) = (queued_ms(
                    lambda: k3.frontend_features(ds.wavs, idx, sc, ds.noise_bank, cfg, n))
                    for _ in range(2))
                t.update(k3=(a, d), queue_full=t["queue_full"] and fa and fd,
                         k3_mixed=int((sc.vols != 0).sum()))
            out[(label, batch)] = t
    return out


def main(argv=None) -> int:
    from tcresnet_tpu_torch.utils.device import card_description

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--geometries", nargs="+", default=list(GEOMETRIES),
                        choices=list(GEOMETRIES))
    parser.add_argument("--batches", nargs="+", type=int, default=[1536, 1])
    parser.add_argument("--variant", default="hops", choices=["hops", "phases", "radix4"])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("frontend_times: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    times = hops_times(torch.device("cuda", 0), args.geometries, args.batches,
                       variant=args.variant)
    print(json.dumps({"card": card_description(), "variant": args.variant, "times_ms": {
        f"{label} B={batch}": t for (label, batch), t in times.items()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
