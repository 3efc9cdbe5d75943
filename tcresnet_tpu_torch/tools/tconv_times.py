"""Device times of the temporal-conv kernels, K7 fwd, dx and dw, over the
convs of a TCResNet8-1.0 training step, beside cuDNN (TF32 off) on one
clock, on one CUDA card.

    python -m tcresnet_tpu_torch.tools.tconv_times
    python -m tcresnet_tpu_torch.tools.tconv_times --ops fwd dx
    python -m tcresnet_tpu_torch.tools.tconv_times --digests

CUDA events around 20 calls of a set of convs that the host enqueues
behind a device-side sleep (`frontend_times.queued_ms`), in the order
kernel, cuDNN, cuDNN, kernel: the ten convs of one step; for dx also the
nine a step launches it for (the first conv's input, the features, needs
no gradient); and each conv alone (kernel, cuDNN, kernel), beside its
bound (`bound_ms`, the same for the three passes). The batch is
a training step's, 1536; the inputs are made from a fixed seed. Prints
one JSON line, with the card's name and power limit. It uses only the
package's public conv calls, so run by its path it also times another
checkout of the package put first on PYTHONPATH (the line names the
module it timed). `--digests` adds, per pass, the sha256 of each conv's
kernel output on those inputs: two checkouts whose digests agree compute
the same bits.
"""

from __future__ import annotations

import argparse
import hashlib
import json

import torch
import torch.nn.functional as F

BATCH = 1536  # TCResNet8-1.0's training batch
SEED = 1234
# the H100 SXM's published HBM rate and float32-exact tensor-core rate
# (3xTF32: the 495 TFLOP/s TF32 peak over three products), as chip_smoke.py
HBM_BYTES_PER_S, TF32X3_FLOPS = 3.35e12, 495e12 / 3


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


def conv_work(geom, batch: int) -> tuple:
    """(operations, bytes) of one pass of a conv: every tap of x that meets
    the map, multiplied once per output channel; each pass reads two of x
    / w / dy and writes the third, each once."""
    from tcresnet_tpu_torch.models.layers import same_padding
    from tcresnet_tpu_torch.ops.kernels.infer2d import valid_taps

    k, s, ci, co, t = geom
    to, lo, _ = same_padding(t, k, s)
    return (2 * batch * valid_taps(to, t, k, s, lo) * ci * co,
            4 * (batch * ci * t + co * ci * k + batch * co * to))


def bound_ms(geom, batch: int) -> float:
    """The least time the card could take for one pass of a conv in 3xTF32."""
    flops, nbytes = conv_work(geom, batch)
    return max(flops / TF32X3_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3


def conv_cases(dev: torch.device, geoms, batch: int, gen: torch.Generator) -> list:
    """Per geometry the inputs of its three passes, drawn from `gen`: x,
    w, dy, and x zero-padded for SAME (cuDNN's input)."""
    from tcresnet_tpu_torch.models.layers import same_padding

    convs = []
    for geom in geoms:
        k, s, ci, co, t = geom
        _, lo, hi = same_padding(t, k, s)
        x = torch.randn(batch, ci, t, device=dev, generator=gen)
        w = torch.randn(co, ci, k, device=dev, generator=gen) * 0.1
        dy = torch.randn(batch, co, -(-t // s), device=dev, generator=gen)
        convs.append(dict(geom=geom, k=k, s=s, t=t, lo=lo, x=x, w=w, dy=dy,
                          xp=F.pad(x, (lo, hi))))
    return convs


def conv_ops() -> dict:
    """{pass: (kernel, plain version, cuDNN f32)}, each a function of one
    `conv_cases` entry."""
    from tcresnet_tpu_torch.ops.kernels import tconv as k7

    return {
        "fwd": (lambda c: k7.tconv_fwd(c["x"], c["w"], c["s"]),
                lambda c: k7.tconv_fwd_reference(c["x"], c["w"], c["s"]),
                lambda c: F.conv1d(c["xp"], c["w"], stride=c["s"])),
        "dx": (lambda c: k7.tconv_dx(c["dy"], c["w"], c["t"], c["s"]),
               lambda c: k7.tconv_dx_reference(c["dy"], c["w"], c["t"], c["s"]),
               lambda c: torch.nn.grad.conv1d_input(c["xp"].shape, c["w"], c["dy"],
                                                    stride=c["s"])[..., c["lo"]:c["lo"] + c["t"]]),
        "dw": (lambda c: k7.tconv_dw(c["x"], c["dy"], c["k"], c["s"]),
               lambda c: k7.tconv_dw_reference(c["x"], c["dy"], c["k"], c["s"]),
               lambda c: torch.nn.grad.conv1d_weight(c["xp"], c["w"].shape, c["dy"],
                                                     stride=c["s"])),
    }


def k7_times(convs, ops=("fwd", "dx", "dw")) -> dict:
    """{pass: {"ten": {"kernel": (ms, ms), "cudnn": (ms, ms), "queue_full"},
    "nine" (dx alone) the same over convs[1:], "per_conv": [{"kernel": ms,
    "cudnn": ms, "queue_full"}, ...]}}: device ms per call of each set,
    behind a device sleep, the kernel's two readings around cuDNN's."""
    from tcresnet_tpu_torch.tools.frontend_times import queued_ms

    out = {}
    for op in ops:
        kernel, _, cudnn = conv_ops()[op]
        sets = {"ten": convs, "nine": convs[1:]} if op == "dx" else {"ten": convs}
        out[op] = {}
        for name, cs in sets.items():
            (a, fa), (b, fb), (c, fc), (d, fd) = (
                queued_ms(lambda f=f: [f(conv) for conv in cs]) for f in (kernel, cudnn, cudnn,
                                                                           kernel))
            out[op][name] = {"kernel": (a, d), "cudnn": (b, c),
                             "queue_full": fa and fb and fc and fd}
        out[op]["per_conv"] = []
        for conv in convs:
            (a, fa), (b, fb), (d, fd) = (queued_ms(lambda f=f: f(conv))
                                         for f in (kernel, cudnn, kernel))
            out[op]["per_conv"].append({"kernel": min(a, d), "cudnn": b,
                                        "queue_full": fa and fb and fd})
    return out


def k7_digests(convs, ops=("fwd", "dx", "dw")) -> dict:
    """{pass: [sha256 of the kernel's output, one a conv]} (16 hex digits)."""
    out = {}
    for op in ops:
        kernel = conv_ops()[op][0]
        out[op] = [hashlib.sha256(kernel(c).cpu().numpy().tobytes()).hexdigest()[:16]
                   for c in convs]
    return out


def main(argv=None) -> int:
    from tcresnet_tpu_torch.config import get_preset
    from tcresnet_tpu_torch.ops.kernels import tconv as k7
    from tcresnet_tpu_torch.utils.device import card_description

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ops", nargs="+", default=["fwd", "dx", "dw"],
                        choices=["fwd", "dx", "dw"])
    parser.add_argument("--digests", action="store_true",
                        help="also print the sha256 of each pass's output per conv")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tconv_times: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    geoms = conv_geometries(get_preset("TCResNet8-1.0").model, 98, 40)
    convs = conv_cases(dev, geoms, BATCH, torch.Generator(device=dev).manual_seed(SEED))
    times = k7_times(convs, args.ops)
    line = {"card": card_description(), "module": k7.__file__, "batch": BATCH,
            "geometries": geoms, "bound_ms": [bound_ms(g, BATCH) for g in geoms],
            "times_ms": times}
    if args.digests:
        line["digests"] = k7_digests(convs, args.ops)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
