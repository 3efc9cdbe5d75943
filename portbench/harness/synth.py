"""Inputs and weights made on the device from the run's seed.

- `tone_dataset`: the synthetic Speech Commands-sized split, the tone
  arithmetic of the port's `data/synthetic.py` vectorised (class k > 0 a
  tone at 220 * 2^(k/6) Hz with random phase, amplitude and vibrato, a
  second harmonic and a noise floor; class 0 silence), as int16 rows, and a
  uniform noise bank in [-0.5, 0.5);
- `glorot_weights`: every convolution and the fc glorot-uniform, batch norm
  at identity (a model at the start of training);
- `calibrate`: batch-norm statistics and an fc scale for a model that
  serves, from one batch of clips, so that every layer sees unit-variance
  inputs and the logits spread as a trained model's do.

Each is a few large draws from one `torch.Generator` on the device.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict

import torch

from portbench.reference import frontend, models


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (`tag`) of the run's seed."""
    digest = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, tag))


def tone_dataset(spec: dict, seed: int, device, chunk: int = 2048) -> Dict[str, torch.Tensor]:
    """{wavs [N, S] int16, labels [N] int64, silent [N] bool, noise [K, L]
    float32} for a configuration's `dataset` section."""
    n, classes, samples = spec["clips"], spec["classes"], spec["samples"]
    g = generator(seed, "dataset", device)
    labels = torch.randint(0, classes, (n,), generator=g, device=device)
    params = torch.rand((3, n), generator=g, device=device, dtype=torch.float64)
    phase, amp, vib_hz = 2 * math.pi * params[0], 0.3 + 0.5 * params[1], 2 + 4 * params[2]
    f0 = 220.0 * torch.pow(2.0, labels.double() / 6.0)
    t = torch.arange(samples, device=device, dtype=torch.float64) / spec["sample_rate"]
    wavs = torch.empty((n, samples), dtype=torch.int16, device=device)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        tt = t[None, :]
        vib = 1.0 + 0.01 * torch.sin(2 * math.pi * vib_hz[lo:hi, None] * tt)
        p, a, f = phase[lo:hi, None], amp[lo:hi, None], f0[lo:hi, None]
        sig = a * torch.sin(2 * math.pi * f * vib * tt + p)
        sig += 0.3 * a * torch.sin(2 * math.pi * 2 * f * tt + p)
        sig += 0.01 * torch.randn((hi - lo, samples), generator=g, device=device,
                                  dtype=torch.float64)
        wav = (sig.clamp(-1, 1).float() * 32767).to(torch.int16)
        wavs[lo:hi] = torch.where((labels[lo:hi] == 0)[:, None], 0, wav)
    noise = torch.rand((spec["noise_clips"], spec["noise_samples"]), generator=g,
                       device=device) - 0.5
    return {"wavs": wavs, "labels": labels, "silent": labels == 0, "noise": noise}


def clip_pool(spec: dict, clips: int, seed: int, device) -> torch.Tensor:
    """[clips, S] float32 clips in [-1, 1): tone rows decoded as a server
    receives them."""
    data = tone_dataset({**spec, "clips": clips}, seed, device)
    return data["wavs"].float() * (1.0 / 32768.0)


def glorot_weights(arch: dict, coeffs: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor for every leaf of the reference model."""
    leaves = models.leaves(arch, coeffs)
    drawn = [k for k, (_, kind) in leaves.items() if kind in ("conv", "fc")]
    sizes = [math.prod(leaves[k][0]) for k in drawn]
    u = torch.rand((sum(sizes),), generator=generator(seed, "weights", device), device=device)
    out = {}
    for k, part in zip(drawn, torch.split(u, sizes)):
        shape = leaves[k][0]
        field = math.prod(shape[2:])
        limit = math.sqrt(6.0 / ((shape[0] + shape[1]) * field))
        out[k] = ((2 * part - 1) * limit).view(shape)
    for k, (shape, kind) in leaves.items():
        if kind in ("scale", "var"):
            out[k] = torch.ones(shape, device=device)
        elif kind in ("shift", "mean"):
            out[k] = torch.zeros(shape, device=device)
    return out


@torch.no_grad()
def calibrate(cfg: dict, weights: Dict[str, torch.Tensor], clips: torch.Tensor,
              logit_std: float) -> Dict[str, torch.Tensor]:
    """`weights` with each batch norm's running statistics set to the
    moments it sees on `clips` (layer by layer) and the fc scaled so that
    the logits' standard deviation is `logit_std`."""
    arch = cfg["architecture"]
    g = frontend.Geometry.from_audio(cfg["audio"])
    feats = frontend.mfcc(clips, g)
    w = dict(weights)
    names = [k[:-len(".running_mean")] for k in w if k.endswith(".running_mean")]
    for name in names:  # in forward order: each layer after the ones before it
        moments = {}
        models.forward(w, feats, arch, False, record=(name, moments))
        w[f"{name}.running_mean"], w[f"{name}.running_var"] = moments[name]
    logits = models.forward(w, feats, arch, False)
    w["fc.weight"] = w["fc.weight"] * (logit_std / logits.std().clamp_min(1e-12))
    return w
