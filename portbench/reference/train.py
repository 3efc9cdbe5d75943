"""The training step of the recipes (helper/trainer.py and
factory/audio_nets.py of the TC-ResNet authors' code):

    loss = mean cross entropy (label smoothing s) + wd * sum(|v|^2 / 2)
           over every convolution and fc weight
    v <- the optimizer's update of v at lr(step)

with lr(step) piecewise constant: lr_list[i] up to and including
boundaries[i], and the update that of `optim["optimizer"]`, found by name in
`optimizers/<optimizer>.py` (optimizers/__init__.py gives what it
provides). Batch norm normalises with the batch's moments in training.
"""

from __future__ import annotations

import bisect
from types import ModuleType
from typing import Dict, List

import torch
import torch.nn.functional as F

from portbench.reference import augment, draws, find, frontend, models

TRAINED = ("conv", "fc", "scale", "shift")


def trained_names(arch: dict, coeffs: int) -> List[str]:
    return [k for k, (_, kind) in models.leaves(arch, coeffs).items() if kind in TRAINED]


def optimizer(optim: dict) -> ModuleType:
    """The module of `optim["optimizer"]`."""
    return find("optimizers", optim["optimizer"])


def learning_rate(optim: dict, step: int) -> float:
    return float(optim["lr_list"][bisect.bisect_left(list(optim["boundaries"]), step)])


def loss_fn(params: Dict[str, torch.Tensor], feats, labels, keep, cfg: dict, arch: dict,
            kinds: Dict[str, str], dtype) -> torch.Tensor:
    logits = models.forward(params, feats, arch, True, keep, dtype)
    s = cfg["model"]["label_smoothing"]
    target = F.one_hot(labels.long(), arch["classes"]).float() * (1 - s) + s / arch["classes"]
    ce = -(target * torch.log_softmax(logits, -1)).sum(-1).mean()
    l2 = sum(0.5 * (v.float() ** 2).sum() for k, v in params.items()
             if kinds[k] in ("conv", "fc"))
    return ce + cfg["model"]["weight_decay"] * l2


def run_steps(cfg: dict, weights: Dict[str, torch.Tensor], data, seed: int, steps: int,
              batch: int, dtype=torch.float32, rows_kept: int = 0, lr_scale: float = 1.0) -> dict:
    """`steps` training steps from `weights` on `data` (a dict with the
    int16 `wavs`, `labels`, `silent` and the `noise` bank) -> {"losses":
    [per step], "first_grad": {name: tensor}, "change": {name: params after
    the steps minus `weights`}}. `rows_kept` > 0 keeps only that many rows of
    each batch, the mean taken over them, and `lr_scale` scales the learning
    rate (faults for the control tests)."""
    arch = cfg["architecture"]
    g = frontend.Geometry.from_audio(cfg["audio"])
    kinds = {k: kind for k, (_, kind) in models.leaves(arch, g.coeffs).items()}
    names = [k for k in kinds if kinds[k] in TRAINED]
    params = {k: weights[k].detach().clone().float() for k in names}
    stats = {k: weights[k] for k in kinds if kinds[k] not in TRAINED}
    optim = cfg["optim"]
    opt = optimizer(optim)
    state = opt.init(params)
    mask = models.dropout_shape(arch, batch)
    losses, first_grad = [], None
    wavs, noise = data["wavs"], data["noise"]
    for step in range(steps):
        d = draws.draw_step(seed, step, batch, wavs.shape[0], cfg["augment"], noise.shape[0],
                            noise.shape[1], g.samples, wavs.device)
        audio = augment.augment_rows(wavs, data["silent"], noise, d.rows, d.shifts, d.clips,
                                     d.offs, d.vols, g.samples)
        feats = frontend.mfcc(audio, g, dtype)
        keep = (None if mask is None else
                draws.dropout_keep(d.generator, mask, arch["dropout_keep_prob"], wavs.device))
        labels = data["labels"][d.rows.long()]
        if rows_kept:
            feats, labels = feats[:rows_kept], labels[:rows_kept]
            keep = None if keep is None else keep[:rows_kept]
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        loss = loss_fn({**leaves, **stats}, feats, labels, keep, cfg, arch, kinds, dtype)
        grads = dict(zip(names, torch.autograd.grad(loss, [leaves[k] for k in names])))
        losses.append(float(loss.detach()))
        lr = lr_scale * learning_rate(optim, step)
        with torch.no_grad():
            params, state = opt.step(params, grads, state, lr, optim)
        if first_grad is None:
            first_grad = {k: gk.detach() for k, gk in grads.items()}
    change = {k: params[k].detach() - weights[k].float() for k in names}
    return {"losses": losses, "first_grad": first_grad, "change": change}
