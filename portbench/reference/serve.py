"""Serving: raw 1 s clips -> MFCC -> the model in inference mode -> softmax."""

from __future__ import annotations

import torch

from portbench.reference import frontend, models


@torch.no_grad()
def softmax(cfg: dict, weights, wavs: torch.Tensor, dtype=torch.float32,
            block: int = 256) -> torch.Tensor:
    """[B, samples] float32 -> [B, classes] float32 probabilities, in
    blocks of `block` clips."""
    g = frontend.Geometry.from_audio(cfg["audio"])
    outs = []
    for start in range(0, wavs.shape[0], block):
        feats = frontend.mfcc(wavs[start:start + block], g, dtype)
        logits = models.forward(weights, feats, cfg["architecture"], False, dtype=dtype)
        outs.append(torch.softmax(logits, -1))
    return torch.cat(outs) if outs else wavs.new_zeros((0, cfg["architecture"]["classes"]))
