"""Streaming SVDF inference with explicit state (counterpart of
tcresnet_tpu/serve/streaming.py).

The KWS `low_latency_svdf` model (models/kws.py) keeps, per filter, its
frequency-filtered activations over the last T frames. A stream feeds
only the frames newer than its last call: `init_state` -> repeated
`streaming_step(params, memory, new_frames)` -> (probs, new memory).
Feeding a full window into a fresh state is the batch model's forward
pass. This is plain PyTorch: the JAX package has no kernel here either.
"""

from __future__ import annotations

from typing import Any, Mapping, Tuple

import torch
import torch.nn.functional as F

from tcresnet_tpu_torch.models.kws import SVDF_RANK, SVDF_UNITS
from tcresnet_tpu_torch.utils.device import resolve_device


def init_state(spectrogram_length: int, num_filters: int = SVDF_RANK * SVDF_UNITS, *,
               device) -> torch.Tensor:
    """Fresh (zero) streaming memory [num_filters, T] on `device`."""
    return torch.zeros((num_filters, spectrogram_length), dtype=torch.float32,
                       device=resolve_device(device))


@torch.no_grad()
def streaming_step(params: Mapping[str, Any], memory: torch.Tensor,
                   new_frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One streaming inference step.

    params: the port's low_latency_svdf params (`weights_frequency` [F, K],
      `weights_time` [K, T], `bias` [units], `fc1`..`fc3` as Linear
      `weight` [out, in] and `bias`), on memory's device.
    memory: [K, T] activation history.
    new_frames: [num_new, F] feature frames newer than the last call.

    Returns (softmax probs [num_classes], updated memory)."""
    num_new = new_frames.shape[0]
    # the new frames' frequency filtering: [K, num_new]
    acts = (new_frames.to(torch.float32) @ params["weights_frequency"]).T
    # the oldest frames shifted out, the new appended
    memory = torch.cat([memory[:, num_new:], acts], dim=1)
    # the time filter over the full window, then the rank sum
    out = (memory * params["weights_time"]).sum(dim=1)
    units = out.reshape(SVDF_UNITS, SVDF_RANK).sum(dim=1)
    x = F.relu(units + params["bias"])
    for name in ("fc1", "fc2", "fc3"):
        x = F.linear(x, params[f"{name}.weight"], params[f"{name}.bias"])
    return torch.softmax(x, dim=-1), memory
