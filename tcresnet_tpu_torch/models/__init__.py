"""Model registry (counterpart of tcresnet_tpu/models/__init__.py).

The port builds the temporal TC-ResNets. Every other family of the JAX
registry is named here and raises NotImplementedError pointing at its
ROADMAP.md row, so a config that names it fails loudly.

`ModelConfig.conv_backend` is honoured:

- "xla": cuDNN convs on the card (PyTorch's conv on the CPU);
- "pallas": every temporal conv, forward and backward, through kernel
  K7 (`csrc/tconv.cu`) on the card, its plain version on the CPU;
- "pallas-interpret": K7's plain version on any device (the JAX
  package's test value);
- "im2col" raises NotImplementedError (not carried over, ROADMAP.md
  Queue 1 item 15); any other value raises ValueError.
"""

from __future__ import annotations

from typing import Mapping, Tuple, Union

import torch
from torch import nn

from tcresnet_tpu.config import ModelConfig
from tcresnet_tpu_torch.models import tc_resnet

_NOT_PORTED = {
    "ResNet2D8": "Queue 1 item 11 (TCResNet2D8[Pool])",
    "ResNet2D8Pool": "Queue 1 item 11 (TCResNet2D8[Pool])",
    "Res8": "Queue 1 item 11 (models/res.py)",
    "Res8Narrow": "Queue 1 item 11 (models/res.py)",
    "Res15": "Queue 1 item 11 (models/res.py)",
    "Res15Narrow": "Queue 1 item 11 (models/res.py)",
    "DSCNNS": "Queue 1 item 11 (models/ds_cnn.py)",
    "DSCNNM": "Queue 1 item 11 (models/ds_cnn.py)",
    "DSCNNL": "Queue 1 item 11 (models/ds_cnn.py)",
    "KWS": "Queue 1 item 11 (models/kws.py)",
}


def build_model(
    cfg: ModelConfig,
    feature_shape: Tuple[int, int, int],
    compute_dtype: str = "float32",
    *,
    device,
) -> nn.Module:
    """The configured model, in eval mode, for a front-end geometry
    (frames, coeffs, 1), with its parameters on `device`. `compute_dtype`
    ("float32" or "bfloat16") is the dtype of its convs and fc; the
    parameters stay float32."""
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if compute_dtype not in dtypes:
        raise ValueError(f"compute_dtype must be one of {sorted(dtypes)}, got {compute_dtype!r}")
    if cfg.name in _NOT_PORTED:
        raise NotImplementedError(
            f"model {cfg.name!r} is not ported yet (ROADMAP.md {_NOT_PORTED[cfg.name]})"
        )
    builders = {"TCResNet8": tc_resnet.tc_resnet8, "TCResNet14": tc_resnet.tc_resnet14}
    if cfg.name not in builders:
        raise KeyError(f"Unknown model {cfg.name!r}")
    model = builders[cfg.name](
        cfg.num_classes, cfg.width_multiplier,
        in_channels=feature_shape[1], dropout_keep_prob=cfg.dropout_keep_prob,
        bn_momentum=cfg.bn_momentum, dtype=dtypes[compute_dtype],
        conv_backend=cfg.conv_backend, device=device,
    )
    return model.eval()


def param_count(model_or_state: Union[nn.Module, Mapping[str, torch.Tensor]]) -> int:
    """Trainable parameter count: a module's parameters, or every entry of
    a `variables["params"]` mapping (buffers such as BN running stats are
    not parameters, as in the JAX count)."""
    if isinstance(model_or_state, nn.Module):
        return sum(p.numel() for p in model_or_state.parameters())
    return sum(int(v.numel()) for v in model_or_state.values())
