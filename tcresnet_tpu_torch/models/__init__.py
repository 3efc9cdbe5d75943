"""Model registry (counterpart of tcresnet_tpu/models/__init__.py).

Every family of the JAX registry is built here, returned in eval mode;
`.train()` gives the training mode the JAX model has with training=True
(batch statistics in every batch norm, dropout from a generator):

- TCResNet8 / TCResNet14: temporal convs (models/tc_resnet.py);
- ResNet2D8 / ResNet2D8Pool: the 2D TC-ResNet variants (tc_resnet.py);
- Res8 / Res8Narrow / Res15 / Res15Narrow (models/res.py);
- DSCNNS / DSCNNM / DSCNNL (models/ds_cnn.py);
- KWS, with `kws_architecture` one of the seven baselines (models/kws.py).

An unknown name raises KeyError.

`ModelConfig.conv_backend` is honoured:

- "xla": cuDNN convs on the card (PyTorch's conv on the CPU);
- "pallas": every temporal conv, forward and backward, through kernel
  K7 (`csrc/tconv.cu`) on the card, its plain version on the CPU;
- "pallas-interpret": K7's plain version on any device (the JAX
  package's test value);
- "im2col" raises NotImplementedError (ROADMAP.md Queue 1, "Not
  carried over"); any other value raises ValueError.

As in the JAX package, the Pallas conv is temporal only, so the 2D
families run cuDNN whichever of the three served values is set.
"""

from __future__ import annotations

from typing import Mapping, Tuple, Union

import torch
from torch import nn

from tcresnet_tpu_torch.config import ModelConfig
from tcresnet_tpu_torch.models import ds_cnn, kws, layers, res, tc_resnet

FAMILIES = ("TCResNet8", "TCResNet14", "ResNet2D8", "ResNet2D8Pool", *res.RES_SHAPES,
            *ds_cnn.NET_DEFS, "KWS")


def build_model(
    cfg: ModelConfig,
    feature_shape: Tuple[int, int, int],
    compute_dtype: str = "float32",
    *,
    device,
) -> nn.Module:
    """The configured model, in eval mode (`.train()` for training), for a
    front-end geometry (frames, coeffs, 1), with its parameters on `device`. `compute_dtype`
    ("float32" or "bfloat16") is the dtype of its convs and fc; the
    parameters stay float32."""
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if compute_dtype not in dtypes:
        raise ValueError(f"compute_dtype must be one of {sorted(dtypes)}, got {compute_dtype!r}")
    if cfg.name not in FAMILIES:
        raise KeyError(f"Unknown model {cfg.name!r}")
    layers.check_conv_backend(cfg.conv_backend)
    kw = dict(dtype=dtypes[compute_dtype], device=device)
    name, ncls = cfg.name, cfg.num_classes
    if name in ("TCResNet8", "TCResNet14"):
        builder = tc_resnet.tc_resnet8 if name == "TCResNet8" else tc_resnet.tc_resnet14
        model = builder(ncls, cfg.width_multiplier, in_channels=feature_shape[1],
                        dropout_keep_prob=cfg.dropout_keep_prob, bn_momentum=cfg.bn_momentum,
                        conv_backend=cfg.conv_backend, **kw)
    elif name.startswith("ResNet2D8"):
        model = tc_resnet.resnet2d8(ncls, cfg.width_multiplier, num_coeffs=feature_shape[1],
                                    pool=name.endswith("Pool"),
                                    dropout_keep_prob=cfg.dropout_keep_prob,
                                    bn_momentum=cfg.bn_momentum, **kw)
    elif name in res.RES_SHAPES:
        model = res.res_model(name, ncls, bn_momentum=cfg.bn_momentum, **kw)
    elif name in ds_cnn.NET_DEFS:
        model = ds_cnn.DSCNN(ncls, ds_cnn.NET_DEFS[name], bn_momentum=cfg.bn_momentum, **kw)
    else:
        model = kws.KWSNet(ncls, cfg.kws_architecture, feature_shape, **kw)
    return model.eval()


def param_count(model_or_state: Union[nn.Module, Mapping[str, torch.Tensor]]) -> int:
    """Trainable parameter count: a module's parameters, or every entry of
    a `variables["params"]` mapping (buffers such as BN running stats are
    not parameters, as in the JAX count)."""
    if isinstance(model_or_state, nn.Module):
        return sum(p.numel() for p in model_or_state.parameters())
    return sum(int(v.numel()) for v in model_or_state.values())
