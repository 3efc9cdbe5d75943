"""The benchmark's frozen operation counts, run on its own reference models.

`count(fn, *args)` is PyTorch's `FlopCounterMode` with XLA's convention for
convolutions: only the taps that land on the input count (2 x Ci/groups x
Co for each), never the zero padding, which the models add explicitly
(TF-SAME) and which is read back from the `constant_pad_nd` that made a
convolution's input; matrix products count 2 x M x K x N; elementwise work
and reductions count nothing. On the `meta` device nothing is computed.

- `step_flops`: one training step (front end with the dense DFT, the
  forward in training mode, the loss and every trained weight's gradient);
- `model_step_flops`: the same from the features (the model's forward and
  backward alone);
- `infer_flops`: one served batch, wav -> softmax;
- `fewest_infer_flops`: the least work of a served batch: the front end at
  its least (`frontend.fewest_flops`) and the model's forward.

These numbers are the benchmark's yardstick; they do not follow later
changes to the program.
"""

from __future__ import annotations

import functools

import torch

from portbench.reference import frontend, models
from portbench.reference import train as ref_train

_aten = torch.ops.aten
META = torch.device("meta")


def valid_taps(n: int, k: int, stride: int, dilation: int, lo: int, out: int) -> int:
    """(output row, tap) pairs of a k-tap convolution along one axis whose
    tap lands on one of the n input rows."""
    return sum(1 for o in range(out) for j in range(k)
               if 0 <= o * stride + j * dilation - lo < n)


class _ConvCount:
    def __init__(self):
        from torch.utils.weak import WeakIdKeyDictionary

        self.padded = WeakIdKeyDictionary()  # tensor -> (zero pads, unpadded shape)

    def pad(self, x, pad, value=0.0, out_val=None) -> int:
        if value == 0 and all(p >= 0 for p in pad):
            self.padded[out_val] = (tuple(pad), tuple(x.shape))
        return 0

    def macs(self, x, w, out_shape, stride, padding, dilation, transposed) -> int:
        if transposed:
            raise NotImplementedError("no transposed convolution is counted")
        spatial = x.dim() - 2
        explicit, shape = self.padded.get(x, ((0,) * (2 * spatial), tuple(x.shape)))
        taps = 1
        for d in range(spatial):
            i = 2 * (spatial - 1 - d)  # F.pad's pads run from the last axis
            lo = explicit[i] if i < len(explicit) else 0
            taps *= valid_taps(shape[2 + d], w.shape[2 + d], stride[d], dilation[d],
                               lo + padding[d], out_shape[2 + d])
        return x.shape[0] * taps * w.shape[0] * w.shape[1]

    def forward(self, x, w, bias, stride, padding, dilation, transposed, output_padding,
                groups, out_val=None) -> int:
        return 2 * self.macs(x, w, out_val.shape, stride, padding, dilation, transposed)

    def backward(self, grad_out, x, w, bias_sizes, stride, padding, dilation, transposed,
                 output_padding, groups, output_mask, out_val=None) -> int:
        one = 2 * self.macs(x, w, grad_out.shape, stride, padding, dilation, transposed)
        return one * (int(output_mask[0]) + int(output_mask[1]))

    def mapping(self) -> dict:
        def refuse(*args, **kwargs):
            raise NotImplementedError("convolutions are counted at aten.convolution only")

        formulas = {_aten.constant_pad_nd: self.pad, _aten.convolution: self.forward,
                    _aten.convolution_backward: self.backward}
        for op in (_aten._convolution, _aten.cudnn_convolution,
                   _aten.convolution_overrideable, _aten._slow_conv2d_forward):
            formulas[op] = refuse

        def raw(f):
            def formula(*args, **kwargs):
                return f(*args, **kwargs)

            formula._get_raw = True
            return formula

        return {op: raw(f) for op, f in formulas.items()}


def count(fn, *args) -> int:
    """FLOPs of one call `fn(*args)`."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False, custom_mapping=_ConvCount().mapping()) as counter:
        fn(*args)
    return int(counter.get_total_flops())


def _meta_weights(cfg: dict) -> dict:
    g = frontend.Geometry.from_audio(cfg["audio"])
    return {k: torch.empty(shape, device=META)
            for k, (shape, _) in models.leaves(cfg["architecture"], g.coeffs).items()}


def _model_step(cfg: dict, batch: int, with_frontend: bool) -> int:
    arch = cfg["architecture"]
    g = frontend.Geometry.from_audio(cfg["audio"])
    kinds = {k: kind for k, (_, kind) in models.leaves(arch, g.coeffs).items()}
    weights = _meta_weights(cfg)
    names = [k for k in kinds if kinds[k] in ref_train.TRAINED]
    for k in names:
        weights[k].requires_grad_(True)
    labels = torch.zeros(batch, dtype=torch.long, device=META)
    shape = models.dropout_shape(arch, batch)
    keep = None if shape is None else torch.ones(shape, dtype=torch.bool, device=META)

    def step(x):
        feats = frontend.mfcc(x, g) if with_frontend else x
        loss = ref_train.loss_fn(weights, feats, labels, keep, cfg, arch, kinds, torch.float32)
        return torch.autograd.grad(loss, [weights[k] for k in names])

    x = (torch.empty(batch, g.samples, device=META) if with_frontend
         else torch.empty(batch, g.frames, g.coeffs, device=META))
    return count(step, x)


@functools.lru_cache(maxsize=None)
def _cached(kind: str, cfg_json: str, batch: int) -> int:
    import json

    cfg = json.loads(cfg_json)
    if kind == "step":
        return _model_step(cfg, batch, True)
    if kind == "model_step":
        return _model_step(cfg, batch, False)
    g = frontend.Geometry.from_audio(cfg["audio"])
    weights = _meta_weights(cfg)

    @torch.no_grad()
    def infer(x):
        feats = frontend.mfcc(x, g) if kind == "infer" else x
        return torch.softmax(models.forward(weights, feats, cfg["architecture"], False), -1)

    if kind == "infer":
        return count(infer, torch.empty(batch, g.samples, device=META))
    return count(infer, torch.empty(batch, g.frames, g.coeffs, device=META))  # "model"


def _key(cfg: dict) -> str:
    import json

    return json.dumps({k: cfg[k] for k in ("audio", "architecture", "model")}, sort_keys=True)


def step_flops(cfg: dict, batch: int) -> int:
    return _cached("step", _key(cfg), batch)


def model_step_flops(cfg: dict, batch: int) -> int:
    return _cached("model_step", _key(cfg), batch)


def infer_flops(cfg: dict, batch: int) -> int:
    return _cached("infer", _key(cfg), batch)


def fewest_infer_flops(cfg: dict, batch: int) -> float:
    g = frontend.Geometry.from_audio(cfg["audio"])
    return batch * frontend.fewest_flops(g) + _cached("model", _key(cfg), batch)
