"""The benchmark's plain reference: what the timed program must compute.

Plain PyTorch and NumPy, written from the published descriptions and the
TF-1.13 front end they train on. It imports neither `jax` nor any module of
the program under test, and takes nothing the program derived: the harness
hands it the dataset, the weights and the seed it made itself.

- `frontend`: the MFCC front end (periodic Hann, dense windowed real DFT,
  power, HTK mel bank, log(mel + 1e-6), scaled DCT-II);
- `draws`: the training step's draws from (seed, step): rows, augmentation
  scalars, dropout masks;
- `augment`: gather, int16 decode, time shift, background mix, clip;
- `models`: the model of a configuration's `architecture`, found by its
  `family` in `families/<family, lower-case>.py` (TC-ResNet, Choi et al.
  2019; Res, Tang & Lin 2018), as functions of a {name: tensor} weight
  mapping, and the layers the families share;
- `train`: the training step (smoothed cross entropy + L2), its update found
  by the configuration's `optimizer` in `optimizers/<optimizer>.py`
  (momentum, Adam) and scaled by the piecewise learning rate;
- `serve`: wav -> softmax in inference mode.

Every function takes a `dtype`, the precision its matmuls and convolutions
run in: float32 (the reference, run inside `strict()`) or a lower one (the
control).
"""

import contextlib
import importlib
import sys
from pathlib import Path
from types import ModuleType

import torch

HERE = Path(__file__).resolve().parent


@contextlib.contextmanager
def strict():
    """TF32 off in cuBLAS and cuDNN for the block; the flags are restored after it."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def find(folder: str, name: str) -> ModuleType:
    """The module `<folder>/<name, lower-case>.py` of this package (a family
    or an optimizer), found by name with no list to edit. A name without
    such a file raises KeyError naming the file looked for."""
    stem = str(name).lower()
    module = f"{__name__}.{folder}.{stem}"
    path = HERE / folder / f"{stem}.py"
    if module not in sys.modules and not (stem.isidentifier() and path.is_file()):
        raise KeyError(f"no reference {folder[:-1]} {name!r}: {path} does not exist")
    return importlib.import_module(module)
