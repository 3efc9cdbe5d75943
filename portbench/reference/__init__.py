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
- `models`: TC-ResNet (Choi et al. 2019) and Res (Tang & Lin 2018) as
  functions of a {name: tensor} weight mapping;
- `train`: the training step (smoothed cross entropy + L2, unit-LR momentum
  scaled by the piecewise learning rate);
- `serve`: wav -> softmax in inference mode.

Every function takes a `dtype`, the precision its matmuls and convolutions
run in: float32 (the reference, run inside `strict()`) or a lower one (the
control).
"""

import contextlib

import torch


@contextlib.contextmanager
def strict():
    """TF32 off in cuBLAS and cuDNN for the block; the flags are restored after it."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
