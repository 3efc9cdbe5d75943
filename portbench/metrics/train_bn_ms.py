"""Device milliseconds of the batch norms (and the ReLUs after them) inside
the benchmarked step: the median over the traced pass's steps of the
program's `model.batch_norm` spans' CUDA events, forward and backward,
summed per step (`harness/batchnorm.py`). None where the program records no
such span."""

from portbench.harness import batchnorm


def read(run):
    return batchnorm.step_ms(run)
