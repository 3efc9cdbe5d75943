"""Device milliseconds of the depthwise convolutions inside the benchmarked
step: the median over the traced pass's steps of the program's
`model.depthwise` spans' CUDA events, forward and backward, summed per
step (`harness/dwconv.py`). None where the program records no such span."""

from portbench.harness import dwconv


def read(run):
    return dwconv.step_ms(run)
