"""Device milliseconds of the optimizer and EMA inside the benchmarked
step: the median over the traced pass's steps of the `train.optimizer`
span's CUDA events (the update, its learning-rate scale, the params' add,
the EMA, the step count and the accuracy)."""

from portbench.harness import spans


def read(run):
    return spans.phase_median(run, ("train.optimizer",))
