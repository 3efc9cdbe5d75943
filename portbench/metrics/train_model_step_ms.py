"""Device milliseconds of the model's forward and backward inside the
benchmarked step: the median over the traced pass's steps of the
`train.forward` (model and loss) plus `train.backward` (the gradients)
spans' CUDA events."""

from portbench.harness import spans


def read(run):
    return spans.phase_median(run, ("train.forward", "train.backward"))
