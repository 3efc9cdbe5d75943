"""Device milliseconds of the input path inside the benchmarked step: the
median over the traced pass's steps of the `train.input` span's CUDA
events (the batch's gather, augmentation and features; K3 in this cell)."""

from portbench.harness import spans


def read(run):
    return spans.phase_median(run, ("train.input",))
