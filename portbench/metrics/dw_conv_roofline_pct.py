"""The depthwise convolutions' share of their roofline inside the
benchmarked step: the least time of their frozen work (`harness/dwconv.py`:
operations at the dense TF32 peak, or each input, output, gradient and
weight moved once at the HBM bandwidth) over `train_dw_conv_ms`, whatever
implements them."""

from portbench.harness import dwconv, peaks


def read(run):
    ms = dwconv.step_ms(run)
    if not ms:
        return None
    cfg = run.cell.config
    ops, nbytes = dwconv.work(cfg, int(cfg["train"]["batch_size"]))
    least = peaks.least_seconds(run.card, ops, nbytes)
    return None if least is None else 100.0 * least / (1e-3 * ms)
