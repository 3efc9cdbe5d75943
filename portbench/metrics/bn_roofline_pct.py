"""The batch norms' share of their roofline inside the benchmarked step: the
least time of their frozen bytes (`harness/batchnorm.py`: at each batch
norm of the reference's step, x read and y written, dy read, x read and dx
written, once each, at the HBM bandwidth) over `train_bn_ms`, whatever
implements them."""

from portbench.harness import batchnorm, peaks


def read(run):
    ms = batchnorm.step_ms(run)
    if not ms:
        return None
    cfg = run.cell.config
    nbytes = batchnorm.work_bytes(cfg, int(cfg["train"]["batch_size"]))
    least = peaks.least_seconds(run.card, 0, nbytes)
    return None if least is None else 100.0 * least / (1e-3 * ms)
