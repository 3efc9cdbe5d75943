"""The whole training step's share of the card's dense TF32 peak: the
frozen step count (portbench/harness/flops.py) times the steps of the
timed calls, over their host time."""

from portbench.harness import peaks


def read(run):
    o = run.obs
    peak = peaks.peak(run.card, peaks.PEAK_FLOPS_KEY)
    if not peak or not o.get("train.timed_s"):
        return None
    flops = run.driver.counts()["step_flops"] * o["train.steps"]
    return 100.0 * flops / o["train.timed_s"] / peak
