"""The whole served batch's share of the card's dense TF32 peak: the frozen
inference count (wav -> softmax, portbench/harness/flops.py) of the timed
requests over their host time."""

from portbench.harness import peaks


def read(run):
    o = run.obs
    peak = peaks.peak(run.card, peaks.PEAK_FLOPS_KEY)
    if not peak or not o.get("serve.timed_s"):
        return None
    return 100.0 * o["serve.flops"] / o["serve.timed_s"] / peak
