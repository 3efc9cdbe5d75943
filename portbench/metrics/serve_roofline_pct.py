"""The served requests' share of their roofline: for each timed request the
least time of its work (the front end at its least, the model's forward by
the frozen count, at the dense TF32 peak; or its clips, softmax and
weights each moved once at the HBM bandwidth), summed, over the sum of
their device times (CUDA events around each request)."""

from portbench.harness import peaks


def read(run):
    seconds = run.obs.get("serve.device_s")
    terms = run.notes.get("serve.work")
    if not seconds or not terms:
        return None
    least = [peaks.least_seconds(run.card, f, b) for f, b in terms]
    if any(x is None for x in least):
        return None
    return 100.0 * sum(least) / seconds
