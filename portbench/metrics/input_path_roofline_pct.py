"""The training input path's share of its roofline: the least time of its
work (a real FFT per frame, the nonzero mel weights and the DCT at the
dense TF32 peak; the batch's int16 rows, the noise bank and the features
each moved once at the HBM bandwidth) over the device time of the
Trainer's `_input_features` on one step's draws, timed alone."""

from portbench.harness import peaks


def read(run):
    seconds = run.obs.get("input_path.device_s")
    if not seconds:
        return None
    c = run.driver.counts()
    least = peaks.least_seconds(run.card, c["input_flops"], c["input_bytes"])
    return None if least is None else 100.0 * least / seconds
