"""The model's forward and backward at the cell's batch against their
roofline: the least time of the frozen count of the model's step from the
features (dense TF32 peak) or of its bytes (features, weights and
gradients, labels, each once) over the device time of the Trainer's model
on the features plus `torch.autograd.grad` of the loss, timed alone."""

from portbench.harness import peaks


def read(run):
    seconds = run.obs.get("model.device_s")
    if not seconds:
        return None
    c = run.driver.counts()
    least = peaks.least_seconds(run.card, c["model_flops"], c["model_bytes"])
    return None if least is None else 100.0 * least / seconds
