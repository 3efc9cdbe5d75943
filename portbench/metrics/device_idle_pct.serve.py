"""The share of the device-only profiled serving window in which no kernel, copy or
set ran on the device (torch.profiler's device activities)."""


def read(run):
    busy, window = run.obs.get("trace.busy_s"), run.obs.get("trace.window_s")
    if not busy or not window:
        return None
    return 100.0 * (1.0 - busy / window)
