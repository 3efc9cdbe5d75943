"""The share of the untraced training step in which the device idles: the
device's busy time per step, from the device-only profile (torch.profiler's
kernel, copy and set activities over its steps), against the host-timed
step of the calls timed before it without a profiler, the window's own
pace. The profiler stretches the host-paced step, so the profiled window's
own idle share (`device.busy_s` / `device.window_s`) reads the profiler's
cost as idle; this reading leaves that cost out. It can read a little
under 0 where the profiler also slows the device's work."""


def read(run):
    o = run.obs
    busy, steps = o.get("trace.busy_s"), o.get("trace.steps")
    timed, timed_steps = o.get("train.timed_s"), o.get("train.steps")
    if not busy or not steps or not timed or not timed_steps:
        return None
    return 100.0 * (1.0 - (busy / steps) / (timed / timed_steps))
