"""The share of the device's idle time, over the pass's requests under a
device-only profile, that falls inside a `serve.request` span on the
host (the spans' clock is the profiler's): idle inside the serving entry
against idle in the client between requests."""

from portbench.harness import spans


def read(run):
    if not spans.observe(run) or not run.obs.get("spans.idle_s"):
        return None
    return 100.0 * run.obs["spans.idle_in_request_s"] / run.obs["spans.idle_s"]
