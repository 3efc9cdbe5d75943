"""Host milliseconds of a request on the fused route (K2 + K5), from the
program's `serve.request` span: the mean over the traced pass's requests
whose span records `route=fused`."""

from portbench.harness import spans


def read(run):
    return spans.request_host_ms(run, "fused")
