"""Host milliseconds of a request on the `xla` route (the dense DFT and
cuDNN), from the program's `serve.request` span: the mean over the traced
pass's requests whose span records `route=xla`."""

from portbench.harness import spans


def read(run):
    return spans.request_host_ms(run, "xla")
