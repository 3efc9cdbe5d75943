"""K5's op tables built per request on the fused route: the change of the
program's `k5_tables` counter over the traced pass, over the pass's
`serve.request` spans with `route=fused`."""

from portbench.harness import spans


def read(run):
    fused = len(spans.requests(run, "fused"))
    if not fused or "spans.k5_tables" not in run.obs:
        return None
    return run.obs["spans.k5_tables"] / fused
