"""Host milliseconds from the call into the serving entry to its return,
before the softmax is read, a mean over the timed requests (the entry's
route choice, the xla route's eager dispatch, K5's host plan)."""


def read(run):
    o = run.obs
    if not o.get("serve.requests"):
        return None
    return 1e3 * o["serve.enqueue_s"] / o["serve.requests"]
