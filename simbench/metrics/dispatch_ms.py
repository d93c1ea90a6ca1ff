"""Host ms inside the executor call (``SimGraph.run_batch`` through the
batched executor), the mean over the window's batches."""


def read(ctx):
    d = ctx["window"].dispatch_s
    return 1e3 * sum(d) / len(d) if d else None
