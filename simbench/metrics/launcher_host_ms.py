"""Host ms a batch outside the executor call and outside ``on_batch``:
the window's wall time less both spans, over the window's batches. It
holds the launcher's generation, validation copy and its wait, padding
and the wait for the finished batch's flags."""


def read(ctx):
    w = ctx["window"]
    if not w.batches:
        return None
    rest = w.window_s - sum(w.dispatch_s) - sum(w.on_batch_s)
    return 1e3 * rest / w.batches
