"""Events completed in the window over the window's seconds."""


def read(ctx):
    w = ctx["window"]
    return w.events / w.window_s if w.window_s > 0 else None
