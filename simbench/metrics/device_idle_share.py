"""The share of the traced window in which no operation ran on the card,
%: 1 less the union of the device's activity intervals (torch.profiler)
over the window's length."""


def read(ctx):
    tr = ctx.get("trace") or {}
    if not tr.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
