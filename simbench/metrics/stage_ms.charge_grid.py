"""The charge_grid stage of one event alone, ms (CUDA events; median of 3)."""


def read(ctx):
    t = (ctx.get("stages") or {}).get("charge_grid")
    return None if t is None else 1e3 * t
