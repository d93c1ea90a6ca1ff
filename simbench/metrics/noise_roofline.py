"""The noise stage's share of its roofline, %: its least time on the card
(the larger of its operations over the float32 rate and its bytes over
the memory rate, counted from the cell's shapes) over its measured time."""

from lartpcbench import peaks


def read(ctx):
    t = (ctx.get("stages") or {}).get("noise")
    work = ctx["counts"].get("noise")
    if not t or work is None:
        return None
    return 100.0 * peaks.bound_s(*work) / t
