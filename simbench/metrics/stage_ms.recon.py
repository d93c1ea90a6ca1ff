"""The recon stages of one event alone, deconvolve plus hit_find, ms (CUDA
events; median of 3 each)."""


def read(ctx):
    st = ctx.get("stages") or {}
    if "deconvolve" not in st or "hit_find" not in st:
        return None
    return 1e3 * (st["deconvolve"] + st["hit_find"])
