"""Host ms a batch blocked in the executor's waits for the card: the tile
binning's boolean-mask writes (``sim.bin.mask``); the program's spans over
the traced chunk."""

from lartpcbench import program_spans


def read(ctx):
    return program_spans.per_batch(lambda s: s["wait_ms"]["executor"])
