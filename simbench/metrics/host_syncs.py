"""Blocking host reads of card data a batch: the reads the program's wait
spans count over the traced chunk (validation copy, binning masks, flags,
hit count)."""

from lartpcbench import program_spans


def read(ctx):
    return program_spans.per_batch(lambda s: s["reads"])
