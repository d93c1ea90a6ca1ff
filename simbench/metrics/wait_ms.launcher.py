"""Host ms a batch blocked in the launcher's waits for the card: the
validation copy (``sim.validate.copy``) and the finished batch's flags and
hit count (``sim.finish.*``); the program's spans over the traced chunk."""

from lartpcbench import program_spans


def read(ctx):
    return program_spans.per_batch(lambda s: s["wait_ms"]["launcher"])
