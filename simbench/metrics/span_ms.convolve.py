"""Card ms a batch between the convolve stage's entry and exit events in
the stream (``sim.stage.convolve``), host-induced idle included: the stage's
cost in the stream, beside ``stage_ms.convolve`` alone on one event. None
off the card."""

from lartpcbench import program_spans


def read(ctx):
    return program_spans.card_ms("sim.stage.convolve")
