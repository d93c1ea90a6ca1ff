"""Card ms a batch between the charge_grid stage's entry and exit events in
the stream (``sim.stage.charge_grid``), host-induced idle included: the stage's
cost in the stream, beside ``stage_ms.charge_grid`` alone on one event. None
off the card."""

from lartpcbench import program_spans


def read(ctx):
    return program_spans.card_ms("sim.stage.charge_grid")
