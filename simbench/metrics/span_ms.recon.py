"""Card ms a batch between the recon stages' entry and exit events in the
stream, deconvolve plus hit_find (``sim.stage.*``), host-induced idle
included. None off the card."""

from lartpcbench import program_spans


def read(ctx):
    return program_spans.card_ms("sim.stage.deconvolve", "sim.stage.hit_find")
