"""Host ms a batch in the launcher's ``sim.pack``, its own time: padding
rows, the event keys and ``pack_events``; the program's spans over the
traced chunk."""

from lartpcbench import program_spans


def read(ctx):
    return program_spans.self_ms("sim.pack")
