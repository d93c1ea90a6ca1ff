"""Host ms a batch in the launcher's ``sim.generate``, its own time: the
``gen(...)`` calls that draw the batch's depos; the program's spans over
the traced chunk."""

from lartpcbench import program_spans


def read(ctx):
    return program_spans.self_ms("sim.generate")
