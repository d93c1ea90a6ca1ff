"""Host ms a batch in the launcher's ``sim.validate``, its own time: the
ingest checks on the host, the validation copy (a wait of its own)
excluded; the program's spans over the traced chunk."""

from lartpcbench import program_spans


def read(ctx):
    return program_spans.self_ms("sim.validate")
