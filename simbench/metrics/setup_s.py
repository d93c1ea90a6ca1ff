"""Seconds from the process's start to the window's: imports, building the
executor (responses, filters, the kernels' libraries), the warm-up
chunk."""


def read(ctx):
    return ctx["setup_s"]
