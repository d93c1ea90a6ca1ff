"""The 95th percentile of the window's batch latencies, ms: from a
batch's entry into the executor to the launcher's ``on_batch`` for it
(linear interpolation between order statistics)."""

import numpy as np


def read(ctx):
    lat = ctx["window"].latency_s
    return 1e3 * float(np.percentile(lat, 95)) if lat else None
