"""Card ms from one batch's last stage exit event to the next batch's
first stage entry event, the mean over the traced chunk's gaps: the card's
idle time plus the launcher's own card work (generation, validation
copy, packing) between batches. None off the card."""

from lartpcbench import program_spans


def read(ctx):
    s = program_spans.summary()
    if s is None or not s["device_calls"].get("launcher"):
        return None
    return s["device_ms"]["launcher"] / s["device_calls"]["launcher"]
