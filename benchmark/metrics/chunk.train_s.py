"""``chunk.train_s``: seconds of a chunk's train phase (the e2e joint fit),
from ``run_sweep``'s ``phase_s`` (the device synced after each phase) of
the traced run's one call with ``phase_timing=True`` after the window,
per chunk."""


def read(record):
    call = record["phase_call"]
    secs = call["phase_s"].get("train")
    return secs / call["chunks"] if secs is not None and call["chunks"] else None
