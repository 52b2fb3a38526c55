"""``chunk.sent_s``: seconds of a chunk's sentiment phase, from
``run_sweep``'s ``phase_s`` (as ``chunk.train_s``), per chunk."""


def read(record):
    call = record["phase_call"]
    secs = call["phase_s"].get("sentiment")
    return secs / call["chunks"] if secs is not None and call["chunks"] else None
