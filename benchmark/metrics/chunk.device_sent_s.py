"""``chunk.device_sent_s``: the stream's seconds in a chunk's sentiment fit
and its scoring (``device_s.sentiment + device_s.metrics`` of
``run_sweep``'s ``chunk_stats``), the mean over the window's chunks that
captured nothing, as ``chunk.device_train_s``: the pipelined window's
counterpart of ``chunk.sent_s``."""


def read(record):
    chunks = [c for call in record["calls"] for c in call["chunk_stats"]]
    if not chunks or any("device_s" not in c or "graphs" not in c for c in chunks):
        return None
    replayed = [c["device_s"]["sentiment"] + c["device_s"]["metrics"]
                for c in chunks if c["graphs"]["captures"] == 0]
    return sum(replayed) / len(replayed) if replayed else None
