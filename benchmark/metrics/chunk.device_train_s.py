"""``chunk.device_train_s``: the stream's seconds in a chunk's train phase
(``device_s.train`` of ``run_sweep``'s ``chunk_stats``, between CUDA
events, as the pipelined window runs it), the mean over the window's
chunks that captured nothing (their bucket's graphs replayed)."""


def read(record):
    chunks = [c for call in record["calls"] for c in call["chunk_stats"]]
    if not chunks or any("device_s" not in c or "graphs" not in c for c in chunks):
        return None
    replayed = [c["device_s"]["train"] for c in chunks if c["graphs"]["captures"] == 0]
    return sum(replayed) / len(replayed) if replayed else None
