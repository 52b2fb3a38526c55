"""``chunk.device_infer_s``: the stream's seconds in a chunk's valid and
test inference fits (``device_s.valid_infer + device_s.test_infer`` of
``run_sweep``'s ``chunk_stats``), the mean over the window's chunks that
captured nothing, as ``chunk.device_train_s``."""


def read(record):
    chunks = [c for call in record["calls"] for c in call["chunk_stats"]]
    if not chunks or any("device_s" not in c or "graphs" not in c for c in chunks):
        return None
    replayed = [c["device_s"]["valid_infer"] + c["device_s"]["test_infer"]
                for c in chunks if c["graphs"]["captures"] == 0]
    return sum(replayed) / len(replayed) if replayed else None
