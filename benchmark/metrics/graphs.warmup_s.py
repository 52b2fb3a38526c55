"""``graphs.warmup_s``: the stream's seconds in the bucket's eager warm-ups
(each graph key's first call, on the side stream, between CUDA events on the
current stream around it: ``device_warmup_s`` of ``run_sweep``'s
``chunk_stats``, from ``Graphs.warmup_marks``) per window call.  The device
seconds of the warm-ups' own work, not the host's wait behind the work
queued before them."""


def read(record):
    calls = record["calls"]
    warm = [c.get("device_warmup_s") for call in calls for c in call["chunk_stats"]]
    if not warm or None in warm:
        return None
    return sum(warm) / len(calls)
