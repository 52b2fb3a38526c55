"""``sweep.allocator_calls``: the caching allocator's ``cudaMalloc`` and
``cudaFree`` calls (``alloc.device_allocs + alloc.device_frees`` of
``run_sweep``'s ``chunk_stats``, counted across each chunk's queue and
drain) per window call."""


def read(record):
    calls = record["calls"]
    counts = [c.get("alloc") for call in calls for c in call["chunk_stats"]]
    if not counts or None in counts:
        return None
    return sum(a["device_allocs"] + a["device_frees"] for a in counts) / len(calls)
