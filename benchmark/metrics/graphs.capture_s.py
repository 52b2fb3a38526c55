"""``graphs.capture_s``: the host's seconds capturing the bucket's CUDA
graphs (``host_s.capture`` of ``run_sweep``'s ``chunk_stats``, from
``Graphs.capture_s``) per window call.  Each capture is timed from an idle
card, the wait for the work queued before it left out; it holds
``torch.cuda.graph``'s own ``gc.collect`` and ``empty_cache`` besides the
recording, and the device idles through all of it."""


def read(record):
    calls = record["calls"]
    host = [c.get("host_s") for call in calls for c in call["chunk_stats"]]
    if not host or None in host:
        return None
    return sum(h["capture"] for h in host) / len(calls)
