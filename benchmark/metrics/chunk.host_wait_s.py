"""``chunk.host_wait_s``: the host's seconds blocked on a chunk's read-back
event (``host_s.wait`` of ``run_sweep``'s ``chunk_stats``), the mean over
the window's chunks.  Near a chunk's device seconds, the call is bound by
the device; near 0, the host paces it."""


def read(record):
    host = [c.get("host_s") for call in record["calls"] for c in call["chunk_stats"]]
    if not host or None in host:
        return None
    return sum(h["wait"] for h in host) / len(host)
