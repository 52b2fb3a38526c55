"""``chunk.drain_s``: the host's seconds draining a chunk once it is read
back (the scatter of its results and the checkpoint save: ``host_s.drain``
of ``run_sweep``'s ``chunk_stats``), the mean over the window's chunks."""


def read(record):
    host = [c.get("host_s") for call in record["calls"] for c in call["chunk_stats"]]
    if not host or None in host:
        return None
    return sum(h["drain"] for h in host) / len(host)
