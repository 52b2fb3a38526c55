"""``chunk.prepare_s``: the host's seconds preparing a chunk (draws, inits,
permutations, packing and uploads, until its first phase is queued:
``host_s.prepare`` of ``run_sweep``'s ``chunk_stats``), the mean over the
window's chunks."""


def read(record):
    host = [c.get("host_s") for call in record["calls"] for c in call["chunk_stats"]]
    if not host or None in host:
        return None
    return sum(h["prepare"] for h in host) / len(host)
