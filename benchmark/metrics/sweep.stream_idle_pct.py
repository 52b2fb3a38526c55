"""``sweep.stream_idle_pct``: the share of the window's calls' wall time in
which the stream was in no chunk's phases: one less the union of the
chunks' ``[device_start_at_s, device_end_at_s]`` (``run_sweep``'s
``chunk_stats``, from CUDA events) over the calls' ``wall_s``, summed over
the calls.  It holds the host-bound start and end of a call and the gaps
between chunks, not the gaps between kernels inside the phases."""


def read(record):
    busy = wall = 0.0
    for call in record["calls"]:
        spans = [(c.get("device_start_at_s"), c.get("device_end_at_s"))
                 for c in call["chunk_stats"]]
        if not spans or any(None in s for s in spans):
            return None
        end = float("-inf")
        for a, b in sorted(spans):
            busy += max(b - max(a, end), 0.0)
            end = max(end, b)
        wall += call["wall_s"]
    return 100.0 * (1.0 - busy / wall) if wall > 0 else None
