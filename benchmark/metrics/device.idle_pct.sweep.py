"""``device.idle_pct.sweep``: the share of the traced piece's unprofiled
wall time in which the card ran nothing: one less the union of the
piece's device intervals under the profiler over the same piece's wall
time run without it (the profiler stretches the host, not the kernels)."""


def read(record):
    wall = record["piece"]["wall_s"]
    return 100.0 * (1.0 - record["trace"]["busy_s"] / wall) if wall > 0 else None
