"""``sweep.first_chunk_extra_device_s``: what a call's first chunk costs
beyond a later one, from the window's own pipelined calls: per call, the
first chunk's ``device_end_at_s`` (the stream's end of its metrics phase,
seconds from the call's start, from ``run_sweep``'s ``chunk_stats``) less
the mean of the later chunks' intervals between those ends; the median
over the calls.  Nothing where the program records no such end."""

import statistics


def read(record):
    extra = []
    for call in record["calls"]:
        ends = [c.get("device_end_at_s") for c in call["chunk_stats"]]
        if len(ends) < 2 or None in ends:
            return None
        later = [b - a for a, b in zip(ends, ends[1:])]
        extra.append(ends[0] - sum(later) / len(later))
    return statistics.median(extra) if extra else None
