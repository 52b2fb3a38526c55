"""``sweep.first_chunk_extra_s``: what a call's first chunk costs beyond a
later one (the bucket's warm-ups and captures), from ``run_sweep``'s
``chunk_stats`` of the traced run's one call with ``phase_timing=True``
after the window: the first chunk's ``done_at_s`` less the mean of the
later chunks' intervals.  Read from that call because there each chunk
ends before the next starts; in the window's calls, chunk k+1 is queued
before chunk k is read back, and ``done_at_s`` (when a chunk was read
back, not when its device work ended) puts nearly the whole call on the
first chunk."""


def read(record):
    done = [c["done_at_s"] for c in record["phase_call"]["chunk_stats"]]
    if len(done) < 2:
        return None
    later = [b - a for a, b in zip(done, done[1:])]
    return done[0] - sum(later) / len(later)
