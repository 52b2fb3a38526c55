"""``k1_fwd_roofline``: K1's forward against its roofline in the traced
piece: the sum of each call's bound (``benchmark.flops.k1_bounds`` at the
call's rows) over the kernel's device time by name.  Nothing is read
where the trace's kernels do not match the piece's calls one for one."""

from benchmark.flops import k1_bounds


def read(record):
    rows, k1 = record["piece"]["k1_rows"], record["trace"]["k1"]
    if not k1["fwd_n"] or k1["fwd_n"] != len(rows):
        return None
    g = record["geometry"]
    bound_ms = sum(k1_bounds(r, g["embed_dim"], g["vocab_size"])["fwd"][0] for r in rows)
    return 100.0 * bound_ms / 1e3 / k1["fwd_s"]
