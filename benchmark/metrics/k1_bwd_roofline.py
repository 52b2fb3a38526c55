"""``k1_bwd_roofline``: K1's backward (its product kernel and the
partials' reduction) against its roofline in the traced piece, as
``k1_fwd_roofline``."""

from benchmark.flops import k1_bounds


def read(record):
    rows, k1 = record["piece"]["k1_rows"], record["trace"]["k1"]
    if not k1["bwd_n"] or k1["bwd_n"] != len(rows):
        return None
    g = record["geometry"]
    bound_ms = sum(k1_bounds(r, g["embed_dim"], g["vocab_size"])["bwd"][0] for r in rows)
    return 100.0 * bound_ms / 1e3 / k1["bwd_s"]
