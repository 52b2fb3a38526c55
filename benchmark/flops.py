"""The yardstick's arithmetic: the card's published peaks, the least time a
call could take, K1's operations and bytes, and the matmul FLOPs that a sweep
call needs, all counted from shapes.

The peaks are one NVIDIA H100 SXM's at its 700 W limit, dense, from NVIDIA's
data sheet: 67 TFLOP/s in float32 outside the tensor cores (the port runs
float32 with TF32 off) and 3.35 TB/s of HBM.

K1's bound counts each input read once and each output written once, and
its operations as the algorithm needs them: the forward one (B, D) x (D, V)
product, the backward two (the cosines again and the gradient's product).
The step's FLOPs count matrix products only (elementwise work is left out),
over the rows and tokens that the data holds, pads left out.
"""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def bound_ms(ops: float, nbytes: float) -> tuple:
    """The least time the card could take, in ms: the larger of operations
    over the float32 peak and bytes over the memory rate; and which one."""
    t_ops, t_bytes = ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k1_bounds(rows: int, depth: int, vocab: int) -> dict:
    """K1's bound per call at ``rows`` latents of ``depth`` against a
    ``vocab``-row table: ``{"fwd": (ms, basis), "bwd": (ms, basis)}``."""
    fwd_bytes = 4 * (rows * depth + vocab * depth + vocab + rows)
    return {"fwd": bound_ms(2 * rows * vocab * depth, fwd_bytes),
            "bwd": bound_ms(4 * rows * vocab * depth, fwd_bytes + 4 * rows * depth)}


def head_width(geometry: dict, pos_dim: int) -> int:
    """The summed output width of MMB2's six Gaussian heads (text, audio
    and visual streams; the config's positional channels on each audio and
    visual segment)."""
    t = geometry["embed_dim"]
    a = geometry["audio_dim"] + pos_dim
    v = geometry["visual_dim"] + pos_dim
    return 3 * t + 4 * a + 4 * v


def latent_step_flops(rows: int, tokens: int, geometry: dict, pos_dim: int,
                      train_decoder: bool) -> float:
    """Matmul FLOPs of one step of a latent fit over ``rows`` valid rows
    holding ``tokens`` valid tokens: the partition's product forward and
    its latent gradient, the per-token dots forward and backward, and the
    heads' two products per head forward, with the input gradient and,
    where the decoder trains, the weight gradient."""
    d, v = geometry["embed_dim"], geometry["vocab_size"]
    partition = 2 * 2 * rows * v * d
    token = 2 * 2 * tokens * d
    heads = 2 * rows * d * 2 * head_width(geometry, pos_dim)
    return float(partition + token + heads * (3 if train_decoder else 2))


def sentiment_flops(rows: int, depth: int, hidden: int, n_out: int, backward: bool,
                    input_grad: bool = False) -> float:
    """The MLP's products over ``rows``: forward, and with ``backward`` the
    weight gradients of both layers and the hidden layer's input gradient
    (and with ``input_grad`` the latents' gradient, as in the joint fit)."""
    fwd = 2 * rows * (depth * hidden + hidden * n_out)
    if not backward:
        return float(fwd)
    extra = 2 * rows * depth * hidden if input_grad else 0
    return float(fwd + 2 * rows * (depth * hidden + 2 * hidden * n_out) + extra)


def config_flops(config: dict, geometry: dict, tokens: dict, valid_every: int = 10) -> float:
    """Matmul FLOPs that one grid config of an e2e sweep needs: the joint
    fit (the e2e sentiment head's products with each step), the valid and
    test inference fits (decoder frozen), the sentiment fit (the valid
    split scored every ``valid_every`` epochs) and the test predictions.
    Every product is linear in the rows, so the batch sizes do not enter.

    ``tokens[split]`` lists each row's valid tokens, in row order."""
    d, n_out = geometry["embed_dim"], geometry["n_out"]
    h, p = int(config["sentiment_hidden_size"]), int(config.get("pos_embed_dim", 0))
    epochs, s_epochs = int(config["n_epochs"]), int(config["n_sentiment_epochs"])
    n = {s: len(tokens[s]) for s in ("train", "valid", "test")}
    tok = {s: sum(tokens[s]) for s in tokens}
    # every row and token is in exactly one minibatch of an epoch, and the
    # step's products are linear in them
    train = (latent_step_flops(n["train"], tok["train"], geometry, p, True)
             + sentiment_flops(n["train"], d, h, n_out, True, input_grad=True)) * epochs
    infer = sum(latent_step_flops(n[s], tok[s], geometry, p, False)
                for s in ("valid", "test")) * epochs
    sent = sentiment_flops(n["train"], d, h, n_out, True) * s_epochs
    sent += sentiment_flops(n["valid"], d, h, n_out, False) * -(-s_epochs // valid_every)
    return float(train + infer + sent + sentiment_flops(n["test"], d, h, n_out, False))


def k1_calls(n_rows: dict, configs: int, batch_size: int, epochs: int,
             infer_mult: int = 8) -> list:
    """The rows of each K1 call of one sweep chunk of ``configs`` configs
    run ``epochs`` epochs (each call is one forward and one backward): the
    training steps at ``configs * batch_size`` rows, the valid and test
    inference steps at ``configs * batch_size * infer_mult``.  A call's
    rows are the rows K1 is handed, pads included."""
    per_epoch = [configs * batch_size] * -(-n_rows["train"] // batch_size)
    big = batch_size * infer_mult
    for s in ("valid", "test"):
        per_epoch += [configs * big] * -(-n_rows[s] // big)
    return per_epoch * epochs
