"""The per-token word term read by id: each token's dot with its row's
latents, and their latent gradient, in one hand-written CUDA kernel each.

A kernel with no Pallas counterpart: mmtpu leaves this term to XLA, which
fuses the gather of the word vectors into the product.  The CUDA C++ source,
``mmtpu_torch/csrc/token_dots.cu`` (built by
:mod:`mmtpu_torch.kernels.build`), says how the kernels are laid out and
what bounds them on an H100: they read each token's row by id from the
vocabulary, which stays in L2, with no ``(R, L, D)`` block of gathered
vectors in device memory.

- :func:`token_dots_fwd` / :func:`token_dots_bwd` are the wrappers.  For a
  CUDA tensor each launches its kernel (and adds one to :data:`LAUNCHES`) or
  raises; for a CPU tensor each runs the plain twin
  (:func:`mmtpu_torch.ops.wordprob.token_dots_plain` and
  :func:`~mmtpu_torch.ops.wordprob.token_dots_plain_bwd`, blocked ``bmm`` /
  ``baddbmm``).  Nothing falls back from CUDA to the twin.
- Their tile parameters come from :func:`fwd_tiles` / :func:`bwd_tiles`, by
  the shape alone: the latents per row ``M`` (one in a training step, the
  sweep's K configs in its inference fits), the tokens per row and the
  block count against the card's SMs.
"""

from __future__ import annotations

import torch

from mmtpu_torch.graphs import launch_counter
from mmtpu_torch.kernels.build import sm_count
from mmtpu_torch.ops.wordprob import token_dots_plain, token_dots_plain_bwd

# kernel launches by wrapper, added to on each CUDA graph replay
# (mmtpu_torch/graphs.py)
LAUNCHES = launch_counter({"fwd": 0, "bwd": 0})

# threads per block (token_dots.cu's THREADS)
THREADS = 256
# by latents per block MT (token_dots.cu's fwd_tile_m, fwd_tile_tokens,
# bwd_tile_m): each forward thread's latents and tokens and its fewest lanes
# per token (8 lanes read 128 contiguous bytes of a row where each unit
# feeds one dot), each backward thread's latents
_FWD_TILE = {1: (1, 1, 8), 32: (8, 4, 4)}
_BWD_TILE = {1: 1, 32: 8}
# the fewest tokens of a row that a backward token slice takes
_SLICE_TOKENS = 64


def m_tile(m: int) -> int:
    """Latents per block, 1 or 32, for ``m`` latents per row (a block of 32
    masks the latents past ``m``)."""
    return 1 if m == 1 else 32


def fwd_tiles(m: int, n_tok: int, rows: int, sms: int) -> tuple:
    """``(mt, ks_log2, passes)`` of the forward for ``rows`` rows of ``m``
    latents and ``n_tok`` tokens on a card of ``sms`` SMs: the latents per
    block; ``2 ** ks_log2`` lanes per token, more where a row is so short that
    a pass would leave half its tokens idle; and the token passes per block
    (up to 8), which reuse the staged latents while the grid keeps at least
    8 blocks per SM."""
    mt = m_tile(m)
    tm, tt, ks = _FWD_TILE[mt]

    def per_pass(ks):
        return tt * (THREADS // (mt // tm * ks))

    while ks < 32 and per_pass(ks) >= 2 * n_tok:
        ks *= 2
    tiles, m_tiles = -(-n_tok // per_pass(ks)), -(-m // mt)
    passes = 1
    while (passes < 8 and 2 * passes <= tiles
           and rows * m_tiles * -(-tiles // (2 * passes)) >= 8 * sms):
        passes *= 2
    return mt, ks.bit_length() - 1, passes


def bwd_tiles(m: int, units: int, n_tok: int, rows: int, sms: int) -> tuple:
    """``(mt, cw, ts)`` of the backward for ``rows`` rows of ``m`` latents,
    ``units`` depth units and ``n_tok`` tokens on a card of ``sms`` SMs: the
    latents per block; the depth units per block, from the fewest near-equal
    chunks that a block's threads cover, cut finer until token slices (of at
    least 64 tokens each) fill 15/16 of the block, and finer again while the
    grid would leave SMs idle; and the token slices."""
    mt = m_tile(m)
    groups = mt // _BWD_TILE[mt]
    most = max(1, n_tok // _SLICE_TOKENS)
    m_tiles = -(-m // mt)

    def layout(n_ch):
        cw = -(-units // n_ch)
        return cw, min(most, THREADS // (groups * cw))

    n_ch = -(-units // (THREADS // groups))
    cw, ts = layout(n_ch)
    while ts < most and ts * groups * cw < THREADS * 15 // 16 and cw > 8:
        n_ch += 1
        cw, ts = layout(n_ch)
    while rows * m_tiles * n_ch < 2 * sms and cw >= 16:
        n_ch *= 2
        cw, ts = layout(n_ch)
    return mt, cw, ts


def _check(latents_like, vocab, ids, last: int) -> None:
    if latents_like.ndim != 3 or vocab.ndim != 2 or ids.ndim != 2:
        raise ValueError(f"token kernel takes (R, M, .) rows, (V, D) vocab and (R, L) ids, got "
                         f"{tuple(latents_like.shape)}, {tuple(vocab.shape)}, "
                         f"{tuple(ids.shape)}")
    if latents_like.shape[0] != ids.shape[0] or latents_like.shape[2] != last:
        raise ValueError(f"rows {tuple(latents_like.shape)} do not fit ids {tuple(ids.shape)} "
                         f"and vocab {tuple(vocab.shape)}")
    if ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"token kernel takes int32 or int64 ids, got {ids.dtype}")


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"token kernel: unsupported device {t.device}")


def _check_cuda(vocab, rows, ids) -> None:
    for t in (rows, ids):
        if t.device != vocab.device:
            raise ValueError(f"token kernel: tensors on {vocab.device} and {t.device}")
    for t in (vocab, rows):
        if t.dtype != torch.float32:
            raise TypeError(f"token kernel takes float32, got {t.dtype}")
    if not vocab.is_contiguous():
        raise ValueError("token kernel takes a contiguous vocabulary")


def _rows_like(t: torch.Tensor, last: int) -> torch.Tensor:
    """An empty float32 ``(R, M, last)`` tensor whose first two axes lie in
    memory in ``t``'s order (a config axis outside the rows stays outside,
    so the caller's transpose back is a view)."""
    r, m = t.shape[:2]
    if r > 1 and m > 1 and t.stride(0) < t.stride(1):
        return torch.empty(m, r, last, dtype=torch.float32, device=t.device).transpose(0, 1)
    return torch.empty(r, m, last, dtype=torch.float32, device=t.device)


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 and t.stride(0) % 4 == 0 and t.stride(-2) % 4 == 0
               for t in tensors)


def token_dots_fwd(latents: torch.Tensor, vocab: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``(R, M, L)`` dots of the ``(R, M, D)`` latents with ``vocab[ids]``
    (``ids`` ``(R, L)``, each in ``[0, V)``: on the card a device-side
    assert stops the kernel at one outside, as it stops the twin's gather);
    the latents' rows and configs may be strided, and the result keeps their
    order."""
    _check(latents, vocab, ids, vocab.shape[1])
    if _on_cpu(latents):
        return token_dots_plain(latents, vocab, ids)
    from mmtpu_torch.kernels.build import check_launch, load

    _check_cuda(vocab, latents, ids)
    if latents.stride(-1) != 1:
        latents = latents.contiguous()
    ids = ids.contiguous()
    rows, m, d = latents.shape
    n_tok = ids.shape[1]
    out = _rows_like(latents, n_tok)
    if out.numel() == 0 or d == 0:
        return out.zero_()
    dev = latents.device
    mt, ks_log2, passes = fwd_tiles(m, n_tok, rows, sm_count(dev.index))
    lib = load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.token_dots_fwd(
            latents.data_ptr(), latents.stride(0), latents.stride(1), vocab.data_ptr(),
            ids.data_ptr(), ids.dtype == torch.int64, out.data_ptr(), out.stride(0),
            out.stride(1), rows, m, n_tok, d, vocab.shape[0],
            d % 4 == 0 and _aligned(latents, vocab), mt, ks_log2, passes, stream)
    check_launch(lib, "token_dots_fwd", err)
    LAUNCHES["fwd"] += 1
    return out


def token_dots_bwd(g: torch.Tensor, vocab: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The ``(R, M, D)`` latent gradient ``sum_l g[r, m, l] vocab[ids[r, l]]``
    of the dots' cotangent ``g`` ``(R, M, L)``, in ``g``'s order of rows and
    configs."""
    _check(g, vocab, ids, ids.shape[1])
    if _on_cpu(g):
        return token_dots_plain_bwd(g, vocab, ids)
    from mmtpu_torch.kernels.build import check_launch, load

    _check_cuda(vocab, g, ids)
    if g.stride(-1) != 1:
        g = g.contiguous()
    ids = ids.contiguous()
    rows, m, n_tok = g.shape
    d = vocab.shape[1]
    glat = _rows_like(g, d)
    if glat.numel() == 0 or n_tok == 0:
        return glat.zero_()
    dev = g.device
    v4 = d % 4 == 0 and _aligned(vocab)
    mt, cw, ts = bwd_tiles(m, d // 4 if v4 else d, n_tok, rows, sm_count(dev.index))
    lib = load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.token_dots_bwd(
            g.data_ptr(), g.stride(0), g.stride(1), vocab.data_ptr(), ids.data_ptr(),
            ids.dtype == torch.int64, glat.data_ptr(), glat.stride(0), glat.stride(1), rows, m,
            n_tok, d, vocab.shape[0], v4, mt, cw, ts, stream)
    check_launch(lib, "token_dots_bwd", err)
    LAUNCHES["bwd"] += 1
    return glat
