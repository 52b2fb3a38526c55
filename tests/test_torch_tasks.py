"""The port on mmtpu's other tasks at long token rows: the per-token word term
read by id (``mmtpu_torch.ops.wordprob.token_dots``) against mmtpu's
gathered form at 1280-token rows, angular and ``dot_prod``; sweep chunks of
POM at long rows, IEMOCAP (e2e SGD) and ``dot_prod`` (e2e Adam) against
``mmtpu.sweep.run_sweep`` on the same draws; and the sweep's width-halving
retry (mmtpu's ``run_sweep`` reruns the sweep at half the chunk width when a
chunk fails on the device) with an injected ``torch.cuda.OutOfMemoryError``.

Tolerances: the per-token term rtol / atol 1e-5, values and the gradient
with respect to the latents (the largest differences seen: values 2.4e-4
on sums near 1.1e3, 2.2e-7 relative; gradients 1.9e-5 on entries up to 34,
5.5e-7 relative, ``dot_prod`` under the config axis; the block size moves
no bit); the
chunks as tests/test_torch_sweep.py's (final loss rtol 2e-4, embeddings
and metrics atol 2e-4); the retry bit for bit against the sweep run at the
narrower width from the start.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mmtpu.ops.wordprob as jwp
from mmtpu.data.pipeline import prepare_device_data
from mmtpu.data.synthetic import synthesize_dataset
import mmtpu_torch.graphs as graphs_mod
import mmtpu_torch.ops.wordprob as twp
import mmtpu_torch.sweep.runner as srunner
from mmtpu_torch.train.latents import train_view
from tests.test_torch_sweep import BATCH, check_case, grid, one_torch_thread, tiny_prep  # noqa: F401

LONG = 1280  # mmtpu's tests/test_sweep.py::test_pom_sweep_real_token_length


def _token_inputs(k=None, b=5, length=LONG, v=60, d=12):
    """Latents ``(B, D)`` (``(K, B, D)`` with ``k``), a unit-norm
    vocabulary, ids with a zero-padded tail per row, weights and the mask."""
    rng = np.random.default_rng(0)
    vocab = rng.standard_normal((v, d)).astype(np.float32)
    vocab /= np.linalg.norm(vocab, axis=-1, keepdims=True)
    lat = (rng.standard_normal((b, d) if k is None else (k, b, d)) * 0.7).astype(np.float32)
    ids = rng.integers(1, v, size=(b, length)).astype(np.int32)
    lengths = rng.integers(length // 3, length + 1, size=b)
    mask = (np.arange(length)[None, :] < lengths[:, None]).astype(np.float32)
    ids = ids * mask.astype(np.int32)
    ww = (rng.random((b, length)) * 0.9 + 0.05).astype(np.float32)
    cot = rng.standard_normal(lat.shape[:-1]).astype(np.float32)  # the cotangent
    return lat, vocab, ids, ww, mask, cot


@pytest.mark.parametrize("layout", ["one_block", "blocks", "config_axis"])
@pytest.mark.parametrize("metric", ["angular", "dot_prod"])
def test_token_term_matches_mmtpu_at_long_rows(metric, layout, monkeypatch):
    """The word log-likelihood with its tokens read by id, in one block, in
    97-token blocks (the last ragged) and under a config axis (``(K, B, D)``
    latents against ``(B, L)`` ids, gathered once for the K configs, each
    config held to mmtpu alone), against
    mmtpu's function on the gathered ``(B, L, D)`` vectors: values and
    ``d(sum(cot * out)) / d latents``."""
    k = 3 if layout == "config_axis" else None
    lat, vocab, ids, ww, mask, cot = _token_inputs(k)
    if layout != "one_block":
        monkeypatch.setattr(twp, "TOKEN_BLOCK_ELEMS", lat.shape[-2] * 12 * 97)
    port = {"angular": twp.word_logprob_angular, "dot_prod": twp.word_logprob_dot_prod}[metric]
    ref = {"angular": jwp.word_logprob_angular, "dot_prod": jwp.word_logprob_dot_prod}[metric]

    lat_t = torch.tensor(lat, requires_grad=True)
    got = port(lat_t, torch.tensor(vocab), torch.tensor(ww), None, torch.tensor(mask),
               text_ids=torch.tensor(ids))
    (got * torch.tensor(cot)).sum().backward()

    sent = jnp.asarray(vocab[ids])
    args = (jnp.asarray(vocab), jnp.asarray(ww), sent, jnp.asarray(mask))
    fn = lambda lt: ref(lt, *args)  # noqa: E731
    for i in range(k or 1):
        lat_i = lat if k is None else lat[i]
        cot_i = cot if k is None else cot[i]
        want = np.asarray(fn(jnp.asarray(lat_i)))
        want_g = np.asarray(jax.grad(lambda lt: jnp.sum(fn(lt) * cot_i))(jnp.asarray(lat_i)))
        got_i = got.detach().numpy() if k is None else got.detach().numpy()[i]
        grad_i = lat_t.grad.numpy() if k is None else lat_t.grad.numpy()[i]
        np.testing.assert_allclose(got_i, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(grad_i, want_g, rtol=1e-5, atol=1e-5)


def test_token_dots_keeps_no_gathered_rows_and_refuses_a_trained_vocabulary(monkeypatch):
    """``token_dots`` saves the vocabulary and the ids for its backward,
    nothing ``(R, L, D)``; each gathered block holds at most
    ``TOKEN_BLOCK_ELEMS`` elements; a vocabulary that requires grad is
    refused (its gradient is not computed)."""
    lat, vocab, ids, *_ = _token_inputs()
    monkeypatch.setattr(twp, "TOKEN_BLOCK_ELEMS", lat.shape[0] * 12 * 100)
    blocks = []
    index = torch.Tensor.__getitem__

    def watch(t, idx):
        out = index(t, idx)
        if isinstance(idx, torch.Tensor) and out.ndim == 3:  # a block of word vectors
            blocks.append(tuple(out.shape))
        return out

    saved = []
    lat_t = torch.tensor(lat, requires_grad=True)
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t.shape) or t,
                                                  lambda t: t):
        monkeypatch.setattr(torch.Tensor, "__getitem__", watch)
        dots = twp.token_dots(lat_t, torch.tensor(vocab), torch.tensor(ids))
        dots.sum().backward()
        monkeypatch.undo()
    assert dots.shape == (5, LONG)
    assert all(len(s) < 3 for s in saved), saved
    assert blocks and all(b * t * d <= 5 * 12 * 100 for b, t, d in blocks), blocks
    assert len(blocks) == 2 * -(-LONG // 100)  # each block gathered once each way
    with pytest.raises(ValueError, match="vocabulary"):
        twp.token_dots(lat_t, torch.tensor(vocab, requires_grad=True), torch.tensor(ids))


@pytest.mark.parametrize("rows,m,n_tok,units", [
    (2048, 1, 1357, 75), (203, 32, 1357, 75), (100, 32, 1357, 75), (2048, 1, 20, 75),
    (512, 32, 20, 75), (64, 1, 1357, 75), (3, 3, 50, 3), (2, 40, 5, 301), (5, 8, 4, 1000)])
def test_token_kernel_tiles_cover_each_output_once(rows, m, n_tok, units):
    """The token kernels' tile parameters, picked by the shape alone, fit a
    block of ``THREADS`` threads and, laid out as ``token_dots.cu`` lays out
    its threads, give each dot of a row (forward) and each depth unit of a
    latent's gradient (backward) to exactly one thread's tile."""
    import mmtpu_torch.kernels.token_dots as TD

    mt, ks_log2, passes = TD.fwd_tiles(m, n_tok, rows, 132)
    tm, tt, _ = TD._FWD_TILE[mt]
    groups = mt // tm
    assert groups << ks_log2 <= TD.THREADS and 1 <= passes <= 8
    per_pass = tt * (TD.THREADS // (groups << ks_log2))
    tiles = -(-n_tok // (per_pass * passes))
    tok = [(b * passes + p) * per_pass + t * tt + j for b in range(tiles) for p in range(passes)
           for t in range(per_pass // tt) for j in range(tt)]
    assert sorted(x for x in tok if x < n_tok) == list(range(n_tok))
    lat = [z * mt + i * groups + q for z in range(-(-m // mt)) for q in range(groups)
           for i in range(tm)]
    assert sorted(x for x in lat if x < m) == list(range(m))

    mt, cw, ts = TD.bwd_tiles(m, units, n_tok, rows, 132)
    assert 1 <= ts <= max(1, n_tok // 64) and ts * (mt // TD._BWD_TILE[mt]) * cw <= TD.THREADS
    cols = [y * cw + c for y in range(-(-units // cw)) for c in range(min(cw, units - y * cw))]
    assert sorted(cols) == list(range(units))


def test_token_wrappers_run_the_twin_on_the_cpu():
    """On the CPU the token wrappers are the plain twins, bit for bit, and
    launch nothing; shapes and types they do not take raise."""
    import mmtpu_torch.kernels.token_dots as TD

    lat, vocab, ids, *_ = _token_inputs(k=3, length=40)
    lat, vocab, ids = torch.tensor(lat).transpose(0, 1), torch.tensor(vocab), torch.tensor(ids)
    g = torch.randn(5, 3, 40, generator=torch.Generator().manual_seed(1))
    before = dict(TD.LAUNCHES)
    assert torch.equal(TD.token_dots_fwd(lat, vocab, ids), twp.token_dots_plain(lat, vocab, ids))
    assert torch.equal(TD.token_dots_bwd(g, vocab, ids), twp.token_dots_plain_bwd(g, vocab, ids))
    assert TD.LAUNCHES == before
    with pytest.raises(ValueError, match="rows"):
        TD.token_dots_fwd(lat[:4], vocab, ids)
    with pytest.raises(ValueError, match="takes"):
        TD.token_dots_fwd(lat[0], vocab, ids)
    with pytest.raises(TypeError, match="ids"):
        TD.token_dots_bwd(g, vocab, ids.float())


def _long_pom_prep():
    """mmtpu's ``test_pom_sweep_real_token_length`` data: POM at 1280-token rows."""
    ds = synthesize_dataset("pom", n_train=16, n_valid=6, n_test=8, vocab_size=60,
                            embed_dim=12, audio_dim=5, visual_dim=4, text_len=LONG)
    return prepare_device_data(ds, pos_mode="shared", pos_dims=(2, 4))


def test_pom_chunk_at_real_token_length_matches_mmtpu(monkeypatch):
    """The port's counterpart of mmtpu's ``test_pom_sweep_real_token_length``:
    int32 ids of 1280 tokens, nothing ``(N, L, D)``-shaped in the per-step
    data, and a two-config POM chunk (17 traits), its tokens read in
    100-token blocks, against ``mmtpu.sweep.run_sweep`` on the same draws."""
    prep = _long_pom_prep()
    tr = prep.splits["train"]
    assert tr["text_ids"].shape == (16, LONG) and tr["text_ids"].dtype == np.int32
    for name, v in train_view(tr).items():
        assert v.ndim < 3 or v.shape[1] != LONG, (name, v.shape)
    monkeypatch.setattr(twp, "TOKEN_BLOCK_ELEMS", 2 * BATCH * 8 * 12 * 100)
    check_case(dict(configs=grid("adam", k=2, n_epochs=(2, 2)), lazy_adam=True), prep)


def _dot_prod_prep():
    ds = synthesize_dataset("mosi", n_train=24, n_valid=8, n_test=10, vocab_size=50,
                            embed_dim=12, audio_dim=5, visual_dim=4)
    return prepare_device_data(ds, word_sim_metric="dot_prod", pos_mode="shared",
                               pos_dims=(2, 4))


@pytest.mark.parametrize("case", ["iemocap_e2e_sgd", "dot_prod_e2e_adam"])
def test_chunk_of_another_task_matches_mmtpu(case):
    """An IEMOCAP e2e SGD chunk (2-class one-hot labels, accuracy and F1) and
    a MOSI e2e Adam chunk under the ``dot_prod`` word metric, against
    ``mmtpu.sweep.run_sweep``."""
    if case == "iemocap_e2e_sgd":
        check_case(dict(configs=grid("sgd", k=3, n_epochs=(2, 2, 2)), lazy_adam=True),
                   tiny_prep("iemocap"))
    else:
        configs = [dict(c, word_sim_metric="dot_prod") for c in grid("adam", k=3,
                                                                     n_epochs=(2, 2, 2))]
        check_case(dict(configs=configs, lazy_adam=True), _dot_prod_prep())


def _failing_above(monkeypatch, width: int, where: str) -> list:
    """Makes every chunk wider than ``width`` fail as the card would: an
    out-of-memory error while it is queued, while its results are read back,
    or as the cause of a failed capture.  Returns the widths tried."""
    tried = []
    queue_chunk = srunner._queue_chunk

    def failing(configs, *args, **kw):
        tried.append(len(configs))
        finish = queue_chunk(configs, *args, **kw)
        if len(configs) <= width:
            return finish
        oom = torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")
        if where == "queue":
            raise oom
        if where == "capture":
            raise graphs_mod.GraphCaptureError("capturing 'epoch' failed") from oom

        def fail():
            raise oom
        return fail

    monkeypatch.setattr(srunner, "_queue_chunk", failing)
    return tried


def _sweep(configs, prep, **kw):
    return srunner.run_sweep(configs, prep, batch_size=BATCH, device="cpu",
                             return_embeddings=True, **kw)


def _assert_same(got, want):
    np.testing.assert_array_equal(got.config_nums, want.config_nums)
    np.testing.assert_array_equal(got.run_idxs, want.run_idxs)
    np.testing.assert_array_equal(got.final_train_loss, want.final_train_loss)
    assert set(got.metrics) == set(want.metrics)
    for name in want.metrics:
        np.testing.assert_array_equal(got.metrics[name], want.metrics[name], err_msg=name)
    for split in want.embeddings:
        np.testing.assert_array_equal(got.embeddings[split], want.embeddings[split])


@pytest.fixture(scope="module")
def retry_prep():
    return tiny_prep()


@pytest.mark.parametrize("where", ["queue", "finish", "capture"])
def test_sweep_retries_at_half_width_on_out_of_memory(where, retry_prep, monkeypatch, capsys):
    """Chunks of 4 fail (out of memory): the sweep reruns whole at width 2,
    says so as mmtpu does, and equals the sweep run at width 2 bit for bit;
    ``n_runs`` is not applied twice; an earlier chunk saved at width 4 is
    abandoned (the checkpoint state keys on the width).  The result names
    the width it ran at and the width that ran out of memory."""
    configs = grid("adam", k=2, n_epochs=(2, 2))
    want = _sweep(configs, retry_prep, chunk_size=2, n_runs=2, verbose=False)
    tried = _failing_above(monkeypatch, 2, where)
    got = _sweep(configs, retry_prep, chunk_size=4, n_runs=2, verbose=True)
    out = capsys.readouterr().out
    assert "[sweep] chunk width 4 failed on device — retrying the sweep at width 2" in out
    assert tried == [4, 2, 2]
    assert [s["configs"] for s in got.chunk_stats] == [2, 2]
    assert got.n_configs == 4
    assert (got.chunk_size, got.out_of_memory_widths) == (2, [4])
    assert (want.chunk_size, want.out_of_memory_widths) == (2, [])
    _assert_same(got, want)


def test_sweep_retry_halves_down_to_width_2_then_raises(retry_prep, monkeypatch, capsys):
    """Every width fails: 4, then 2, where the error is raised (mmtpu
    re-raises at width 2 or less); an error that is not the device's memory
    is raised at once."""
    configs = grid("adam", k=4, n_epochs=(2, 2, 2, 2))
    tried = _failing_above(monkeypatch, 0, "queue")
    with pytest.raises(torch.cuda.OutOfMemoryError):
        _sweep(configs, retry_prep, chunk_size=4, verbose=True)
    assert tried == [4, 2]
    assert capsys.readouterr().out.count("failed on device") == 1

    def broken(*args, **kw):
        raise graphs_mod.GraphCaptureError("capturing 'epoch' failed: a host read")

    monkeypatch.setattr(srunner, "_queue_chunk", broken)
    with pytest.raises(graphs_mod.GraphCaptureError):
        _sweep(configs, retry_prep, chunk_size=4, verbose=True)
    assert "failed on device" not in capsys.readouterr().out


def test_sweep_retry_abandons_chunks_saved_at_the_old_width(retry_prep, monkeypatch,
                                                            tmp_path):
    """Three buckets (2, 3 and 4 epochs) in chunks of width 4: the first
    chunk is saved, the third fails; the rerun at width 2 finds the state of
    width 4 stale, computes every chunk again and leaves the state of width
    2, and its result is the width-2 sweep's bit for bit."""
    import json

    configs = grid("adam", k=4, n_epochs=(2, 3, 4, 4))
    want = _sweep(configs, retry_prep, chunk_size=2, verbose=False)
    queue_chunk = srunner._queue_chunk
    calls = []

    def third_fails(configs, *args, **kw):
        calls.append(len(configs))
        if len(calls) == 3:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")
        return queue_chunk(configs, *args, **kw)

    monkeypatch.setattr(srunner, "_queue_chunk", third_fails)
    got = _sweep(configs, retry_prep, chunk_size=4, verbose=False,
                 checkpoint_dir=str(tmp_path))
    assert calls == [1, 1, 2, 1, 1, 2]
    with open(tmp_path / "sweep_state.json") as f:
        state = json.load(f)
    assert state["chunk"] == 2 and len(state["chunks"]) == 3
    assert (got.chunk_size, got.out_of_memory_widths) == (2, [4])
    _assert_same(got, want)
