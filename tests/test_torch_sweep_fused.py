"""The fused decoder update under the sweep's config axis, on the CPU.

- ``run_sweep(fused_dec_update=True)`` against mmtpu's on JAX-CPU (mmtpu's
  Pallas kernel in interpret mode under its ``vmap``), on the grid of
  mmtpu's ``tests/test_fused_update.py::test_run_sweep_fused_matches_default``
  (an SGD and an Adam bucket), fed mmtpu's draws; one mmtpu reference, run
  once.  Tolerances: final loss rtol 2e-4 and embeddings atol 2e-4 (the
  parity tests'), metrics rtol/atol 5e-4 (that mmtpu test's).
- The plain versions of K2 (what a CPU tensor gets) with a leading config
  axis against the 2-D ones on each config's slice at rtol 1e-5 (a batched
  product sums in another order than a 2-D one), and a config at flag 0
  passed through bit for bit.
- ``fused_joint_step`` over K = 3 configs against its three single-config
  calls (rtol 1e-5: the same float32 arithmetic with a leading axis).
"""

import numpy as np
import pytest
import torch

from mmtpu.data.pipeline import prepare_device_data as j_prepare
from mmtpu.data.synthetic import synthesize_dataset as j_synthesize
from mmtpu.sweep import run_sweep as j_run_sweep
import mmtpu_torch.kernels.decoder_update as T
from mmtpu_torch.convert import to_torch
from mmtpu_torch.models.decoder import init_decoder, stack_decoder
from mmtpu_torch.models.sentiment import init_sentiment
from mmtpu_torch.sweep.runner import run_sweep
from mmtpu_torch.train.e2e import senti_l1
from mmtpu_torch.train.fused import fused_joint_step
from mmtpu_torch.train.latents import LatentFitSpec, gather_batch, train_view
from mmtpu_torch.train.optim import init_opt_state
from mmtpu_torch.tree import per_config, tree_leaves, tree_map
from tests.test_torch_sweep import JaxSweepDraws, one_torch_thread  # noqa: F401

SEED = 0


def fused_grid():
    """mmtpu's test_run_sweep_fused_matches_default configs."""
    base = {"seq_len": 6, "word_sim_metric": "angular", "freeze_weights": False,
            "n_sentiment_epochs": 4, "e2e": True, "sentiment_lr": 1e-2,
            "word_loss_weight": 0.001, "likelihood_weight": 0.0001,
            "sentiment_hidden_size": 8}
    return [dict(base, lr=1e-3, optimizer="sgd", norm="layer_norm", pos_embed_dim=2,
                 n_epochs=2, config_num=0),
            dict(base, lr=1e-4, optimizer="adam", norm="batch_norm", pos_embed_dim=4,
                 n_epochs=3, config_num=1)]


def test_fused_run_sweep_matches_mmtpu():
    ds = j_synthesize("mosi", n_train=22, n_valid=6, n_test=6, vocab_size=60, embed_dim=12,
                      audio_dim=5, visual_dim=4, seq_len=6)
    prep = j_prepare(ds, pos_mode="shared", pos_dims=(2, 4))
    want = j_run_sweep(fused_grid(), prep, batch_size=8, seed=SEED, verbose=False,
                       fused_dec_update=True, return_embeddings=True)
    got = run_sweep(fused_grid(), prep, batch_size=8, seed=SEED, verbose=False, device="cpu",
                    fused_dec_update=True, return_embeddings=True,
                    draws=lambda num, run: JaxSweepDraws(SEED, num, run))
    assert [c["chunk"] for c in got.chunk_stats] == [c["chunk"] for c in want.chunk_stats]
    assert [r.keys() for r in got.to_records()] == [r.keys() for r in want.to_records()]
    assert np.isfinite(want.final_train_loss).all() and not got.diverged.any()
    np.testing.assert_allclose(got.final_train_loss, want.final_train_loss, rtol=2e-4)
    for m in want.metrics:
        np.testing.assert_allclose(got.metrics[m], want.metrics[m], rtol=5e-4, atol=5e-4,
                                   err_msg=m)
    for s in ("train", "valid", "test"):
        np.testing.assert_allclose(got.embeddings[s], want.embeddings[s], atol=2e-4,
                                   err_msg=s)


@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_batched_plain_k2_equals_2d_on_each_slice(kind):
    """The wrappers on CPU tensors (their plain versions) with a leading
    config axis, per-config lr and flag, against the 2-D call on each
    config's slice; config 1 at flag 0 keeps its tables bit for bit."""
    gen = torch.Generator().manual_seed(5)
    k, b, d, f = 3, 7, 6, 9
    r = lambda *s: torch.randn(*s, generator=gen)
    w, m, v = 0.05 * r(k, d, f), 0.1 * r(k, d, f), 0.01 * (1.0 + r(k, d, f).abs())
    x, gz = r(k, b, d), r(k, b, f)
    lr, flag = torch.tensor([1e-3, 2e-3, 5e-4]), torch.tensor([1.0, 0.0, 1.0])
    bc1, bc2 = torch.tensor([0.19, 0.41, 0.1]), torch.tensor([0.002, 0.005, 0.001])
    if kind == "adam":
        got = T.fused_gemm_adam_update(w, m, v, x, gz, lr, bc1, bc2, flag)
        one = lambda i: T.fused_gemm_adam_update(w[i], m[i], v[i], x[i], gz[i], lr[i], bc1[i],
                                                 bc2[i], flag[i])
        tables = (w, m, v)
    else:
        got = T.fused_gemm_sgd_update(w, x, gz, lr, flag)
        one = lambda i: T.fused_gemm_sgd_update(w[i], x[i], gz[i], lr[i], flag[i])
        tables = (w,)
    assert [g.shape for g in got] == [t.shape for t in tables] + [(k, b, d)]
    for i in range(k):
        for g, s in zip(got, one(i)):
            torch.testing.assert_close(g[i], s, rtol=1e-5, atol=1e-7)
    for g, t in zip(got[:-1], tables):
        assert torch.equal(g[1], t[1]) and not torch.equal(g[0], t[0])
    with pytest.raises(ValueError, match="scalar"):
        T.fused_gemm_sgd_update(w, x, gz, torch.ones(2), flag)
    with pytest.raises(ValueError, match="disagree"):
        T.fused_gemm_sgd_update(w, x[:2], gz, lr, flag)


def _joint_inputs(kind, e2e, k=3, b=6):
    """One fused step's inputs for K configs from the tiny MOSI data: a
    shared batch with one pad row, per-config decoders (stacked), latents,
    lr, norms, word weights, gates and activity; config 2 inactive, config 1
    with frozen heads."""
    from mmtpu_torch.data.pipeline import prepare_device_data
    from mmtpu_torch.data.synthetic import synthesize_dataset

    prep = prepare_device_data(synthesize_dataset(
        "mosi", n_train=12, n_valid=4, n_test=4, vocab_size=30, embed_dim=8, audio_dim=5,
        visual_dim=4, seq_len=5), pos_embed_dim=2)
    gen = torch.Generator().manual_seed(7)
    decs = [stack_decoder(init_decoder(gen, 8, prep.audio_dim, prep.visual_dim,
                                       text_dim=prep.text_gauss_dim))[0] for _ in range(k)]
    dec = tree_map(lambda *xs: torch.stack(xs), *decs)
    d_opt = init_opt_state(dec, kind, k)
    d_opt = d_opt._replace(count=torch.tensor([0, 3, 1], dtype=torch.int32))
    if kind == "adam":  # moments as after a few steps
        d_opt = d_opt._replace(m=tree_map(lambda t: 0.01 * torch.randn(t.shape, generator=gen),
                                          d_opt.m),
                               v=tree_map(lambda t: 1e-4 * torch.rand(t.shape, generator=gen),
                                          d_opt.v))
    data = to_torch(train_view(prep.splits["train"]))
    j = torch.arange(b) % 12
    batch = gather_batch(data, j.expand(k, b))
    inputs = {
        "dec": dec, "d_opt": d_opt, "rows": torch.randn(k, b, 8, generator=gen),
        "b": batch, "vocab": to_torch(prep.vocab_embeddings),
        "hp": {"lr": torch.tensor([1e-3, 1e-2, 1e-3]), "norm_code": torch.tensor([1, 2, 0]),
               "word_loss_weight": torch.tensor([1e-3, 1e-2, 1e-3])},
        "row_valid": torch.tensor([1.0] * (b - 1) + [0.0]),
        "active": torch.tensor([True, True, False]), "heads_gate": torch.tensor([1.0, 0.0, 1.0]),
        "spec": LatentFitSpec(n_epochs_max=1, batch_size=b, train_decoder=True,
                              unimodal=False, opt_kind=kind, fused_dec_update=True),
    }
    if e2e:
        sens = [init_sentiment(gen, 8, 5, 1) for _ in range(k)]
        inputs["sen"] = tree_map(lambda *xs: torch.stack(xs), *sens)
        inputs["y"] = to_torch(prep.labels["train"])[j]
        inputs["lw"] = torch.tensor([0.3, 0.5, 0.9])
    return inputs


def _step(inp, i=None):
    """The fused step over every config (``i`` None) or config ``i`` alone."""
    pick = (lambda t: t) if i is None else (lambda t: t[i])
    tree = lambda t: tree_map(pick, t)
    d_opt = inp["d_opt"]
    d_opt = d_opt._replace(m=None if d_opt.m is None else tree(d_opt.m),
                           v=None if d_opt.v is None else tree(d_opt.v), count=pick(d_opt.count))
    kw = {}
    if "sen" in inp:
        lw, y = pick(inp["lw"]), inp["y"]
        kw = dict(extra_params=tree(inp["sen"]),
                  combine=lambda sp, neg, lat: per_config(lw, neg.ndim) * neg
                  + (1.0 - per_config(lw, neg.ndim)) * senti_l1(sp, lat, y, None))
    active = pick(inp["active"])
    return fused_joint_step(tree(inp["dec"]), d_opt, pick(inp["rows"]), tree(inp["b"]),
                            inp["vocab"], tree(inp["hp"]), inp["spec"], inp["row_valid"],
                            active if i is None else bool(active),
                            heads_gate=pick(inp["heads_gate"]), norm_gate=1.0, **kw)


@pytest.mark.parametrize("e2e", [False, True])
@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_fused_joint_step_over_configs_equals_each_config(kind, e2e):
    """Loss, latent cotangent, the extra term's gradients, the decoder and
    its optimizer state: the K = 3 step against each config's own step.  The
    inactive config and the frozen heads keep their weights bit for bit."""
    inp = _joint_inputs(kind, e2e)
    loss, g_rows, g_extra, dec2, opt2 = _step(inp)
    assert loss.shape == (3,)
    for i in range(3):
        loss_i, g_rows_i, g_extra_i, dec2_i, opt2_i = _step(inp, i)
        pairs = [(loss[i], loss_i), (g_rows[i], g_rows_i), (opt2.count[i], opt2_i.count)]
        pairs += zip([t[i] for t in tree_leaves(dec2)], tree_leaves(dec2_i))
        if kind == "adam":
            pairs += zip([t[i] for t in tree_leaves(opt2.m) + tree_leaves(opt2.v)],
                         tree_leaves(opt2_i.m) + tree_leaves(opt2_i.v))
        if e2e:
            pairs += zip([t[i] for t in tree_leaves(g_extra)], tree_leaves(g_extra_i))
        for a, want in pairs:
            torch.testing.assert_close(a, want, rtol=1e-5, atol=1e-7)
    for key in ("w_mu", "w_log_sigma", "b_mu"):
        for i in (1, 2):  # frozen heads, inactive config
            assert torch.equal(dec2["heads"][key][i], inp["dec"]["heads"][key][i])
        assert not torch.equal(dec2["heads"][key][0], inp["dec"]["heads"][key][0])
    assert torch.equal(dec2["norm"]["scale"][2], inp["dec"]["norm"]["scale"][2])
