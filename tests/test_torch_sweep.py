"""The port's sweep chunk against mmtpu's sweep: ``mmtpu_torch.sweep.pack``
against ``mmtpu.sweep.pack`` bit for bit, and ``run_chunk`` against
``mmtpu.sweep.run_sweep(..., return_embeddings=True)`` on JAX-CPU, fed the
draws mmtpu makes from its keys, for an e2e lazy-Adam chunk and an e2e SGD
chunk (a non-e2e dense-Adam chunk and a POM chunk:
tests/test_torch_sweep_kinds.py, a file of its own so that the two files'
mmtpu references run on two test workers).  Each chunk mixes norms,
positional dims and hidden sizes.  The lazy-Adam chunk mixes epoch counts
too: mmtpu buckets them into separate programs, which is exact
(tests/test_sweep.py), so its result stands for one chunk.  The other
chunks keep one epoch count, since each bucket is one more mmtpu program
to compile (about half a minute here); the port's epoch masks are held to
its single-config fits for every kind in tests/test_torch_sweep_mech.py.
Each mmtpu reference runs once.

Tolerances: final loss rtol 2e-4; embeddings and metrics atol 2e-4 (the
whole-run tests'; float32 summed in another order).  The
port's own mechanisms (the chunk against its configs run alone, isolation,
padding, options): tests/test_torch_sweep_mech.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

import mmtpu.sweep.pack as jpack
from mmtpu.data.pipeline import prepare_device_data
from mmtpu.data.synthetic import synthesize_dataset
from mmtpu.models.decoder import init_decoder as j_init_decoder
from mmtpu.models.sentiment import init_sentiment as j_init_sentiment
from mmtpu.sweep import run_sweep
import mmtpu_torch.kernels.angular as K
import mmtpu_torch.sweep.pack as tpack
from mmtpu_torch.convert import to_torch
from mmtpu_torch.sweep.runner import metric_schema, run_chunk
from tests.test_torch_runner import _perms

SEED = 0
BATCH = 8
N_TRAIN, N_VALID, N_TEST = 24, 8, 10


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side at these tiny shapes on one intra-op thread: with the
    suite's workers sharing the cores, torch's thread pool only waits; the
    setting is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def tiny_prep(name="mosi", pos_dims=(2, 4), suff_stats=True):
    """mmtpu's tests/test_sweep.py data: shared positional table, tiny shapes."""
    ds = synthesize_dataset(name, n_train=N_TRAIN, n_valid=N_VALID, n_test=N_TEST,
                            vocab_size=50, embed_dim=12, audio_dim=5, visual_dim=4)
    return prepare_device_data(ds, pos_mode="shared", pos_dims=pos_dims, suff_stats=suff_stats)


def grid(optimizer, e2e=True, k=4, n_epochs=(2, 3, 3, 2)):
    """K configs of one optimizer mixing norms, positional dims, hidden
    sizes and epoch counts (mmtpu's tests/test_sweep.py::_grid4)."""
    rows = [(1e-3, "layer_norm", 2, 8), (1e-4, "batch_norm", 4, 12),
            (1e-3, "layer_norm", 2, 12), (1e-4, "batch_norm", 4, 8)]
    return [dict(seq_len=20, word_sim_metric="angular", freeze_weights=False,
                 n_sentiment_epochs=3, e2e=e2e, lr=lr, optimizer=optimizer, norm=norm,
                 pos_embed_dim=pos, sentiment_hidden_size=hid, n_epochs=ne,
                 sentiment_lr=1e-2, word_loss_weight=0.001, likelihood_weight=0.0001,
                 config_num=i)
            for i, ((lr, norm, pos, hid), ne) in enumerate(zip(rows[:k], n_epochs))]


class JaxSweepDraws:
    """One config's draws in ``mmtpu.sweep.run_sweep``: keys folded from the
    run's three roots by ``config_num * 1024 + run_idx``
    (mmtpu/sweep/runner.py:519-520, 672-686); the train and the sentiment
    fits both draw their permutations from the run key (runner.py:321-329)."""

    def __init__(self, seed, config_num, run_idx=0):
        dec_root, sent_root, run_root = jax.random.split(jax.random.key(seed), 3)
        uid = config_num * 1024 + run_idx
        self.k_dec, self.k_sent, self.k_run = (jax.random.fold_in(r, uid)
                                               for r in (dec_root, sent_root, run_root))

    def init_decoder(self, embed_dim, audio_dim, visual_dim, unimodal, text_dim):
        return to_torch(j_init_decoder(self.k_dec, embed_dim, audio_dim, visual_dim,
                                       unimodal=unimodal, text_dim=text_dim))

    def init_sentiment(self, embed_dim, hidden_dim, n_out, hidden_pad):
        return to_torch(j_init_sentiment(self.k_sent, embed_dim, hidden_dim, n_out,
                                         hidden_pad=hidden_pad))

    def train_permutations(self, n, n_epochs):
        return [torch.as_tensor(p) for p in _perms(self.k_run, n, n_epochs)]

    sentiment_permutations = train_permutations


def jax_draws(configs):
    return [JaxSweepDraws(SEED, c["config_num"]) for c in configs]


CASES = {
    "e2e_lazy_adam": dict(configs=grid("adam"), lazy_adam=True),
    "e2e_sgd": dict(configs=grid("sgd", k=3, n_epochs=(2, 2, 2)), lazy_adam=True),
}


@pytest.fixture(scope="module")
def prep():
    return tiny_prep()


def check_case(case: dict, prep):
    """One chunk: the port's ``run_chunk`` against mmtpu's ``run_sweep``."""
    want = run_sweep(case["configs"], prep, batch_size=BATCH, seed=SEED, verbose=False,
                     return_embeddings=True, lazy_adam=case["lazy_adam"])
    got = run_chunk(case["configs"], prep, batch_size=BATCH, lazy_adam=case["lazy_adam"],
                    return_embeddings=True, device="cpu", draws=jax_draws(case["configs"]))
    assert got.n_configs == want.n_configs == len(case["configs"])
    np.testing.assert_array_equal(got.config_nums, want.config_nums)
    assert np.isfinite(want.final_train_loss).all() and not got.diverged.any()
    np.testing.assert_allclose(got.final_train_loss, want.final_train_loss, rtol=2e-4)
    for split in ("train", "valid", "test"):
        np.testing.assert_allclose(got.embeddings[split], want.embeddings[split], atol=2e-4,
                                   err_msg=split)
    schema = metric_schema(prep)
    assert set(got.metrics) == set(want.metrics) == set(schema)
    for name, shape in schema.items():
        assert got.metrics[name].shape == (got.n_configs, *shape)
        np.testing.assert_allclose(got.metrics[name], want.metrics[name], atol=2e-4,
                                   err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_chunk_matches_mmtpu_sweep(case, prep):
    check_case(CASES[case], prep)


def test_k1_once_per_step_for_the_chunk(prep, monkeypatch):
    """On the CPU wrapper path: one K1 forward and one backward per step for
    the whole chunk, each over K*B rows (K*8B in the inference fits)."""
    rows = {"fwd": [], "bwd": []}
    fwd, bwd = K.angular_fwd, K.angular_bwd

    def count_fwd(lat, *a):
        rows["fwd"].append(lat.shape[0])
        return fwd(lat, *a)

    def count_bwd(lat, *a):
        rows["bwd"].append(lat.shape[0])
        return bwd(lat, *a)

    monkeypatch.setattr(K, "angular_fwd", count_fwd)
    monkeypatch.setattr(K, "angular_bwd", count_bwd)
    configs = grid("adam")
    run_chunk(configs, prep, batch_size=BATCH, device="cpu",
              draws=jax_draws(configs))
    k, epochs = len(configs), max(c["n_epochs"] for c in configs)
    train = [k * BATCH] * (epochs * -(-N_TRAIN // BATCH))
    infer = [k * 8 * BATCH] * (2 * epochs)  # valid and test: one batch per epoch
    assert rows["fwd"] == rows["bwd"] == train + infer


def test_pack_matches_mmtpu():
    """Statics and packed arrays bit for bit (mmtpu's test_pack_shapes
    cases), and the port's codes are mmtpu's."""
    from mmtpu.models.decoder import NORM_CODES
    from mmtpu.train.optim import OPT_CODES

    assert tpack.NORM_CODES == NORM_CODES and tpack.OPT_CODES == OPT_CODES
    cfgs = grid("sgd") + [dict(grid("adam")[1], optimizer="adam", freeze_weights=True,
                               config_num=9, _run_idx=2, pos_embed_dim=0)]
    for batch_size, unimodal in ((8, False), (64, True)):
        want = jpack.statics_from_configs(cfgs, batch_size=batch_size, unimodal=unimodal)
        got = tpack.statics_from_configs(cfgs, batch_size=batch_size, unimodal=unimodal)
        for f in dataclasses.fields(got):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
        assert (got.pos_dims, got.pos_max, got.hidden_max, got.n_epochs_max) == ((2, 4), 6, 12, 3)
        hp_w, hp_g = jpack.pack_configs(cfgs, want), tpack.pack_configs(cfgs, got)
        assert hp_g.keys() == hp_w.keys()
        for key in hp_w:
            assert hp_g[key].dtype == hp_w[key].dtype, key
            np.testing.assert_array_equal(hp_g[key], hp_w[key], err_msg=key)
    np.testing.assert_array_equal(hp_g["pos_mask"][0], [1, 1, 0, 0, 0, 0])
    np.testing.assert_array_equal(hp_g["pos_mask"][1], [0, 0, 1, 1, 1, 1])
    np.testing.assert_array_equal(hp_g["pos_mask"][4], 0)


def test_mixed_modes_rejected_as_mmtpu():
    cfgs = grid("sgd")
    cfgs[0]["e2e"] = False
    for pack in (jpack, tpack):
        with pytest.raises(ValueError):
            pack.statics_from_configs(cfgs)
