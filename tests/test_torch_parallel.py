"""The port's mesh fits and sharded ops over real ``torch.distributed``
worlds on the CPU (gloo), against mmtpu's mesh fits on the conftest's
8-device CPU mesh and against the port's single-process fits.

Two worlds run as subprocesses (tests/_torch_parallel_worker.py, which
imports torch and mmtpu_torch only), one spawn per world size for all of
its cases: four ranks for the (2, 2) mesh, two for (2, 1) and (1, 2).  The
inputs are mmtpu's tiny mesh-test data (tests/test_parallel.py::_inputs:
24 utterances, vocab 64, embed 16, audio 6, visual 5, batch 8) with the
decoder and the permutations that JAX draws.

Tolerances: mmtpu's mesh tests' (loss rtol 2e-4 / atol 1e-5, embeddings,
decoder and sentiment MLP rtol 2e-3 / atol 2e-5: float32 in another order,
over 9 optimizer steps); one step's vocab-sharded latent gradient against
the single-process one rtol 1e-5 / atol 1e-6 (the sums of the shards only
reorder a float32 sum: a gradient counted once per shard would be off by a
factor).  Every rank returns the same results, bit for bit.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

from mmtpu.data.pipeline import prepare_device_data
from mmtpu.data.synthetic import synthesize_dataset
from mmtpu.models.decoder import NORM_CODES, init_decoder
from mmtpu.models.sentiment import init_sentiment
from mmtpu.ops.gaussian import gaussian_logpdf_masked as j_gauss
from mmtpu.parallel import fit_e2e_mesh as j_fit_e2e_mesh
from mmtpu.parallel import fit_latents_mesh as j_fit_latents_mesh
from mmtpu.parallel import make_fit_mesh as j_make_fit_mesh
from mmtpu.parallel import sharded_angular_partition as j_sharded_z
from mmtpu.parallel import sharded_gaussian_logpdf as j_sharded_gauss
from mmtpu.train.e2e import E2EFitSpec as JE2ESpec
from mmtpu.train.latents import LatentFitSpec as JSpec
from mmtpu.train.latents import train_view as j_train_view
from mmtpu.train.optim import OPT_CODES
from mmtpu_torch.convert import to_numpy, to_torch
from mmtpu_torch.ops.gaussian import gaussian_logpdf_masked
from mmtpu_torch.ops.wordprob import angular_partition
from mmtpu_torch.parallel.mesh import init_world, make_mesh
from mmtpu_torch.train import e2e as te2e
from mmtpu_torch.train import latents as tl
from tests.test_torch_runner import REPO, _perms

WORKER = os.path.join(REPO, "tests", "_torch_parallel_worker.py")
SPAWN_TIMEOUT_S = 120
LOSS = dict(rtol=2e-4, atol=1e-5)
PARAMS = dict(rtol=2e-3, atol=2e-5)
GRAD = dict(rtol=1e-5, atol=1e-6)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_world(n: int, cases: list, tmp) -> tuple:
    """Start a gloo world of ``n`` worker processes (torchrun's environment,
    a free port) on ``cases``; :func:`finish_world` waits for it."""
    path = os.path.join(tmp, "cases.pt")
    torch.save(cases, path)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), WORLD_SIZE=str(n))
    procs = [subprocess.Popen([sys.executable, WORKER, path, str(tmp)], cwd=str(tmp),
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    return procs, cases, tmp


def finish_world(world) -> dict:
    """Wait (at most ``SPAWN_TIMEOUT_S``) for a world of :func:`start_world`;
    returns ``{case: [rank 0's out, rank 1's, ...]}``."""
    procs, cases, tmp = world
    try:
        logs = [p.communicate(timeout=SPAWN_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"rank failed:\n{log[-4000:]}"
    return {c["name"]: [torch.load(os.path.join(tmp, f"{c['name']}_rank{r}.pt"),
                                   weights_only=False) for r in range(len(procs))]
            for c in cases}


@pytest.fixture
def world_of_one():
    """A gloo process group of this one process, ended after the test."""
    init_world("cpu")
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()


def _inputs(vocab_size=64, norm="batch_norm", opt="adam", batch_size=8, seed=0):
    """tests/test_parallel.py::_inputs, as numpy, with its JAX draws."""
    ds = synthesize_dataset("mosi", n_train=24, n_valid=8, n_test=8, vocab_size=vocab_size,
                            embed_dim=16, audio_dim=6, visual_dim=5)
    prep = prepare_device_data(ds, pos_embed_dim=0)
    dec = init_decoder(jax.random.key(3), prep.embed_dim, prep.audio_dim, prep.visual_dim,
                       unimodal=False)
    hp = {"lr": 1e-3, "word_loss_weight": 0.001, "opt_code": OPT_CODES[opt],
          "norm_code": NORM_CODES[norm], "n_epochs": 3}
    return {"data": {k: np.asarray(v) for k, v in j_train_view(prep.splits["train"]).items()},
            "vocab": np.asarray(prep.vocab_embeddings), "init": np.asarray(prep.sif_init["train"]),
            "dec": to_numpy(to_torch(dec)), "hp": hp, "key": seed,
            "perms": _perms(jax.random.key(seed), 24, 3), "batch_size": batch_size}


def _j_hp(hp):
    return {k: jnp.asarray(v, jnp.int32 if isinstance(v, int) else jnp.float32)
            for k, v in hp.items()}


def _t_hp(hp):
    return {k: (v if isinstance(v, int) else torch.tensor(v)) for k, v in hp.items()}


# name: (world, mesh, op, input kwargs, spec extras)
FITS = {
    "bn_dense_adam_22": (4, (2, 2), "latents", {}, {}),
    "lazy_adam_22": (4, (2, 2), "latents", {"norm": "layer_norm"},
                     {"opt_kind": "adam", "lazy_adam": True}),
    "indivisible_22": (4, (2, 2), "latents", {"vocab_size": 63, "batch_size": 7}, {}),
    "e2e_mask_bn_22": (4, (2, 2), "e2e", {"seed": 4}, {}),
    "sgd_sparse_21": (2, (2, 1), "latents", {"opt": "sgd", "seed": 2}, {"opt_kind": "sgd"}),
    "adam_permuted_21": (2, (2, 1), "latents", {"seed": 5}, {"opt_kind": "adam"}),
    "bn_vocab_12": (2, (1, 2), "latents", {"seed": 1}, {}),
    "dot_prod_vocab_12": (2, (1, 2), "latents", {"norm": "layer_norm", "seed": 6},
                          {"word_metric": "dot_prod", "opt_kind": "sgd"}),
}


def _fit_case(name):
    world, mesh, op, kw, extra = FITS[name]
    inp = _inputs(**kw)
    spec = dict(n_epochs_max=3, batch_size=inp["batch_size"], unimodal=False, **extra)
    case = dict(name=name, world=world, mesh=mesh, op=op, **{k: inp[k] for k in (
        "data", "vocab", "init", "dec", "hp", "perms", "key")})
    if op == "e2e":
        n = inp["init"].shape[0]
        case.update(hp=dict(inp["hp"], likelihood_weight=1e-4), spec=spec,
                    senti=to_numpy(to_torch(init_sentiment(jax.random.key(9), 16, 6, 1))),
                    labels=np.random.default_rng(7).standard_normal(n).astype(np.float32),
                    mask=(np.arange(n) % 3 != 0).astype(np.float32))
    else:
        case.update(spec=dict(spec, train_decoder=True))
    return case


def _ops_case(name, world, mesh):
    rng = np.random.default_rng(world)
    b, d, v, l, f = 6, 16, 64, 8, 5
    return dict(name=name, world=world, mesh=mesh, op="ops",
                lat=rng.standard_normal((b, d)).astype(np.float32),
                vocab=rng.standard_normal((v, d)).astype(np.float32),
                w=rng.standard_normal((b, 1)).astype(np.float32),
                mu=rng.standard_normal((b, f)).astype(np.float32),
                sigma=(rng.random((b, f)) + 0.5).astype(np.float32),
                values=rng.standard_normal((b, l, f)).astype(np.float32),
                mask=(rng.random((b, l, f)) < 0.8).astype(np.float32))


def _step_case(name, world, mesh):
    inp = _inputs(norm="batch_norm", seed=world)
    j = inp["perms"][0][:8]
    valid = np.ones(8, np.float32)
    valid[-2:] = 0.0  # the padded tail of a last batch
    rng = np.random.default_rng(3)
    return dict(name=name, world=world, mesh=mesh, op="step", vocab=inp["vocab"],
                dec=inp["dec"], hp=inp["hp"], valid=valid,
                lat=(inp["init"][j] + 0.3 * rng.standard_normal((8, 16))).astype(np.float32),
                data={k: v[j] for k, v in inp["data"].items()})


def _cases(world):
    cases = [_fit_case(n) for n, c in FITS.items() if c[0] == world]
    mesh = (2, 2) if world == 4 else (1, 2)
    tag = f"{mesh[0]}{mesh[1]}"
    return cases + [_ops_case(f"ops_{tag}", world, mesh), _step_case(f"step_{tag}", world, mesh)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds' outputs ``{case: [per rank]}``, the cases, and mmtpu's
    results on them, computed while the worlds run."""
    cases = {w: _cases(w) for w in (2, 4)}
    running = [start_world(w, cs, tmp_path_factory.mktemp(f"world{w}"))
               for w, cs in cases.items()]
    by_name = {c["name"]: c for cs in cases.values() for c in cs}
    refs = {name: (_j_mesh_fit(c) if c["op"] in ("latents", "e2e") else _j_ops(c))
            for name, c in by_name.items() if c["op"] != "step"}
    out = {}
    for world in running:
        out.update(finish_world(world))
    return out, by_name, refs


def _same_on_every_rank(outs):
    for other in outs[1:]:
        jax.tree.map(np.testing.assert_array_equal, outs[0], other)


def _j_mesh_fit(case):
    mesh = j_make_fit_mesh(*case["mesh"])
    d = {k: jnp.asarray(v) for k, v in case["data"].items()}
    dec = jax.tree.map(jnp.asarray, case["dec"])
    rng = jax.random.key(case["key"])
    if case["op"] == "e2e":
        return j_fit_e2e_mesh(mesh, rng, jnp.asarray(case["init"]), dec,
                              jax.tree.map(jnp.asarray, case["senti"]), d,
                              jnp.asarray(case["labels"]), jnp.asarray(case["vocab"]),
                              _j_hp(case["hp"]), JE2ESpec(**case["spec"]),
                              jnp.asarray(case["mask"]))
    return j_fit_latents_mesh(mesh, rng, jnp.asarray(case["init"]), dec, d,
                              jnp.asarray(case["vocab"]), _j_hp(case["hp"]),
                              JSpec(**case["spec"]))


def _j_ops(case):
    """mmtpu's sharded ops on the case's mesh: Z and the latent gradient of
    ``sum(Z * w) + sum(lat^2)``; the sequence-sharded Gaussian and the
    gradients of its row-weighted sum."""
    lat, vocab, w = (jnp.asarray(case[k]) for k in ("lat", "vocab", "w"))
    jmesh = j_make_fit_mesh(*case["mesh"])
    z_fn = jax.jit(lambda x: j_sharded_z(x, vocab, jmesh))
    g_fn = jax.jit(jax.grad(lambda x: jnp.sum(j_sharded_z(x, vocab, jmesh) * w)
                            + jnp.sum(x * x)))
    mu, sigma, values, mask = (jnp.asarray(case[k]) for k in ("mu", "sigma", "values", "mask"))
    seq = JMesh(np.array(jax.devices()[:jmesh.devices.size]), ("seq",))
    scale = jnp.arange(1.0, mu.shape[0] + 1)
    lp_fn = jax.jit(lambda m, s: j_sharded_gauss(m, s, values, mask, seq))
    glp_fn = jax.jit(jax.grad(lambda m, s: jnp.sum(lp_fn(m, s) * scale), argnums=(0, 1)))
    g_mu, g_sigma = glp_fn(mu, sigma)
    return {k: np.asarray(v) for k, v in dict(
        z=z_fn(lat), g_lat=g_fn(lat), lp=lp_fn(mu, sigma), g_mu=g_mu, g_sigma=g_sigma,
        lp_single=j_gauss(mu, sigma, values, mask)).items()}


def _t_single_fit(case):
    args = (torch.tensor(case["init"]), to_torch(case["dec"]))
    data, vocab, hp = to_torch(case["data"]), torch.tensor(case["vocab"]), _t_hp(case["hp"])
    if case["op"] == "e2e":
        return te2e.fit_e2e(*args, to_torch(case["senti"]), data, torch.tensor(case["labels"]),
                            vocab, hp, te2e.E2EFitSpec(**case["spec"]),
                            senti_mask=torch.tensor(case["mask"]), perms=case["perms"])
    return tl.fit_latents(*args, data, vocab, hp, tl.LatentFitSpec(**case["spec"]),
                          perms=case["perms"])


def _assert_fit(got, want, e2e):
    """``got`` (the port's mesh fit, numpy) against a fit tuple ``want``."""
    losses = want[3] if e2e else want[2]
    assert np.isfinite(got["losses"]).all() and np.isfinite(got["embed"]).all()
    np.testing.assert_allclose(got["losses"], np.asarray(losses), **LOSS)
    np.testing.assert_allclose(got["embed"], np.asarray(want[0]), **PARAMS)
    trees = [(got["dec"], want[1])] + ([(got["senti"], want[2])] if e2e else [])
    for g, w in trees:  # to_numpy takes the port's tensors and mmtpu's arrays
        jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, **PARAMS), g, to_numpy(w))


@pytest.mark.parametrize("name", list(FITS))
def test_mesh_fit_matches_mmtpu_and_single_process(worlds, name):
    """The port's mesh fit on every rank equals mmtpu's mesh fit of the same
    shape and the port's single-process fit: batch norm over the global
    batch, the sparse SGD and permuted and lazy Adam paths, degrading axes,
    the e2e fit with a semi-supervised mask, and the dot-product word
    likelihood's partition over vocabulary shards."""
    outs, cases, refs = worlds
    case = cases[name]
    _same_on_every_rank(outs[name])
    got, e2e = outs[name][0], case["op"] == "e2e"
    _assert_fit(got, refs[name], e2e)
    _assert_fit(got, _t_single_fit(case), e2e)


@pytest.mark.parametrize("tag", ["12", "22"])
def test_sharded_ops_match_mmtpu_and_single_process(worlds, tag):
    """``sharded_angular_partition`` (values and the latent gradient of a
    loss that adds a replicated term to Z, so that an n_v-fold count of
    either part shows) and ``sharded_gaussian_logpdf`` over the sequence
    axis, against mmtpu's sharded ops and the single-process ops."""
    outs, cases, refs = worlds
    case, got, want = cases[f"ops_{tag}"], outs[f"ops_{tag}"], refs[f"ops_{tag}"]
    _same_on_every_rank(got)
    got = got[0]
    for k in ("z", "g_lat", "g_mu", "g_sigma"):
        np.testing.assert_allclose(got[k], want[k], **GRAD, err_msg=k)
    np.testing.assert_allclose(got["lp"], want["lp"], rtol=1e-5)
    np.testing.assert_allclose(got["lp"], want["lp_single"], rtol=1e-5)

    t_lat = torch.tensor(case["lat"], requires_grad=True)
    z = angular_partition(t_lat, torch.tensor(case["vocab"]))
    (g,) = torch.autograd.grad(torch.sum(z * torch.tensor(case["w"])) + torch.sum(t_lat ** 2),
                               t_lat)
    np.testing.assert_allclose(got["z"], z.detach().numpy(), **GRAD)
    np.testing.assert_allclose(got["g_lat"], g.numpy(), **GRAD)
    t_mu = torch.tensor(case["mu"], requires_grad=True)
    t_sig = torch.tensor(case["sigma"], requires_grad=True)
    lp = gaussian_logpdf_masked(t_mu, t_sig, torch.tensor(case["values"]),
                                torch.tensor(case["mask"]))
    g_mu, g_sig = torch.autograd.grad(torch.sum(lp * torch.arange(1.0, lp.shape[0] + 1)),
                                      [t_mu, t_sig])
    np.testing.assert_allclose(got["lp"], lp.detach().numpy(), rtol=1e-5)
    np.testing.assert_allclose(got["g_mu"], g_mu.numpy(), **GRAD)
    np.testing.assert_allclose(got["g_sigma"], g_sig.numpy(), **GRAD)


@pytest.mark.parametrize("tag", ["12", "22"])
def test_vocab_sharded_step_gradient_equals_single_process(worlds, tag):
    """One step of the joint loss (heads, sentence score, Z) on the (1, 2)
    and (2, 2) meshes: the batch's latent gradient, assembled from each
    rank's rows, equals the single-process gradient; no part of it is
    counted once per vocabulary shard."""
    outs, cases, _ = worlds
    case, got = cases[f"step_{tag}"], outs[f"step_{tag}"]
    _same_on_every_rank(got)
    lat = torch.tensor(case["lat"], requires_grad=True)
    spec = tl.LatentFitSpec(n_epochs_max=1, batch_size=8, train_decoder=True, unimodal=False)
    loss = tl.batch_neg_log_prob(lat, to_torch(case["dec"]), to_torch(case["data"]),
                                 torch.tensor(case["vocab"]), _t_hp(case["hp"]), spec,
                                 torch.tensor(case["valid"]))
    (g,) = torch.autograd.grad(loss, lat)
    np.testing.assert_allclose(got[0]["loss"], loss.detach().numpy(), rtol=1e-6)
    np.testing.assert_allclose(got[0]["g_lat"], g.numpy(), **GRAD)
    assert np.abs(got[0]["g_lat"][-2:]).max() == 0.0  # padded rows take no gradient


def test_world_of_one_mesh_fit_is_the_plain_fit(world_of_one):
    """A (1, 1) mesh runs the sharded code path (its collectives over
    groups of one rank) and ends on the single-process fit bit for bit."""
    from mmtpu_torch.parallel.fit import fit_latents_mesh, make_fit_mesh

    case = _fit_case("bn_dense_adam_22")
    got = fit_latents_mesh(make_fit_mesh(1, 1), torch.tensor(case["init"]),
                           to_torch(case["dec"]), to_torch(case["data"]),
                           torch.tensor(case["vocab"]), _t_hp(case["hp"]),
                           tl.LatentFitSpec(**case["spec"]), perms=case["perms"])
    want = _t_single_fit(case)
    for a, b in zip(got, want):
        jax.tree.map(np.testing.assert_array_equal, to_numpy(a), to_numpy(b))


def test_mesh_refusals_as_mmtpu(world_of_one):
    """The fused decoder update is per-shard (mmtpu/train/fused.py:81), a
    batch axis needs its mesh, and the sweep shards a "config" axis."""
    from mmtpu_torch.parallel.fit import make_fit_mesh
    from mmtpu_torch.sweep.runner import _check_mesh

    mesh = make_fit_mesh(1, 1)
    spec = tl.LatentFitSpec(n_epochs_max=1, batch_size=4, train_decoder=True, unimodal=False,
                            opt_kind="sgd", batch_shard_axis="data")
    args = (torch.zeros(4, 3), {}, {}, torch.zeros(5, 3), {"norm_code": 1})
    with pytest.raises(ValueError, match="needs the mesh"):
        tl.fit_latents(*args, spec)
    with pytest.raises(ValueError, match="per-shard"):
        tl.fit_latents(*args, tl.dataclasses.replace(spec, fused_dec_update=True), mesh=mesh)
    with pytest.raises(ValueError, match="'config' axis"):
        _check_mesh(mesh)
    assert make_mesh().axis_names == ("config",)
