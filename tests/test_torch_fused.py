"""The port's kernel K2 (fused decoder update), stacked decoder layout, gated
optimizer and fused latent fit against mmtpu's.

K2's plain versions are held to mmtpu's Pallas kernels (run in interpret mode
on the CPU, as mmtpu's own tests run them) and to mmtpu's plain XLA versions
at rtol 1e-5 / atol 1e-5; ``flag = 0`` must pass w, m, v through bit for
bit.  Whole fits use the repo's tolerances: losses rtol 2e-4, embeddings and
decoder atol 2e-4 (float32 summed in another order over 9 steps).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmtpu.data.pipeline import prepare_device_data
from mmtpu.data.synthetic import synthesize_dataset
from mmtpu.kernels import decoder_update as jk
from mmtpu.models import decoder as jdec
from mmtpu.train import latents as jl
from mmtpu.train import optim as jopt
from mmtpu_torch.convert import to_numpy, to_torch
from mmtpu_torch.kernels import decoder_update as tk
from mmtpu_torch.models import decoder as tdec
from mmtpu_torch.train import latents as tl
from mmtpu_torch.train import optim as topt

TOL = dict(rtol=1e-5, atol=1e-5)


def _k2_inputs(rng, b, d, f):
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"w": r(d, f), "m": 0.1 * r(d, f), "v": np.abs(0.1 * r(d, f)), "x": r(b, d),
            "g_z": r(b, f)}


def _t(a):
    return torch.tensor(np.array(a))


@pytest.mark.parametrize("b,d,f", [(8, 12, 37), (8, 12, 32), (5, 7, 3)])
@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_k2_plain_matches_mmtpu(rng, kind, b, d, f):
    """The port's wrapper on CPU tensors (its plain version) against mmtpu's
    Pallas kernel (interpret mode, F tile 16: F = 37 and 3 are ragged) and
    its XLA reference."""
    a = _k2_inputs(rng, b, d, f)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    if kind == "adam":
        args = (0.01, 0.1, 0.001, 1.0)
        got = tk.fused_gemm_adam_update(*(_t(a[k]) for k in ("w", "m", "v", "x", "g_z")), *args)
        plain = tk.reference_adam(*(_t(a[k]) for k in ("w", "m", "v", "x", "g_z")), *args)
        pallas = jk.fused_gemm_adam_update(j["w"], j["m"], j["v"], j["x"], j["g_z"], *args,
                                           tile=16)
        xla = jk.xla_reference_adam(j["w"], j["m"], j["v"], j["x"], j["g_z"], *args)
    else:
        got = tk.fused_gemm_sgd_update(_t(a["w"]), _t(a["x"]), _t(a["g_z"]), 0.05, 1.0)
        plain = tk.reference_sgd(_t(a["w"]), _t(a["x"]), _t(a["g_z"]), 0.05, 1.0)
        pallas = jk.fused_gemm_sgd_update(j["w"], j["x"], j["g_z"], 0.05, 1.0, tile=16)
        xla = jk.xla_reference_sgd(j["w"], j["x"], j["g_z"], 0.05, 1.0)
    assert len(got) == len(pallas) == (4 if kind == "adam" else 2)
    for g, p, want_p, want_x in zip(got, plain, pallas, xla):
        assert g.shape == tuple(want_p.shape)
        np.testing.assert_array_equal(g.numpy(), p.numpy())
        np.testing.assert_allclose(g.numpy(), np.asarray(want_p), **TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(want_x), **TOL)


@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_k2_flag_zero_passes_through(rng, kind):
    """flag 0: w, m, v come back bit for bit; g_x is still g_z w^T."""
    a = {k: _t(v) for k, v in _k2_inputs(rng, 4, 6, 19).items()}
    if kind == "adam":
        out = tk.fused_gemm_adam_update(a["w"], a["m"], a["v"], a["x"], a["g_z"],
                                        torch.tensor(0.5), 0.1, 0.001, torch.tensor(0.0))
        tables = (a["w"], a["m"], a["v"])
    else:
        out = tk.fused_gemm_sgd_update(a["w"], a["x"], a["g_z"], 0.5, 0.0)
        tables = (a["w"],)
    for got, want in zip(out[:-1], tables):
        assert torch.equal(got, want)
    np.testing.assert_allclose(out[-1].numpy(), (a["g_z"] @ a["w"].T).numpy(), **TOL)


@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_k2_zero_pad_columns_stay_zero(rng, kind):
    """Pad columns of a stacked table (zero w, m, v; zero cotangent) stay
    exactly zero through a step."""
    a = {k: _t(v) for k, v in _k2_inputs(rng, 6, 5, 12).items()}
    for k in ("w", "m", "v"):
        a[k][:, 9:] = 0.0
    a["g_z"][:, 9:] = 0.0
    if kind == "adam":
        out = tk.fused_gemm_adam_update(a["w"], a["m"], a["v"], a["x"], a["g_z"], 1e-2,
                                        0.1, 0.001, 1.0)[:3]
    else:
        out = tk.fused_gemm_sgd_update(a["w"], a["x"], a["g_z"], 1e-2, 1.0)[:1]
    for t in out:
        assert torch.count_nonzero(t[:, 9:]) == 0
        assert torch.count_nonzero(t[:, :9]) > 0


@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_k2_scalar_arguments_give_the_same_result(rng, kind):
    """lr, bc1, bc2 and flag as numbers, as 0-d float32 tensors and as 0-d
    tensors of other dtypes (float64, and an int flag) give the same plain
    result bit for bit; on the card each travels to the kernel by value or
    by its device pointer (tests/test_torch_cuda.py)."""
    a = {k: _t(v) for k, v in _k2_inputs(rng, 6, 5, 13).items()}
    nums = (0.01, 0.1, 0.001, 1)
    forms = [nums, tuple(torch.tensor(float(n)) for n in nums),
             tuple(torch.tensor(float(n), dtype=torch.float64) for n in nums[:3])
             + (torch.tensor(1),)]
    outs = []
    for lr, bc1, bc2, flag in forms:
        outs.append(tk.fused_gemm_adam_update(a["w"], a["m"], a["v"], a["x"], a["g_z"], lr, bc1,
                                              bc2, flag) if kind == "adam"
                    else tk.fused_gemm_sgd_update(a["w"], a["x"], a["g_z"], lr, flag))
    for out in outs[1:]:
        assert all(torch.equal(p, q) for p, q in zip(out, outs[0]))


def test_k2_scalars_on_the_host_travel_by_value():
    """A number or a host tensor goes to the kernel by value, with no device
    pointer and nothing to keep alive; a scalar must have one element."""
    dev = torch.device("cpu")
    assert tk._scalar(0.5, dev) == (None, 0.5, None)
    assert tk._scalar(torch.tensor(2.5, dtype=torch.float64), dev) == (None, 2.5, None)
    assert tk._scalar(torch.tensor([3]), dev) == (None, 3.0, None)
    with pytest.raises(ValueError, match="scalar"):
        tk._scalar(torch.zeros(2), dev)


def test_k2_wrappers_reject_what_the_kernel_does_not_take():
    w, x, gz = torch.zeros(4, 6), torch.zeros(3, 4), torch.zeros(3, 6)
    with pytest.raises(ValueError, match="disagree"):
        tk.fused_gemm_sgd_update(w, x, torch.zeros(3, 5), 0.1, 1.0)
    with pytest.raises(ValueError, match="moment shape"):
        tk.fused_gemm_adam_update(w, torch.zeros(4, 5), w, x, gz, 0.1, 0.1, 0.1, 1.0)
    with pytest.raises(ValueError, match="non-empty"):
        tk.fused_gemm_sgd_update(torch.zeros(4, 0), x, torch.zeros(3, 0), 0.1, 1.0)
    with pytest.raises(ValueError, match="unsupported device"):
        tk.fused_gemm_sgd_update(w.to("meta"), x.to("meta"), gz.to("meta"), 0.1, 1.0)
    with pytest.raises(ValueError, match="tensors on"):
        tk.fused_gemm_sgd_update(w, x.to("meta"), gz, 0.1, 1.0)


@pytest.mark.parametrize("unimodal,pad_to", [(False, 0), (False, 16), (True, 7)])
def test_stack_decoder_matches_mmtpu(rng, unimodal, pad_to):
    """stack_decoder (padded or not) equals mmtpu's, its forward equals the
    per-head forward, and unstack_decoder round-trips."""
    dec = jdec.init_decoder(jax.random.key(2), 6, 4, 3, unimodal=unimodal, text_dim=5)
    want, order = jdec.stack_decoder(dec, pad_to=pad_to)
    got, t_order = tdec.stack_decoder(to_torch(dec), pad_to=pad_to)
    assert t_order == order and tdec.is_stacked(got) and not tdec.is_stacked(to_torch(dec))
    jax.tree.map(lambda g, w: np.testing.assert_array_equal(g, np.asarray(w)),
                 to_numpy(got), want)
    lat = torch.tensor(rng.standard_normal((5, 6)).astype(np.float32))
    mu, sigma = tdec.apply_decoder_stacked(got, lat, tdec.NORM_LAYER)
    per_head = tdec.apply_decoder(to_torch(dec), lat, tdec.NORM_LAYER)
    widths = [(h, per_head[h]["mu"].shape[-1]) for h in order]
    ofs = 0
    for h, f in widths:
        torch.testing.assert_close(mu[:, ofs:ofs + f], per_head[h]["mu"], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(sigma[:, ofs:ofs + f], per_head[h]["sigma"], rtol=1e-6,
                                   atol=1e-6)
        ofs += f
    assert mu.shape[-1] == ofs + ((-ofs) % pad_to if pad_to else 0)
    back = tdec.unstack_decoder(got, widths)
    jax.tree.map(lambda g, w: np.testing.assert_array_equal(g, np.asarray(w)),
                 to_numpy(back), dec)


@pytest.mark.parametrize("kind", ["sgd", "adam"])
@pytest.mark.parametrize("active", [True, False])
def test_opt_update_gates_match_mmtpu(rng, kind, active):
    """Per-leaf gates: a gate-0 leaf keeps its parameter and its moments;
    the count advances with ``active`` alone."""
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "n": {"s": rng.standard_normal(4).astype(np.float32),
                    "t": rng.standard_normal(2).astype(np.float32)}}
    grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
    gates = {"a": 1.0, "n": {"s": 0.0, "t": 1.0}}
    j_params = jax.tree.map(jnp.asarray, params)
    state = jopt.init_opt_state(j_params, kind)
    if kind == "adam":  # nonzero moments, so a frozen leaf's moments must not decay
        state = jopt.OptState(m=jax.tree.map(lambda p: 0.3 * p, j_params),
                              v=jax.tree.map(lambda p: p * p, j_params), count=jnp.int32(4))
    want = jopt.opt_update(j_params, jax.tree.map(jnp.asarray, grads), state, 0.01,
                           jopt.OPT_CODES[kind], jnp.asarray(active), kind=kind,
                           gates=jax.tree.map(jnp.float32, gates))
    t_gates = {"a": torch.tensor(1.0), "n": {"s": 0.0, "t": torch.tensor(1.0)}}
    got = topt.opt_update(to_torch(params), to_torch(grads), to_torch(state), 0.01, None,
                          torch.tensor(active), kind=kind, gates=t_gates)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-7),
                 to_numpy(got[0]), want[0])
    assert int(got[1].count) == int(want[1].count)
    if kind == "adam":
        for t_tree, j_tree in ((got[1].m, want[1].m), (got[1].v, want[1].v)):
            jax.tree.map(lambda g, w: np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6,
                                                                 atol=1e-7),
                         to_numpy(t_tree), j_tree)
        np.testing.assert_array_equal(got[1].m["n"]["s"].numpy(), np.asarray(state.m["n"]["s"]))
    np.testing.assert_array_equal(got[0]["n"]["s"].numpy(), params["n"]["s"])


def _prep(rng, pos_embed_dim):
    ds = synthesize_dataset("mosi", n_train=22, n_valid=6, n_test=6, vocab_size=60,
                            embed_dim=16, audio_dim=7, visual_dim=5, seq_len=6,
                            seed=int(rng.integers(1e6)))
    return prepare_device_data(ds, pos_embed_dim=pos_embed_dim)


def _jax_perms(key, n, n_epochs):
    perms = []
    for _ in range(n_epochs):
        key, sub = jax.random.split(key)
        perms.append(np.array(jax.random.permutation(sub, n)))
    return perms


def _fit_both(prep, kind, norm, n_epochs=3, extra_hp=None, layout="fused_dec_update"):
    dec = jdec.init_decoder(jax.random.key(3), prep.embed_dim, prep.audio_dim, prep.visual_dim,
                            unimodal=False)
    hp = {"lr": 5e-3, "word_loss_weight": 0.002, "opt_code": jopt.OPT_CODES[kind],
          "norm_code": jdec.NORM_CODES[norm], "n_epochs": n_epochs, **(extra_hp or {})}
    j_hp = {k: jnp.asarray(v, jnp.int32 if isinstance(v, int) else jnp.float32)
            for k, v in hp.items()}
    t_hp = {k: (v if isinstance(v, int) else torch.tensor(v)) for k, v in hp.items()}
    args = dict(n_epochs_max=n_epochs, batch_size=8, train_decoder=True, unimodal=False,
                opt_kind=kind, **{layout: True})
    key = jax.random.key(0)
    data = {k: jnp.asarray(v) for k, v in prep.splits["train"].items()}
    init = prep.sif_init["train"]
    want = jax.jit(lambda: jl.fit_latents(key, jnp.asarray(init), dec, data,
                                          jnp.asarray(prep.vocab_embeddings), j_hp,
                                          jl.LatentFitSpec(**args)))()
    got = tl.fit_latents(torch.tensor(init), to_torch(dec),
                         tl.train_view(to_torch(prep.splits["train"])),
                         torch.tensor(prep.vocab_embeddings), t_hp, tl.LatentFitSpec(**args),
                         perms=_jax_perms(key, init.shape[0], n_epochs))
    return dec, want, got


@pytest.mark.parametrize("kind,norm,pos", [("adam", "layer_norm", 2), ("sgd", "batch_norm", 0),
                                           ("adam", None, 2)])
def test_fused_fit_latents_matches_mmtpu(rng, kind, norm, pos):
    """The port's fused latent fit against mmtpu's fused fit (its kernel in
    interpret mode), same draws."""
    _, want, got = _fit_both(_prep(rng, pos), kind, norm)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=2e-4)
    assert not tdec.is_stacked(got[1])
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=2e-4),
                 to_numpy(got[1]), want[1])


@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_stacked_fit_latents_matches_mmtpu(rng, kind):
    """stacked_heads alone: the stacked layout with autograd's update, and the
    train_dec gate on the non-fused path (1: trains)."""
    _, want, got = _fit_both(_prep(rng, 2), kind, "layer_norm", layout="stacked_heads",
                             extra_hp={"train_dec": 1.0})
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=2e-4)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=2e-4),
                 to_numpy(got[1]), want[1])


def test_fused_fit_latents_train_dec_gate(rng):
    """hp["train_dec"] = 0 freezes the whole decoder (heads and norm) bit for
    bit while the latents still move, as in mmtpu."""
    prep = _prep(rng, 2)
    dec, want, got = _fit_both(prep, "adam", "layer_norm", n_epochs=2,
                               extra_hp={"train_dec": 0.0})
    jax.tree.map(lambda g, w: np.testing.assert_array_equal(g, np.asarray(w)),
                 to_numpy(got[1]), dec)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=2e-4)
    assert not np.allclose(got[0].numpy(), prep.sif_init["train"])
