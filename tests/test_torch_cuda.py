"""Tests of the port that need a CUDA card; each skips where there is none.

This file imports no jax, so it also runs on a GPU machine without jax:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: K1 forward rtol 1e-5 and backward atol 1e-5, K2 rtol 1e-5 /
atol 1e-5, against the plain versions (the TPU kernels' tests); small fits on
the card against the same fits on the CPU at the parity tests' 2e-4.
"""

import numpy as np
import pytest
import torch

import mmtpu_torch.kernels.angular as K
import mmtpu_torch.kernels.decoder_update as T


@pytest.fixture
def cuda_device():
    """The first CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on a GPU: python -m pytest --noconftest -m cuda "
                    "tests/test_torch_cuda.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,d,v,zero_row", [
    (64, 300, 3016, False), (37, 300, 3001, False), (5, 301, 70, False),
    (64, 301, 3016, False), (33, 512, 100, False), (1, 300, 20, False),
    (512, 300, 3016, False), (2048, 300, 3016, False), (64, 300, 3016, True)])
def test_kernels_match_plain(cuda_device, b, d, v, zero_row):
    """Both K1 kernels against their plain versions: the train batch's shape,
    a ragged one, depths that take the scalar load path (one at full tile
    depth), the largest depth, a vocabulary below one tile with one row, the
    inference batch, a large batch, and a zero latent row (the forward's
    clamped denominator; the backward is held there on the other rows).  A
    second forward call is bit for bit equal to the first."""
    gen = torch.Generator().manual_seed(0)
    lat = torch.randn(b, d, generator=gen).to(cuda_device)
    if zero_row:
        lat[0] = 0.0
    vocab = torch.randn(v, d, generator=gen).to(cuda_device)
    g = torch.randn(b, 1, generator=gen).to(cuda_device)
    vn = torch.linalg.vector_norm(vocab, dim=-1)
    before = dict(K.LAUNCHES)
    z = K.angular_fwd(lat, vocab, vn)
    torch.testing.assert_close(z, K.angular_partition_ref(lat, vocab), rtol=1e-5, atol=0)
    rows = slice(1, None) if zero_row else slice(None)
    torch.testing.assert_close(K.angular_bwd(lat, vocab, vn, g)[rows],
                               K.angular_partition_bwd_ref(lat, vocab, vn, g)[rows],
                               rtol=0, atol=1e-5)
    assert K.LAUNCHES == {"fwd": before["fwd"] + 1, "bwd": before["bwd"] + 1}
    assert torch.equal(z, K.angular_fwd(lat, vocab, vn))


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    lat = torch.randn(8, 16, device=cuda_device)
    vocab = torch.randn(20, 16, device=cuda_device)
    vn = torch.linalg.vector_norm(vocab, dim=-1)
    with pytest.raises(TypeError):
        K.angular_fwd(lat.double(), vocab, vn)
    with pytest.raises(ValueError, match="contiguous"):
        K.angular_fwd(lat.T.contiguous().T, vocab, vn)
    with pytest.raises(ValueError, match="tensors on"):
        K.angular_fwd(lat, vocab.cpu(), vn)
    with pytest.raises(ValueError, match="depth"):
        K.angular_fwd(torch.randn(2, 600, device=cuda_device),
                      torch.randn(3, 600, device=cuda_device), torch.ones(3, device=cuda_device))


@pytest.mark.cuda
def test_small_run_matches_cpu(cuda_device, tmp_path):
    """A small experiment on the card (kernels) against the CPU (plain)."""
    from mmtpu_torch.config import ExperimentConfig
    from mmtpu_torch.data.pipeline import prepare_device_data
    from mmtpu_torch.data.synthetic import synthesize_dataset
    from mmtpu_torch.runner import run_experiment

    ds = synthesize_dataset("mosi", n_train=40, n_valid=10, n_test=12, vocab_size=100,
                            embed_dim=16, audio_dim=6, visual_dim=5)
    prep = prepare_device_data(ds, pos_embed_dim=2)
    cfg = ExperimentConfig(dataset="mosi", n_epochs=2, n_sentiment_epochs=2, batch_size=8,
                           e2e=False, norm="layer_norm", optimizer="adam", lr=1e-3,
                           config_name="card")
    res = {str(dev): run_experiment(cfg, out_root=str(tmp_path / str(dev)), prep=prep,
                                    verbose=False, device=dev)
           for dev in (cuda_device, "cpu")}
    np.testing.assert_allclose(res[str(cuda_device)]["final_train_loss"],
                               res["cpu"]["final_train_loss"], rtol=2e-4)
    emb = [np.load(tmp_path / dev / "card" / "config_0_run_0" / "post" / "embed.npy")
           for dev in res]
    np.testing.assert_allclose(emb[0], emb[1], atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("b,d,f", [(64, 300, 1400), (37, 300, 37), (5, 7, 300),
                                   (512, 300, 1416), (64, 300, 1536), (33, 300, 1401),
                                   (64, 301, 1400)])
@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_k2_matches_plain(cuda_device, kind, b, d, f):
    """K2 against its plain version with flag 1 and flag 0 (w, m, v then come
    back bit for bit): the train batch's shape, the inference batch (several
    batch chunks), the width the TPU code padded to, and ragged ones (F not a
    multiple of 4 and D not a multiple of 4 take the scalar edge paths).  A
    second call is bit for bit equal to the first."""
    gen = torch.Generator().manual_seed(2)
    r = lambda *s: torch.randn(*s, generator=gen).to(cuda_device)
    # every output table far above atol 1e-5, so an error in any element shows
    w, m, v, x, gz = 0.05 * r(d, f), 0.1 * r(d, f), 0.01 * (1.0 + r(d, f).abs()), r(b, d), r(b, f)
    lr = torch.tensor(1e-3, device=cuda_device)
    for on in (1.0, 0.0):
        flag = torch.tensor(on, device=cuda_device)
        before = dict(T.LAUNCHES)
        if kind == "adam":
            args = (w, m, v, x, gz, lr, 0.41, 0.005, flag)
            got, want = T.fused_gemm_adam_update(*args), T.reference_adam(*args)
            tables = (w, m, v)
        else:
            got, want = (T.fused_gemm_sgd_update(w, x, gz, lr, flag),
                         T.reference_sgd(w, x, gz, lr, flag))
            tables = (w,)
        torch.cuda.synchronize()
        assert T.LAUNCHES[kind] == before[kind] + 1
        for g, p, t in zip(got[:-1], want[:-1], tables):
            torch.testing.assert_close(g, p, rtol=1e-5, atol=1e-5)
            if on == 0.0:
                assert torch.equal(g, t)
        torch.testing.assert_close(got[-1], want[-1], rtol=1e-5, atol=1e-5)
        again = (T.fused_gemm_adam_update(*args) if kind == "adam"
                 else T.fused_gemm_sgd_update(w, x, gz, lr, flag))
        assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_k2_scalar_arguments(cuda_device, kind):
    """lr, bc1, bc2 and flag as numbers, as float32 scalars on the card (by
    pointer), as float64 scalars on the card (converted) and as host scalars
    give the same bits, one launch per call."""
    gen = torch.Generator().manual_seed(4)
    r = lambda *s: torch.randn(*s, generator=gen).to(cuda_device)
    w, m, v, x, gz = 0.05 * r(300, 1400), 0.1 * r(300, 1400), 0.01 * (1.0 + r(300, 1400).abs()), \
        r(64, 300), r(64, 1400)
    nums = (1e-3, 0.41, 0.005, 1.0)
    forms = [nums,
             tuple(torch.tensor(a, device=cuda_device) for a in nums),
             tuple(torch.tensor(a, dtype=torch.float64, device=cuda_device) for a in nums),
             tuple(torch.tensor(a) for a in nums)]
    outs = []
    for lr, bc1, bc2, flag in forms:
        before = T.LAUNCHES[kind]
        outs.append(T.fused_gemm_adam_update(w, m, v, x, gz, lr, bc1, bc2, flag)
                    if kind == "adam" else T.fused_gemm_sgd_update(w, x, gz, lr, flag))
        assert T.LAUNCHES[kind] == before + 1
    for out in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(out, outs[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_fused_fit_e2e_matches_cpu(cuda_device, kind):
    """One epoch of the fused e2e fit on the card (K1 and K2) against the
    same fit on the CPU (plain versions)."""
    from mmtpu_torch.config import ExperimentConfig
    from mmtpu_torch.convert import to_torch
    from mmtpu_torch.data.pipeline import prepare_device_data
    from mmtpu_torch.data.synthetic import synthesize_dataset
    from mmtpu_torch.runner import Draws, build_hp
    from mmtpu_torch.train.e2e import E2EFitSpec, fit_e2e
    from mmtpu_torch.train.latents import train_view

    prep = prepare_device_data(synthesize_dataset(
        "mosi", n_train=40, n_valid=10, n_test=12, vocab_size=100, embed_dim=16, audio_dim=6,
        visual_dim=5), pos_embed_dim=2)
    cfg = ExperimentConfig(dataset="mosi", n_epochs=1, batch_size=8, norm="layer_norm",
                           optimizer=kind, lr=1e-3, likelihood_weight=0.3)
    spec = E2EFitSpec(n_epochs_max=1, batch_size=8, unimodal=False, opt_kind=kind,
                      fused_dec_update=True)
    fits = []
    for dev in (cuda_device, torch.device("cpu")):
        draws = Draws(0)
        move = lambda tree: {k: (move(v) if isinstance(v, dict) else v.to(dev))
                             for k, v in tree.items()}
        dec = move(draws.init_decoder(16, prep.audio_dim, prep.visual_dim, False,
                                      prep.text_gauss_dim))
        sen = move(draws.init_e2e_sentiment(16, 8, 1))
        before = T.LAUNCHES[kind]
        fits.append(fit_e2e(to_torch(prep.sif_init["train"], dev), dec, sen,
                            to_torch(train_view(prep.splits["train"]), dev),
                            to_torch(prep.labels["train"], dev),
                            to_torch(prep.vocab_embeddings, dev), build_hp(cfg, dev), spec,
                            perms=draws.train_permutations(40, 1)))
        assert T.LAUNCHES[kind] == before + (2 * 5 if dev.type == "cuda" else 0)
    card, cpu = fits
    np.testing.assert_allclose(card[3].cpu().numpy(), cpu[3].numpy(), rtol=2e-4)
    np.testing.assert_allclose(card[0].cpu().numpy(), cpu[0].numpy(), atol=2e-4)
