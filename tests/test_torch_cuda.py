"""Tests of the port that need a CUDA card; each skips where there is none.

This file imports no jax, so it also runs on a GPU machine without jax:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: kernel forward rtol 1e-5 and backward atol 1e-5 against the
plain versions (the TPU kernel's tests); a small fit on the card against the
same fit on the CPU at the parity tests' 2e-4.
"""

import numpy as np
import pytest
import torch

import mmtpu_torch.kernels.angular as K


@pytest.fixture
def cuda_device():
    """The first CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on a GPU: python -m pytest --noconftest -m cuda "
                    "tests/test_torch_cuda.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,d,v", [(64, 300, 3016), (37, 300, 3001), (5, 301, 70)])
def test_kernels_match_plain(cuda_device, b, d, v):
    """Both K1 kernels against their plain versions: the train batch's shape,
    a ragged one, and a depth that takes the scalar load path."""
    gen = torch.Generator().manual_seed(0)
    lat = torch.randn(b, d, generator=gen).to(cuda_device)
    vocab = torch.randn(v, d, generator=gen).to(cuda_device)
    g = torch.randn(b, 1, generator=gen).to(cuda_device)
    vn = torch.linalg.vector_norm(vocab, dim=-1)
    before = dict(K.LAUNCHES)
    torch.testing.assert_close(K.angular_fwd(lat, vocab, vn),
                               K.angular_partition_ref(lat, vocab), rtol=1e-5, atol=0)
    torch.testing.assert_close(K.angular_bwd(lat, vocab, vn, g),
                               K.angular_partition_bwd_ref(lat, vocab, vn, g),
                               rtol=0, atol=1e-5)
    assert K.LAUNCHES == {"fwd": before["fwd"] + 1, "bwd": before["bwd"] + 1}


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
    from mmtpu.config import ExperimentConfig
    from mmtpu.data.pipeline import prepare_device_data
    from mmtpu.data.synthetic import synthesize_dataset
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
