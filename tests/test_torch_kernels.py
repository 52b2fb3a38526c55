"""Kernel K1 (angular partition) of the port against mmtpu's.

On the CPU the wrappers compute their plain PyTorch versions, so these tests
hold the plain forward, the explicit backward formula and the autograd
function around them to mmtpu's XLA function and to its Pallas kernel in
interpret mode (forward rtol 1e-5, gradient atol 1e-5, the tolerances of
tests/test_kernels.py).  The CUDA kernels themselves are compared with the
plain versions on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mmtpu_torch.kernels.angular as K
from mmtpu.kernels.angular import angular_partition_pallas
from mmtpu.ops.wordprob import angular_partition as j_angular_partition


def _inputs(rng, b, d, v):
    lat = rng.standard_normal((b, d)).astype(np.float32)
    vocab = rng.standard_normal((v, d)).astype(np.float32)
    g = rng.standard_normal((b, 1)).astype(np.float32)
    return lat, vocab, g


@pytest.mark.parametrize("b,d,v,tile", [(16, 36, 100, 32), (37, 12, 40, 16), (8, 20, 64, 16)])
def test_forward_matches_mmtpu(rng, b, d, v, tile):
    """Includes vocab sizes that are not a multiple of the kernel's tile."""
    lat, vocab, _ = _inputs(rng, b, d, v)
    got = K.angular_fwd(torch.tensor(lat), torch.tensor(vocab),
                        torch.linalg.vector_norm(torch.tensor(vocab), dim=-1))
    want_x = j_angular_partition(jnp.asarray(lat), jnp.asarray(vocab))
    want_p = angular_partition_pallas(jnp.asarray(lat), jnp.asarray(vocab), tile)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_x), rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_p), rtol=1e-5)


@pytest.mark.parametrize("b,d,v,tile", [(6, 12, 40, 16), (37, 12, 40, 16)])
def test_backward_matches_mmtpu_vjp(rng, b, d, v, tile):
    """bwd_ref and autograd through AngularPartitionFn against JAX's VJP of
    the Pallas kernel, with a non-uniform cotangent."""
    lat, vocab, g = _inputs(rng, b, d, v)
    want = jax.grad(lambda l: (angular_partition_pallas(l, jnp.asarray(vocab), tile)
                               * jnp.asarray(g)).sum())(jnp.asarray(lat))
    lat_t, voc_t, g_t = torch.tensor(lat), torch.tensor(vocab), torch.tensor(g)
    ref = K.angular_partition_bwd_ref(lat_t, voc_t, torch.linalg.vector_norm(voc_t, dim=-1), g_t)
    lat_g = lat_t.clone().requires_grad_()
    voc_g = voc_t.clone().requires_grad_()
    (K.angular_partition(lat_g, voc_g) * g_t).sum().backward()
    np.testing.assert_allclose(ref.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(lat_g.grad.numpy(), np.asarray(want), atol=1e-5)
    assert voc_g.grad is None  # the vocabulary is a constant, as in mmtpu


def test_autograd_fn_matches_autograd_of_plain(rng):
    lat, vocab, g = _inputs(rng, 9, 16, 50)
    a = torch.tensor(lat, requires_grad=True)
    b = torch.tensor(lat, requires_grad=True)
    (K.angular_partition(a, torch.tensor(vocab)) * torch.tensor(g)).sum().backward()
    (K.angular_partition_ref(b, torch.tensor(vocab)) * torch.tensor(g)).sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=1e-6)


def test_cpu_path_launches_nothing(rng):
    lat, vocab, g = _inputs(rng, 4, 8, 20)
    before = dict(K.LAUNCHES)
    z = K.angular_partition(torch.tensor(lat, requires_grad=True), torch.tensor(vocab))
    z.sum().backward()
    assert K.LAUNCHES == before


def test_wrappers_reject_bad_shapes(rng):
    lat, vocab, g = (torch.tensor(x) for x in _inputs(rng, 4, 8, 20))
    vn = torch.linalg.vector_norm(vocab, dim=-1)
    with pytest.raises(ValueError, match="depth"):
        K.angular_fwd(lat[:, :7].contiguous(), vocab, vn)
    with pytest.raises(ValueError, match="vnorm"):
        K.angular_fwd(lat, vocab, vn[:5])
    with pytest.raises(ValueError, match="cotangent"):
        K.angular_bwd(lat, vocab, vn, g[:3])
    with pytest.raises(ValueError, match="device"):
        K.angular_fwd(lat.to("meta"), vocab.to("meta"), vn.to("meta"))


def _check_grid(grid, b, v, blocks_per_sm, row_tile=32, vocab_tile=32):
    """A K1 grid at chip_smoke.py's shapes on a 132-SM card (or K2's, with D
    tiles for row tiles and F sub-tiles for vocabulary sub-tiles): the chunks
    cut the sub-tiles into whole, non-empty ranges that cover each sub-tile
    exactly once; the blocks fit in one wave of the card's ``blocks_per_sm``
    slots per SM (unless the row tiles alone overflow it) and fill more than
    half of what the work allows, every SM where two blocks fit per SM and
    there is enough work; and the grid depends on its arguments only (no
    device is asked).  Returns ``(chunks, tiles per chunk)``."""
    sm = 132
    chunks, tpc = grid(b, v, row_tile, vocab_tile, sm, blocks_per_sm)
    n_rt, n_sub = -(-b // row_tile), -(-v // vocab_tile)
    covered = [st for c in range(chunks) for st in range(c * tpc, min((c + 1) * tpc, n_sub))]
    assert sorted(covered) == list(range(n_sub))
    assert all(c * tpc < n_sub for c in range(chunks))
    assert grid(b, v, row_tile, vocab_tile, sm, blocks_per_sm) == (chunks, tpc)
    assert n_rt * chunks <= max(blocks_per_sm * sm, n_rt)
    assert 2 * n_rt * chunks > min(n_rt * n_sub, blocks_per_sm * sm)
    if blocks_per_sm >= 2 and n_rt * n_sub >= sm:
        assert n_rt * chunks >= sm
    return chunks, tpc


# blocks_per_sm 2 is the depth of the main path (D = 300), 1 is D = 512
@pytest.mark.parametrize("blocks_per_sm", [2, 1])
@pytest.mark.parametrize("b,v", [(64, 3016), (512, 3016), (2048, 3016), (37, 3001), (1, 20)])
def test_bwd_grid_covers_every_sub_tile_once(b, v, blocks_per_sm):
    _check_grid(K.bwd_grid, b, v, blocks_per_sm)


@pytest.mark.parametrize("blocks_per_sm", [2, 1])
@pytest.mark.parametrize("b,v", [(64, 3016), (512, 3016), (2048, 3016), (37, 3001), (1, 20)])
def test_fwd_grid_covers_every_sub_tile_once(b, v, blocks_per_sm):
    _check_grid(K.fwd_grid, b, v, blocks_per_sm)


def _k2_tiles():
    """K2's (D tile, F sub-tile, batch chunk), read from its source."""
    src = (Path(K.__file__).resolve().parent.parent / "csrc" / "decoder_update.cu").read_text()
    return tuple(int(re.search(rf"constexpr int {n} = (\d+);", src).group(1))
                 for n in ("DT", "FT", "BB"))


# blocks_per_sm 2 is what the occupancy query gives K2 on an H100; 1 is a
# card or build where only one fits
@pytest.mark.parametrize("blocks_per_sm", [2, 1])
@pytest.mark.parametrize("b,d,f", [(64, 300, 1400), (512, 300, 1416), (37, 300, 37),
                                   (5, 7, 300)])
def test_k2_grid_covers_every_tile_once(b, d, f, blocks_per_sm):
    """K2's grid (K1's rule, D tiles for row tiles, F sub-tiles for
    vocabulary sub-tiles) covers every (D tile, F sub-tile) exactly once in
    one wave that it fills more than half of, and its blocks' stages cover
    every (D tile, F sub-tile, batch chunk) exactly once."""
    d_tile, f_tile, b_chunk = _k2_tiles()
    chunks, tpc = _check_grid(K.fwd_grid, d, f, blocks_per_sm, d_tile, f_tile)
    n_sub, nbc = -(-f // f_tile), -(-b // b_chunk)
    stages = [(dt, st, c) for dt in range(-(-d // d_tile)) for ch in range(chunks)
              for st in range(ch * tpc, min((ch + 1) * tpc, n_sub)) for c in range(nbc)]
    assert sorted(stages) == sorted(set(stages))
    assert len(stages) == -(-d // d_tile) * n_sub * nbc


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from mmtpu_torch.kernels import build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build()


@pytest.mark.parametrize("name", ["k.cu", "k.cuh"])
def test_library_name_tracks_sources(monkeypatch, tmp_path, name):
    """An edit of a source, or of a header the sources include, changes the
    library's name, so it rebuilds."""
    from mmtpu_torch.kernels import build

    (tmp_path / "main.cu").write_text('#include "k.cuh"')
    src = tmp_path / name
    src.write_text("// one")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build.library_path()
    src.write_text("// two")
    assert build.library_path() != first
