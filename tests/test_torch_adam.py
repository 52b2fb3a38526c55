"""The one-launch Adam kernel's plan and its CPU path, at tiny shapes.

The kernel (``mmtpu_torch/csrc/adam.cu``) runs only on the card, where
tests/test_torch_cuda.py holds it to the plain twin bit for bit.  Here: the
wrapper's launch plan, walked block by block as the kernel walks it, covers
every element of every leaf exactly once; only aligned leaves whose
per-config size is a multiple of 4 take float4 units; a tree of more leaves
than the argument struct holds is split; and on the CPU ``opt_update`` and
``lazy_adam_touch`` stay the twin and launch nothing.
"""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import mmtpu_torch.kernels.adam as A
from mmtpu_torch.train.optim import (OptState, adam_leaf, adam_plain, init_opt_state,
                                     lazy_adam_coeffs, lazy_adam_touch, opt_update)
from mmtpu_torch.tree import tree_leaves, tree_map

K = 32
# the decoder's per-head widths at the grid's geometry (text 300 and the
# audio / visual widths): MOSI sums to 1,384, POM to 1,244
WIDTHS = {"mosi": (74, 47, 121, 374, 347, 421), "pom": (43, 43, 86, 343, 343, 386)}


def _tree_sizes(name: str) -> list:
    """Element counts of a width-32 e2e decoder tree (each head's two weights
    and two biases, the norm's scale and bias) and its sentiment head."""
    sizes = [K * n for f in WIDTHS[name] for n in (300 * f, f, 300 * f, f)] + [K * 300] * 2
    n_out = 1 if name == "mosi" else 17
    return sizes + [K * n for n in (300 * 100, 100, 100 * n_out, n_out)]


def _walk(launch, leaves):
    """Each leaf's element ranges that the launch's blocks take, found by
    the kernel's scan of the block starts."""
    blocks, members = launch
    firsts = [first for _, first in members]
    covered = {}
    for b in range(blocks):
        i = 0
        while i + 1 < len(members) and b >= firsts[i + 1]:
            i += 1
        leaf, first = members[i]
        n, vec = leaves[leaf]
        unit = 4 if vec else 1
        start = (b - first) * A.TILE
        end = min(start + A.TILE, n // unit)
        assert start < end, f"block {b} of the launch takes nothing"
        covered.setdefault(leaf, []).append((start * unit, end * unit))
    return covered


@pytest.mark.parametrize("case", ["mosi", "pom", "ragged", "many"])
def test_plan_covers_every_element_once(case):
    """The MOSI and POM grid trees (vector weights, scalar biases), ragged
    sizes on either path, and 70 leaves (three launches)."""
    if case in WIDTHS:
        leaves = [(n, n // K % 4 == 0) for n in _tree_sizes(case)]
    elif case == "ragged":
        leaves = [(n, vec) for n in (1, 3, 4, 1023, 1024, 4095, 4096, 4097, 12289)
                  for vec in (False, True) if not vec or n % 4 == 0]
    else:
        leaves = [(5 + 37 * i, False) for i in range(70)]
    launches = A.plan(leaves)
    assert [i for _, members in launches for i, _ in members] == list(range(len(leaves)))
    ranges = {}
    for launch in launches:
        assert 1 <= len(launch[1]) <= A.MAX_LEAVES
        for leaf, rs in _walk(launch, leaves).items():
            assert leaf not in ranges
            ranges[leaf] = rs
    for leaf, (n, _) in enumerate(leaves):
        rs = sorted(ranges[leaf])
        assert rs[0][0] == 0 and rs[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(rs, rs[1:]))


def test_large_tree_splits_and_the_struct_fits():
    """The argument struct stays under the 4 KB parameter limit; a tree of
    more leaves than it holds takes several launches, each full but the
    last; the wrapper's constants are the source's."""
    assert A.args_size() <= 4096
    launches = A.plan([(8, True)] * (2 * A.MAX_LEAVES + 6))
    assert [len(m) for _, m in launches] == [A.MAX_LEAVES, A.MAX_LEAVES, 6]
    assert [b for b, _ in launches] == [A.MAX_LEAVES, A.MAX_LEAVES, 6]
    src = (Path(A.__file__).resolve().parent.parent / "csrc" / "adam.cu").read_text()
    consts = {n: int(re.search(rf"constexpr int {n} = (\d+);", src).group(1))
              for n in ("THREADS", "UNROLL", "MAX_LEAVES")}
    assert consts == {"THREADS": A.THREADS, "UNROLL": A.UNROLL, "MAX_LEAVES": A.MAX_LEAVES}


def test_only_aligned_multiples_of_four_take_float4():
    """float4 units need the per-config size and every config stride a
    multiple of 4 and every pointer 16-byte aligned; a block of a permuted
    table (configs a table apart) qualifies as such, a row offset by one
    float does not."""
    assert A.takes_vector(300 * 74, [0, 16, 32, 4096], [300 * 74] * 4)
    assert not A.takes_vector(74, [0, 16, 32, 48], [74] * 4)
    assert not A.takes_vector(300, [0, 16, 36, 48], [300] * 4)
    assert not A.takes_vector(300, [0, 16, 32, 48], [300, 300, 302, 300])
    table = torch.zeros(3, 5 * 8, 12)
    blk = table[:, 8:16, :]
    assert A._config_stride(blk, 3) == 5 * 8 * 12
    assert A.takes_vector(8 * 12, [blk.data_ptr()], [A._config_stride(blk, 3)])
    assert A._config_stride(table[:, :, 1:], 3) is None
    assert A._config_stride(blk, None) is None


def _tree(gen, shapes, scale=1.0, k=3):
    return tree_map(lambda s: scale * torch.randn(k, *s, generator=gen), shapes)


def test_cpu_opt_update_is_the_twin():
    """On the CPU ``opt_update``'s Adam step is :func:`adam_plain` bit for
    bit under a config axis with mixed ``active`` and a gate with a zero,
    and launches nothing."""
    gen = torch.Generator().manual_seed(4)
    shapes = {"heads": {"a": {"w": (6, 5), "b": (5,)}}, "norm": {"scale": (6,)}}
    p, g = _tree(gen, shapes), _tree(gen, shapes)
    m = _tree(gen, shapes, 0.1)
    v = tree_map(lambda t: t.square(), _tree(gen, shapes, 0.01))
    state = OptState(m=m, v=v, count=torch.tensor([0, 4, 9], dtype=torch.int32))
    lr = torch.tensor([1e-3, 3e-4, 1e-2])
    active = torch.tensor([True, False, True])
    gates = {"heads": {"a": {"w": torch.tensor([1.0, 1.0, 0.0]), "b": 1.0}},
             "norm": {"scale": 1.0}}
    before = dict(A.LAUNCHES)
    p2, s2 = opt_update(p, g, state, lr, None, active, kind="adam", gates=gates)
    count = state.count.float() + 1
    bc1, bc2 = 1.0 - torch.pow(0.9, count), 1.0 - torch.pow(0.999, count)
    want = adam_plain(p, g, m, v, lr, bc1, bc2, active, gates)
    direct = A.adam_tree(p, g, m, v, lr, bc1, bc2, active, gates)
    assert A.LAUNCHES == before
    for got, also, ref in zip((p2, s2.m, s2.v), direct, want):
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(ref)))
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(also), tree_leaves(ref)))
    assert torch.equal(s2.count, torch.tensor([1, 4, 10], dtype=torch.int32))
    w2 = p2["heads"]["a"]["w"]
    assert torch.equal(w2[1:], p["heads"]["a"]["w"][1:])  # config 1 inactive, 2 gated off
    assert not torch.equal(w2[0], p["heads"]["a"]["w"][0])


def test_cpu_lazy_touch_is_the_twin():
    """On the CPU ``lazy_adam_touch`` of a block of a permuted table is
    :func:`adam_leaf` at the epoch step's bias corrections, bit for bit,
    and :func:`adam_touch` the same; nothing launches."""
    gen = torch.Generator().manual_seed(5)
    k, steps, b, d = 3, 4, 2, 8
    table = torch.randn(3, k, steps * b, d, generator=gen)
    p, m, v = table[0], 0.1 * table[1], 0.01 * table[2].square()
    g = torch.randn(k, b, d, generator=gen)
    lr = torch.tensor([1e-3, 3e-4, 1e-2])
    coeffs = lazy_adam_coeffs(torch.tensor([0, 3, 7], dtype=torch.int32), steps, lr)
    before = dict(A.LAUNCHES)
    for s in (1, steps - 1):
        blk = slice(s * b, (s + 1) * b)
        args = (p[:, blk], m[:, blk], v[:, blk])
        got = lazy_adam_touch(*args, g, s, lr, coeffs)
        want = adam_leaf(args[0], g, args[1], args[2], lr, coeffs[2][:, s], coeffs[3][:, s])
        also = A.adam_touch(*args, g, lr, coeffs[2][:, s], coeffs[3][:, s])
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        assert all(torch.equal(x, y) for x, y in zip(also, want))
    assert A.LAUNCHES == before


def test_cpu_one_config_adam_keeps_an_inactive_step():
    """One config, a float rate and a bool ``active``: inactive, nothing
    moves and the count stays; active, the step is the twin's."""
    gen = torch.Generator().manual_seed(6)
    p = {"w": torch.randn(4, 3, generator=gen), "b": torch.randn(3, generator=gen)}
    g = tree_map(lambda t: torch.randn(t.shape, generator=gen), p)
    state = init_opt_state(p, "adam")
    same, s_same = opt_update(p, g, state, 1e-3, None, False, kind="adam")
    assert all(a is b for a, b in zip(tree_leaves(same), tree_leaves(p)))
    assert int(s_same.count) == 0
    p2, s2 = opt_update(p, g, state, 1e-3, None, True, kind="adam")
    bc1, bc2 = 1.0 - torch.pow(0.9, torch.tensor(1.0)), 1.0 - torch.pow(0.999, torch.tensor(1.0))
    want = adam_plain(p, g, state.m, state.v, 1e-3, bc1, bc2, True)
    for got, ref in zip((p2, s2.m, s2.v), want):
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(ref)))


def test_importing_optim_registers_the_launch_counter():
    """The counter is registered when ``optim`` is imported, before any
    Adam step, so a capture that makes the first call still counts it."""
    code = ("import mmtpu_torch.train.optim, mmtpu_torch.graphs as g, "
            "mmtpu_torch.kernels.adam as A; "
            "assert any(c is A.LAUNCHES for c in g._COUNTERS)")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=Path(__file__).parent.parent)


def test_adam_takes_no_device_but_the_card_and_the_cpu():
    """A tree on another device raises; nothing runs the twin there."""
    p = {"w": torch.zeros(4, 3, device="meta")}
    with pytest.raises(ValueError, match="unsupported device"):
        opt_update(p, p, init_opt_state(p, "adam"), 1e-3, None, True, kind="adam")
    with pytest.raises(ValueError, match="unsupported device"):
        lazy_adam_touch(p["w"], p["w"], p["w"], p["w"], 0, 1e-3,
                        lazy_adam_coeffs(torch.tensor(0, dtype=torch.int32), 2, 1e-3))
