"""The parts of a training step as profiler ranges, on the CPU.

Each fit's step body enters the ranges ``mmtpu.step.<part>``
(:data:`mmtpu_torch.utils.profiling.STEP`) around the code that computes
each part, so that a trace of a captured step can tie each kernel to the
part whose range held its launch at capture.  One epoch of each fit kind
is profiled (its body marked by a range of the test's own):

- every part the fit runs is a range of the trace;
- every ``aten::`` operation of the body lies under exactly one step range,
  and every autograd node that the backward evaluates is tied by its
  sequence number to a forward operation under a step range other than
  ``backward``;
- the fit's results are bit for bit those of the same fit without a
  profiler.
"""

import numpy as np
import pytest
import torch

import mmtpu_torch.train.latents as tl
from mmtpu_torch.models.decoder import NORM_CODES
from mmtpu_torch.train import e2e as te2e
from mmtpu_torch.tree import tree_map
from mmtpu_torch.utils.profiling import STEP, STEP_PARTS
from tests.test_torch_graphs import _assert_bit_equal, _e2e_inputs, _hp, _latent_inputs

K = 2  # the sweep's config axis
BODY = "test.body"
EVALUATE = "autograd::engine::evaluate_function: "


def _e2e_config_axis(spec_args):
    """One epoch of an e2e fit of two configs."""
    init, dec, sen, data, labels, vocab, smask, _ = _e2e_inputs()
    n = init.shape[0]
    stack = lambda tree: tree_map(lambda t: torch.stack([t] * K), tree)  # noqa: E731
    hp = {"lr": torch.tensor([5e-3, 1e-3]), "word_loss_weight": torch.tensor([0.002, 0.01]),
          "likelihood_weight": torch.tensor([0.7, 0.3]),
          "norm_code": torch.tensor([NORM_CODES["layer_norm"], NORM_CODES["batch_norm"]]),
          "n_epochs": torch.tensor([1, 1]), "train_heads": torch.tensor([1.0, 1.0])}
    rng = np.random.default_rng(4)
    perms = [torch.tensor(np.stack([rng.permutation(n) for _ in range(K)]))]
    spec = te2e.E2EFitSpec(n_epochs_max=1, batch_size=8, unimodal=False, opt_kind="adam",
                           lazy_adam=True, **spec_args)
    return lambda: te2e.fit_e2e(init.expand(K, *init.shape), stack(dec), stack(sen), data,
                                labels, vocab, hp, spec, senti_mask=smask, perms=perms)


def _latent(train_decoder, spec_args):
    """One epoch of a latent fit (training) or of an inference fit."""
    init, dec, data, vocab, perms = _latent_inputs()
    spec = tl.LatentFitSpec(n_epochs_max=1, batch_size=5, train_decoder=train_decoder,
                            unimodal=False, **spec_args)
    return lambda: tl.fit_latents(init, dec, data, vocab, _hp(n_epochs=1), spec,
                                  perms=perms[:1])


CASES = {
    "e2e_lazy_config_axis": (lambda: _e2e_config_axis({}), STEP_PARTS),
    "e2e_fused_config_axis": (lambda: _e2e_config_axis({"fused_dec_update": True}), STEP_PARTS),
    "latent_dense_adam": (lambda: _latent(True, {"opt_kind": "adam"}),
                          tuple(p for p in STEP_PARTS if p != "senti")),
    "inference_lazy_adam": (lambda: _latent(False, {"opt_kind": "adam", "lazy_adam": True,
                                                     "shuffle": False}),
                            tuple(p for p in STEP_PARTS if p != "senti")),
}


@pytest.fixture
def marked_bodies(monkeypatch):
    """Each fit's epoch body runs inside the range :data:`BODY`."""
    def fit_graphs(*_):
        def run(key, body, *args, carry=False):
            with torch.profiler.record_function(BODY):
                return body(*args)
        return run
    monkeypatch.setattr(tl, "fit_graphs", fit_graphs)
    monkeypatch.setattr(te2e, "fit_graphs", fit_graphs)


def _chain(e) -> list:
    """``e`` and the events that hold it, innermost first."""
    out = []
    while e is not None:
        out.append(e)
        e = e.cpu_parent
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_step_parts_cover_the_body(case, marked_bodies):
    make, parts = CASES[case]
    fit = make()
    want = fit()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = fit()
    _assert_bit_equal(got, want)

    ranges = {name: part for part, name in STEP.items()}
    assert {ranges[e.name] for e in prof.events() if e.name in ranges} == set(parts)
    # forward: (thread, sequence number) -> the step ranges above the op that
    # made the autograd node of that number: an operation records the number
    # that the next node will take, so the node's maker is the last of them
    body, forward = [], {}
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        chain = _chain(e)
        if BODY not in [c.name for c in chain]:
            continue
        held = [ranges[c.name] for c in chain if c.name in ranges]
        node = next((c for c in chain if c.name.startswith(EVALUATE)), None)
        if node is None and e.sequence_nr >= 0 and e.name not in ranges:
            forward[(e.thread, e.sequence_nr)] = held
        if e.name.startswith("aten::"):
            body.append((e.name, held, node))
    assert body
    assert [(name, held) for name, held, _ in body if len(held) != 1] == []
    nodes = {node for _, _, node in body if node is not None}
    assert nodes  # the backward's operations, each under the node it evaluates
    for node in nodes:
        held = forward.get((node.fwd_thread, node.sequence_nr))
        assert held is not None and len(held) == 1 and held[0] != "backward", (
            node.name, node.sequence_nr, held)
