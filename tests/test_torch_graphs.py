"""The port's captured units (``mmtpu_torch/graphs.py``) on the CPU.

A CUDA graph cannot be captured here, so :class:`ReplayOnCpu` stands in
for the card: it runs the same :class:`mmtpu_torch.graphs.Graphs`
logic (the first call of a key eagerly, the second captured, later calls
replayed; static input buffers, the carry copied back, launch counters),
with a "capture" that records the captured function and a "replay" that
runs it again and writes into the outputs the capture returned.  Every
body runs under :class:`NoHostReads`, a ``TorchFunctionMode`` that refuses
what a capture on the card refuses or freezes: reading a tensor on the host
(``item``, ``bool``, ``float``, ``int``, ``tolist``, ``numpy``, ``cpu``)
and making a tensor from host data on a device (``torch.tensor`` /
``torch.as_tensor`` with a ``device``).

Cases: the latent fit with SGD, dense Adam and lazy Adam, the inference fit
(its inactive epochs a graph of their own), the fused decoder update (K2's
plain version), the validation curve's refits, the config axis (dense and
fused lazy Adam), the e2e fit (dense, fused, lazy), the sentiment fit (early
stopping through reloads and stop, inactive and validating epochs, the
config axis), the alternating fit (K1's plain calls counted as launches)
and the server's raw and statistics bodies.  Each must give the eager fit's
results bit for bit (the host part and the replayed body against the same
code run directly), and one training fit and one sentiment fit are also
held to mmtpu at the tolerances of tests/test_torch_fit.py.  A planted host
read in a fit's body must fail.
"""

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import mmtpu_torch.serve as tserve
import mmtpu_torch.graphs as tg
import mmtpu_torch.train.latents as tl
import mmtpu_torch.train.sentiment as ts
from mmtpu_torch.convert import to_torch
from mmtpu_torch.data import prepare_device_data, synthesize_dataset
from mmtpu_torch.kernels import angular as tk1
from mmtpu_torch.kernels.build import Tickets
from mmtpu_torch.models.decoder import NORM_CODES, init_decoder
from mmtpu_torch.models.legacy import init_audio_visual_generator
from mmtpu_torch.models.sentiment import init_sentiment
from mmtpu_torch.serve import ClosedFormServer, stats_request
from mmtpu_torch.train import e2e as te2e
from mmtpu_torch.train.alternating import AlternatingFitSpec, fit_alternating
from mmtpu_torch.train.optim import _B1, _B2, _gated, lazy_adam_catch_up, lazy_adam_coeffs
from mmtpu_torch.tree import tree_map
from tests.test_torch_fit import (A, VIS, _assert_close, _data, _run_both,
                                  assert_sentiment_close, sentiment_fits)
from tests.test_torch_legacy import _alt_data
from tests.test_torch_serve import LADDER, _request, _servers


GRAPHS = tg.Graphs  # the class itself, for eager references under the fixture's patch


class HostRead(AssertionError):
    """A captured body read a tensor on the host or copied host data to a device."""


_READS = {torch.Tensor.item, torch.Tensor.__bool__, torch.Tensor.__float__,
          torch.Tensor.__int__, torch.Tensor.tolist, torch.Tensor.numpy, torch.Tensor.cpu}


class NoHostReads(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _READS:
            raise HostRead(f"{func.__name__} in a captured body")
        if (func in (torch.tensor, torch.as_tensor) and not isinstance(args[0], torch.Tensor)
                and kwargs.get("device") is not None):
            raise HostRead(f"torch.{func.__name__} from host data onto a device in a captured "
                           "body")
        return func(*args, **kwargs)


class _RecordedGraph:
    """A "graph" that runs the captured function again and writes its
    results into the outputs of the capture, as a replay does.  The
    "capture" here ran the function already, so the replay that follows it
    (the capturing call's) has nothing left to do."""

    def __init__(self, fn, outputs):
        self.fn, self.outputs, self.ran = fn, outputs, True

    def replay(self):
        if self.ran:
            self.ran = False
            return
        counts = [dict(c) for c in tg._COUNTERS]  # Python does not run on a replay
        with NoHostReads():
            new = self.fn()
        for c, before in zip(tg._COUNTERS, counts):
            c.update(before)
        got, want = [], []
        tg._flatten(new, got)
        tg._flatten(self.outputs, want)
        for dst, src in zip(want, got):
            if dst is not src:
                dst.copy_(src)


class ReplayOnCpu(tg.Graphs):
    """:class:`Graphs` on the CPU, enabled, with recorded "captures"."""

    made: list = []

    def __init__(self, device, enabled=True):
        super().__init__(device, True)
        ReplayOnCpu.made.append(self)

    def _on_side_stream(self, fn, args):
        with NoHostReads():
            return fn(*args)

    def _record(self, fn):
        with NoHostReads():
            out = fn()
        return _RecordedGraph(fn, out), out


@pytest.fixture
def replayed(monkeypatch):
    """Fits and servers made in the test run on :class:`ReplayOnCpu`; yields
    its instances.  Every fit makes its store through ``tg.fit_graphs``, so
    patching ``tg.Graphs`` reaches them all."""
    ReplayOnCpu.made = []
    monkeypatch.setattr(tg, "Graphs", ReplayOnCpu)
    monkeypatch.setattr(tserve, "Graphs", ReplayOnCpu)
    yield ReplayOnCpu.made


def _leaves(tree) -> list:
    out = []
    tg._flatten(tree, out)
    return out


def _assert_bit_equal(got, want):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w) and g
    for a, b in zip(g, w):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b) or (a.isnan() == b.isnan()).all() and torch.equal(
            a.nan_to_num(), b.nan_to_num())


def _hp(norm="layer_norm", lr=1e-2, n_epochs=3, **extra):
    return {"lr": torch.tensor(lr), "word_loss_weight": torch.tensor(0.002),
            "opt_code": 0, "norm_code": NORM_CODES[norm], "n_epochs": n_epochs, **extra}


def _latent_inputs(seed=0):
    rng = np.random.default_rng(seed)
    inp = _data(rng, stats=True)
    d = inp["vocab"].shape[1]
    dec = init_decoder(torch.Generator().manual_seed(seed), d, A, VIS, text_dim=d)
    perms = [rng.permutation(inp["init"].shape[0]) for _ in range(3)]
    return (torch.tensor(inp["init"]), dec, tl.train_view(to_torch(inp["data"])),
            torch.tensor(inp["vocab"]), perms)


LATENT_CASES = {
    "sgd": (dict(opt_kind="sgd"), {}),
    "adam_dense": (dict(opt_kind="adam"), dict(norm_code=torch.tensor(NORM_CODES["batch_norm"]))),
    "adam_lazy": (dict(opt_kind="adam", lazy_adam=True), {}),
    "inference": (dict(opt_kind="adam", train_decoder=False, shuffle=False, batch_size=8),
                  dict(n_epochs=2)),
    "fused_adam": (dict(opt_kind="adam", fused_dec_update=True), dict(train_dec=torch.tensor(1.0))),
    "fused_sgd": (dict(opt_kind="sgd", fused_dec_update=True), {}),
    "validation_curve": (dict(opt_kind="sgd", valid_every=2, valid_batch_mult=2), {}),
}


def _fit_latents(case):
    spec_args, hp_extra = LATENT_CASES[case]
    init, dec, data, vocab, perms = _latent_inputs()
    spec = tl.LatentFitSpec(**{**dict(n_epochs_max=3, batch_size=5, train_decoder=True,
                                      unimodal=False), **spec_args})
    validation = None
    if spec.valid_every:
        v_init, _, v_data, _, _ = _latent_inputs(seed=1)
        validation = (v_init, v_data)
    return tl.fit_latents(init, dec, data, vocab, _hp(**hp_extra), spec,
                          perms=perms if spec.shuffle else None, validation=validation)


@pytest.mark.parametrize("case", sorted(LATENT_CASES))
def test_replayed_latent_fit_is_the_eager_fit(case, replayed):
    """Host part plus replayed body, no host read in the body, bit for bit
    the eager fit; one capture per (fit, active flag), a replay for every
    later epoch."""
    with pytest.MonkeyPatch.context() as mp:  # the eager reference: graphs off
        mp.setattr(tg, "Graphs", GRAPHS)
        want = _fit_latents(case)
    got = _fit_latents(case)
    _assert_bit_equal(got, want)
    outer = replayed[0]
    n_epochs = LATENT_CASES[case][1].get("n_epochs", 3)
    if n_epochs == 3:
        assert (outer.captures, outer.replays) == (1, 2)
    else:  # two active epochs, one inactive: the inactive flag is its own graph, never captured
        assert (outer.captures, outer.replays) == (1, 1)
    if case == "validation_curve":  # the refits are fits of their own, each captured
        assert len(replayed) == 1 + 3 and all(g.captures == 1 for g in replayed)


def _config_axis_inputs(k=3, seed=2):
    rng = np.random.default_rng(seed)
    inp = _data(rng, stats=True)
    n, d = inp["init"].shape
    decs = [init_decoder(torch.Generator().manual_seed(seed + i), d, A, VIS, text_dim=d)
            for i in range(k)]
    dec = tree_map(lambda *xs: torch.stack(xs), *decs)
    perms = [torch.tensor(np.stack([rng.permutation(n) for _ in range(k)])) for _ in range(3)]
    hp = {"lr": torch.tensor([1e-2, 3e-3, 1e-3]),
          "word_loss_weight": torch.tensor([0.002, 0.01, 0.0]),
          "norm_code": torch.tensor([NORM_CODES["layer_norm"], NORM_CODES["batch_norm"], 0]),
          "n_epochs": torch.tensor([3, 2, 1]), "train_dec": torch.tensor([1.0, 0.0, 1.0])}
    init = torch.tensor(inp["init"]).expand(k, n, d)
    return init, dec, tl.train_view(to_torch(inp["data"])), torch.tensor(inp["vocab"]), hp, perms


@pytest.mark.parametrize("spec_args", [dict(opt_kind="sgd"),
                                       dict(opt_kind="adam", lazy_adam=True,
                                            fused_dec_update=True)],
                         ids=["sgd", "fused_lazy_adam"])
def test_replayed_config_axis_fit_is_the_eager_fit(spec_args, replayed):
    """The sweep's config axis: (K,) hp on the device, each config's own
    epoch count as a (K,) mask copied in before each replay."""
    init, dec, data, vocab, hp, perms = _config_axis_inputs()
    spec = tl.LatentFitSpec(n_epochs_max=3, batch_size=5, train_decoder=True, unimodal=False,
                            **spec_args)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tg, "Graphs", GRAPHS)
        want = tl.fit_latents(init, dec, data, vocab, hp, spec, perms=perms)
    got = tl.fit_latents(init, dec, data, vocab, hp, spec, perms=perms)
    _assert_bit_equal(got, want)
    assert (replayed[0].captures, replayed[0].replays) == (1, 2)


def _e2e_inputs(seed=3):
    rng = np.random.default_rng(seed)
    prep = prepare_device_data(synthesize_dataset(
        "mosi", n_train=22, n_valid=6, n_test=6, vocab_size=60, embed_dim=16, audio_dim=7,
        visual_dim=5, seq_len=6, seed=seed), pos_embed_dim=2)
    gen = torch.Generator().manual_seed(seed)
    dec = init_decoder(gen, prep.embed_dim, prep.audio_dim, prep.visual_dim,
                       text_dim=prep.text_gauss_dim)
    sen = init_sentiment(gen, prep.embed_dim, 12, 1)
    n = prep.sif_init["train"].shape[0]
    labels = torch.tensor(rng.standard_normal(n).astype(np.float32))
    smask = torch.tensor((rng.random(n) > 0.4).astype(np.float32))
    perms = [rng.permutation(n) for _ in range(3)]
    return (torch.tensor(prep.sif_init["train"]), dec, sen,
            tl.train_view(to_torch(prep.splits["train"])), labels,
            torch.tensor(prep.vocab_embeddings), smask, perms)


@pytest.mark.parametrize("spec_args", [dict(opt_kind="sgd"),
                                       dict(opt_kind="adam", fused_dec_update=True),
                                       dict(opt_kind="adam", lazy_adam=True)],
                         ids=["sgd", "fused_adam", "lazy_adam"])
def test_replayed_e2e_fit_is_the_eager_fit(spec_args, replayed):
    """The e2e fit: the sentiment head and its optimizer state in the carry."""
    init, dec, sen, data, labels, vocab, smask, perms = _e2e_inputs()
    hp = dict(_hp(lr=5e-3), likelihood_weight=torch.tensor(0.7),
              train_heads=torch.tensor(1.0))
    spec = te2e.E2EFitSpec(n_epochs_max=3, batch_size=8, unimodal=False, **spec_args)
    run = lambda: te2e.fit_e2e(init, dec, sen, data, labels, vocab, hp, spec,  # noqa: E731
                               senti_mask=smask, perms=perms)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tg, "Graphs", GRAPHS)
        want = run()
    _assert_bit_equal(run(), want)
    assert (replayed[0].captures, replayed[0].replays) == (1, 2)


def _sentiment_inputs(case):
    """The sentiment fit's inputs for ``case`` at tests/test_torch_fit.py's
    sizes (40 rows, width 6): ``(args, hp, spec, perms)``."""
    rng = np.random.default_rng(5)
    n, nv, d = 40, 12, 6
    n_out = 3 if case == "reload" else 1
    y, yv = (torch.tensor(rng.standard_normal((m, n_out) if n_out > 1 else (m,))
                          .astype(np.float32)) for m in (n, nv))
    x, xv = (torch.tensor(rng.standard_normal((m, d)).astype(np.float32)) for m in (n, nv))
    gen = torch.Generator().manual_seed(5)
    if case != "config_axis":
        params = init_sentiment(gen, d, 5, n_out)
        hp = {"lr": 0.0 if case == "stop" else 0.05, "lr_decay": 0.5, "n_epochs": 313}
        spec = ts.SentimentFitSpec(n_epochs_max=320, early_stopping=True)
        perms = [rng.permutation(n) for _ in range(spec.n_epochs_max)]
        return (params, x, y, xv, yv), hp, spec, perms
    k = 3
    params = tree_map(lambda *xs: torch.stack(xs), *[init_sentiment(gen, d, 5, 1)
                                                   for _ in range(k)])
    hp = {"lr": torch.tensor([0.0, 0.05, 0.02]), "lr_decay": torch.tensor([0.5, 0.3, 0.5]),
          "n_epochs": torch.tensor([60, 40, 25])}
    spec = ts.SentimentFitSpec(n_epochs_max=60, early_stopping=True, valid_niter=3, patience=2)
    perms = [torch.tensor(np.stack([rng.permutation(n) for _ in range(k)]))
             for _ in range(spec.n_epochs_max)]
    return (params, x.expand(k, n, d), y, xv.expand(k, nv, d), yv), hp, spec, perms


@pytest.mark.parametrize("case", ["stop", "reload", "config_axis"])
def test_replayed_sentiment_fit_is_the_eager_fit(case, replayed):
    """One config at lr 0 (every trial runs out and the fit stops inside
    the validating key's replays), three outputs at lr 0.05 (best reloaded),
    and the config axis with its own epoch count, lr and retries per config:
    replayed bit for bit as eager.  Keys: training, validating and (one
    config) inactive epochs, each warmed up, captured, then replayed."""
    args, hp, spec, perms = _sentiment_inputs(case)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tg, "Graphs", GRAPHS)
        want = ts.fit_sentiment(*args, hp, spec, perms=perms)
    got = ts.fit_sentiment(*args, hp, spec, perms=perms)
    _assert_bit_equal(got, want)
    keys = 2 if case == "config_axis" else 3
    assert (replayed[0].captures, replayed[0].replays) == (keys, spec.n_epochs_max - keys)


def test_replayed_sentiment_fit_matches_mmtpu(replayed):
    """The replayed sentiment fit (three outputs, early stopping with
    reloads) against mmtpu's jitted fit at tests/test_torch_fit.py's
    tolerances."""
    assert_sentiment_close(*sentiment_fits(0, True, 3, 0.05))
    assert (replayed[0].captures, replayed[0].replays) == (3, 317)


def test_replayed_alternating_fit_is_the_eager_fit(replayed, monkeypatch):
    """Each epoch's closed form and steps replayed: bit for bit the eager
    fit, and K1's calls (its plain version here, counted as launches) equal:
    each replay adds the calls its capture recorded."""
    real = tk1.angular_partition_ref

    def counted(*args):
        tk1.LAUNCHES["fwd"] += 1
        return real(*args)

    monkeypatch.setattr(tk1, "angular_partition_ref", counted)
    vocab, data = _alt_data()
    params = init_audio_visual_generator(torch.Generator().manual_seed(2), 8, 4, 3)
    spec = AlternatingFitSpec(n_epochs=4, batch_size=8)
    runs, calls = [], []
    for graphs in (GRAPHS, ReplayOnCpu):
        before = dict(tk1.LAUNCHES)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tg, "Graphs", graphs)
            runs.append(fit_alternating(params, to_torch(data), to_torch(vocab), lr=1e-2,
                                        word_loss_weight=0.3, spec=spec))
        calls.append({k: tk1.LAUNCHES[k] - before[k] for k in before})
        tk1.LAUNCHES.update(before)
    _assert_bit_equal(runs[1], runs[0])
    assert calls[0] == calls[1] == {"fwd": 4 * 2, "bwd": 0}
    assert (replayed[0].captures, replayed[0].replays) == (1, 3)


def test_planted_host_read_in_the_sentiment_body_fails(replayed, monkeypatch):
    """A ``.item()`` planted in the sentiment MLP's forward is caught in the body."""
    real = ts.apply_sentiment

    def reads(params, x):
        out = real(params, x)
        out.sum().item()
        return out

    monkeypatch.setattr(ts, "apply_sentiment", reads)
    args, hp, spec, perms = _sentiment_inputs("stop")
    with pytest.raises(HostRead, match="item"):
        ts.fit_sentiment(*args, hp, spec, perms=perms)


def test_replayed_fit_matches_mmtpu(replayed):
    """The replayed training fit against mmtpu's, at the fit tolerances."""
    want, got = _run_both(_data(np.random.default_rng(4), stats=True), "adam", "layer_norm",
                          train_decoder=True, shuffle=True, bsz=5)
    _assert_close(want, got, train_decoder=True)
    assert replayed[0].replays == 2


def test_replayed_server_is_the_eager_server(replayed):
    """Both server bodies (raw and statistics) per ladder size: captured by
    ``warmup`` for the example's form, at first use for another, replayed
    after; requests above the ladder run eagerly at their own size."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tserve, "Graphs", tg.Graphs)
        _, eager, t = _servers()
    server = ClosedFormServer(to_torch(t["dec"]), sentiment_params=eager._senti,
                              batch_sizes=LADDER, word_embeddings=t["vocab"], device="cpu")
    graphs = replayed[-1]
    server.warmup(_request(t, slice(0, 2)))
    assert graphs.captures == len(LADDER)
    for rows in (slice(0, 3), slice(0, 6), slice(2, 9), slice(0, 13)):
        for form in (_request(t, rows), stats_request(_request(t, rows))):
            for _ in range(2):
                got, want = server(form), eager(form)
                for g, w in zip(got, want):
                    assert np.array_equal(g, w)
    assert graphs.captures == 2 * len(LADDER) and graphs.replays > graphs.captures


def test_planted_host_read_fails_the_guard(replayed, monkeypatch):
    """A ``.item()`` planted in the fit's loss is caught in the body."""
    real = tl.batch_neg_log_prob

    def reads(*args, **kw):
        loss = real(*args, **kw)
        loss.sum().item()
        return loss

    monkeypatch.setattr(tl, "batch_neg_log_prob", reads)
    with pytest.raises(HostRead, match="item"):
        _fit_latents("sgd")


@pytest.mark.parametrize("read", ["item", "bool", "float", "int", "tolist", "numpy", "cpu",
                                  "tensor_to_device", "as_tensor_to_device"])
def test_guard_refuses_each_host_read(read, replayed):
    x = torch.ones(())
    body = {"item": lambda: x.item(), "bool": lambda: bool(x), "float": lambda: float(x),
            "int": lambda: int(x), "tolist": lambda: x.tolist(), "numpy": lambda: x.numpy(),
            "cpu": lambda: x.cpu(), "tensor_to_device": lambda: torch.tensor(1.0, device="cpu"),
            "as_tensor_to_device": lambda: torch.as_tensor(2, device="cpu")}[read]
    with pytest.raises(HostRead):
        ReplayOnCpu("cpu")("planted", lambda t: body() and t, x)


def test_capture_failure_raises_with_the_line_and_never_falls_back():
    calls = []

    def body(t):
        calls.append(1)
        if len(calls) == 2:  # fails at capture only
            raise RuntimeError("operation not permitted when stream is capturing")
        return t * 2

    graphs = ReplayOnCpu("cpu")
    x = torch.ones(3)
    assert torch.equal(graphs("k", body, x), 2 * x)
    with pytest.raises(tg.GraphCaptureError, match=r"test_torch_graphs\.py:\d+ .*raise"):
        graphs("k", body, x)
    assert len(calls) == 2 and graphs.replays == 0  # no eager rerun after the failure


def test_launch_counters_count_each_replay():
    """Launches made while capturing are taken off; each replay adds the
    captured ones: the counters equal the calls that ran."""
    before = dict(tk1.LAUNCHES)

    def body(t):
        tk1.LAUNCHES["fwd"] += 2
        tk1.LAUNCHES["bwd"] += 1
        return t + 1

    graphs = ReplayOnCpu("cpu")
    try:
        x = torch.zeros(2)
        for _ in range(5):
            x = graphs("k", body, x)
        assert torch.equal(x, torch.full((2,), 5.0))
        assert tk1.LAUNCHES["fwd"] - before["fwd"] == 10
        assert tk1.LAUNCHES["bwd"] - before["bwd"] == 5
        assert (graphs.captures, graphs.replays) == (1, 4)
    finally:
        tk1.LAUNCHES.update(before)


def test_carry_copies_back_and_keeps_aliases_apart():
    """The new carry goes into the static carry buffers, also where a new
    leaf is another buffer of the carry (a swap)."""
    graphs = ReplayOnCpu("cpu")
    carry = (torch.zeros(2), torch.ones(2))
    for _ in range(4):
        carry, _ = graphs("swap", lambda c: ((c[1], c[0] + 1), c[0].sum()), carry, carry=True)
    a, b = carry
    # (0, 1) -> (1, 1) -> (1, 2) -> (2, 2) -> (2, 3)
    assert torch.equal(a, torch.full((2,), 2.0)) and torch.equal(b, torch.full((2,), 3.0))


def test_use_graphs_picks_the_mode():
    """True captures on CUDA, a fit only from MIN_EPOCHS epochs and not
    batch-sharded; False and the CPU run eagerly, the CPU the same fit."""
    cuda = torch.device("cuda", 0)
    assert tg.use_graphs(True, cuda) is True
    assert tg.use_graphs(True, "cuda", tg.MIN_EPOCHS) is True
    assert tg.use_graphs(True, cuda, tg.MIN_EPOCHS - 1) is False
    assert tg.use_graphs(False, "cuda") is False
    assert tg.use_graphs(True, "cpu") is False and tg.use_graphs(False, "cpu") is False
    assert tg.fit_graphs(True, cuda, None, tg.MIN_EPOCHS).enabled
    assert not tg.fit_graphs(True, cuda, object(), tg.MIN_EPOCHS).enabled
    assert not tg.fit_graphs(True, cuda, None, tg.MIN_EPOCHS - 1).enabled
    args = (*_latent_inputs()[:4], _hp(), tl.LatentFitSpec(
        n_epochs_max=1, batch_size=5, train_decoder=True, unimodal=False, shuffle=False))
    _assert_bit_equal(tl.fit_latents(*args, graphs=True), tl.fit_latents(*args, graphs=False))


def test_tickets_keep_the_buffers_they_replace():
    """A graph keeps the ticket buffer it captured: growth makes a new one
    and keeps the old alive."""
    tickets = Tickets()
    dev = torch.device("cpu")
    first = tickets(dev, 7, 4)
    assert tickets(dev, 7, 3) is first
    grown = tickets(dev, 7, 9)
    assert grown.numel() == 9 and grown is not first
    assert any(t is first for t in tickets._replaced)


@pytest.mark.parametrize("S", [2, 5, 40])
def test_capture_safe_helpers_equal_the_old_formulas(S):
    """The catch-up's decays from the coefficients' device exponents, and
    ``_gated`` without a tensor made from host data, bit for bit as the
    formulas they replace."""
    rng = np.random.default_rng(S)
    m0, v0, p0 = (torch.tensor(rng.random((3, 4)).astype(np.float32)) for _ in range(3))
    coeffs = lazy_adam_coeffs(torch.tensor(5, dtype=torch.int32), S, torch.tensor(1e-2))
    for s in range(S):
        got = lazy_adam_catch_up(p0, m0, v0, s, coeffs)
        if s:
            sf = torch.tensor(float(s))
            assert torch.equal(got[1], torch.pow(_B1, sf) * m0)
            assert torch.equal(got[2], torch.pow(_B2, sf) * v0)
    gate = torch.tensor([1.0, 0.0])
    for active in (True, False, torch.tensor([True, False]), torch.tensor([False, False])):
        old = (gate > 0) & torch.as_tensor(active)
        assert torch.equal(_gated(active, gate), old)
