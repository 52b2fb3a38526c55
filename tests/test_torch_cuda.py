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
from mmtpu_torch.graphs import MIN_EPOCHS


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


@pytest.mark.cuda
@pytest.mark.parametrize("b,d,v,zero_row", [
    (64, 513, 3016, False), (37, 767, 3001, False), (64, 768, 3016, False),
    (2048, 768, 3016, False), (64, 1024, 3016, True), (33, 2048, 1000, False)])
def test_deep_kernels_match_plain(cuda_device, b, d, v, zero_row):
    """Both K1 kernels above the one-chunk depth, where the forward streams
    both operands in depth chunks and the backward cuts the output depth into
    slices: one chunk past 512 floats, a depth off the float4 boundary (the
    scalar load path), the largest GloVe-like widths, a 2048-row batch, a
    zero latent row, and 2048 (four slices).  chip_smoke.py's phase 2 gates:
    forward sum rel < 1e-5 and element rtol 1e-5; gradient max-rel < 1e-3
    against autograd of the plain version and atol 1e-5 against the explicit
    formula (the zero row held to the max-rel limit only).  Each kernel
    launches once per call, and two calls are bit for bit equal."""
    gen = torch.Generator().manual_seed(d)
    lat = torch.randn(b, d, generator=gen)
    if zero_row:
        lat[0] = 0.0
    vocab = torch.randn(v, d, generator=gen)
    vocab = vocab / torch.linalg.vector_norm(vocab, dim=-1, keepdim=True)
    lat, vocab = lat.to(cuda_device), vocab.to(cuda_device)
    g = torch.randn(b, 1, generator=gen).to(cuda_device)
    vn = torch.linalg.vector_norm(vocab, dim=-1)
    before = dict(K.LAUNCHES)
    z, dl = K.angular_fwd(lat, vocab, vn), K.angular_bwd(lat, vocab, vn, g)
    assert K.LAUNCHES == {"fwd": before["fwd"] + 1, "bwd": before["bwd"] + 1}
    z_p = K.angular_partition_ref(lat, vocab)
    assert abs(z.sum().item() - z_p.sum().item()) / abs(z_p.sum().item()) < 1e-5
    torch.testing.assert_close(z, z_p, rtol=1e-5, atol=0)
    lat_a = lat.clone().requires_grad_()
    (K.angular_partition_ref(lat_a, vocab) * g).sum().backward()
    assert ((dl - lat_a.grad).abs().max() / lat_a.grad.abs().max()).item() < 1e-3
    rows = slice(1, None) if zero_row else slice(None)
    torch.testing.assert_close(dl[rows], K.angular_partition_bwd_ref(lat, vocab, vn, g)[rows],
                               rtol=0, atol=1e-5)
    assert torch.equal(z, K.angular_fwd(lat, vocab, vn))
    assert torch.equal(dl, K.angular_bwd(lat, vocab, vn, g))


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


def _k2_batched_case(dev, k, b, d, f, seed=6):
    """Batched K2 inputs: per-config lr and flag tensors on the card (the
    last config at flag 0), bias corrections per config, every output table
    far above atol 1e-5 (g_z scaled to g_w ~ N(0, 1))."""
    gen = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen).to(dev)
    t = {"w": 0.05 * r(k, d, f), "m": 0.1 * r(k, d, f), "v": 0.01 * (1.0 + r(k, d, f).abs()),
         "x": r(k, b, d), "g_z": r(k, b, f) / b ** 0.5}
    count = torch.arange(1, k + 1, dtype=torch.float32, device=dev)
    t.update(lr=1e-3 * (1.0 + torch.arange(k, device=dev) % 3),
             bc1=1.0 - 0.9 ** count, bc2=1.0 - 0.999 ** count,
             flag=(torch.arange(k, device=dev) < k - 1).to(torch.float32))
    return t


def _k2_batched_calls(t):
    adam = (lambda fn: fn(t["w"], t["m"], t["v"], t["x"], t["g_z"], t["lr"], t["bc1"], t["bc2"],
                          t["flag"]))
    sgd = lambda fn: fn(t["w"], t["x"], t["g_z"], t["lr"], t["flag"])
    return {"adam": (lambda: adam(T.fused_gemm_adam_update), lambda: adam(T.reference_adam)),
            "sgd": (lambda: sgd(T.fused_gemm_sgd_update), lambda: sgd(T.reference_sgd))}


@pytest.mark.cuda
@pytest.mark.parametrize("k,b,d,f", [(32, 64, 300, 1400), (3, 37, 300, 37),
                                     (2, 33, 300, 1401)])
@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_k2_config_axis_matches_plain(cuda_device, kind, k, b, d, f):
    """K2 with a leading config axis (the sweep's fused chunk) against its
    batched plain version, per-config lr, bias corrections and flag, the
    last config at flag 0: w, m, v at rtol/atol 1e-5, g_x at max-rel 1e-5
    per config, the flag-0 config's tables bit for bit; one launch per call;
    a second call bit for bit equal."""
    t = _k2_batched_case(cuda_device, k, b, d, f)
    kernel, plain = _k2_batched_calls(t)[kind]
    before = T.LAUNCHES[kind]
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    assert T.LAUNCHES[kind] == before + 1
    tables = ("w", "m", "v") if kind == "adam" else ("w",)
    for name, g, p in zip(tables, got[:-1], want[:-1]):
        torch.testing.assert_close(g, p, rtol=1e-5, atol=1e-5, msg=name)
        assert torch.equal(g[-1], t[name][-1]), name
        assert not torch.equal(g[0], t[name][0]), name
    gx_rel = ((got[-1] - want[-1]).abs().amax(dim=(1, 2))
              / want[-1].abs().amax(dim=(1, 2)))
    assert gx_rel.max().item() < 1e-5
    assert all(torch.equal(a, g) for a, g in zip(kernel(), got))


@pytest.mark.cuda
def test_k2_config_axis_is_one_device_kernel(cuda_device):
    """One batched call of each kind at the sweep's shape issues one CUDA
    kernel, as torch.profiler counts them (one profiler session; each call
    in its own range, synchronised)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    calls = _k2_batched_calls(_k2_batched_case(cuda_device, 32, 64, 300, 1400))
    for kernel, _ in calls.values():
        kernel()  # scratch and tickets of the first calls stay out of the count
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for kind, (kernel, _) in calls.items():
            with record_function(f"k2_call_{kind}"):
                kernel()
                torch.cuda.synchronize()
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in events if e.device_type == cuda and not e.name.startswith("k2_call")]
    assert kernels, "torch.profiler recorded no device event"
    for kind in calls:
        span = next(e.time_range for e in events
                    if e.name == f"k2_call_{kind}" and e.device_type != cuda)
        assert sum(span.start <= e.time_range.start <= span.end for e in kernels) == 1, kind
    assert len(kernels) == 2


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


def _closed_form_inputs(gen, n=37, L=6, V=50, D=16, A=5, Vis=4):
    """A decoder, a vocabulary and a raw request, drawn on the CPU."""
    from mmtpu_torch.models.decoder import init_decoder

    vocab = torch.randn(V, D, generator=gen)
    ids = torch.randint(0, V, (n, L), generator=gen)
    req = {"text_ids": ids, "text_weights": torch.rand(n, L, generator=gen) + 0.05,
           "text_gauss": vocab[ids], "audio": torch.randn(n, L, A, generator=gen),
           "visual": torch.randn(n, L, Vis, generator=gen)}
    return init_decoder(gen, D, A, Vis, text_dim=D), vocab, req


@pytest.mark.cuda
def test_closed_form_and_server_match_cpu(cuda_device):
    """``closed_form_latents`` on the card against the CPU on copies of the
    same tensors (rtol 1e-5, atol 1e-6), and ``ClosedFormServer`` on the
    card against the one on the CPU, raw and stats requests, on the ladder
    and above it (atol 1e-5)."""
    from mmtpu_torch.models.decoder import MMB2_HEADS
    from mmtpu_torch.models.sentiment import init_sentiment
    from mmtpu_torch.ops.closed_form import closed_form_latents
    from mmtpu_torch.serve import ClosedFormServer, assemble_head_data, stats_request
    from mmtpu_torch.tree import tree_map

    gen = torch.Generator().manual_seed(5)
    dec, vocab, req = _closed_form_inputs(gen)
    senti = init_sentiment(gen, 16, 8, 1)

    def latents(dev):
        r = tree_map(lambda t: t.to(dev), req)
        return closed_form_latents(assemble_head_data(r, MMB2_HEADS),
                                   tree_map(lambda t: t.to(dev), dec["heads"]),
                                   r["text_weights"], r["text_gauss"])

    torch.testing.assert_close(latents(cuda_device).cpu(), latents("cpu"), rtol=1e-5, atol=1e-6)
    servers = {dev: ClosedFormServer(dec, batch_sizes=(8, 16), sentiment_params=senti,
                                     word_embeddings=vocab, device=dev)
               for dev in (cuda_device, "cpu")}
    np_req = {k: v.numpy() for k, v in req.items()}
    for r in (np_req, stats_request(np_req), {k: v[:5] for k, v in np_req.items()}):
        (lat_g, pred_g), (lat_c, pred_c) = (s(r) for s in servers.values())
        np.testing.assert_allclose(lat_g, lat_c, atol=1e-5)
        np.testing.assert_allclose(pred_g, pred_c, atol=1e-5)


@pytest.mark.cuda
def test_alternating_fit_launches_k1_forward_only(cuda_device):
    """``fit_alternating`` on the card: one K1 forward per step and no
    backward (its latents are constants of the steps), and the CPU's result
    (losses rtol 2e-4, latents atol 2e-4)."""
    from mmtpu_torch.models.legacy import init_audio_visual_generator
    from mmtpu_torch.train.alternating import AlternatingFitSpec, fit_alternating
    from mmtpu_torch.tree import tree_map

    gen = torch.Generator().manual_seed(6)
    _, vocab, req = _closed_form_inputs(gen)
    data = {"text_ids": req["text_ids"], "text_weights": req["text_weights"],
            "text_mask": torch.ones(37, 6), "audio": req["audio"],
            "audio_mask": torch.ones(37, 6, 5), "visual": req["visual"],
            "visual_mask": torch.ones(37, 6, 4)}
    params = init_audio_visual_generator(gen, 16, 5, 4)
    spec = AlternatingFitSpec(n_epochs=2, batch_size=8)
    out = {}
    for dev in (cuda_device, "cpu"):
        move = lambda tree: tree_map(lambda t: t.to(dev), tree)  # noqa: E731
        before = dict(K.LAUNCHES)
        out[str(dev)] = fit_alternating(move(params), move(data), vocab.to(dev), lr=1e-2,
                                        word_loss_weight=0.3, spec=spec)
        launched = {k: K.LAUNCHES[k] - before[k] for k in before}
        assert launched == ({"fwd": 2 * 5, "bwd": 0} if dev != "cpu" else {"fwd": 0, "bwd": 0})
    (lat_g, _, loss_g), (lat_c, _, loss_c) = out.values()
    torch.testing.assert_close(loss_g.cpu(), loss_c, rtol=2e-4, atol=0)
    torch.testing.assert_close(lat_g.cpu(), lat_c, rtol=0, atol=2e-4)


@pytest.fixture
def card_world_of_one(cuda_device):
    """A gloo process group of this one process around a test on the card."""
    from mmtpu_torch.parallel.mesh import init_world

    init_world(cuda_device, "gloo")
    try:
        yield cuda_device
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("b,v_shard", [(32, 1508), (16, 754), (64, 1508), (256, 1508)])
def test_sharded_partition_matches_plain(card_world_of_one, b, v_shard):
    """``ShardedAngularPartition`` on the card, with its all-reduces over a
    group of one rank, at the mesh fits' shard shapes (MOSI's 3016 rows over
    2 and 4 vocabulary ranks; 64- and 512-row batches over 2 and 4 data
    ranks): Z and the latent gradient against K1's plain versions on the
    shard (K1's gates), one K1 launch of each kind; and the shards of the
    whole vocabulary, each through its own call, sum to the plain Z of the
    whole (rtol 1e-5)."""
    from mmtpu_torch.parallel.collectives import shard_vocab

    dev = card_world_of_one
    gen = torch.Generator().manual_seed(b)
    lat = torch.randn(b, 300, generator=gen).to(dev).requires_grad_()
    vocab = torch.randn(3016, 300, generator=gen).to(dev)
    g = torch.randn(b, 1, generator=gen).to(dev)
    n = 3016 // v_shard
    shards = [shard_vocab(vocab, torch.distributed.group.WORLD, n, i) for i in range(n)]
    before = dict(K.LAUNCHES)
    z = shards[0].partition(lat)
    (dl,) = torch.autograd.grad(z, lat, g)
    assert {k: K.LAUNCHES[k] - before[k] for k in before} == {"fwd": 1, "bwd": 1}
    s = shards[0]
    torch.testing.assert_close(z, K.angular_partition_ref(lat.detach(), s.table),
                               rtol=1e-5, atol=0)
    torch.testing.assert_close(dl, K.angular_partition_bwd_ref(lat.detach(), s.table, s.vnorm,
                                                               g), rtol=0, atol=1e-5)
    with torch.no_grad():
        total = sum(sh.partition(lat) for sh in shards)
    torch.testing.assert_close(total, K.angular_partition_ref(lat.detach(), vocab), rtol=1e-5,
                               atol=0)


@pytest.mark.cuda
def test_step_timer_with_block_waits_for_the_card(cuda_device):
    """``StepTimer``'s ``with`` form stops its clock only once the work
    queued in the block has run on the card."""
    from mmtpu_torch.utils.profiling import StepTimer

    x = torch.randn(4096, 4096, device=cuda_device)
    done = torch.cuda.Event()
    with StepTimer(warmup=0) as timer:
        for _ in range(8):
            x = x @ x / 64.0
        done.record()
    assert done.query() and len(timer.times) == 1


def _tiny_fit_inputs(dev, seed=0):
    """A small synthetic MOSI on ``dev``: the training fit's inputs."""
    from mmtpu_torch.config import ExperimentConfig
    from mmtpu_torch.convert import to_torch
    from mmtpu_torch.data.pipeline import prepare_device_data
    from mmtpu_torch.data.synthetic import synthesize_dataset
    from mmtpu_torch.runner import Draws, build_hp
    from mmtpu_torch.train.latents import train_view
    from mmtpu_torch.tree import tree_map

    prep = prepare_device_data(synthesize_dataset(
        "mosi", n_train=40, n_valid=10, n_test=12, vocab_size=100, embed_dim=16, audio_dim=6,
        visual_dim=5, seed=seed), pos_embed_dim=2)
    cfg = ExperimentConfig(dataset="mosi", n_epochs=MIN_EPOCHS, batch_size=8,
                           norm="layer_norm", lr=1e-3, likelihood_weight=0.3)
    draws = Draws(seed)
    dec = tree_map(lambda t: t.to(dev), draws.init_decoder(16, prep.audio_dim, prep.visual_dim,
                                                           False, prep.text_gauss_dim))
    sen = tree_map(lambda t: t.to(dev), draws.init_e2e_sentiment(16, 8, 1))
    hp = dict(build_hp(cfg, dev), train_heads=torch.tensor(1.0, device=dev))
    return {"init": to_torch(prep.sif_init["train"], dev), "dec": dec, "sen": sen,
            "data": to_torch(train_view(prep.splits["train"]), dev),
            "labels": to_torch(prep.labels["train"], dev),
            "vocab": to_torch(prep.vocab_embeddings, dev), "hp": hp,
            "perms": draws.train_permutations(40, MIN_EPOCHS)}


@pytest.fixture
def made_graphs(monkeypatch):
    """Every :class:`mmtpu_torch.graphs.Graphs` made in the test."""
    from mmtpu_torch import graphs as G

    made, init = [], G.Graphs.__init__

    def record(self, *args, **kw):
        init(self, *args, **kw)
        made.append(self)

    monkeypatch.setattr(G.Graphs, "__init__", record)
    return made


def _fit(kind: str, x: dict, graphs, epochs: int = MIN_EPOCHS):
    from mmtpu_torch.train.e2e import E2EFitSpec, fit_e2e
    from mmtpu_torch.train.latents import LatentFitSpec, fit_latents

    opt, rest = kind.split("-", 1)
    if rest.startswith("e2e"):
        spec = E2EFitSpec(n_epochs_max=epochs, batch_size=8, unimodal=False, opt_kind=opt,
                          fused_dec_update="fused" in rest, lazy_adam="lazy" in rest)
        out = fit_e2e(x["init"], x["dec"], x["sen"], x["data"], x["labels"], x["vocab"],
                      x["hp"], spec, perms=x["perms"], graphs=graphs)
        return out[0], out[3]
    spec = LatentFitSpec(n_epochs_max=epochs, batch_size=8, train_decoder=rest != "infer",
                         unimodal=False, opt_kind=opt, shuffle=rest != "infer",
                         lazy_adam="lazy" in rest, fused_dec_update="fused" in rest)
    out = fit_latents(x["init"], x["dec"], x["data"], x["vocab"], x["hp"], spec,
                      perms=x["perms"] if spec.shuffle else None, graphs=graphs)
    return out[0], out[2]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sgd-train", "adam-train-lazy", "adam-infer", "sgd-e2e",
                                  "adam-e2e-fused", "sgd-e2e-fused-lazy"])
def test_captured_fit_matches_eager(cuda_device, kind, made_graphs):
    """Each fit kind on the card at MIN_EPOCHS epochs captured (the default)
    against eager (``graphs=False``): the fit tolerances (loss rtol 2e-4,
    embeddings atol 2e-4), and the kernels' launch counts equal: a replay
    adds the launches its capture recorded.  One epoch fewer runs eagerly
    by default."""
    x = _tiny_fit_inputs(cuda_device)
    out = {}
    for graphs in (False, True):
        before = {**K.LAUNCHES, **T.LAUNCHES}
        emb, losses = _fit(kind, x, graphs)
        torch.cuda.synchronize()
        out[graphs] = (emb.cpu(), losses.cpu(),
                       {k: v - before[k] for k, v in {**K.LAUNCHES, **T.LAUNCHES}.items()})
    (emb_e, loss_e, n_e), (emb_c, loss_c, n_c) = out[False], out[True]
    assert [(g.enabled, g.captures, g.replays) for g in made_graphs] == [
        (False, 0, 0), (True, 1, MIN_EPOCHS - 1)]
    assert n_c == n_e and n_e["fwd"] == n_e["bwd"] == MIN_EPOCHS * 5
    assert n_e["adam" if kind.startswith("adam") else "sgd"] == (
        2 * MIN_EPOCHS * 5 if "fused" in kind else 0)
    _fit(kind, x, True, epochs=MIN_EPOCHS - 1)
    assert not made_graphs[-1].enabled
    np.testing.assert_allclose(loss_c.numpy(), loss_e.numpy(), rtol=2e-4)
    np.testing.assert_allclose(emb_c.numpy(), emb_e.numpy(), atol=2e-4)


@pytest.mark.cuda
def test_captured_config_axis_chunk_matches_eager(cuda_device, made_graphs):
    """A sweep chunk of three configs (fused lazy Adam) at MIN_EPOCHS epochs
    captured and eager: its train and two inference fits each one capture
    (its 2-epoch sentiment fit runs eagerly), train losses and embeddings
    at the fit tolerances, K1 and K2 counts equal."""
    from mmtpu_torch.config import make_grid
    from mmtpu_torch.data.pipeline import prepare_device_data
    from mmtpu_torch.data.synthetic import synthesize_dataset
    from mmtpu_torch.sweep.runner import run_chunk

    configs = [dict(c, n_epochs=MIN_EPOCHS, n_sentiment_epochs=2) for c in make_grid()
               if c["optimizer"] == "adam"][:3]
    dims = tuple(sorted({c["pos_embed_dim"] for c in configs}))
    prep = prepare_device_data(synthesize_dataset(
        "mosi", n_train=40, n_valid=10, n_test=12, vocab_size=100, embed_dim=16, audio_dim=6,
        visual_dim=5), pos_mode="shared", pos_dims=dims)
    res = {}
    for graphs in (False, True):
        before = {**K.LAUNCHES, **T.LAUNCHES}
        r = run_chunk(configs, prep, batch_size=8, device=cuda_device, return_embeddings=True,
                      fused_dec_update=True, graphs=graphs)
        res[graphs] = (r, {k: v - before[k] for k, v in {**K.LAUNCHES, **T.LAUNCHES}.items()})
    (eager, n_e), (captured, n_c) = res[False], res[True]
    assert [(g.enabled, g.captures, g.replays) for g in made_graphs] == (
        [(False, 0, 0)] * 4 + [(True, 1, MIN_EPOCHS - 1)] * 3 + [(False, 0, 0)])
    assert n_c == n_e and n_e["adam"] == 2 * MIN_EPOCHS * 5
    np.testing.assert_allclose(captured.final_train_loss, eager.final_train_loss, rtol=2e-4)
    for s in ("train", "valid", "test"):
        np.testing.assert_allclose(captured.embeddings[s], eager.embeddings[s], atol=2e-4)


def _small_fit(kind: str, dev, graphs) -> tuple:
    """A small sentiment fit (one config or K = 3, early stopping with
    reloads and a stop inside MIN_EPOCHS * 2 epochs) or alternating fit
    (MIN_EPOCHS epochs) on ``dev``; its tensors."""
    from mmtpu_torch.models.legacy import init_audio_visual_generator
    from mmtpu_torch.models.sentiment import init_sentiment
    from mmtpu_torch.train.alternating import AlternatingFitSpec, fit_alternating
    from mmtpu_torch.train.sentiment import SentimentFitSpec, fit_sentiment
    from mmtpu_torch.tree import tree_leaves, tree_map

    gen = torch.Generator().manual_seed(7)
    move = lambda tree: tree_map(lambda t: t.to(dev), tree)  # noqa: E731
    if kind == "alternating":
        _, vocab, req = _closed_form_inputs(gen)
        data = {"text_ids": req["text_ids"], "text_weights": req["text_weights"],
                "text_mask": torch.ones(37, 6), "audio": req["audio"],
                "audio_mask": torch.ones(37, 6, 5), "visual": req["visual"],
                "visual_mask": torch.ones(37, 6, 4)}
        params = init_audio_visual_generator(gen, 16, 5, 4)
        lat, params, losses = fit_alternating(
            move(params), move(data), vocab.to(dev), lr=1e-2, word_loss_weight=0.3,
            spec=AlternatingFitSpec(n_epochs=MIN_EPOCHS, batch_size=8), graphs=graphs)
        return (lat, losses, *tree_leaves(params))
    k = 3 if kind == "sentiment-k3" else None
    x, xv = torch.randn(70, 16, generator=gen), torch.randn(20, 16, generator=gen)
    y, yv = torch.randn(70, generator=gen), torch.randn(20, generator=gen)
    params = init_sentiment(gen, 16, 8, 1)
    hp = {"lr": 0.05, "lr_decay": 0.5, "n_epochs": 2 * MIN_EPOCHS - 3}
    if k:
        params = tree_map(lambda t: torch.stack([t, 0.5 * t, 2 * t]), params)
        x, xv = x.expand(k, -1, -1), xv.expand(k, -1, -1)
        hp = {"lr": torch.tensor([0.0, 0.05, 0.02], device=dev),
              "lr_decay": torch.tensor([0.5, 0.3, 0.5], device=dev),
              "n_epochs": torch.tensor([2 * MIN_EPOCHS, MIN_EPOCHS, MIN_EPOCHS // 2], device=dev)}
    spec = SentimentFitSpec(n_epochs_max=2 * MIN_EPOCHS, early_stopping=True, valid_niter=3,
                            patience=2)
    perms = [torch.randperm(70, generator=gen).expand(*(k,) if k else (), 70)
             for _ in range(spec.n_epochs_max)]
    last, best, losses, vlosses = fit_sentiment(
        move(params), x.to(dev), y.to(dev), xv.to(dev), yv.to(dev), hp, spec,
        perms=[p.to(dev) for p in perms], graphs=graphs)
    return (losses, vlosses, *tree_leaves(last), *tree_leaves(best))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sentiment", "sentiment-k3", "alternating"])
def test_captured_sentiment_and_alternating_fits_are_eager(cuda_device, kind, made_graphs):
    """The sentiment fit (one config and the config axis: training,
    validating and inactive epochs, reloads and stops inside replays) and
    the alternating fit captured on the card: bit for bit the eager fit,
    with equal K1 counts (the alternating fit's forward once per step, each
    replay adding its capture's launches)."""
    out = {}
    for graphs in (False, True):
        before = dict(K.LAUNCHES)
        res = _small_fit(kind, cuda_device, graphs)
        torch.cuda.synchronize()
        out[graphs] = ([t.cpu() for t in res], {k: K.LAUNCHES[k] - before[k] for k in before})
    (eager, n_e), (captured, n_c) = out[False], out[True]
    assert [(g.enabled, g.captures > 0) for g in made_graphs] == [(False, False), (True, True)]
    assert n_c == n_e == ({"fwd": MIN_EPOCHS * 5, "bwd": 0} if kind == "alternating"
                          else {"fwd": 0, "bwd": 0})
    for c, e in zip(captured, eager):
        assert torch.equal(c, e)


@pytest.mark.cuda
def test_captured_server_matches_eager(cuda_device):
    """The server's graphs per ladder size, raw and stats, against the eager
    server on the card (atol 1e-5), with a request above the ladder; each
    form's second request of a size replays."""
    from mmtpu_torch.models.sentiment import init_sentiment
    from mmtpu_torch.serve import ClosedFormServer, stats_request

    gen = torch.Generator().manual_seed(5)
    dec, vocab, req = _closed_form_inputs(gen)
    senti = init_sentiment(gen, 16, 8, 1)
    servers = {g: ClosedFormServer(dec, batch_sizes=(8, 16), sentiment_params=senti,
                                   word_embeddings=vocab, device=cuda_device, graphs=g)
               for g in (False, True)}
    np_req = {k: v.numpy() for k, v in req.items()}
    servers[True].warmup({k: v[:2] for k, v in np_req.items()})
    assert servers[True]._graphs.captures == 2
    for r in (np_req, {k: v[:5] for k, v in np_req.items()}, {k: v[:16] for k, v in np_req.items()}):
        for form in (r, stats_request(r)):
            for _ in range(2):
                (lat_c, pred_c), (lat_e, pred_e) = servers[True](form), servers[False](form)
                np.testing.assert_allclose(lat_c, lat_e, atol=1e-5)
                np.testing.assert_allclose(pred_c, pred_e, atol=1e-5)
    assert servers[True]._graphs.replays >= 6


@pytest.mark.cuda
def test_capture_of_a_host_scalar_raises(cuda_device):
    """K2 refuses a host tensor scalar inside a capture (a graph would
    freeze it), and the failed capture raises: nothing falls back."""
    from mmtpu_torch.graphs import GraphCaptureError, Graphs

    gen = torch.Generator().manual_seed(1)
    w, x, gz = (torch.randn(*s, generator=gen).to(cuda_device)
                for s in ((12, 37), (8, 12), (8, 37)))
    graphs = Graphs(cuda_device, True)
    body = lambda w: T.fused_gemm_sgd_update(w, x, gz, torch.tensor(0.1), 1.0)[0]  # noqa: E731
    graphs("sgd", body, w)
    with pytest.raises(GraphCaptureError, match="host tensor scalar"):
        graphs("sgd", body, w)
    assert graphs.replays == 0
    assert torch.ones(3, device=cuda_device).sum().item() == 3.0  # the card still runs


@pytest.mark.cuda
def test_capture_that_reads_the_host_raises(cuda_device, monkeypatch):
    """A host read planted in a fit's body runs in the eager first epoch
    and breaks the capture of the second, which raises naming the line."""
    import mmtpu_torch.train.latents as tl
    from mmtpu_torch.graphs import GraphCaptureError

    real = tl.batch_neg_log_prob

    def reads(*args, **kw):
        loss = real(*args, **kw)
        loss.sum().item()
        return loss

    monkeypatch.setattr(tl, "batch_neg_log_prob", reads)
    x = _tiny_fit_inputs(cuda_device)
    with pytest.raises(GraphCaptureError, match="test_torch_cuda.py"):
        _fit("sgd-train", x, True)
    torch.cuda.synchronize()
    assert torch.ones(3, device=cuda_device).sum().item() == 3.0


@pytest.mark.cuda
@pytest.mark.parametrize("b", [64, 512, 4096])
def test_kernels_match_plain_at_pom_vocabulary(cuda_device, b):
    """Both K1 kernels at POM's 9206-word vocabulary (a ragged last vocabulary
    tile) at the train batch, the inference batch and a K = 8 chunk's
    inference rows: phase 2's gates (forward sum rel < 1e-5, element rtol
    1e-5; gradient max-rel < 1e-3 against autograd, atol 1e-5 against the
    explicit formula), one launch each, two calls bit for bit equal."""
    gen = torch.Generator().manual_seed(b)
    lat = torch.randn(b, 300, generator=gen).to(cuda_device)
    vocab = torch.randn(9206, 300, generator=gen)
    vocab = (vocab / torch.linalg.vector_norm(vocab, dim=-1, keepdim=True)).to(cuda_device)
    g = torch.randn(b, 1, generator=gen).to(cuda_device)
    vn = torch.linalg.vector_norm(vocab, dim=-1)
    before = dict(K.LAUNCHES)
    z, dl = K.angular_fwd(lat, vocab, vn), K.angular_bwd(lat, vocab, vn, g)
    assert K.LAUNCHES == {"fwd": before["fwd"] + 1, "bwd": before["bwd"] + 1}
    z_p = K.angular_partition_ref(lat, vocab)
    assert abs(z.sum().item() - z_p.sum().item()) / abs(z_p.sum().item()) < 1e-5
    torch.testing.assert_close(z, z_p, rtol=1e-5, atol=0)
    lat_a = lat.clone().requires_grad_()
    (K.angular_partition_ref(lat_a, vocab) * g).sum().backward()
    assert ((dl - lat_a.grad).abs().max() / lat_a.grad.abs().max()).item() < 1e-3
    torch.testing.assert_close(dl, K.angular_partition_bwd_ref(lat, vocab, vn, g),
                               rtol=0, atol=1e-5)
    assert torch.equal(z, K.angular_fwd(lat, vocab, vn))
    assert torch.equal(dl, K.angular_bwd(lat, vocab, vn, g))


@pytest.mark.cuda
def test_token_dots_repeat_bit_for_bit(cuda_device):
    """The per-token term read by id at POM's row length (1357 tokens of a
    9206-word vocabulary, 4096 rows, several token blocks): two calls'
    dots and latent gradients are bit for bit equal (no atomics), and they
    match the gathered form on the card at rtol 1e-5."""
    from mmtpu_torch.ops.wordprob import token_block, token_dots

    gen = torch.Generator().manual_seed(3)
    vocab = torch.randn(9206, 300, generator=gen).to(cuda_device)
    ids = torch.randint(0, 9206, (4096, 1357), generator=gen, dtype=torch.int32).to(cuda_device)
    ids[:, :40] = 7  # a word repeated in every row
    g = torch.randn(4096, 1357, generator=gen).to(cuda_device)
    assert token_block(4096, 300) < 1357
    outs = []
    for _ in range(2):
        lat = torch.randn(4096, 300, generator=torch.Generator().manual_seed(4)).to(
            cuda_device).requires_grad_()
        dots = token_dots(lat, vocab, ids)
        (dots * g).sum().backward()
        outs.append((dots.detach(), lat.grad))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    rows = slice(0, 64)  # the gathered form on a slice of the rows
    sent = vocab[ids[rows].long()]
    lat = torch.randn(4096, 300, generator=torch.Generator().manual_seed(4)).to(cuda_device)
    torch.testing.assert_close(outs[0][0][rows], torch.einsum("bld,bd->bl", sent, lat[rows]),
                               rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(outs[0][1][rows], torch.einsum("bl,bld->bd", g[rows], sent),
                               rtol=1e-5, atol=1e-3)


@pytest.mark.cuda
def test_pom_chunk_at_long_rows_matches_cpu(cuda_device):
    """A POM sweep chunk (three Adam configs of the grid, 17 traits) at
    1024-token rows on the card against the same chunk on the CPU: final
    losses rtol 2e-4, embeddings and metrics atol 2e-4."""
    from mmtpu_torch.config import make_grid
    from mmtpu_torch.data.pipeline import prepare_device_data
    from mmtpu_torch.data.synthetic import synthesize_dataset
    from mmtpu_torch.sweep.runner import run_chunk

    configs = [dict(c, n_epochs=2, n_sentiment_epochs=2) for c in make_grid()
               if c["optimizer"] == "adam" and c["norm"] == "layer_norm"][:3]
    dims = tuple(sorted({c["pos_embed_dim"] for c in configs}))
    prep = prepare_device_data(synthesize_dataset(
        "pom", n_train=40, n_valid=10, n_test=12, vocab_size=500, embed_dim=32, audio_dim=6,
        visual_dim=5, text_len=1024), pos_mode="shared", pos_dims=dims)
    res = {str(dev): run_chunk(configs, prep, batch_size=8, device=dev, return_embeddings=True)
           for dev in (cuda_device, "cpu")}
    card, cpu = res[str(cuda_device)], res["cpu"]
    assert np.isfinite(cpu.final_train_loss).all()
    np.testing.assert_allclose(card.final_train_loss, cpu.final_train_loss, rtol=2e-4)
    for s in ("train", "valid", "test"):
        np.testing.assert_allclose(card.embeddings[s], cpu.embeddings[s], atol=2e-4)
    for name, v in cpu.metrics.items():
        assert v.shape == (3, 17)
        np.testing.assert_allclose(card.metrics[name], v, atol=2e-4, err_msg=name)


def _timeline_sweep(dev, phase_timing: bool):
    """Two chunks of three Adam configs of the grid at MIN_EPOCHS epochs (the
    first captures the bucket's train and inference fits, the second
    replays them) on a small MOSI-like set of 160 train rows, batch 8."""
    from mmtpu_torch.config import make_grid
    from mmtpu_torch.data.pipeline import prepare_device_data
    from mmtpu_torch.data.synthetic import synthesize_dataset
    from mmtpu_torch.sweep.runner import run_sweep

    configs = [dict(c, n_epochs=MIN_EPOCHS, n_sentiment_epochs=2) for c in make_grid()
               if c["optimizer"] == "adam"][:6]
    dims = tuple(sorted({c["pos_embed_dim"] for c in configs}))
    prep = prepare_device_data(synthesize_dataset(
        "mosi", n_train=160, n_valid=10, n_test=12, vocab_size=100, embed_dim=16, audio_dim=6,
        visual_dim=5), pos_mode="shared", pos_dims=dims)
    return run_sweep(configs, prep, batch_size=8, chunk_size=3, verbose=False, device=dev,
                     phase_timing=phase_timing).chunk_stats


@pytest.mark.cuda
def test_sweep_timeline_events_on_the_card(cuda_device):
    """A sweep's chunk timeline from CUDA events: in a phase-timed call each
    chunk's train phase between its events is within 2 % of its host-synced
    seconds; in a pipelined call the second chunk starts on the stream no
    earlier than the first ends (1 ms of rounding), the first chunk's
    warm-ups took stream seconds and its captures host seconds and the
    second's none, and each chunk's phases fill its interval and hold its
    warm-ups."""
    timed = _timeline_sweep(cuda_device, phase_timing=True)
    for c in timed:
        assert c["device_s"]["train"] == pytest.approx(c["phases"]["train"], rel=0.02), c
    first, second = _timeline_sweep(cuda_device, phase_timing=False)
    assert second["device_start_at_s"] >= first["device_end_at_s"] - 1e-3
    assert first["graphs"]["captures"] > 0 and first["host_s"]["capture"] > 0
    assert first["graphs"]["warmups"] > 0 and first["device_warmup_s"] > 0
    assert second["graphs"]["captures"] == 0 and second["host_s"]["capture"] == 0
    assert second["graphs"]["warmups"] == 0 and second["device_warmup_s"] == 0
    for c in (first, second):
        busy = sum(c["device_s"].values())
        assert c["device_warmup_s"] <= busy <= (c["device_end_at_s"] - c["device_start_at_s"]
                                                + 1e-5)
        assert 0 <= c["device_start_at_s"] <= c["device_end_at_s"] <= c["done_at_s"] + 0.005
        assert min(c["alloc"].values()) >= 0
