"""The port's closed-form server (``mmtpu_torch.serve``) against
``mmtpu.serve`` on JAX-CPU, on the same numpy requests and converted
parameters: raw requests on the padding ladder and above it, padding
invariance, the chained sentiment head, compressed (sufficient-statistics)
requests, masked statistics against a truncated sequence, the
missing-vocabulary error.  ``run_experiment(time_test=True)``:
tests/test_torch_runner.py.

Tolerances: the port against mmtpu rtol 1e-5 / atol 1e-6 (latents) and
atol 1e-5 (predictions); within the port, padding and the stats path
against the raw one atol 1e-5 (mmtpu's tests/test_runner.py and
tests/test_warm_start.py); ``stats_request`` bit for bit.
"""

import numpy as np
import pytest
import torch

import jax

from mmtpu.models.sentiment import init_sentiment as j_init_sentiment
from mmtpu.serve import ClosedFormServer as JServer, stats_request as j_stats_request
from mmtpu_torch.convert import to_torch
from mmtpu_torch.serve import ClosedFormServer, stats_request
from tests.test_torch_closed_form import _tiny

LADDER = (4, 8)


def _request(t, rows=slice(None)):
    return {"text_ids": t["ids"][rows], "text_weights": t["weights"][rows],
            **{k: v[rows] for k, v in t["streams"].items()}}


def _servers(vocab=True, senti=True):
    """mmtpu's server and the port's on the CPU, the same parameters."""
    t = _tiny(seed=4)
    s = j_init_sentiment(jax.random.key(5), 8, 6, 1) if senti else None
    kw = dict(batch_sizes=LADDER, word_embeddings=t["vocab"] if vocab else None)
    return (JServer(t["dec"], sentiment_params=s, **kw),
            ClosedFormServer(to_torch(t["dec"]), sentiment_params=to_torch(s), device="cpu",
                             **kw), t)


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def test_raw_requests_match_mmtpu():
    """6 rows (padded to 8), 3 rows (padded to 4; the first rows of the 6),
    and 13 rows, above the ladder: one call at its own size, equal to its
    two halves served apart."""
    jserver, server, t = _servers()
    server.warmup(_request(t, slice(0, 2)))
    out = {}
    for n in (6, 3, 13):
        lat, pred = server(_request(t, slice(0, n)))
        want_lat, want_pred = jserver(_request(t, slice(0, n)))
        assert lat.shape == (n, 8) and pred.shape == (n,)
        _close(lat, want_lat)
        _close(pred, want_pred, rtol=0, atol=1e-5)
        out[n] = lat
    np.testing.assert_allclose(np.linalg.norm(out[6], axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(out[3], out[6][:3], atol=1e-5)
    halves = np.concatenate([server(_request(t, slice(0, 7)))[0],
                             server(_request(t, slice(7, 13)))[0]])
    np.testing.assert_allclose(out[13], halves, atol=1e-5)


def test_tensors_pass_and_heads_select():
    """A tensor request of a ladder size is used as it is; a head subset and
    no sentiment head match mmtpu's."""
    t = _tiny(seed=6)
    heads = ("audio", "visual")
    jserver = JServer(t["dec"], heads=heads, batch_sizes=LADDER, word_embeddings=t["vocab"])
    server = ClosedFormServer(to_torch(t["dec"]), heads=heads, batch_sizes=LADDER,
                              word_embeddings=to_torch(t["vocab"]), device="cpu")
    req = to_torch(_request(t, slice(0, 8)))
    assert server._pad(req["audio"], 8) is req["audio"]
    lat, pred = server(req)
    assert pred is None
    _close(lat, jserver(_request(t, slice(0, 8)))[0])


def test_stats_requests_match_mmtpu_and_the_raw_path():
    jserver, server, t = _servers()
    req = _request(t, slice(0, 6))
    sreq = stats_request(req)
    want = j_stats_request(req)
    assert sreq.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(sreq[k], want[k], err_msg=k)
    lat, pred = server(sreq)
    j_lat, j_pred = jserver(sreq)
    _close(lat, j_lat)
    _close(pred, j_pred, rtol=0, atol=1e-5)
    raw_lat, raw_pred = server(req)
    np.testing.assert_allclose(lat, raw_lat, atol=1e-5)
    np.testing.assert_allclose(pred, raw_pred, atol=1e-5)
    part, _ = server({k: v[:3] for k, v in sreq.items()})
    np.testing.assert_allclose(part, lat[:3], atol=1e-5)


def test_masked_stats_equal_a_truncated_sequence():
    """Masked statistics leave a poisoned padded tail out: the estimate is the
    truncated sequence's (the text term sees zero weights there)."""
    jserver, server, t = _servers(senti=False)
    req = _request(t, slice(0, 6))
    lv = 3
    mask = np.zeros(req["text_ids"].shape, np.float32)
    mask[:, :lv] = 1.0
    req["text_weights"] = req["text_weights"].copy()
    req["text_weights"][:, lv:] = 0.0
    for k in ("text_gauss", "audio", "visual"):
        req[k] = req[k].copy()
        req[k][:, lv:] = 1e3
    sreq = stats_request(req, masks={k: mask for k in ("text_gauss", "audio", "visual")})
    lat, _ = server(sreq)
    _close(lat, jserver(sreq)[0])
    trunc, _ = server({k: v[:, :lv] for k, v in req.items()})
    np.testing.assert_allclose(lat, trunc, atol=1e-5)


def test_missing_vocabulary_and_device_errors():
    _, server, t = _servers(vocab=False)
    req = _request(t, slice(0, 4))
    for r in (req, stats_request(req)):
        with pytest.raises(ValueError, match="word_embeddings"):
            server(r)
    gathered = dict(req, text=t["vocab"][req["text_ids"]])
    del gathered["text_ids"]
    assert server(gathered)[0].shape == (4, 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ClosedFormServer(to_torch(t["dec"]))
