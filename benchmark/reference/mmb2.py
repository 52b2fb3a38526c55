"""The plain reference of e2e grid configs, phase by phase, for several
configs side by side (a leading config axis ``S``; nothing crosses
configs).  Plain PyTorch, float32, eager, no kernel of the program; the
caller sets TF32 off (``benchmark/drivers/grid_sweep.py::Driver.reference``;
on for the control).  :func:`train` runs the whole joint fit from a
config's draws, :func:`infer`, :func:`sentiment` and :func:`score` each
later phase from the inputs they are handed (``benchmark.compare`` says why).

MMB2 (N19-1267, "Strong and Simple Baselines for Multimodal Utterance
Embeddings"), as the baselines' code runs it end to end:

- a latent ``c`` per utterance, started at its SIF embedding;
- the decoder: LayerNorm or train-mode BatchNorm (batch statistics over the
  batch's rows, eps 1e-5, biased variance), then six Gaussian heads (audio,
  visual, audiovisual, textaudio, textvisual, textaudiovisual), each a
  linear map to the means and one to the log standard deviations;
- the joint log-likelihood of an utterance: the heads' masked Gaussian
  log-densities summed, times ``(1 - w) / 6``, plus ``w`` times the word
  term (Arora's mixture with the angular score): ``log(alpha(c) p(t) +
  (1 - alpha(c)) score(t, c) / Z(c))`` summed over the utterance's tokens,
  ``score = 1 - acos(cos(t, c)) / pi``, ``Z`` the score summed over the
  vocabulary, ``alpha = 1 / (1e-3 Z + 1)``, cosines clipped 1e-7 from +-1;
- the e2e objective per utterance: ``lw * (-joint) + (1 - lw) * |senti(c) -
  y|`` (L1 averaged over the outputs), its mean over the batch's rows;
- Adam (0.9, 0.999, eps 1e-8 after the square root, bias corrections by
  the step count) on the latents, the decoder and the e2e sentiment head,
  every latent row stepping every step (torch's Adam over the whole table);
  100 epochs of the config's permutations, batch 64, the last batch short;
- the valid and test latents fitted likelihood-only against the frozen
  decoder, unshuffled, batch 512, the config's epochs;
- the sentiment MLP (from its own initial draw) by plain SGD on the L1
  loss, batch 32, the config's sentiment epochs and permutations, then
  scored on the test latents with its last parameters.

The final training loss is the last epoch's sum of its batches' losses.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from benchmark.generate import MMB2_HEADS
from benchmark.reference.prep import pos_column_mask

LOG_2PI = math.log(2.0 * math.pi)
B1, B2, EPS = 0.9, 0.999, 1e-8
NORM_EPS = 1e-5
COS_EPS, ACOS_CLIP = 1e-8, 1e-7


def _acos_score(cos):
    return 1.0 - torch.acos(torch.clamp(cos, -1.0 + ACOS_CLIP, 1.0 - ACOS_CLIP)) / math.pi


def word_log_prob(c, vocab, vnorm, ids, tok_w, tok_mask):
    """``(S, B)`` word term of latents ``c`` ``(S, B, D)`` for each row's
    tokens ``ids`` ``(S, B, T)``."""
    cn = torch.linalg.vector_norm(c, dim=-1, keepdim=True)  # (S, B, 1)
    cos_v = (c @ vocab.T) / torch.clamp_min(cn * vnorm, COS_EPS)
    z = torch.sum(_acos_score(cos_v), dim=-1, keepdim=True)  # (S, B, 1)
    alpha = 1.0 / (1e-3 * z + 1.0)
    dots = torch.einsum("sbtd,sbd->sbt", vocab[ids], c)
    cos_t = dots / torch.clamp_min(vnorm[ids] * cn, COS_EPS)
    p = alpha * tok_w + (1.0 - alpha) * _acos_score(cos_t) / z
    return torch.sum(torch.log(p) * tok_mask, dim=-1)


def normed(c, scale, bias, is_batch, rows):
    """LayerNorm, or BatchNorm over the ``rows``-weighted rows, per config."""
    ln = (c - c.mean(-1, keepdim=True)) / torch.sqrt(
        c.var(-1, keepdim=True, correction=0) + NORM_EPS)
    w = rows[..., None]
    n = torch.clamp_min(w.sum(-2, keepdim=True), 1.0)
    mean = (c * w).sum(-2, keepdim=True) / n
    var = (torch.square(c - mean) * w).sum(-2, keepdim=True) / n
    bn = (c - mean) / torch.sqrt(var + NORM_EPS)
    x = torch.where(is_batch[:, None, None], bn, ln)
    return x * scale[:, None, :] + bias[:, None, :]


def neg_joint(c, dec, hp, batch, rows, words):
    """``(S, B)`` negative weighted joint log-likelihood."""
    x = normed(c, dec["scale"], dec["bias"], hp["is_batch"], rows)
    mu = x @ dec["w_mu"] + dec["b_mu"][:, None, :]
    sigma = torch.exp(x @ dec["w_ls"] + dec["b_ls"][:, None, :])
    sig_sq = torch.square(sigma)[:, :, None, :]  # (S, B, 1, F)
    dens = -0.5 * (LOG_2PI + torch.log(sig_sq)) - torch.square(
        batch["obs"] - mu[:, :, None, :]) / (2.0 * sig_sq)
    mask = batch["obs_mask"] * hp["cols"][:, None, None, :]
    gauss = torch.sum(dens * mask, dim=(-1, -2))
    w = hp["word_w"][:, None]
    word = word_log_prob(c, words["vocab"], words["vnorm"], batch["ids"], batch["tok_w"],
                         batch["tok_mask"])
    return -(gauss * (1.0 - w) / len(MMB2_HEADS) + w * word)


def senti(p, c):
    out = torch.relu(c @ p["w1"] + p["b1"][:, None, :]) @ p["w2"] + p["b2"][:, None, :]
    return out[..., 0] if out.shape[-1] == 1 else out


def l1(pred, y):
    err = torch.abs(pred - y)
    return err.mean(-1) if err.ndim == 3 else err


class Adam:
    """Dense Adam over a dict of ``(S, ...)`` tensors at per-config rates."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: torch.Tensor):
        self.lr, self.t = lr, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params, grads):
        self.t += 1
        bc1, bc2 = 1.0 - B1 ** self.t, 1.0 - B2 ** self.t
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.m[k] = B1 * self.m[k] + (1.0 - B1) * g
            self.v[k] = B2 * self.v[k] + (1.0 - B2) * torch.square(g)
            lr = self.lr.reshape(-1, *([1] * (p.ndim - 1)))
            out[k] = p - lr * (self.m[k] / bc1) / (torch.sqrt(self.v[k] / bc2) + EPS)
        return out


def _rows_of(split: dict, j: torch.Tensor) -> dict:
    """The batch's data at rows ``j`` ``(S, B)``."""
    return {k: split[k][j] for k in ("obs", "obs_mask", "ids", "tok_w", "tok_mask")}


def _batches(n: int, bsz: int):
    for s in range(0, n, bsz):
        yield slice(s, s + bsz), min(bsz, n - s)


def stack_decoder(decs: List[dict], device) -> dict:
    """The configs' decoders with the heads side by side (the observation
    columns' order), stacked over the configs."""
    def cat(key):
        return torch.stack([torch.cat([d["heads"][h][key] for h in MMB2_HEADS], -1)
                            for d in decs]).to(device)

    return {"w_mu": cat("w_mu"), "b_mu": cat("b_mu"), "w_ls": cat("w_log_sigma"),
            "b_ls": cat("b_log_sigma"),
            "scale": torch.stack([d["norm"]["scale"] for d in decs]).to(device),
            "bias": torch.stack([d["norm"]["bias"] for d in decs]).to(device)}


def fit_latents(init, dec, hp, split, words, epochs, bsz, perms=None, sen=None, y=None):
    """The latent fit of ``init`` ``(S, N, D)``: e2e with ``sen`` and
    labels ``y`` (decoder, head and latents by Adam over ``perms``), else
    likelihood-only against the frozen decoder, unshuffled.  Returns
    ``(latents, decoder, losses)``, ``losses`` ``(S, epochs)``."""
    s_cfg, n, _ = init.shape
    dev = init.device
    c = init.clone()
    lat_opt = Adam({"c": c}, hp["lr"])
    e2e = sen is not None
    if e2e:
        dec_opt, sen_opt = Adam(dec, hp["lr"]), Adam(sen, hp["lr"])
    cfg = torch.arange(s_cfg, device=dev)[:, None]
    losses = []
    for e in range(epochs):
        order = perms[e] if e2e else torch.arange(n, device=dev).expand(s_cfg, n)
        total = torch.zeros(s_cfg, device=dev)
        for blk, count in _batches(n, bsz):
            j = order[:, blk]  # (S, count)
            pad = bsz - count
            if pad:
                j = torch.cat([j, torch.zeros(s_cfg, pad, dtype=j.dtype, device=dev)], 1)
            rows = (torch.arange(bsz, device=dev) < count).to(torch.float32)
            cb = c[cfg, j].detach().requires_grad_()
            batch = _rows_of(split, j)
            if e2e:
                dec = {k: v.detach().requires_grad_() for k, v in dec.items()}
                sen = {k: v.detach().requires_grad_() for k, v in sen.items()}
                lw = hp["lik_w"][:, None]
                per = lw * neg_joint(cb, dec, hp, batch, rows, words) + (1.0 - lw) * l1(
                    senti(sen, cb), y[j])
            else:
                per = neg_joint(cb, dec, hp, batch, rows, words)
            loss = torch.sum(per * rows, dim=-1) / count
            wrt = [cb] + (list(dec.values()) + list(sen.values()) if e2e else [])
            grads = torch.autograd.grad(loss.sum(), wrt)
            # pad rows repeat row 0 with a zero gradient: indices repeat, so add
            g = torch.zeros_like(c).index_put_((cfg.expand_as(j), j), grads[0], accumulate=True)
            c = lat_opt.step({"c": c}, {"c": g})["c"]
            if e2e:
                gd = dict(zip(dec, grads[1:1 + len(dec)]))
                gs = dict(zip(sen, grads[1 + len(dec):]))
                dec = dec_opt.step({k: v.detach() for k, v in dec.items()}, gd)
                sen = sen_opt.step({k: v.detach() for k, v in sen.items()}, gs)
            total = total + loss.detach()
        losses.append(total)
    return c, {k: v.detach() for k, v in dec.items()}, torch.stack(losses, -1)


@torch.no_grad()
def fit_sentiment(p, train_e, y, lr, perms, epochs, bsz=32):
    """Plain SGD on the L1 batch mean, its gradients written out (the MLP's
    two layers; ``sign`` is the L1 error's derivative, 0 at 0, and a ReLU
    passes where its input is positive); returns the last parameters and
    each epoch's mean of its batches' losses, ``(S, epochs)``."""
    s_cfg, n, _ = train_e.shape
    dev = train_e.device
    cfg = torch.arange(s_cfg, device=dev)[:, None]
    w1, b1, w2, b2 = (p[k].clone() for k in ("w1", "b1", "w2", "b2"))
    n_out = w2.shape[-1]
    ys = y if y.ndim == 2 else y[:, None]
    lr3, lr2 = lr[:, None, None], lr[:, None]
    losses = []
    for e in range(epochs):
        total = torch.zeros(s_cfg, device=dev)
        batches = 0
        for blk, count in _batches(n, bsz):
            j = perms[e][:, blk]
            x = train_e[cfg, j]  # (S, b, D)
            pre = x @ w1 + b1[:, None, :]
            h = torch.relu(pre)
            err = h @ w2 + b2[:, None, :] - ys[j]  # (S, b, O)
            total += err.abs().sum((1, 2)) / (count * n_out)
            batches += 1
            g = torch.sign(err) / (count * n_out)
            gh = (g @ w2.transpose(1, 2)) * (pre > 0)
            w2 = w2 - lr3 * (h.transpose(1, 2) @ g)
            b2 = b2 - lr2 * g.sum(1)
            w1 = w1 - lr3 * (x.transpose(1, 2) @ gh)
            b1 = b1 - lr2 * gh.sum(1)
        losses.append(total / batches)
    return {"w1": w1, "b1": b1, "w2": w2, "b2": b2}, torch.stack(losses, -1)


def _round_match(a, b):
    return (torch.round(a) == torch.round(b)).to(torch.float32).mean(-1)


def _pearson(p, y):
    pc, yc = p - p.mean(-1, keepdim=True), y - y.mean(-1, keepdim=True)
    return (pc * yc).sum(-1) / torch.sqrt((pc * pc).sum(-1) * (yc * yc).sum(-1))


def _weighted_f1(y_true, y_pred):
    """sklearn's weighted F1 over the rounded classes (bins -20..20, NaN to
    the lowest), rows of the last axis."""
    def bins(x):
        return torch.where(torch.isnan(x), 0.0, torch.clamp(x + 20, 0, 40)).to(torch.long)
    t, p = torch.round(y_true), torch.round(y_pred)
    t_onehot = torch.nn.functional.one_hot(bins(t), 41).to(torch.float32)
    true_c = t_onehot.sum(-2)
    pred_c = torch.nn.functional.one_hot(bins(p), 41).to(torch.float32).sum(-2)
    tp = (t_onehot * (t == p).to(torch.float32)[..., None]).sum(-2)
    prec = torch.where(pred_c > 0, tp / torch.clamp_min(pred_c, 1.0), 0.0)
    rec = torch.where(true_c > 0, tp / torch.clamp_min(true_c, 1.0), 0.0)
    f1 = torch.where(prec + rec > 0, 2 * prec * rec / torch.clamp_min(prec + rec, 1e-30), 0.0)
    return (f1 * true_c).sum(-1) / torch.clamp_min(true_c.sum(-1), 1.0)


def scores(pred, y, dataset: str) -> Dict[str, torch.Tensor]:
    """The baselines' test metrics (f_score with the predictions in the
    true labels' place, as their code calls it); POM's per trait."""
    if dataset == "pom":  # traits on the last axis: score each over the rows
        pred, y = pred.transpose(-1, -2), y.T
        return {"mae": torch.abs(pred - y).mean(-1), "corr": _pearson(pred, y),
                "mult_acc": _round_match(pred, y), "f_score": _weighted_f1(pred, y)}
    return {"mae": torch.abs(pred - y).mean(-1), "corr": _pearson(pred, y),
            "mult_acc": _round_match(pred, y), "f_score": _weighted_f1(pred, y),
            "accuracy": ((pred >= 0) == (y >= 0)).to(torch.float32).mean(-1)}


def hyper(configs: List[dict], prep: Dict) -> Dict[str, torch.Tensor]:
    """The configs' hyperparameters, one entry per config."""
    if any(c["norm"] not in ("layer_norm", "batch_norm") for c in configs):
        raise ValueError("the grid's norms are layer_norm and batch_norm")
    dev = prep["vocab"].device
    f32 = dict(dtype=torch.float32, device=dev)
    return {"lr": torch.tensor([c["lr"] for c in configs], **f32),
            "word_w": torch.tensor([c["word_loss_weight"] for c in configs], **f32),
            "lik_w": torch.tensor([c["likelihood_weight"] for c in configs], **f32),
            "s_lr": torch.tensor([c["sentiment_lr"] for c in configs], **f32),
            "is_batch": torch.tensor([c["norm"] == "batch_norm" for c in configs], device=dev),
            "cols": torch.stack([pos_column_mask(prep, int(c["pos_embed_dim"]))
                                 for c in configs])}


def _words(prep: Dict) -> dict:
    return {"vocab": prep["vocab"], "vnorm": torch.linalg.vector_norm(prep["vocab"], dim=-1)}


def _senti_init(configs, draws, prep) -> dict:
    d = prep["train"]["init"].shape[1]
    y = prep["train"]["label"]
    n_out = 1 if y.ndim == 1 else y.shape[-1]
    hidden = max(int(c["sentiment_hidden_size"]) for c in configs)
    sens = [dr.init_sentiment(d, int(c["sentiment_hidden_size"]), n_out, hidden)
            for dr, c in zip(draws, configs)]
    return {k: torch.stack([s[k] for s in sens]).to(prep["vocab"].device) for k in sens[0]}


def train(configs: List[dict], draws: list, prep: Dict, batch_size: int = 64) -> dict:
    """The whole joint fit of each config from its draws (the decoder, the
    e2e head and the permutations): ``losses`` ``(S, epochs)``, the trained
    ``latents`` ``(S, N, D)`` and ``decoder`` and the initial ``decoder0``
    (:func:`flat_decoder`'s layout)."""
    dev = prep["vocab"].device
    tr = prep["train"]
    n, d = tr["init"].shape
    pos_w = sum(prep["pos_dims"])
    dec0 = stack_decoder([dr.init_decoder(d, _stream_width(prep, "audio") + pos_w,
                                          _stream_width(prep, "visual") + pos_w, False,
                                          _stream_width(prep, "text")) for dr in draws], dev)
    epochs = {int(c["n_epochs"]) for c in configs}.pop()
    perms = torch.stack([torch.stack(dr.train_permutations(n, epochs)) for dr in draws], 1)
    c, dec, losses = fit_latents(tr["init"].expand(len(configs), n, d), dec0,
                                 hyper(configs, prep), tr, _words(prep), epochs, batch_size,
                                 perms.to(dev), _senti_init(configs, draws, prep), tr["label"])
    return {"losses": losses, "latents": c, "decoder": dec, "decoder0": dec0}


def flat_decoder(decoder: dict) -> dict:
    """A decoder in the program's per-head layout (leading config axis) with
    the heads side by side, as :func:`stack_decoder` lays them out."""
    heads = decoder["heads"]
    cat = lambda key: torch.cat([heads[h][key] for h in MMB2_HEADS], -1)  # noqa: E731
    return {"w_mu": cat("w_mu"), "b_mu": cat("b_mu"), "w_ls": cat("w_log_sigma"),
            "b_ls": cat("b_log_sigma"), "scale": decoder["norm"]["scale"],
            "bias": decoder["norm"]["bias"]}


def infer(configs: List[dict], dec: dict, prep: Dict, split: str,
          batch_size: int = 512) -> torch.Tensor:
    """``(S, N, D)``: the split's latents fitted likelihood-only from their
    SIF init against the decoder ``dec`` (:func:`flat_decoder`'s layout),
    frozen, for each config's epochs."""
    sp = prep[split]
    m, d = sp["init"].shape
    epochs = {int(c["n_epochs"]) for c in configs}.pop()
    return fit_latents(sp["init"].expand(len(configs), m, d), dec, hyper(configs, prep), sp,
                       _words(prep), epochs, batch_size)[0]


def sentiment(configs: List[dict], draws: list, prep: Dict, train_e: torch.Tensor,
              epochs: int) -> torch.Tensor:
    """The first ``epochs`` epoch losses ``(S, epochs)`` of the sentiment
    MLP's plain SGD on ``train_e`` ``(S, N, D)``, from its initial draw."""
    n = train_e.shape[1]
    full = {int(c["n_sentiment_epochs"]) for c in configs}.pop()
    perms = torch.stack([torch.stack(dr.sentiment_permutations(n, full)[:epochs])
                         for dr in draws], 1)
    return fit_sentiment(_senti_init(configs, draws, prep), train_e, prep["train"]["label"],
                         hyper(configs, prep)["s_lr"], perms.to(train_e.device), epochs)[1]


def score(params: dict, test_e: torch.Tensor, prep: Dict, dataset: str):
    """``(predictions, metrics)`` of the MLP ``params`` on ``test_e``."""
    with torch.no_grad():
        pred = senti(params, test_e)
    return pred, scores(pred, prep["test"]["label"], dataset)


def _stream_width(prep: Dict, stream: str) -> int:
    """The base stream's feature width, read off the observation layout."""
    for tag, _, w in prep["layout"]:
        if tag == stream:
            return w
    raise KeyError(stream)
