"""Closed-form serving: latent embeddings for new utterances without a
gradient loop (port of :mod:`mmtpu.serve`).

- :class:`ClosedFormServer` holds trained decoder weights on its device,
  right-pads each request to the smallest size of a ladder, inverts the
  decoder in closed form (:func:`mmtpu_torch.ops.closed_form.closed_form_latents`)
  and returns L2-normalised latents, with the sentiment head's predictions
  when it has one.
- :func:`stats_request` compresses a request to the Gaussian sufficient
  statistics on the host (an about L/3-fold smaller payload on those
  streams); the server answers it from the statistics
  (:func:`mmtpu_torch.train.warm_start.closed_form_latents_from_stats`),
  with the same estimate as from the raw streams when no masks are given.

mmtpu compiles one program per ladder size; here, on the card, each ladder
size and request form (raw or statistics, and the request's keys) is one
CUDA graph (:mod:`mmtpu_torch.graphs`): :meth:`ClosedFormServer.warmup`
warms each size up and captures it, and a request copies its padded arrays
into the size's static inputs, replays, and copies the answer out.  A
request larger than the ladder's largest size runs eagerly at its own size,
as one call, as in mmtpu.
"""

from __future__ import annotations

import bisect
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from mmtpu_torch.models.decoder import assemble_head_data
from mmtpu_torch.models.sentiment import apply_sentiment
from mmtpu_torch.ops.closed_form import closed_form_latents
from mmtpu_torch.graphs import Graphs, use_graphs
from mmtpu_torch.train.warm_start import closed_form_latents_from_stats
from mmtpu_torch.tree import tree_map


def stats_request(batch: Mapping[str, np.ndarray],
                  masks: Optional[Mapping[str, np.ndarray]] = None) -> Dict[str, np.ndarray]:
    """A raw request compressed to sufficient statistics, on the host.

    Each ``(B, L, F)`` Gaussian stream becomes its ``(B, F)``
    ``_s0/_s1/_s2`` triplet (sums in float64, stored float32); the word
    inputs (``text_ids`` / ``text``, ``text_weights``) pass through.
    ``masks=None`` sums every timestep, as the raw estimator does with its
    ignored mask; per-stream masks leave the padding out instead.
    """
    out: Dict[str, np.ndarray] = {k: np.asarray(batch[k])
                                  for k in ("text_ids", "text", "text_weights") if k in batch}
    for stream in ("text_gauss", "audio", "visual"):
        x = np.asarray(batch[stream])
        m = None if masks is None else masks.get(stream)
        if m is None:
            s0 = np.full(x.shape[:1] + x.shape[2:], x.shape[1], np.float32)
            xd = x.astype(np.float64)
            s1 = xd.sum(1).astype(np.float32)
            s2 = (xd * xd).sum(1).astype(np.float32)
        else:
            m3 = np.asarray(m)
            if m3.ndim == 2:
                m3 = m3[:, :, None]
            mv = (m3 * x).astype(np.float64)
            s0 = np.broadcast_to(m3, x.shape).sum(1).astype(np.float32)
            s1 = mv.sum(1).astype(np.float32)
            s2 = (mv * x).sum(1).astype(np.float32)
        out[f"{stream}_s0"], out[f"{stream}_s1"], out[f"{stream}_s2"] = s0, s1, s2
    return out


class ClosedFormServer:
    """Batch serving of the closed-form latent estimator on one device.

    Args:
        decoder_params: trained decoder (:mod:`mmtpu_torch.models.decoder`).
        heads: the heads to invert (default: every head of the decoder).
        batch_sizes: the padding ladder; a request is right-padded with zeros
            to the smallest size that holds it.
        sentiment_params: optional sentiment MLP, chained on the latents.
        word_embeddings: optional ``(V, D)`` vocabulary, so that requests may
            carry ``text_ids`` in place of gathered ``text`` vectors.
        device: where the weights live and requests run (``"cuda"`` by
            default; asking for CUDA where there is none raises).
        graphs: :func:`mmtpu_torch.graphs.use_graphs`'s argument: True
            (the default) captures one graph per ladder size and form on
            the card and runs eagerly on the CPU; False runs eagerly on the
            card.
    """

    def __init__(self, decoder_params, heads: Optional[Sequence[str]] = None,
                 batch_sizes: Sequence[int] = (64, 256, 1024), sentiment_params=None,
                 word_embeddings=None, device="cuda", graphs: bool = True):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False")
        move = lambda t: torch.as_tensor(t).to(self.device)  # noqa: E731
        self.heads = tuple(heads or decoder_params["heads"].keys())
        self._head_params = {h: tree_map(move, decoder_params["heads"][h]) for h in self.heads}
        self.batch_sizes = sorted(batch_sizes)
        self._senti = None if sentiment_params is None else tree_map(move, sentiment_params)
        self._vocab = None if word_embeddings is None else move(word_embeddings)
        self._graphs = Graphs(self.device, use_graphs(graphs, self.device))

    def _chain(self, lat):
        return lat, (None if self._senti is None else apply_sentiment(self._senti, lat))

    def _check_text(self, streams) -> None:
        if "text" not in streams and self._vocab is None:
            raise ValueError("request carries text_ids but the server was built without "
                             "word_embeddings — pass the (V, D) vocab table at construction, "
                             "or send pre-gathered 'text'")

    def _sent(self, streams):
        self._check_text(streams)
        return streams["text"] if "text" in streams else self._vocab[streams["text_ids"]]

    def _run(self, streams):
        lat = closed_form_latents(assemble_head_data(streams, self.heads), self._head_params,
                                  streams["text_weights"], self._sent(streams))
        return self._chain(lat)

    def _run_stats(self, req):
        self._check_text(req)
        lat = closed_form_latents_from_stats({"heads": self._head_params}, req, self._vocab,
                                             heads=self.heads)
        return self._chain(lat)

    def warmup(self, example: Mapping) -> None:
        """Run every ladder size from one example request: once eagerly and,
        on the card, once more to capture the size's graph for the
        example's form."""
        for bs in self.batch_sizes:
            for _ in range(2 if self._graphs.enabled else 1):
                self(example, _force_batch=bs)

    def _pad(self, x, target: int) -> torch.Tensor:
        """``x`` on the device with ``target`` rows: a float32 or int64 device
        tensor of the target size passes through untouched; anything else is
        converted, moved and zero-padded at the end."""
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
        # float32 values and int64 indices (no-ops for tensors that are so already)
        t = (t.float() if t.is_floating_point() else t.long()).to(self.device)
        if t.shape[0] == target:
            return t
        return torch.cat([t, t.new_zeros((target - t.shape[0], *t.shape[1:]))])

    @torch.no_grad()
    def __call__(self, batch: Mapping, _force_batch: Optional[int] = None):
        """Serve one request.

        Args:
            batch: ``text_gauss`` (B, L, Tg), ``audio`` (B, L, A), ``visual``
                (B, L, V), ``text_weights`` (B, Lt) and either ``text_ids``
                (B, Lt) (with ``word_embeddings`` at construction) or
                gathered ``text`` (B, Lt, D); or a :func:`stats_request`
                (``<stream>_s0/s1/s2`` in place of the raw streams, told
                apart by the ``audio_s0`` key).  numpy arrays or tensors.

        Returns:
            ``(latents (B, D), predictions or None)`` as numpy, padding
            stripped.
        """
        b = batch["audio_s0" if "audio_s0" in batch else "audio"].shape[0]
        if _force_batch is not None:
            target = _force_batch
        else:
            i = bisect.bisect_left(self.batch_sizes, b)
            target = self.batch_sizes[i] if i < len(self.batch_sizes) else b
        padded = {k: self._pad(v, target) for k, v in batch.items()}
        run = self._run_stats if "audio_s0" in batch else self._run
        if target in self.batch_sizes:  # a ladder size: its graph on the card
            lat, pred = self._graphs(run.__name__, run, padded)
        else:
            lat, pred = run(padded)
        lat = lat.cpu().numpy()[:b]
        return lat, (None if pred is None else pred.cpu().numpy()[:b])
