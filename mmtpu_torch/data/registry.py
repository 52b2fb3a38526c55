"""Dataset registry (the port's copy of :mod:`mmtpu.data.registry`): real
HDF5/npy ingestion with synthetic fallback.

File layout mirrors the reference exactly (``utils.py:10-128``):

- MOSI  (``load_mosi``, utils.py:20-50): ``mosi/word2ix_300_mosi.pkl``,
  ``mosi/glove_300_mosi.npy``, ``data/mosi_data.h5`` with groups
  train/valid/test and keys facet/covarep/text/lengths/label/id;
  word weights from ``word_weights.npy`` or the enwiki frequency file
  (``sif.py:14-32,54-76``).
- POM   (``load_pom``, utils.py:52-90): ``pom/glove_mappings.pom.json``,
  ``pom/glove.pom.npy``, ``data/pom_data.h5`` (facet/covarep/text/label),
  ``pom/pom_{train,valid,test}_ids.npy``, ``pom/pom_word_weights.npy``.
- IEMOCAP (``load_iemocap``, utils.py:92-128): per-emotion
  ``data/iemocap_<emotion>.h5`` + ``iemocap/*`` glove/ids/weights.

Since the large blobs are not vendored upstream, ``load_dataset`` falls back
to :func:`mmtpu_torch.data.synthetic.synthesize_dataset` (flagged in the result)
unless ``require_real=True``.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, Optional

import numpy as np

from mmtpu_torch.data.synthetic import synthesize_dataset

DATASETS = ("mosi", "pom", "iemocap")

SIF_A = 1e-3  # sif.py:14 default


def compute_word_weights_from_freq_file(
    path: str, word2ix: Dict[str, int], a: float = SIF_A
) -> np.ndarray:
    """Vectorized equivalent of ``sif.py:14-32`` + the cold path of
    ``sif.py:54-76``: ``a / (a + p(w))`` from a "word count" frequency file;
    unknown words get weight 1."""
    freqs: Dict[str, float] = {}
    total = 0.0
    with open(path, "r") as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) == 2:
                freqs[parts[0]] = float(parts[1])
                total += float(parts[1])
    weights = np.ones(max(word2ix.values()) + 1, dtype=np.float64)
    for word, ix in word2ix.items():
        p = freqs.get(word.lower())
        if p is not None:
            weights[ix] = a / (a + p / total)
    return weights


def _load_h5_splits(path: str, keys) -> Dict[str, Dict[str, np.ndarray]]:
    import h5py

    out: Dict[str, Dict[str, np.ndarray]] = {}
    with h5py.File(path, "r") as f:
        for split in ("train", "valid", "test"):
            out[split] = {k: f[split][k][:] for k in keys}
    return out


def load_dataset(
    name: str,
    data_dir: str = ".",
    emotion: Optional[str] = None,
    require_real: bool = False,
    synthetic_seed: int = 0,
) -> Dict:
    """Load a dataset as ``{name, word_embeddings, word_weights, splits,
    word2ix?, synthetic: bool}``.

    ``data_dir`` is the reference repo-root convention: ``<data_dir>/data/*.h5``
    plus ``<data_dir>/{mosi,pom,iemocap}/`` sidecar files.
    """
    if name not in DATASETS:
        raise ValueError(f"unknown dataset {name!r}; expected one of {DATASETS}")
    try:
        if name == "mosi":
            return _load_mosi(data_dir)
        if name == "pom":
            return _load_pom(data_dir)
        return _load_iemocap(data_dir, emotion or "happy")
    except (FileNotFoundError, OSError, KeyError) as e:
        if require_real:
            raise
        ds = synthesize_dataset(name, seed=synthetic_seed)
        ds["synthetic"] = True
        ds["fallback_reason"] = f"{type(e).__name__}: {e}"
        return ds


def _load_mosi(root: str) -> Dict:
    word2ix = pickle.load(open(os.path.join(root, "mosi/word2ix_300_mosi.pkl"), "rb"))
    we = np.load(os.path.join(root, "mosi/glove_300_mosi.npy"), allow_pickle=False)
    splits = _load_h5_splits(
        os.path.join(root, "data/mosi_data.h5"),
        ["facet", "covarep", "text", "lengths", "label", "id"],
    )
    ww_path = os.path.join(root, "word_weights.npy")
    if os.path.isfile(ww_path):
        ww = np.load(ww_path, allow_pickle=False).squeeze()
    else:
        ww = compute_word_weights_from_freq_file(
            os.path.join(root, "SIF/auxiliary_data/enwiki_vocab_min200.txt"), word2ix
        )
        # cache write-back so the cold path runs once (sif.py:54-76 semantics,
        # minus its word2ix NameError); best-effort — a read-only data_dir is fine
        try:
            np.save(ww_path, ww)
        except OSError:
            pass
    return {
        "name": "mosi", "word2ix": word2ix, "word_embeddings": we,
        "word_weights": ww, "splits": splits, "synthetic": False,
    }


def _load_pom(root: str) -> Dict:
    word2ix = json.load(open(os.path.join(root, "pom/glove_mappings.pom.json")))
    we = np.load(os.path.join(root, "pom/glove.pom.npy"))
    splits = _load_h5_splits(
        os.path.join(root, "data/pom_data.h5"),
        ["facet", "covarep", "text", "label"],
    )
    for split in ("train", "valid", "test"):
        ids = np.load(
            os.path.join(root, f"pom/pom_{split}_ids.npy"), allow_pickle=False
        )
        splits[split]["text_id"] = ids
    ww = np.load(os.path.join(root, "pom/pom_word_weights.npy")).squeeze()
    return {
        "name": "pom", "word2ix": word2ix, "word_embeddings": we,
        "word_weights": ww, "splits": splits, "synthetic": False,
    }


def _load_iemocap(root: str, emotion: str) -> Dict:
    word2ix = json.load(open(os.path.join(root, "iemocap/glove_mappings.iemocap.json")))
    we = np.load(os.path.join(root, "iemocap/glove.iemocap.npy"))
    splits = _load_h5_splits(
        os.path.join(root, f"data/iemocap_{emotion}.h5"),
        ["facet", "covarep", "text", "label"],
    )
    for split in ("train", "valid", "test"):
        ids = np.load(
            os.path.join(root, f"iemocap/iemocap_{split}_ids.npy"),
            allow_pickle=False,
        )
        splits[split]["text_id"] = ids
    ww = np.load(os.path.join(root, "iemocap/iemocap_word_weights.npy")).squeeze()
    return {
        "name": "iemocap", "word2ix": word2ix, "word_embeddings": we,
        "word_weights": ww, "splits": splits, "synthetic": False,
    }
