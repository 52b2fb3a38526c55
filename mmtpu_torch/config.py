"""Typed experiment configuration + hyperparameter grid generation (the
port's copy of :mod:`mmtpu.config`: the same grid, order and seeded shuffle).

Replaces the reference's untyped JSON-merged ``args`` dict (``read_config`` /
``parse_arguments``, ``simplesif.py:177-238``) with a dataclass carrying the
same keys, plus the grid generator of ``configs/make_configs.py`` with exact
axis parity (512 configs).  Unlike the reference's unseeded
``random.shuffle`` (``make_configs.py:53``), the shuffle here is seeded for
reproducibility.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import random
from typing import List, Optional

# the reference grid (configs/make_configs.py:16-32), key order preserved —
# the Cartesian-product enumeration order depends on it.
GRID_PARAMS = {
    "sentiment_hidden_size": [100, 150],
    "lr": [1e-3, 1e-4],
    "sentiment_lr": [1e-1, 1e-2],
    "seq_len": [20],
    "word_sim_metric": ["angular"],
    "n_epochs": [100, 200],
    "freeze_weights": [False],
    "n_sentiment_epochs": [400],
    "word_loss_weight": [0.001, 0.002],
    "likelihood_weight": [0.0001, 0.001],
    "pos_embed_dim": [2, 4],
    "e2e": [True],
    "norm": ["layer_norm", "batch_norm"],
    "optimizer": ["sgd", "adam"],
}


@dataclasses.dataclass
class ExperimentConfig:
    """One experiment = the reference's merged config JSON + CLI flags."""

    # --- grid keys (config JSON) ---
    sentiment_hidden_size: int = 100
    lr: float = 1e-3
    sentiment_lr: float = 1e-1
    seq_len: int = 20
    word_sim_metric: str = "angular"
    n_epochs: int = 100
    freeze_weights: bool = False
    n_sentiment_epochs: int = 400
    word_loss_weight: float = 0.001
    likelihood_weight: float = 0.0001
    pos_embed_dim: int = 2
    e2e: bool = True
    norm: Optional[str] = None  # None | 'layer_norm' | 'batch_norm'
    optimizer: str = "sgd"
    config_num: int = 0

    # --- CLI-layer keys (simplesif.py:186-238) ---
    dataset: str = "mosi"
    unimodal: bool = False  # --unimodal → MMB1
    batch_size: int = 64
    n_runs: int = 1
    semi_sup_idxes: Optional[str] = None  # '0.1'..'0.9'
    config_name: Optional[str] = None
    lr_decay: float = 0.5
    early_stopping: bool = False
    emotion: Optional[str] = None  # iemocap emotion

    # --- mmtpu extensions ---
    parity: bool = False  # reproduce reference bugs (pos-embed indexing)
    seed: int = 0
    use_pallas: bool = False  # fused Pallas kernel for the angular partition

    @classmethod
    def from_json(cls, path: str, **overrides) -> "ExperimentConfig":
        """Load a config JSON (reference format) + apply CLI-style overrides.

        Mirrors the merge semantics of ``parse_arguments``
        (``simplesif.py:210-238``): JSON keys update the base args; explicit
        overrides win over JSON; ``e2e`` accepts 'y'/'n' strings.
        """
        raw = json.load(open(path))
        return cls.from_dict(raw, **overrides)

    @classmethod
    def from_dict(cls, raw: dict, **overrides) -> "ExperimentConfig":
        merged = dict(raw)
        merged.update({k: v for k, v in overrides.items() if v is not None})
        if merged.get("e2e") == "y":
            merged["e2e"] = True
        elif merged.get("e2e") == "n":
            merged["e2e"] = False
        if "sentiment_epochs" in merged:  # CLI alias (simplesif.py:235-236)
            if merged["sentiment_epochs"]:
                merged["n_sentiment_epochs"] = merged["sentiment_epochs"]
            del merged["sentiment_epochs"]
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in merged.items() if k in fields})

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, path: str) -> None:
        json.dump(self.to_dict(), open(path, "w"), indent=2)


def make_grid(shuffle_seed: Optional[int] = 0) -> List[dict]:
    """Enumerate the full Cartesian grid (make_configs.py:40-59): 512 configs,
    shuffled, each stamped with its ``config_num``."""
    keys = list(GRID_PARAMS.keys())
    configs = [
        dict(zip(keys, combo)) for combo in itertools.product(*GRID_PARAMS.values())
    ]
    if shuffle_seed is not None:
        random.Random(shuffle_seed).shuffle(configs)
    for i, c in enumerate(configs):
        c["config_num"] = i
    return configs


def write_grid(folder: str, shuffle_seed: Optional[int] = 0) -> int:
    """Materialize ``config_<i>.json`` files + an index CSV, like
    ``configs/make_configs.py``.  Returns the number of configs written."""
    import csv
    import os

    os.makedirs(folder, exist_ok=True)
    configs = make_grid(shuffle_seed)
    with open(os.path.join(folder, "index.csv"), "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(GRID_PARAMS) + ["config_num"])
        writer.writeheader()
        for c in configs:
            with open(os.path.join(folder, f"config_{c['config_num']}.json"), "w") as g:
                json.dump(c, g)
            writer.writerow(c)
    return len(configs)
