"""Artifact store keeping mmtpu's (and the reference's) directory contract
(port of :mod:`mmtpu.io.artifacts`)::

    <root>/<config_name>/config_<n>_run_<r>/
        config.json
        embed_loss.txt, embed_valid_loss.txt, embed_test_loss.txt
        {pre,post}/embed.npy
        {pre,post}/senti.npz
        {pre,post}/senti_train_loss.txt, senti_valid_loss.txt
        {pre,post}/test_acc_{before,after}.txt, acc_{before,after}.txt
        {pre,post}/test_results_{before,after}.json

``senti.npz`` holds leaves ``p0..pN`` in ``jax.tree.flatten`` order (dict keys
sorted), so a file written by either package loads in the other.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Mapping

import numpy as np

from mmtpu_torch.convert import to_numpy
from mmtpu_torch.tree import tree_leaves, tree_unflatten


class ArtifactStore:
    """One run's artifact folder (``<root>/<name>/config_<n>_run_<r>``)."""

    def __init__(self, root: str, config_name: str, config_num: int, run_idx: int = 0):
        self.folder = os.path.join(root, config_name, f"config_{config_num}_run_{run_idx}")
        self.pre = os.path.join(self.folder, "pre")
        self.post = os.path.join(self.folder, "post")
        os.makedirs(self.pre, exist_ok=True)
        os.makedirs(self.post, exist_ok=True)

    def save_config(self, config: Mapping) -> None:
        with open(os.path.join(self.folder, "config.json"), "w") as f:
            json.dump(dict(config), f, indent=2)

    def save_embeddings(self, which: str, embeddings) -> None:
        np.save(os.path.join(getattr(self, which), "embed.npy"), to_numpy(embeddings))

    def save_losses(self, name: str, losses: Iterable[float]) -> None:
        with open(os.path.join(self.folder, f"{name}.txt"), "w") as f:
            for loss in to_numpy(losses):
                f.write(f"{float(loss)}\n")

    def save_sentiment_losses(self, which: str, train_losses, valid_losses) -> None:
        for nm, arr in (("senti_train_loss", train_losses), ("senti_valid_loss", valid_losses)):
            with open(os.path.join(getattr(self, which), f"{nm}.txt"), "w") as f:
                for loss in to_numpy(arr):
                    f.write(f"{float(loss)}\n")

    def save_results(self, which: str, stage: str, results: Mapping) -> None:
        base = getattr(self, which)
        if "accuracy" in results:
            for prefix in ("test_acc", "acc"):
                with open(os.path.join(base, f"{prefix}_{stage}.txt"), "w") as f:
                    f.write(str(results["accuracy"]))
        with open(os.path.join(base, f"test_results_{stage}.json"), "w") as f:
            json.dump(results, f, indent=2)

    def save_sentiment_model(self, which: str, params) -> None:
        leaves = tree_leaves(to_numpy(params))
        np.savez(os.path.join(getattr(self, which), "senti.npz"),
                 **{f"p{i}": leaf for i, leaf in enumerate(leaves)})

    def load_sentiment_model(self, which: str, like) -> object:
        """numpy leaves arranged like ``like``."""
        data = np.load(os.path.join(getattr(self, which), "senti.npz"))
        n = len(tree_leaves(like))
        return tree_unflatten(like, [data[f"p{i}"] for i in range(n)])
