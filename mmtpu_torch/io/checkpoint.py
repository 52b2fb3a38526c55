"""Checkpoints of tensor trees (port of :mod:`mmtpu.io.checkpoint`).

A tree (nested dicts of tensors, as :mod:`mmtpu_torch.tree` walks them) is
saved atomically as ``.npz`` (leaves in :func:`~mmtpu_torch.tree.tree_leaves`
order) beside a ``.tree`` file that names each leaf's dtype and shape.  A
:class:`Checkpointer` keeps step-stamped files in one directory with a
``manifest.json`` (``latest_step`` and the caller's ``extra``) and deletes all
but the newest ``keep``.  :func:`mmtpu_torch.train.chunked.fit_latents_checkpointed`
saves a latent fit's state with it between epoch segments.  The format is the
port's own: mmtpu's checkpoints (which carry a JAX key) are not read.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Mapping, Optional

import numpy as np
import torch

from mmtpu_torch.tree import tree_leaves, tree_unflatten


def _structure(tree):
    if isinstance(tree, Mapping):
        return {k: _structure(tree[k]) for k in sorted(tree)}
    return f"{tree.dtype} {list(tree.shape)}"


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path: str, tree) -> None:
    """Save ``tree``'s leaves to ``path`` (written to a temporary file in the
    same directory, then renamed) and its structure to ``path + ".tree"``."""
    folder = os.path.dirname(path) or "."
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=folder, suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **{f"leaf{i}": _to_numpy(leaf)
                           for i, leaf in enumerate(tree_leaves(tree))})
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    with open(path + ".tree", "w") as f:
        json.dump(_structure(tree), f)


def load_pytree(path: str, like):
    """The leaves saved at ``path`` in ``like``'s structure; a leaf that is a
    tensor in ``like`` comes back as a tensor of its dtype on its device."""
    refs = tree_leaves(like)
    with np.load(path) as data:
        if len(data.files) != len(refs):
            raise ValueError(f"{path} holds {len(data.files)} leaves, the tree has {len(refs)}")
        out = []
        for i, ref in enumerate(refs):
            raw = data[f"leaf{i}"]
            if isinstance(ref, torch.Tensor):
                raw = torch.from_numpy(raw).to(device=ref.device, dtype=ref.dtype)
            out.append(raw)
    return tree_unflatten(like, out)


class Checkpointer:
    """Step-stamped checkpoint directory with resume support."""

    def __init__(self, directory: str, keep: int = 2):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _manifest_path(self) -> str:
        return os.path.join(self.directory, "manifest.json")

    def save(self, step: int, tree, extra: Optional[dict] = None) -> str:
        path = os.path.join(self.directory, f"ckpt_{step}.npz")
        save_pytree(path, tree)
        tmp = self._manifest_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"latest_step": step, "extra": extra or {}}, f)
        os.replace(tmp, self._manifest_path())
        self._gc()
        return path

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[:max(0, len(steps) - self.keep)]:
            for suffix in (".npz", ".npz.tree"):
                p = os.path.join(self.directory, f"ckpt_{s}{suffix}")
                if os.path.exists(p):
                    os.unlink(p)

    def steps(self) -> list:
        return [int(fn[len("ckpt_"):-len(".npz")]) for fn in os.listdir(self.directory)
                if fn.startswith("ckpt_") and fn.endswith(".npz")]

    def manifest(self) -> Optional[dict]:
        """``{"latest_step": ..., "extra": ...}`` of the last save, or None."""
        if not os.path.exists(self._manifest_path()):
            return None
        with open(self._manifest_path()) as f:
            return json.load(f)

    def latest_step(self) -> Optional[int]:
        manifest = self.manifest()
        return None if manifest is None else manifest["latest_step"]

    def restore(self, like, step: Optional[int] = None):
        """``(tree, step, extra)`` of ``step`` (default: the latest), or
        ``(None, None, None)`` when nothing was saved."""
        manifest = self.manifest()
        step = step if step is not None else (manifest or {}).get("latest_step")
        if step is None:
            return None, None, None
        path = os.path.join(self.directory, f"ckpt_{step}.npz")
        return load_pytree(path, like), step, manifest.get("extra", {})
