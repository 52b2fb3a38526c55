"""Host-side (numpy) feature normalization and mask construction (the
port's copy of :mod:`mmtpu.data.normalize`).

Equivalent of reference ``utils.py:155-191`` (``normalize_data``) and the text
mask builders ``simplesif.py:36-47``.  One-time preprocessing — stays on the
host; everything downstream is device arrays.

Parity quirk (``utils.py:185-186``): the reference scales with
``(x + min) * 2 / (max - min) - 1`` — a ``+min`` where classic min-max
normalization uses ``-min``.  ``parity=True`` (default) reproduces it exactly,
since the decoder learns whatever affine frame the data is in and matching the
reference's frame is required for output parity; ``parity=False`` applies the
classic formula.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def normalize_split(
    covarep: np.ndarray, facet: np.ndarray, parity: bool = True
) -> Tuple[np.ndarray, np.ndarray, Dict[str, np.ndarray]]:
    """Normalize audio/visual features, drop constant audio features, build masks.

    Mirrors ``utils.py:155-191`` step for step:
    1. drop audio features whose min == max over the whole split;
    2. masks = (value != 0) per element (computed BEFORE scaling);
    3. min-max scale to ≈[-1, 1] (with the reference's ``+min`` quirk when
       ``parity``);
    4. set original-zero (padding) positions to -10.

    Returns ``(covarep, facet, {"covarep": mask, "facet": mask})`` — masks are
    int arrays like the reference's ``.astype(int)``.
    """
    covarep = np.array(covarep, dtype=np.float32)
    facet = np.array(facet, dtype=np.float32)

    a_min = covarep.min((0, 1))
    a_max = covarep.max((0, 1))
    nonconst = (a_max - a_min).nonzero()[0]
    covarep = covarep[:, :, nonconst]

    audio_pad = covarep == 0
    vis_pad = facet == 0
    audio_mask = (covarep != 0).astype(np.int64)
    vis_mask = (facet != 0).astype(np.int64)

    a_min = covarep.min((0, 1))
    a_max = covarep.max((0, 1))
    v_min = facet.min((0, 1))
    v_max = facet.max((0, 1))

    sign = 1.0 if parity else -1.0
    covarep = (covarep + sign * a_min) * 2.0 / (a_max - a_min) - 1.0
    facet = (facet + sign * v_min) * 2.0 / (v_max - v_min) - 1.0

    covarep[audio_pad] = -10.0
    facet[vis_pad] = -10.0

    return covarep, facet, {"covarep": audio_mask, "facet": vis_mask}


def text_token_mask(token_ids: np.ndarray) -> np.ndarray:
    """``(N, L)`` 0/1 mask: id != 0 (reference ``update_masks``,
    ``simplesif.py:36-40`` — which broadcasts to the embedding dim; mmtpu
    keeps the compact (N, L) form and broadcasts in the op)."""
    return (token_ids != 0).astype(np.float32)


def aligned_text_mask(text_aligned: np.ndarray) -> np.ndarray:
    """``(N, L)`` 0/1 mask: all features nonzero at a timestep (reference
    ``update_masks_vect``, ``simplesif.py:42-47``)."""
    return np.all(text_aligned != 0, axis=-1).astype(np.float32)
