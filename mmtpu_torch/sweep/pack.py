"""Packing heterogeneous configs into shape-uniform arrays with a leading
config axis (port of :mod:`mmtpu.sweep.pack`, its values bit for bit).

The grid's axes (``configs/make_configs.py:16-32``) differ in ways the
reference bakes into program *structure*; mmtpu turns each into data:

| axis                  | values        | mechanism                          |
|-----------------------|---------------|------------------------------------|
| lr, sentiment_lr      | floats        | per-config scalar arrays           |
| word/likelihood weight| floats        | per-config scalar arrays           |
| optimizer             | sgd/adam      | branchless opt_code                |
| norm                  | layer/batch   | branchless norm_code               |
| n_epochs              | 100/200       | run max, mask late updates         |
| pos_embed_dim         | 2/4           | shared table of one exact          |
|                       |               | standalone-encoding block per      |
|                       |               | unique dim; a config's channel     |
|                       |               | mask selects its own block (other  |
|                       |               | blocks → zero loss, zero grads)    |
| sentiment_hidden_size | 100/150       | zero-padded dead hidden units      |

Every mechanism is *exactly* equivalent to running the config standalone
(see :mod:`mmtpu_torch.models.sentiment` for the dead-unit argument;
tests/test_torch_sweep_mech.py checks equivalence).  The codes are the
port's own (:data:`mmtpu_torch.models.decoder.NORM_CODES`,
:data:`mmtpu_torch.train.optim.OPT_CODES`), equal to mmtpu's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np

from mmtpu_torch.models.decoder import NORM_CODES
from mmtpu_torch.train.optim import OPT_CODES


@dataclasses.dataclass(frozen=True)
class SweepStatics:
    """Maxima and flags shared by every config of a sweep chunk (the fields
    of :class:`mmtpu.sweep.pack.SweepStatics` that the port runs; the TPU's
    ``unroll`` and ``use_pallas`` have no counterpart: the port runs no
    scan, and K1 is always the kernel on the card)."""

    n_epochs_max: int
    n_sentiment_epochs_max: int
    pos_max: int  # total shared-table width = sum(pos_dims)
    hidden_max: int
    # sorted unique positional dims — the block layout of the shared table
    # (must match PreparedData.pos_dims)
    pos_dims: tuple = ()
    batch_size: int = 64
    unimodal: bool = False
    word_metric: str = "angular"
    e2e: bool = True
    early_stopping: bool = False
    # the chunk's one optimizer kind ("sgd" | "adam"); run_chunk sets it
    opt_kind: str | None = None
    # epoch-level lazy Adam for the latent tables (train/optim.py), the
    # sweep's default in mmtpu (mmtpu/sweep/runner.py:453-454)
    lazy_adam: bool = False
    # recursive validation curves during training, reference cadence 80
    # (simplesif.py:146-159, 795-799); expensive, opt-in
    validation_curve: bool = False
    # shrink a single-batch inference fit's batch to the next batch_size
    # multiple >= the split's rows: the same row grouping, float order only
    infer_batch_clamp: bool = False
    # the train fit's decoder-weight updates in kernel K2 (train/fused.py)
    fused_dec_update: bool = False
    # start the valid/test inference fits from the trained decoder's
    # closed-form estimate (train/warm_start.py) in place of the SIF
    # embedding; not reference parity, pair with infer_epochs_cap
    infer_warm_start: bool = False
    # cap the inference fits' epochs (0: the config's own n_epochs, the
    # reference's semantics); opt-in, not reference parity
    infer_epochs_cap: int = 0


def statics_from_configs(
    configs: Sequence[dict],
    batch_size: int = 64,
    unimodal: bool = False,
) -> SweepStatics:
    def vals(key, default=None):
        return [c.get(key, default) for c in configs]

    e2e_vals = {bool(v in (True, "y")) for v in vals("e2e", True)}
    metric_vals = set(vals("word_sim_metric", "angular"))
    if len(e2e_vals) > 1 or len(metric_vals) > 1:
        raise ValueError(
            "configs mixing e2e modes or word metrics must be bucketed into "
            f"separate sweeps (got e2e={e2e_vals}, metric={metric_vals})"
        )
    pos_dims = tuple(sorted({int(p) for p in vals("pos_embed_dim", 0) if p > 0}))
    return SweepStatics(
        n_epochs_max=max(vals("n_epochs", 100)),
        n_sentiment_epochs_max=max(vals("n_sentiment_epochs", 400)),
        pos_max=sum(pos_dims),
        pos_dims=pos_dims,
        hidden_max=max(vals("sentiment_hidden_size", 100)),
        batch_size=batch_size,
        unimodal=unimodal,
        word_metric=metric_vals.pop(),
        e2e=e2e_vals.pop(),
    )


def pack_configs(configs: Sequence[dict], statics: SweepStatics) -> Dict[str, np.ndarray]:
    """Per-config hyperparameter arrays, leading axis K = len(configs)."""
    k = len(configs)

    def arr(key, default, dtype=np.float32):
        return np.asarray([c.get(key, default) for c in configs], dtype)

    # block-select mask: config with pos_embed_dim == p activates exactly the
    # channels of its own standalone-encoding block in the shared table
    cfg_dims = arr("pos_embed_dim", 0, np.int32)
    pos_mask = np.zeros((k, statics.pos_max), np.float32)
    ofs = 0
    for p in statics.pos_dims:
        pos_mask[:, ofs : ofs + p] = (cfg_dims == p)[:, None]
        ofs += p

    return {
        "lr": arr("lr", 1e-3),
        "sentiment_lr": arr("sentiment_lr", 1e-1),
        "lr_decay": arr("lr_decay", 0.5),
        "word_loss_weight": arr("word_loss_weight", 0.001),
        "likelihood_weight": arr("likelihood_weight", 0.0001),
        "opt_code": np.asarray(
            [OPT_CODES[c.get("optimizer", "sgd")] for c in configs], np.int32
        ),
        "norm_code": np.asarray(
            [NORM_CODES[c.get("norm")] for c in configs], np.int32
        ),
        "n_epochs": arr("n_epochs", 100, np.int32),
        # 1.0 unless freeze_weights — gates the decoder update per config
        # (whole decoder in non-e2e buckets, heads-only in e2e buckets)
        "train_dec": np.asarray(
            [0.0 if c.get("freeze_weights") else 1.0 for c in configs],
            np.float32,
        ),
        "n_sentiment_epochs": arr("n_sentiment_epochs", 400, np.int32),
        "hidden_dims": arr("sentiment_hidden_size", 100, np.int32),
        "pos_mask": pos_mask,
        "config_num": arr("config_num", 0, np.int32),
        "run_idx": arr("_run_idx", 0, np.int32),
    }
