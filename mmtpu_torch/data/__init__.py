"""Data layer of the port: the port's own numpy copy of :mod:`mmtpu.data`
(dataset registry, HDF5/npy ingestion, normalization, synthesis).  The
arrays it prepares are the same as mmtpu's, bit for bit."""

from mmtpu_torch.data.normalize import normalize_split, text_token_mask, aligned_text_mask
from mmtpu_torch.data.synthetic import synthesize_dataset
from mmtpu_torch.data.registry import load_dataset, DATASETS
from mmtpu_torch.data.pipeline import prepare_device_data, PreparedData

__all__ = [
    "normalize_split",
    "text_token_mask",
    "aligned_text_mask",
    "synthesize_dataset",
    "load_dataset",
    "DATASETS",
    "prepare_device_data",
    "PreparedData",
]
