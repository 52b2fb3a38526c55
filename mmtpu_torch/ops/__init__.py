"""Tensor ops (ports of :mod:`mmtpu.ops`), with mmtpu's ``ops`` API names.

Importing them builds no kernel: :func:`word_logprob_angular` reaches kernel
K1 through :mod:`mmtpu_torch.kernels.angular`, imported at its first call;
:func:`angular_partition` is the plain version of its partition.
"""

from mmtpu_torch.ops.closed_form import closed_form_latents, gaussian_inverse_weights
from mmtpu_torch.ops.gaussian import gaussian_logpdf_masked
from mmtpu_torch.ops.joint import joint_log_prob
from mmtpu_torch.ops.posenc import add_positional_embeddings, positional_encoding
from mmtpu_torch.ops.sif import (
    first_pc,
    remove_pc,
    seq_weights,
    sif_embedding,
    sif_weighted_average,
)
from mmtpu_torch.ops.wordprob import (
    angular_partition,
    word_logprob_angular,
    word_logprob_dot_prod,
)

__all__ = [
    "seq_weights",
    "sif_weighted_average",
    "first_pc",
    "remove_pc",
    "sif_embedding",
    "gaussian_logpdf_masked",
    "word_logprob_angular",
    "word_logprob_dot_prod",
    "angular_partition",
    "positional_encoding",
    "add_positional_embeddings",
    "joint_log_prob",
    "closed_form_latents",
    "gaussian_inverse_weights",
]
