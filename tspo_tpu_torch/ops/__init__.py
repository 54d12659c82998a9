"""Ops of the scoring slice.  The ``vit_attention`` kernel lives in the
submodule ``tspo_tpu_torch.ops.vit_attention`` (not re-exported here, so the
submodule name stays the module)."""

from .masking import band_offsets, bucket_for, pad_to_bucket, window_mask
from .positional import sinusoidal_positional_encoding
from .selection import (
    aks_select,
    bin_max_select,
    generate_uniform_integers,
    gumbel_topk,
    topk_select,
    uniform_sample_indices,
)

__all__ = [
    "sinusoidal_positional_encoding",
    "window_mask",
    "band_offsets",
    "pad_to_bucket",
    "bucket_for",
    "topk_select",
    "bin_max_select",
    "aks_select",
    "gumbel_topk",
    "uniform_sample_indices",
    "generate_uniform_integers",
]
