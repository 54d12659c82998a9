"""Window masks and shape-bucketing utilities.

The reference's window mask (model/temporal_agent.py:97-104) is a contiguous
band: mask[j, c] is True iff j - w//2 <= c <= j - w//2 + w - 1, clipped to
[0, T-1].  Variable frame counts are padded to a few bucket lengths, and a
``valid`` mask carries the true length.
"""

from __future__ import annotations

import numpy as np
import torch


def window_mask(seq_len: int, window_size: int,
                valid: torch.Tensor | None = None) -> torch.Tensor:
    """Dense [T, T] boolean band mask, True where attention is allowed.
    ``valid`` ([T] bool) additionally masks padded key columns and sets the
    device."""
    device = "cpu" if valid is None else valid.device
    j = torch.arange(seq_len, device=device)[:, None]
    c = torch.arange(seq_len, device=device)[None, :]
    lo = j - window_size // 2
    mask = (c >= lo) & (c <= lo + window_size - 1)
    if valid is not None:
        mask = mask & valid[None, :]
    return mask


def band_offsets(window_size: int) -> np.ndarray:
    """Column offsets of the band relative to the query row: [-w//2, w-w//2-1]."""
    return np.arange(window_size) - window_size // 2


def bucket_for(n: int, buckets=(64, 128, 256, 512, 1024, 2048, 4096, 8192)) -> int:
    """Smallest bucket >= n; past the largest, the next multiple of it."""
    for b in buckets:
        if n <= b:
            return b
    big = buckets[-1]
    return ((n + big - 1) // big) * big


def pad_to_bucket(x: np.ndarray, bucket: int, axis: int = 0, fill=0):
    """Pad ``x`` along ``axis`` to ``bucket``; returns (padded, valid_mask[bucket])."""
    n = x.shape[axis]
    if n > bucket:
        raise ValueError(f"length {n} exceeds bucket {bucket}")
    pad_width = [(0, 0)] * x.ndim
    pad_width[axis] = (0, bucket - n)
    padded = np.pad(x, pad_width, constant_values=fill)
    valid = np.zeros(bucket, bool)
    valid[:n] = True
    return padded, valid
