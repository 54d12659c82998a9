"""Helpers for reading HuggingFace/torch checkpoints as float32 numpy."""

from __future__ import annotations

import numpy as np


def t2n(t) -> np.ndarray:
    """torch tensor / ndarray -> float32 numpy."""
    if hasattr(t, "detach"):
        return t.detach().cpu().float().numpy()
    return np.asarray(t, np.float32)


def state_dict_of(model_or_sd) -> dict:
    if hasattr(model_or_sd, "state_dict"):
        return {k: t2n(v) for k, v in model_or_sd.state_dict().items()}
    return {k: t2n(v) for k, v in model_or_sd.items()}


def stack_layers(sd: dict, n_layers: int, fmt: str) -> np.ndarray:
    """Stack per-layer tensors ``fmt.format(i=...)`` along a new leading axis."""
    return np.stack([sd[fmt.format(i=i)] for i in range(n_layers)])
