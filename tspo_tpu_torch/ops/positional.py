"""Sinusoidal temporal positional encoding (reference model/temporal_agent.py:10-19).

Positions are normalised by the real frame count (pos / true_len), so the
encoding does not depend on the padded bucket length.  Computed in fp32 and
cast by the caller.
"""

from __future__ import annotations

import torch


def sinusoidal_positional_encoding(padded_len: int, channels: int,
                                   true_len: int | torch.Tensor | None = None,
                                   dtype=torch.float32,
                                   device: str | torch.device = "cpu") -> torch.Tensor:
    """Return [padded_len, channels] PE; positions normalised by ``true_len``."""
    if true_len is None:
        true_len = padded_len
    half = channels // 2
    true_len = torch.as_tensor(true_len, dtype=torch.float32, device=device)
    pos = torch.arange(padded_len, dtype=torch.float32, device=device)[:, None] / true_len
    log_base = torch.log(torch.tensor(10000.0, dtype=torch.float32, device=device))
    div = torch.exp(torch.arange(0, channels, 2, dtype=torch.float32, device=device)
                    * (-log_base / channels))                       # [ceil(C/2)]
    angles = pos * div[None, :]                                     # [T, ceil(C/2)]
    pe = torch.zeros(padded_len, channels, dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(angles)
    # the cos lanes are floor(C/2) columns; for odd C angles carries one extra
    pe[:, 1::2] = torch.cos(angles[:, :half])
    return pe.to(dtype)
