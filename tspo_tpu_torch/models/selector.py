"""MultiModalAlign selector head — the ~3.5M-param temporal agent.

Counterpart of ``tspo_tpu/models/selector.py`` (reference
``model/temporal_agent.py:21-143``).  Score for frame t: mean over text tokens
of cosine(contextualised frame embedding, text embedding) plus the raw CLIP
frame-text cosine, divided by the temperature ``score_tau``.

The module's ``state_dict`` keys are the reference ``MultiModal_Align`` keys
(``temporal.Self_q``, ``temporal.Self_k``, ``temporal.Self_v``,
``temporal.ffn_o``, ``mlp.0``, ``mlp.2``), so reference selector checkpoints
load with ``load_state_dict``.  ``ffn_o`` is carried for checkpoint
compatibility only.  The selector always runs in fp32: bf16 rounding flips
frame ranks near ties.

The window attention is computed as a band, O(T*w), by gathering each row's w
keys; :func:`score_frames_dense` keeps the literal dense-mask formulation as
the oracle.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..configs import SelectorConfig
from ..ops.masking import window_mask
from ..ops.positional import sinusoidal_positional_encoding


class SimpleSelfAttn(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.Self_q = nn.Linear(dim, dim)
        self.Self_k = nn.Linear(dim, dim)
        self.Self_v = nn.Linear(dim, dim)
        self.ffn_o = nn.Linear(dim, dim)   # checkpointed, unused


class MultiModalAlign(nn.Module):
    def __init__(self, cfg: SelectorConfig = SelectorConfig()):
        super().__init__()
        self.cfg = cfg
        self.temporal = SimpleSelfAttn(cfg.dim)
        self.mlp = nn.Sequential(nn.Linear(cfg.dim, cfg.dim), nn.ReLU(),
                                 nn.Linear(cfg.dim, cfg.dim))


def init_selector(cfg: SelectorConfig = SelectorConfig(),
                  generator: torch.Generator | None = None) -> MultiModalAlign:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for kernels and biases (torch
    nn.Linear's default bound), drawn on the CPU from ``generator``; fp32."""
    with torch.device("meta"):
        sel = MultiModalAlign(cfg)
    sel = sel.to_empty(device="cpu")
    bound = 1.0 / np.sqrt(cfg.dim)
    with torch.no_grad():
        for p in sel.parameters():
            p.uniform_(-bound, bound, generator=generator)
    return sel.eval()


def pair_cosine(a: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """[N, C] x [M, C] -> [N, M] cosine similarity, dividing by
    (|a| |b| + eps) (ref temporal_agent.py:106-114); fp32."""
    a32, b32 = a.float(), b.float()
    dots = a32 @ b32.T
    an = torch.sqrt(torch.sum(a32 * a32, dim=-1))[:, None]
    bn = torch.sqrt(torch.sum(b32 * b32, dim=-1))[None, :]
    return dots / (an * bn + eps)


def _contextualize(sel: MultiModalAlign, frame_emb, valid, true_len,
                   window_size: int, dense_mask: bool):
    """Shared trunk: PE -> windowed self-attn -> MLP residual.  Returns [T, D]."""
    cfg = sel.cfg
    T, D = frame_emb.shape
    H, hd = cfg.num_heads, cfg.head_dim
    w = window_size
    dev = frame_emb.device

    pe = sinusoidal_positional_encoding(T, D, true_len, frame_emb.dtype, dev)
    x = frame_emb + pe
    t = sel.temporal
    q = t.Self_q(x).reshape(T, H, hd).transpose(0, 1)
    k = t.Self_k(x).reshape(T, H, hd).transpose(0, 1)
    v = t.Self_v(x).reshape(T, H, hd).transpose(0, 1)
    scale = 1.0 / np.sqrt(hd)

    if dense_mask:
        # literal reference formulation (temporal_agent.py:38-56)
        mask = window_mask(T, w, valid)                         # [T, T]
        scores = torch.einsum("htd,hsd->hts", q, k) * scale
        scores = torch.where(mask[None], scores,
                             torch.full_like(scores, cfg.mask_fill))
        attn = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("hts,hsd->htd", attn, v)
    else:
        # banded O(T*w): gather the w keys/values in each row's window
        offs = torch.arange(w, device=dev) - w // 2             # [w]
        cols = torch.arange(T, device=dev)[:, None] + offs[None, :]  # [T, w]
        in_range = (cols >= 0) & (cols < T)
        cols_c = torch.clamp(cols, 0, T - 1)
        band_ok = in_range & valid[cols_c]                      # [T, w]
        k_band = k[:, cols_c, :]                                # [H, T, w, hd]
        v_band = v[:, cols_c, :]
        scores = torch.einsum("htd,htwd->htw", q, k_band) * scale
        scores = torch.where(band_ok[None], scores,
                             torch.full_like(scores, cfg.mask_fill))
        attn = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("htw,htwd->htd", attn, v_band)

    ctx = ctx.transpose(0, 1).reshape(T, D)
    return sel.mlp(ctx) + frame_emb                             # residual w/ raw input


def score_frames(sel: MultiModalAlign, frame_emb: torch.Tensor,
                 text_emb: torch.Tensor, clip_scores: torch.Tensor, *,
                 window_size: int | None = None, score_tau: float | None = None,
                 valid: torch.Tensor | None = None, true_len=None,
                 dense_mask: bool = False):
    """Score every candidate frame against the question.

    Args:
      frame_emb:   [T, D] CLIP image embeddings (padded to a bucket).
      text_emb:    [M, D] CLIP text embedding(s); the reference passes M=1.
      clip_scores: [T] raw CLIP frame-text cosine.
      valid:       [T] bool, True for real frames; None = all valid.
      true_len:    real frame count; defaults to sum(valid).

    Returns (logits [T] fp32, contextual_emb [T, D]).  Padded logits are
    meaningless; selection masks them via ``valid``.
    """
    cfg = sel.cfg
    T = frame_emb.shape[0]
    if valid is None:
        valid = torch.ones(T, dtype=torch.bool, device=frame_emb.device)
    if true_len is None:
        true_len = valid.sum()
    window_size = cfg.window_size if window_size is None else window_size
    score_tau = cfg.score_tau if score_tau is None else score_tau

    ctx = _contextualize(sel, frame_emb, valid, true_len, window_size, dense_mask)
    if text_emb.dim() == 1:
        text_emb = text_emb[None, :]
    sim = pair_cosine(ctx, text_emb, cfg.cosine_eps).mean(dim=-1)     # [T]
    tau = torch.as_tensor(score_tau, dtype=torch.float32, device=frame_emb.device)
    logits = (sim + clip_scores.float()) / tau
    return logits, ctx


def score_frames_dense(sel, frame_emb, text_emb, clip_scores, **kw):
    """Dense-mask formulation (test oracle for the banded path)."""
    kw["dense_mask"] = True
    return score_frames(sel, frame_emb, text_emb, clip_scores, **kw)


def load_reference_state_dict(sel: MultiModalAlign, state_dict) -> MultiModalAlign:
    """Load a reference ``MultiModal_Align`` state dict (tensors or ndarrays),
    with or without the ``multiModal_align.`` prefix."""
    sd = {}
    for k, v in state_dict.items():
        v = v.detach().cpu() if hasattr(v, "detach") else torch.from_numpy(np.array(v))
        sd[k.removeprefix("multiModal_align.")] = v.float()
    sel.load_state_dict(sd, strict=True)
    return sel
