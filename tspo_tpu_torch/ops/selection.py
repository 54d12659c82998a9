"""Frame-selection ops: top-k, bin-max, AKS, Gumbel straight-through top-k,
uniform helpers.

Reference behaviour being matched:
  - topk:    ``llava_qwen.py:154-157`` / ``temporal_agent.py:191-192``
  - bin-max: ``llava_qwen.py:159-176`` (uniform proposal bins, argmax per bin)
  - AKS:     ``model/utils.py:83-153`` (recursive mean/std split; host-side)
  - gumbel straight-through top-k: ``model/utils.py:69-80`` (stochastic
    selection, *noise-free* log-probs)
  - uniform: ``model/utils.py:53-67``

The tensor ops take a padded length with a ``valid`` mask; invalid slots
score -1e30 and sort to the tail.  They return ``(indices[k], count)`` with
``count = min(k, n_valid)``; callers slice ``indices[:count]``.  Ties resolve
to the lower frame index, as ``jax.lax.top_k``, first-min ``argmin`` and
first-max ``argmax`` do in the JAX package: top-k is a stable descending
sort, never ``torch.topk``, whose tie order is unspecified.  AKS and the
small helpers stay in numpy.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

_NEG = -1e30


def generate_uniform_integers(t: int, l: int) -> list:
    """l integers uniformly spanning [0, t] (banker's rounding, ref utils.py:10-16)."""
    if l <= 0:
        return []
    if l == 1:
        return [t]
    step = t / (l - 1)
    return [round(i * step) for i in range(l)]


def uniform_sample_indices(n: int, num_samples: int) -> list:
    """Stride-based uniform subsample of range(n) (ref utils.py:53-67)."""
    if num_samples <= 0 or num_samples > n:
        return []
    step = n // num_samples
    remainder = n % num_samples
    out, index = [], 0
    for i in range(num_samples):
        out.append(index)
        index += step + (1 if i < remainder else 0)
    return out


def _valid_or_all(scores: torch.Tensor, valid):
    if valid is None:
        return torch.ones(scores.shape[0], dtype=torch.bool, device=scores.device)
    return torch.as_tensor(valid, dtype=torch.bool, device=scores.device)


def topk_select(scores: torch.Tensor, k: int, valid: torch.Tensor | None = None):
    """Top-k scores -> ascending frame indices.

    Returns (indices[k] int32, count int32).  When fewer than k frames are
    valid, the first ``count`` slots hold the selection and the rest are T
    (an out-of-range sentinel)."""
    T = scores.shape[0]
    valid = _valid_or_all(scores, valid)
    masked = torch.where(valid, scores, torch.full_like(scores, _NEG))
    idx = torch.sort(masked, descending=True, stable=True).indices[:k]
    keep = valid[idx]
    key = torch.where(keep, idx, torch.full_like(idx, T))
    return (torch.sort(key).values.to(torch.int32),
            keep.sum().to(torch.int32))


def bin_max_select(scores: torch.Tensor, k: int, valid: torch.Tensor | None = None):
    """k uniform proposal bins over the true length; argmax of scores per bin.

    Proposals are ``round(i*(n-1)/(k-1))`` in fp32 (half to even), every frame
    joins its nearest proposal (ties to the lower bin) and the best-scoring
    frame per bin wins (ties to the lower index).  Requires n_valid >= k; the
    scorer returns every frame for shorter videos, as the reference does."""
    T = scores.shape[0]
    dev = scores.device
    valid = _valid_or_all(scores, valid)
    n = valid.sum().to(torch.float32)
    i = torch.arange(k, dtype=torch.float32, device=dev)
    proposals = torch.round(i * (n - 1.0) / (k - 1.0))            # [k]
    x = torch.arange(T, dtype=torch.float32, device=dev)
    dist = torch.abs(x[:, None] - proposals[None, :])              # [T, k]
    slot = torch.argmin(dist, dim=1)                               # first-min ties
    masked = torch.where(valid, scores, torch.full_like(scores, _NEG))
    in_bin = slot[None, :] == torch.arange(k, device=dev)[:, None]  # [k, T]
    per_bin = torch.where(in_bin, masked[None, :],
                          torch.full_like(masked[None, :], _NEG))
    sel = torch.argmax(per_bin, dim=1).to(torch.int32)             # first-max ties
    return torch.sort(sel).values, torch.tensor(k, dtype=torch.int32)


def gumbel_topk(logits: torch.Tensor, k: int, valid: torch.Tensor | None = None,
                tau: float = 1.0, k_len=None, *,
                generator: torch.Generator | None = None, noise=None):
    """Gumbel-softmax straight-through top-k frame sampling.

    Matches reference ``model/utils.py:69-80`` and the JAX package's
    ``gumbel_topk``:
      selection   ~ top-k of softmax((logits + Gumbel)/tau)   (stochastic)
      probs       = straight-through one-hot (grads flow through the softmax)
      log_probs   = log_softmax(logits)                        (noise-free)

    Returns (indices[k] ascending, st_probs[T], log_probs[T]).

    The Gumbel noise [T] is ``noise`` when given (the JAX package's draw,
    passed in for parity: the two RNGs differ), else -log(-log(U)) with U
    drawn from ``generator`` on the logits' device.  The top k is taken from
    a stable descending sort of the softmax: with a small ``score_tau`` many
    entries underflow to exactly 0, and the tie goes to the lower index, as
    in ``jax.lax.top_k``.

    ``k_len`` (<= k) selects only the top ``k_len`` frames: the first k_len
    entries are the chosen indices ascending, the tail is 0-padded (mixed
    "general"/"specific" batches with per-sample subset sizes).
    """
    T = logits.shape[0]
    dev = logits.device
    valid = _valid_or_all(logits, valid)
    neg = torch.full_like(logits, _NEG)
    masked = torch.where(valid, logits, neg)
    if noise is None:
        u = torch.rand(T, generator=generator, device=dev, dtype=logits.dtype)
        g = -torch.log(-torch.log(u.clamp_min(torch.finfo(logits.dtype).tiny)))
    else:
        g = torch.as_tensor(noise, dtype=logits.dtype, device=dev)
    y = torch.softmax(torch.where(valid, (masked + g) / tau, neg), dim=-1)
    idxv = torch.sort(y.detach(), descending=True, stable=True).indices[:k]
    one_hot = torch.zeros_like(y)
    if k_len is None:
        idx = torch.sort(idxv).values.to(torch.int32)
        one_hot[idxv] = 1.0
    else:
        keep = torch.arange(k, device=dev) < torch.as_tensor(k_len, device=dev)
        # sentinels >= T sort to the tail; kept indices end up ascending first
        idx = torch.sort(torch.where(keep, idxv, T + torch.arange(k, device=dev))).values
        idx = torch.where(keep, idx, 0).to(torch.int32)
        one_hot[idxv] = keep.to(y.dtype)
    st_probs = one_hot - y.detach() + y
    log_probs = torch.log_softmax(masked, dim=-1)
    return idx, st_probs, log_probs


# ---------------------------------------------------------------------------
# AKS — adaptive keyframe sampling (host-side; ref model/utils.py:83-153)
# ---------------------------------------------------------------------------

def _meanstd_split(dic_scores, n, fns, t1, t2, all_depth):
    """Recursive segment split: keep segments whose top-n scores stand out
    (mean of top-n minus segment mean > t1 and std > t2), bisect the rest up
    to ``all_depth``."""
    split_scores, split_fn = [], []
    no_split_scores, no_split_fn = [], []
    for dic, fn in zip(dic_scores, fns):
        score, depth = dic["score"], dic["depth"]
        mean = np.mean(score)
        std = np.std(score)
        top_n = heapq.nlargest(n, range(len(score)), score.__getitem__)
        mean_diff = np.mean([score[t] for t in top_n]) - mean
        if mean_diff > t1 and std > t2:
            no_split_scores.append(dic)
            no_split_fn.append(fn)
        elif depth < all_depth:
            h = len(score) // 2
            split_scores.append(dict(score=score[:h], depth=depth + 1))
            split_scores.append(dict(score=score[h:], depth=depth + 1))
            split_fn.append(fn[:h])
            split_fn.append(fn[h:])
        else:
            no_split_scores.append(dic)
            no_split_fn.append(fn)
    if split_scores:
        rec_scores, rec_fn = _meanstd_split(split_scores, n, split_fn, t1, t2, all_depth)
    else:
        rec_scores, rec_fn = [], []
    return no_split_scores + rec_scores, no_split_fn + rec_fn


def aks_select(scores: np.ndarray, max_num_frames: int,
               t1: float = 0.2, t2: float = -100.0, all_depth: int = 3) -> list:
    """Adaptive keyframe sampling over a host score vector.

    Thresholds follow the reference defaults (utils.py:131-133, the LVB
    profile; VideoMME uses t1=0.8, all_depth=5).  Budget per surviving
    segment is ``max_num_frames / 2**depth``."""
    scores = np.asarray(scores, np.float32)
    fn = list(range(len(scores)))
    num = max_num_frames
    if len(scores) < num:
        return fn
    lo, hi = np.min(scores), np.max(scores)
    normalized = (scores - lo) / (hi - lo) if hi > lo else np.zeros_like(scores)
    segs, seg_fns = _meanstd_split([dict(score=normalized, depth=0)], num, [fn],
                                   t1, t2, all_depth)
    out = []
    for s, f in zip(segs, seg_fns):
        f_num = int(num / 2 ** s["depth"])
        topk = heapq.nlargest(f_num, range(len(s["score"])), s["score"].__getitem__)
        out.extend(f[t] for t in topk)
    out.sort()
    return out
