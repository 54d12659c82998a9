"""GRPO-style policy-gradient training of the selector head.

Counterpart of ``tspo_tpu/train/grpo.py`` (reference tspo_trainer.py:434-640):
per sample, draw G Gumbel-top-k frame subsets, let the frozen backbone answer
once per subset, convert answers to rewards, group-normalise them into
advantages, and apply the REINFORCE surrogate ``-mean(exp(lp - sg(lp))) *
adv`` to the selector's noise-free log-probs at the selected indices.  Only
the selector trains; its gradient is torch autograd over plain ops, as the
JAX package's is ``jax.value_and_grad``.

The functions take torch tensors on one device and loop over the batch axis
(one sample per step is the reference's per-rank layout).  Rewards arrive as
tensors, from the backbone rollouts (train/trainer.py) or from test stubs.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..configs import TrainConfig
from ..models.selector import MultiModalAlign, score_frames
from ..ops.selection import gumbel_topk

_NEG = -1e30


class TrainBatch(NamedTuple):
    """One batch of training samples (padded frame buckets), fp32.

    frame_feat:  [B, T, D]  CLIP image features
    text_feat:   [B, 1, D]  CLIP text features
    clip_scores: [B, T]
    valid:       [B, T]     bool frame-validity mask
    """

    frame_feat: torch.Tensor
    text_feat: torch.Tensor
    clip_scores: torch.Tensor
    valid: torch.Tensor


class SampledSubsets(NamedTuple):
    """G sampled frame subsets per batch element: indices [B, G, K].

    ``k_len`` [B]: per-sample subset size for mixed-type batches ("general"
    samples select training_sample_len//2 frames, "specific" ones
    training_sample_len; tspo_trainer.py:456-480); rows with k_len[b] < K
    carry 0-padding past k_len[b]."""

    indices: torch.Tensor
    k_len: torch.Tensor | None = None


def anneal_tau(step, max_steps, tau0: float, tau_final: float) -> float:
    """Linear temperature anneal (tspo_trainer.py:496), in fp32 as the JAX
    package computes it.  frac clamps to 1: past the planned horizon tau
    stays at tau_final (unclamped it would cross zero and a negative tau
    inverts every selector logit)."""
    frac = np.float32(step) / np.float32(max(max_steps, 1))
    return float(np.float32(tau0)
                 - np.float32(tau0 - tau_final) * min(frac, np.float32(1.0)))


@torch.no_grad()
def sample_subsets(selector: MultiModalAlign, batch: TrainBatch, tau, *,
                   num_generations: int, sample_len: int, window_size: int,
                   k_len=None, generator: torch.Generator | None = None,
                   noise=None) -> SampledSubsets:
    """Rollout phase: per sample, G stochastic Gumbel-top-k frame subsets
    (the no-grad G-loop of tspo_trainer.py:508-537).

    ``noise`` [B, G, T] is the Gumbel noise of every draw when given (parity
    with the JAX package's key splits); else each draw comes from
    ``generator``.  ``k_len`` [B] enables mixed-type batches."""
    B = batch.frame_feat.shape[0]
    dev = batch.frame_feat.device
    kl = (torch.full((B,), sample_len, dtype=torch.int64, device=dev)
          if k_len is None else torch.as_tensor(k_len, device=dev).long())
    out = []
    for b in range(B):
        logits, _ = score_frames(selector, batch.frame_feat[b], batch.text_feat[b],
                                 batch.clip_scores[b], window_size=window_size,
                                 score_tau=tau, valid=batch.valid[b])
        out.append(torch.stack([
            gumbel_topk(logits, sample_len, batch.valid[b], k_len=kl[b],
                        generator=generator,
                        noise=None if noise is None else noise[b][g])[0]
            for g in range(num_generations)]))
    return SampledSubsets(indices=torch.stack(out).long(), k_len=kl)


def grpo_surrogate_loss(selector: MultiModalAlign, batch: TrainBatch,
                        subsets: SampledSubsets, rewards: torch.Tensor, tau, *,
                        window_size: int, adv_eps: float = 1e-4) -> torch.Tensor:
    """REINFORCE surrogate with group-normalised advantages.

    rewards: [B, G].  Loss per generation: -mean_K(exp(lp - sg(lp))) * adv
    (tspo_trainer.py:586-607); the value of exp(...) is 1, its gradient is
    d(lp)/dθ: plain REINFORCE with a group baseline.  The advantage divides
    by the std with ddof=1 (torch's ``.std`` default, as the reference).
    Indices past ``k_len`` are masked out of the sum, so the 0-padding adds
    nothing to frame 0's gradient."""
    K = subsets.indices.shape[-1]
    B = batch.frame_feat.shape[0]
    dev = batch.frame_feat.device
    k_len = (torch.full((B,), K, dtype=torch.int64, device=dev)
             if subsets.k_len is None else subsets.k_len)
    losses = []
    for b in range(B):
        valid = batch.valid[b]
        logits, _ = score_frames(selector, batch.frame_feat[b], batch.text_feat[b],
                                 batch.clip_scores[b], window_size=window_size,
                                 score_tau=tau, valid=valid)
        lp = torch.log_softmax(torch.where(valid, logits,
                                           torch.full_like(logits, _NEG)), dim=-1)
        rew = rewards[b]
        adv = (rew - rew.mean()) / (rew.std(correction=1) + adv_eps)   # [G]
        lps = lp[subsets.indices[b]]                                     # [G, K]
        keep = (torch.arange(K, device=dev) < k_len[b])[None, :]
        ratio = torch.exp(lps - lps.detach())
        ratio = torch.where(keep, ratio, torch.zeros_like(ratio)).sum(-1) / k_len[b]
        losses.append(-(ratio * adv).mean())
    return torch.stack(losses).mean()


class AdamW(torch.optim.AdamW):
    """``optax.adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0)``,
    with ``optax.MultiSteps(every_k_schedule=every_k)`` semantics when
    ``every_k > 1`` (torch's own AdamW defaults to weight_decay=0.01).

    Each :meth:`step` folds the parameters' ``.grad`` (zeros where a
    parameter got none, as ``jax.grad`` gives) into a running mean, by
    optax's Welford update; every ``every_k``-th call sets ``.grad`` to that
    mean, steps AdamW on it and clears it.  On the calls in between the
    parameters and the AdamW state are untouched."""

    def __init__(self, params, lr: float, every_k: int = 1):
        super().__init__(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                         weight_decay=0.0)
        self.every_k = every_k
        self.mini_step = 0
        self.acc_grads = [torch.zeros_like(p) for p in self.params()]

    def params(self) -> list:
        return [p for group in self.param_groups for p in group["params"]]

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamW.step takes no closure")
        params = self.params()
        for i, p in enumerate(params):
            grad = p.grad if p.grad is not None else torch.zeros_like(p)
            acc = self.acc_grads[i]
            self.acc_grads[i] = acc + (grad - acc) / (self.mini_step + 1)
        if self.mini_step < self.every_k - 1:
            self.mini_step += 1
            return None
        for p, acc in zip(params, self.acc_grads):
            p.grad = acc
        super().step()
        self.mini_step = 0
        self.acc_grads = [torch.zeros_like(p) for p in params]
        return None


def make_optimizer(cfg: TrainConfig, params) -> AdamW:
    """AdamW over ``params``; ``grad_accum > 1`` accumulates like
    ``optax.MultiSteps`` (the reference's per-rank gradient accumulation,
    train_deepspeed.sh --gradient_accumulation_steps 2)."""
    return AdamW(params, cfg.learning_rate, every_k=cfg.grad_accum)


def selector_update_step(selector: MultiModalAlign, optimizer: AdamW,
                         batch: TrainBatch, subsets: SampledSubsets,
                         rewards: torch.Tensor, tau, *, train_cfg: TrainConfig,
                         window_size: int) -> dict:
    """One optimizer call over a batch: the surrogate loss, its gradient
    with respect to the selector, and ``optimizer.step()``.

    Returns the JAX package's metrics as 0-d tensors: ``loss``,
    ``grad_norm`` (the global norm of this call's gradient), ``reward_mean``
    and ``reward_std`` (ddof=0).  Afterwards each parameter's ``.grad`` holds
    the gradient the optimizer applied (this call's, at ``every_k`` 1)."""
    optimizer.zero_grad(set_to_none=True)
    loss = grpo_surrogate_loss(selector, batch, subsets, rewards, tau,
                               window_size=window_size,
                               adv_eps=train_cfg.adv_eps)
    loss.backward()
    grads = [p.grad for p in optimizer.params() if p.grad is not None]
    gnorm = torch.sqrt(sum(g.square().sum() for g in grads))
    optimizer.step()
    return {"loss": loss.detach(), "grad_norm": gnorm,
            "reward_mean": rewards.mean(), "reward_std": rewards.std(correction=0)}


def optimizer_state(optimizer: AdamW, selector: MultiModalAlign) -> dict:
    """The optimizer's state as numpy, keyed by the selector's parameter
    names: ``{"step", "mini_step", "exp_avg": {name: ...}, "exp_avg_sq":
    {...}, "acc_grads": {...}}``; zeros and step 0 before the first update."""
    pos = {id(p): i for i, p in enumerate(optimizer.params())}
    out = {"step": 0, "mini_step": optimizer.mini_step, "exp_avg": {},
           "exp_avg_sq": {}, "acc_grads": {}}
    for name, p in selector.named_parameters():
        st = optimizer.state.get(p, {})
        if "step" in st:
            out["step"] = int(st["step"])
        for key in ("exp_avg", "exp_avg_sq"):
            val = st.get(key)
            out[key][name] = (np.zeros(p.shape, np.float32) if val is None
                              else val.detach().cpu().numpy())
        out["acc_grads"][name] = optimizer.acc_grads[pos[id(p)]].cpu().numpy()
    return out


def load_optimizer_state(optimizer: AdamW, selector: MultiModalAlign, state: dict):
    """Inverse of :func:`optimizer_state`."""
    pos = {id(p): i for i, p in enumerate(optimizer.params())}
    optimizer.mini_step = int(state["mini_step"])
    for name, p in selector.named_parameters():
        def put(x):
            return torch.tensor(np.asarray(x), dtype=p.dtype, device=p.device)
        optimizer.state[p] = {
            "step": torch.tensor(float(state["step"]), dtype=torch.float32),
            "exp_avg": put(state["exp_avg"][name]),
            "exp_avg_sq": put(state["exp_avg_sq"][name])}
        optimizer.acc_grads[pos[id(p)]] = put(state["acc_grads"][name])
