"""Qwen2 decoder — the language model of LLaVA-Video-7B-Qwen2 — in PyTorch:
the greedy-serving subset of ``tspo_tpu/models/qwen2.py``.

  - :class:`Qwen2Model`, an ``nn.Module`` with the HF ``Qwen2ForCausalLM``
    parameter names (``model.embed_tokens``, ``model.layers.{i}...``,
    ``model.norm``, ``lm_head``), so an HF or llava_qwen state dict loads
    under the ``model.`` prefix;
  - :class:`KVCache`, preallocated [L, B, T, KV, hd] tensors;
  - :func:`qwen2_forward`, the decoder over embeddings appended after the
    cache.  A prompt of ``flash_threshold`` (512) or more tokens goes through
    ``ops/flash_attention.py`` (the Hopper GQA kernel on the card, its plain
    version on the CPU), with no KV repeat; shorter blocks, decode steps
    among them, take the dense path;
  - :func:`greedy_decode`, ragged rows with per-row rope positions, a Python
    loop that stops when every row is done.

Numerics are the JAX package's, not HF's: RMS norm multiplies the weight in
fp32 before the cast down; rope angles are fp32 from an fp32 ``inv_freq`` in
the half-rotation layout; attention scores and softmax are fp32 and masked
with the finite -1e30, never -inf.

Out of scope here, queued in ROADMAP.md: sampled, streamed and speculative
decode, ``prefill_extend`` with ``q_offset``, int8 weights, LoRA.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..ops.flash_attention import flash_attention

_NEG = -1e30


@dataclass(frozen=True)
class Qwen2Config:
    vocab_size: int = 152064
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_layers: int = 28
    num_heads: int = 28
    num_kv_heads: int = 4
    head_dim: int = 128
    rope_theta: float = 1_000_000.0
    rms_eps: float = 1e-6
    max_position_embeddings: int = 32768
    tie_word_embeddings: bool = False
    eos_token_id: int = 151645  # <|im_end|> for chat models
    # Llama-family knobs: bias-free attention projections, linear rope
    # position scaling, Mistral sliding-window attention
    qkv_bias: bool = True
    rope_scaling_factor: float = 1.0
    sliding_window: int | None = None

    @classmethod
    def tiny(cls) -> "Qwen2Config":
        return cls(vocab_size=512, hidden_size=64, intermediate_size=128,
                   num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                   rope_theta=10_000.0, max_position_embeddings=128,
                   eos_token_id=511)

    @classmethod
    def llava_video_7b(cls) -> "Qwen2Config":
        return cls()  # Qwen2-7B-Instruct geometry


class KVCache:
    """Preallocated K/V of every layer, [L, B, T, KV, hd] each.
    :func:`qwen2_forward` writes the new positions in place and advances
    ``length`` (the number of written positions), so one cache serves a
    prefill and every decode step without a copy."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor, length: int = 0):
        self.k, self.v, self.length = k, v, int(length)

    @classmethod
    def create(cls, cfg: Qwen2Config, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cpu") -> "KVCache":
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# Modules (HF Qwen2ForCausalLM names)
# ---------------------------------------------------------------------------

class Qwen2RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.eps = eps

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


class Qwen2Attention(nn.Module):
    def __init__(self, cfg: Qwen2Config):
        super().__init__()
        D, hd = cfg.hidden_size, cfg.head_dim
        self.q_proj = nn.Linear(D, cfg.num_heads * hd, bias=cfg.qkv_bias)
        self.k_proj = nn.Linear(D, cfg.num_kv_heads * hd, bias=cfg.qkv_bias)
        self.v_proj = nn.Linear(D, cfg.num_kv_heads * hd, bias=cfg.qkv_bias)
        self.o_proj = nn.Linear(cfg.num_heads * hd, D, bias=False)


class Qwen2MLP(nn.Module):
    def __init__(self, cfg: Qwen2Config):
        super().__init__()
        D, I = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = nn.Linear(D, I, bias=False)
        self.up_proj = nn.Linear(D, I, bias=False)
        self.down_proj = nn.Linear(I, D, bias=False)

    def forward(self, x):
        return self.down_proj(nn.functional.silu(self.gate_proj(x)) * self.up_proj(x))


class Qwen2DecoderLayer(nn.Module):
    def __init__(self, cfg: Qwen2Config):
        super().__init__()
        self.input_layernorm = Qwen2RMSNorm(cfg.hidden_size, cfg.rms_eps)
        self.self_attn = Qwen2Attention(cfg)
        self.post_attention_layernorm = Qwen2RMSNorm(cfg.hidden_size, cfg.rms_eps)
        self.mlp = Qwen2MLP(cfg)


class Qwen2Decoder(nn.Module):
    def __init__(self, cfg: Qwen2Config):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(Qwen2DecoderLayer(cfg)
                                    for _ in range(cfg.num_layers))
        self.norm = Qwen2RMSNorm(cfg.hidden_size, cfg.rms_eps)


class Qwen2Model(nn.Module):
    """Qwen2ForCausalLM's parameters; the computation is :func:`qwen2_forward`,
    :func:`lm_logits` and :func:`greedy_decode`."""

    def __init__(self, cfg: Qwen2Config = Qwen2Config()):
        super().__init__()
        self.cfg = cfg
        self.model = Qwen2Decoder(cfg)
        if not cfg.tie_word_embeddings:
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)


# ---------------------------------------------------------------------------
# Core blocks
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """The weight is multiplied in fp32, then cast down (JAX numerics)."""
    x32 = x.float()
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (y * weight.float()).to(x.dtype)


def rope(positions: torch.Tensor, head_dim: int, theta: float) -> tuple:
    """[S] (or per-row [B, S]) positions -> (cos, sin) [..., head_dim] fp32,
    half-rotation layout, from an fp32 ``inv_freq``."""
    inv_freq = torch.from_numpy(
        (1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))).astype(np.float32)
    ).to(positions.device)
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, hd]; cos/sin [S, hd] (shared) or [B, S, hd] (per-row)."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    if cos.dim() == 3:
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    else:
        c, s = cos[None, :, None, :], sin[None, :, None, :]
    return (x.float() * c + rotated.float() * s).to(x.dtype)


def _attention(q, k, v, mask_bias):
    """q [B,S,H,hd], k/v [B,T,KV,hd] -> [B,S,H,hd]; GQA by grouping the query
    heads.  fp32 scores and softmax; ``mask_bias`` is additive fp32
    [B, 1, S, T]."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    q = q.reshape(B, S, KV, H // KV, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", q, k).float()
    scores = scores / math.sqrt(hd) + mask_bias[:, :, None]
    attn = torch.softmax(scores, dim=-1).to(v.dtype)
    ctx = torch.einsum("bkgst,btkd->bskgd", attn, v)
    return ctx.reshape(B, S, H, hd)


def qwen2_forward(model: Qwen2Model, embeds: torch.Tensor, cache: KVCache,
                  positions: torch.Tensor, attn_valid: torch.Tensor,
                  flash_threshold: int = 512):
    """Run the decoder over ``embeds`` [B, S, D] appended after the cache.

    positions:  [S] (or per-row [B, S]) rope positions of the new tokens.
    attn_valid: [B, T] bool validity of the cache's key slots (T = its
                capacity); the new tokens are written at
                [cache.length, cache.length + S).
    Returns (hidden [B, S, D] after the final norm, cache) with the cache
    written in place and advanced by S.  Causality within the block is
    enforced here.  A block of ``flash_threshold`` or more tokens (only a
    prefill from an empty cache) takes the flash kernel over the first S
    slots, with the per-row valid prefix lengths of ``attn_valid``."""
    cfg = model.cfg
    B, S, D = embeds.shape
    start = cache.length
    if start + S > cache.k.shape[2]:
        raise ValueError(f"a cache of {cache.k.shape[2]} slots cannot take "
                         f"{S} tokens after {start}")
    use_flash = S >= flash_threshold
    if use_flash and start != 0:
        raise ValueError("the flash path is a prefill from an empty cache")
    dev = embeds.device
    T, end = cache.k.shape[2], start + S

    if use_flash:
        lengths = attn_valid[:, :S].sum(dim=1).to(torch.int32)
    else:
        # key j attendable by query i (slot start+i) iff attn_valid[j] and
        # j <= start+i (and within the sliding window when the config sets
        # one, measured in logical positions: a valid slot's rank)
        key_pos = torch.arange(T, device=dev)[None, :]
        q_glob = start + torch.arange(S, device=dev)[:, None]
        ok = (key_pos <= q_glob)[None]                              # [1, S, T]
        valid = attn_valid
        if cfg.sliding_window is not None:
            key_logical = torch.cumsum(valid.int(), dim=1) - 1       # [B, T]
            q_logical = positions.reshape(-1, S).expand(B, S)
            ok = ok & (key_logical[:, None, :]
                       > q_logical[..., None] - cfg.sliding_window)
        # over all T slots, as the JAX package: a row with every key masked
        # (padding past a window) then gets the same finite garbage
        ok = ok & valid[:, None, :]                                  # [B, S, T]
        mask_bias = torch.where(ok, 0.0, _NEG).float()[:, None]

    rope_pos = positions if cfg.rope_scaling_factor == 1.0 else \
        positions / cfg.rope_scaling_factor
    cos, sin = rope(rope_pos, cfg.head_dim, cfg.rope_theta)
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    h = embeds
    for li, layer in enumerate(model.model.layers):
        a = layer.self_attn
        x = layer.input_layernorm(h)
        q = apply_rope(a.q_proj(x).reshape(B, S, H, hd), cos, sin)
        k = apply_rope(a.k_proj(x).reshape(B, S, KV, hd), cos, sin)
        v = a.v_proj(x).reshape(B, S, KV, hd)
        k_l, v_l = cache.k[li], cache.v[li]
        k_l[:, start:end] = k.to(k_l.dtype)
        v_l[:, start:end] = v.to(v_l.dtype)
        if use_flash:
            ctx = flash_attention(q, k_l[:, :S], v_l[:, :S], lengths,
                                  causal=True, window=cfg.sliding_window)
        else:
            ctx = _attention(q, k_l, v_l, mask_bias)
        h = h + a.o_proj(ctx.reshape(B, S, D))
        h = h + layer.mlp(layer.post_attention_layernorm(h))
    cache.length = end
    return model.model.norm(h), cache


def embed_tokens(model: Qwen2Model, input_ids: torch.Tensor) -> torch.Tensor:
    return model.model.embed_tokens.weight[input_ids]


def lm_logits(model: Qwen2Model, hidden: torch.Tensor) -> torch.Tensor:
    """fp32 logits of ``hidden`` [..., D].  Callers pass only the rows they
    need: at S = 11.7k full-prompt logits would be ~7 GB."""
    w = model.model.embed_tokens.weight if model.cfg.tie_word_embeddings \
        else model.lm_head.weight
    return (hidden @ w.T.to(hidden.dtype)).float()


# ---------------------------------------------------------------------------
# Greedy decode
# ---------------------------------------------------------------------------

@torch.inference_mode()
def greedy_decode(model: Qwen2Model, prompt_embeds: torch.Tensor,
                  prompt_valid: torch.Tensor, cache: KVCache,
                  max_new_tokens: int, eos_token_id: int | None = None,
                  step_logits: list | None = None):
    """Greedy generation over right-padded prompts.

    prompt_embeds: [B, S, D]; prompt_valid: [B, S] bool, a valid prefix per
    row (rows may be ragged).  Each row's decode rope positions continue from
    its own valid length while cache slots stay row-aligned at S, S+1, ...
    with the padding masked.  Returns (tokens [B, max_new_tokens] — [max_new]
    for B = 1 — padded with EOS after each row's first EOS, n_steps); the
    loop stops when every row is done.  ``step_logits``, when given (a list,
    or any object with ``append``), gets each step's fp32 [B, V] logits."""
    cfg = model.cfg
    eos = cfg.eos_token_id if eos_token_id is None else eos_token_id
    B, S, D = prompt_embeds.shape
    dev = prompt_embeds.device
    T = cache.k.shape[2]
    n_prompt = prompt_valid.sum(dim=1)                               # [B]

    attn_valid = torch.zeros(B, T, dtype=torch.bool, device=dev)
    attn_valid[:, :S] = prompt_valid
    hidden, cache = qwen2_forward(model, prompt_embeds, cache,
                                  torch.arange(S, device=dev), attn_valid)
    # the last *valid* prompt token predicts the first output token
    logits = lm_logits(model, hidden[torch.arange(B, device=dev), n_prompt - 1])
    if step_logits is not None:
        step_logits.append(logits)
    tok = torch.argmax(logits, dim=-1)

    out = torch.full((B, max_new_tokens), eos, dtype=torch.long, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    key_valid = attn_valid.clone()
    key_valid[:, S:] = True       # decode slots become valid as written
    i = 0
    while i < max_new_tokens and not bool(done.all()):
        out[:, i] = torch.where(done, torch.full_like(tok, eos), tok)
        done = done | (tok == eos)
        emb = embed_tokens(model, tok)[:, None, :].to(prompt_embeds.dtype)
        pos = (n_prompt + i)[:, None]                                # [B, 1]
        av = key_valid & (torch.arange(T, device=dev)[None, :] < cache.length + 1)
        h, cache = qwen2_forward(model, emb, cache, pos, av)
        logits = lm_logits(model, h[:, -1])
        if step_logits is not None:
            step_logits.append(logits)
        tok = torch.argmax(logits, dim=-1)
        i += 1
    if B == 1:
        return out[0], i
    return out, i
