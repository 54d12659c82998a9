"""Qwen2 decoder — the language model of LLaVA-Video-7B-Qwen2 — in PyTorch:
the serving half of ``tspo_tpu/models/qwen2.py``.

  - :class:`Qwen2Model`, an ``nn.Module`` with the HF ``Qwen2ForCausalLM``
    parameter names (``model.embed_tokens``, ``model.layers.{i}...``,
    ``model.norm``, ``lm_head``), so an HF or llava_qwen state dict loads
    under the ``model.`` prefix;
  - :class:`KVCache`, preallocated [L, B, T, KV, hd] tensors;
  - :func:`qwen2_forward`, the decoder over embeddings appended after the
    cache.  A block of ``flash_threshold`` (512) or more tokens goes through
    ``ops/flash_attention.py`` (the Hopper GQA kernel on the card, its plain
    version on the CPU), with no KV repeat: a prefill from an empty cache,
    or a suffix after a filled one at ``q_offset`` = the cache length over
    the cache's keys; shorter blocks, decode steps among them, take the
    dense path;
  - :func:`greedy_decode`, ragged rows with per-row rope positions, a Python
    loop that stops when every row is done;
  - the split prefill and chunked decode behind the streams
    (:func:`decode_prefill`, :func:`decode_chunk`,
    :func:`greedy_decode_stream`, :func:`stream_detokenize`), the suffix
    prefill and in-place continuation behind conversation prefix reuse
    (:func:`prefill_extend`, :func:`greedy_decode_continue` and its stream);
  - nucleus sampling (:func:`sample_token`, :func:`sample_decode`, its
    split and streamed forms, :func:`prefill_extend_sampled`) with Gumbel
    noise from an explicit ``torch.Generator``, one [B, V] draw an emitted
    token in the JAX package's key-split order, or the caller's ``noise``;
  - prompt-lookup speculative decode (:func:`build_spec_lookup`,
    :func:`greedy_decode_speculative`), greedy-exact.

A chunk of decode steps runs without a host sync and synchronises once at
its end; it stops at ``max_new_tokens``, not at a multiple of the chunk (the
steps the JAX package runs past it write only slots that are rewound over).

Numerics are the JAX package's, not HF's: RMS norm multiplies the weight in
fp32 before the cast down; rope angles are fp32 from an fp32 ``inv_freq`` in
the half-rotation layout; attention scores and softmax are fp32 and masked
with the finite -1e30, never -inf.

Out of scope here, queued in ROADMAP.md: int8 weights, LoRA.
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
                  flash_threshold: int = 512, flash_suffix: bool = False):
    """Run the decoder over ``embeds`` [B, S, D] appended after the cache.

    positions:  [S] (or per-row [B, S]) rope positions of the new tokens.
    attn_valid: [B, T] bool validity of the cache's key slots (T = its
                capacity); the new tokens are written at
                [cache.length, cache.length + S).
    Returns (hidden [B, S, D] after the final norm, cache) with the cache
    written in place and advanced by S.  Causality within the block is
    enforced here.  A block of ``flash_threshold`` or more tokens takes the
    flash kernel with the per-row valid prefix lengths of ``attn_valid``:
    from an empty cache over its first S slots, or, with ``flash_suffix``
    (the JAX package's ``flash_q_offset``), after a filled one over the
    slots [0, start + S) with its rows at ``q_offset`` = start.  The caller
    of ``flash_suffix`` promises that each row's valid slots below
    start + S form a prefix (a hole-free cache); a flash block after a
    filled cache without it raises."""
    cfg = model.cfg
    B, S, D = embeds.shape
    start = cache.length
    if start + S > cache.k.shape[2]:
        raise ValueError(f"a cache of {cache.k.shape[2]} slots cannot take "
                         f"{S} tokens after {start}")
    use_flash = S >= flash_threshold
    if use_flash and start != 0 and not flash_suffix:
        raise ValueError("a flash block after a filled cache needs "
                         "flash_suffix (a hole-free cache below the block)")
    dev = embeds.device
    T, end = cache.k.shape[2], start + S

    if use_flash:
        lengths = attn_valid[:, :end].sum(dim=1).to(torch.int32)
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
            ctx = flash_attention(q, k_l[:, :end], v_l[:, :end], lengths,
                                  causal=True, window=cfg.sliding_window,
                                  q_offset=start)
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

def _prefill(model: Qwen2Model, prompt_embeds: torch.Tensor,
             prompt_valid: torch.Tensor, cache: KVCache) -> tuple:
    """Prefill of right-padded prompts into an empty cache.  Returns (fp32
    logits [B, V] at each row's last valid token, n_prompt [B])."""
    B, S, _ = prompt_embeds.shape
    dev = prompt_embeds.device
    attn_valid = torch.zeros(B, cache.k.shape[2], dtype=torch.bool, device=dev)
    attn_valid[:, :S] = prompt_valid
    hidden, _ = qwen2_forward(model, prompt_embeds, cache,
                              torch.arange(S, device=dev), attn_valid)
    n_prompt = prompt_valid.sum(dim=1)
    # the last *valid* prompt token predicts the first output token
    return lm_logits(model, hidden[torch.arange(B, device=dev), n_prompt - 1]), n_prompt


def _key_valid(prompt_valid: torch.Tensor, T: int) -> torch.Tensor:
    """[B, T] key validity of a decode: the prompt's valid slots, then every
    slot past the prompt (a decode slot is attendable once written)."""
    B, S = prompt_valid.shape
    kv = torch.ones(B, T, dtype=torch.bool, device=prompt_valid.device)
    kv[:, :S] = prompt_valid
    return kv


def _step(model: Qwen2Model, tok: torch.Tensor, cache: KVCache,
          pos: torch.Tensor, key_valid: torch.Tensor, dtype) -> torch.Tensor:
    """One decode step: ``tok`` [B] appended at the cache length with rope
    positions ``pos`` [B, 1].  Returns the fp32 logits [B, V] it predicts."""
    T = cache.k.shape[2]
    emb = embed_tokens(model, tok)[:, None, :].to(dtype)
    av = key_valid & (torch.arange(T, device=tok.device)[None, :] < cache.length + 1)
    h, _ = qwen2_forward(model, emb, cache, pos, av)
    return lm_logits(model, h[:, -1])


def _argmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1)


def _prefill_first(model, prompt_embeds, prompt_valid, cache, pick, step_logits):
    """:func:`_prefill` and the first token: (first_tok [B], cache, pos0 [B])."""
    logits, n_prompt = _prefill(model, prompt_embeds, prompt_valid, cache)
    if step_logits is not None:
        step_logits.append(logits)
    return pick(logits), cache, n_prompt


def _decode(model, prompt_embeds, prompt_valid, cache, max_new_tokens, eos,
            pick, step_logits):
    """The loop of :func:`greedy_decode` and :func:`sample_decode`: ``pick``
    maps each [B, V] logits to the next tokens [B]."""
    B, dev = prompt_embeds.shape[0], prompt_embeds.device
    tok, cache, n_prompt = _prefill_first(model, prompt_embeds, prompt_valid, cache,
                                          pick, step_logits)
    out = torch.full((B, max_new_tokens), eos, dtype=torch.long, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    key_valid = _key_valid(prompt_valid, cache.k.shape[2])
    i = 0
    while i < max_new_tokens and not bool(done.all()):
        out[:, i] = torch.where(done, torch.full_like(tok, eos), tok)
        done = done | (tok == eos)
        logits = _step(model, tok, cache, (n_prompt + i)[:, None], key_valid,
                       prompt_embeds.dtype)
        if step_logits is not None:
            step_logits.append(logits)
        tok = pick(logits)
        i += 1
    if B == 1:
        return out[0], i
    return out, i


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
    eos = model.cfg.eos_token_id if eos_token_id is None else eos_token_id
    return _decode(model, prompt_embeds, prompt_valid, cache, max_new_tokens,
                   eos, _argmax, step_logits)


# ---------------------------------------------------------------------------
# Sampled decode (temperature / nucleus top-p)
# ---------------------------------------------------------------------------

def gumbel_noise(shape, generator: torch.Generator | None = None,
                 device="cpu") -> torch.Tensor:
    """Standard Gumbel draws -log(-log(U)) in fp32 from ``generator``, with U
    uniform and clamped below at the smallest normal fp32, as
    ``jax.random.gumbel`` draws U from [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def _gumbel(logits: torch.Tensor, generator, noise) -> torch.Tensor:
    """The [B, V] Gumbel draw of one emitted token: the next array of the
    iterator ``noise`` when given (the caller's draws, e.g. the JAX
    package's), else one draw from ``generator``."""
    if noise is not None:
        return torch.as_tensor(np.array(next(noise), np.float32),
                               device=logits.device).reshape(logits.shape)
    return gumbel_noise(logits.shape, generator, logits.device)


def sample_token(logits: torch.Tensor, temperature: float, top_p: float,
                 noise: torch.Tensor) -> torch.Tensor:
    """Nucleus sampling over [B, V] fp32 logits with the Gumbel draw ``noise``
    [B, V]: temperature-scale, keep the smallest prefix of descending-
    probability tokens whose mass reaches ``top_p`` (the top-1 token always
    survives), and take the argmax of kept logits + noise, which samples the
    renormalised nucleus (``jax.random.categorical``).  Returns [B] ids.

    The descending order is the JAX package's ``argsort(scaled)[..., ::-1]``:
    a stable ascending sort, flipped, so among equal logits the HIGHER index
    comes first.  The noise is added in that order, so the tie order decides
    the token; bf16 products cast to fp32 tie often over 152k tokens."""
    dev = logits.device
    t = torch.tensor(max(float(temperature), 1e-6), dtype=torch.float32, device=dev)
    scaled = logits.float() / t
    order = torch.argsort(scaled, dim=-1, stable=True).flip(-1)
    sorted_logits = torch.gather(scaled, -1, order)
    sorted_p = torch.softmax(sorted_logits, dim=-1)
    prefix_mass = torch.cumsum(sorted_p, dim=-1) - sorted_p        # exclusive
    keep = prefix_mass < torch.tensor(float(top_p), dtype=torch.float32, device=dev)
    masked = torch.where(keep, sorted_logits,
                         torch.full((), -torch.inf, device=dev))
    choice = torch.argmax(masked + noise, dim=-1)
    return torch.gather(order, -1, choice[:, None])[:, 0]


def _sampler(temperature, top_p, generator, noise):
    return lambda logits: sample_token(logits, temperature, top_p,
                                       _gumbel(logits, generator, noise))


@torch.inference_mode()
def sample_decode(model: Qwen2Model, prompt_embeds: torch.Tensor,
                  prompt_valid: torch.Tensor, cache: KVCache,
                  max_new_tokens: int, temperature: float, top_p: float,
                  eos_token_id: int | None = None,
                  generator: torch.Generator | None = None, noise=None,
                  step_logits: list | None = None):
    """Sampled generation: :func:`greedy_decode`'s loop with the argmax
    replaced by :func:`sample_token`.  One [B, V] Gumbel draw an emitted
    token, the prefill's token first, from ``generator`` (on the model's
    device) or, in order, from the iterator ``noise``; rows of a step get
    distinct draws.  Returns (tokens, n_steps) as :func:`greedy_decode`;
    ``step_logits`` gets each step's fp32 logits before sampling."""
    eos = model.cfg.eos_token_id if eos_token_id is None else eos_token_id
    return _decode(model, prompt_embeds, prompt_valid, cache, max_new_tokens,
                   eos, _sampler(temperature, top_p, generator, noise), step_logits)


# ---------------------------------------------------------------------------
# Chunked streaming decode (token-exact vs the fused loops)
# ---------------------------------------------------------------------------

@torch.inference_mode()
def decode_prefill(model: Qwen2Model, prompt_embeds: torch.Tensor,
                   prompt_valid: torch.Tensor, cache: KVCache,
                   step_logits: list | None = None):
    """The prefill half of :func:`greedy_decode`, so that decode can go on
    in host-visible chunks.  Returns (first_tok [B], cache, pos0 [B])."""
    return _prefill_first(model, prompt_embeds, prompt_valid, cache, _argmax,
                          step_logits)


@torch.inference_mode()
def sample_prefill(model: Qwen2Model, prompt_embeds: torch.Tensor,
                   prompt_valid: torch.Tensor, cache: KVCache,
                   temperature: float, top_p: float,
                   generator: torch.Generator | None = None, noise=None):
    """The prefill half of :func:`sample_decode`: its first token takes the
    first Gumbel draw.  Returns (first_tok [B], cache, pos0 [B])."""
    return _prefill_first(model, prompt_embeds, prompt_valid, cache,
                          _sampler(temperature, top_p, generator, noise), None)


def _chunk(model, tok, cache, pos0, i0, prompt_valid, done, chunk, eos, pick,
           steps, step_logits):
    B = tok.shape[0]
    out = torch.full((B, chunk), eos, dtype=torch.long, device=tok.device)
    key_valid = _key_valid(prompt_valid, cache.k.shape[2])
    for j in range(chunk if steps is None else min(steps, chunk)):
        out[:, j] = torch.where(done, torch.full_like(tok, eos), tok)
        done = done | (tok == eos)
        logits = _step(model, tok, cache, (pos0 + i0 + j)[:, None], key_valid,
                       cache.k.dtype)
        if step_logits is not None:
            step_logits.append(logits)
        tok = pick(logits)
    return out, tok, cache, done


@torch.inference_mode()
def decode_chunk(model: Qwen2Model, tok: torch.Tensor, cache: KVCache,
                 pos0: torch.Tensor, i0: int, prompt_valid: torch.Tensor,
                 done: torch.Tensor, chunk: int, eos: int,
                 steps: int | None = None, step_logits: list | None = None):
    """Up to ``chunk`` greedy decode steps continuing from (tok, cache), step
    for step :func:`greedy_decode`'s body, with no host sync: ``i0`` is the
    global decode step of ``tok``, rows already ``done`` emit EOS.  ``steps``
    (<= chunk) ends the chunk early, at the caller's ``max_new_tokens``; the
    out columns past it stay EOS.  Returns (out [B, chunk], tok, cache, done)."""
    return _chunk(model, tok, cache, pos0, i0, prompt_valid, done, chunk, eos,
                  _argmax, steps, step_logits)


@torch.inference_mode()
def sample_chunk(model: Qwen2Model, tok: torch.Tensor, cache: KVCache,
                 pos0: torch.Tensor, i0: int, prompt_valid: torch.Tensor,
                 done: torch.Tensor, chunk: int, eos: int, temperature: float,
                 top_p: float, generator: torch.Generator | None = None,
                 noise=None, steps: int | None = None):
    """:func:`decode_chunk` with :func:`sample_token` for the argmax: one
    Gumbel draw a step, so chunks reproduce :func:`sample_decode`."""
    return _chunk(model, tok, cache, pos0, i0, prompt_valid, done, chunk, eos,
                  _sampler(temperature, top_p, generator, noise), steps, None)


def _check_stream_cache(cache: KVCache, S: int, max_new_tokens: int, chunk: int):
    """The JAX package's capacity rule: S + ceil(max_new/chunk) * chunk slots
    (it always runs whole chunks)."""
    n_chunks = -(-max_new_tokens // chunk)
    if cache.k.shape[2] < S + n_chunks * chunk:
        raise ValueError(
            f"stream cache needs >= {S + n_chunks * chunk} slots "
            f"(S={S} + {n_chunks}x{chunk}), got {cache.k.shape[2]}")
    return n_chunks


def _blocks(run_chunk, tok, max_new_tokens, chunk, n_chunks):
    """The stream loop: one chunk at a time, stopped when every row is done;
    yields each chunk's np.int32 [B, <= chunk] block, EOS-padded."""
    done = torch.zeros(tok.shape[0], dtype=torch.bool, device=tok.device)
    for c in range(n_chunks):
        if bool(done.all()):
            return
        n = min(chunk, max_new_tokens - c * chunk)
        out, tok, _, done = run_chunk(tok, c * chunk, done, n)
        yield out[:, :n].to(torch.int32).cpu().numpy()


def greedy_decode_stream(model: Qwen2Model, prompt_embeds: torch.Tensor,
                         prompt_valid: torch.Tensor, cache: KVCache,
                         max_new_tokens: int, eos_token_id: int | None = None,
                         chunk: int = 8, step_logits: list | None = None):
    """Generator over greedy decode: yields np.int32 [B, <= chunk] blocks of
    fresh tokens as they land, token-exact vs :func:`greedy_decode` (same
    EOS padding).  The cache must have >= S + ceil(max_new/chunk) * chunk
    slots, the JAX package's rule."""
    eos = model.cfg.eos_token_id if eos_token_id is None else eos_token_id
    n_chunks = _check_stream_cache(cache, prompt_embeds.shape[1],
                                   max_new_tokens, chunk)
    tok, cache, pos0 = decode_prefill(model, prompt_embeds, prompt_valid, cache,
                                      step_logits=step_logits)
    yield from _blocks(
        lambda t, i0, done, n: decode_chunk(model, t, cache, pos0, i0, prompt_valid,
                                            done, chunk, eos, steps=n,
                                            step_logits=step_logits),
        tok, max_new_tokens, chunk, n_chunks)


def sample_decode_stream(model: Qwen2Model, prompt_embeds: torch.Tensor,
                         prompt_valid: torch.Tensor, cache: KVCache,
                         max_new_tokens: int, temperature: float, top_p: float,
                         eos_token_id: int | None = None, chunk: int = 8,
                         generator: torch.Generator | None = None, noise=None):
    """Generator over sampled decode: yields np.int32 [B, <= chunk] blocks,
    token-exact vs :func:`sample_decode` with the same generator state or
    noise.  The cache contract of :func:`greedy_decode_stream`."""
    eos = model.cfg.eos_token_id if eos_token_id is None else eos_token_id
    n_chunks = _check_stream_cache(cache, prompt_embeds.shape[1],
                                   max_new_tokens, chunk)
    tok, cache, pos0 = sample_prefill(model, prompt_embeds, prompt_valid, cache,
                                      temperature, top_p, generator, noise)
    yield from _blocks(
        lambda t, i0, done, n: sample_chunk(model, t, cache, pos0, i0, prompt_valid,
                                            done, chunk, eos, temperature, top_p,
                                            generator, noise, steps=n),
        tok, max_new_tokens, chunk, n_chunks)


def stream_detokenize(blocks, decode, eos_id: int):
    """Turn a :func:`greedy_decode_stream` block iterator into TEXT DELTAS
    whose concatenation equals decoding the full token sequence at once —
    the shared state machine behind every backbone's ``generate_stream``.

    Detokenization is prefix-based: each block decodes the full emitted
    prefix and yields the new suffix, so BPE merges across chunk boundaries
    render correctly.  A trailing U+FFFD is held back — a multibyte
    character whose byte-level BPE tokens straddle the chunk boundary
    decodes as the replacement char NOW but completes next chunk, and the
    prefix-slice never re-sends emitted text — then a genuinely-invalid
    tail is flushed as-is at end of stream.  An all-eos block after any
    real token ends the stream (eos-padding semantics of the chunked
    decode)."""
    toks: list = []
    sent = ""
    text = ""
    for block in blocks:
        fresh = [int(t) for t in block[0] if int(t) != eos_id]
        if not fresh and toks:
            break               # eos padding only: stream is done
        toks.extend(fresh)
        text = decode(toks)
        stable = text
        while stable and stable[-1] == "�":
            stable = stable[:-1]
        if len(stable) > len(sent):
            yield stable[len(sent):]
            sent = stable
    if len(text) > len(sent):   # flush a genuinely-invalid tail as-is
        yield text[len(sent):]


# ---------------------------------------------------------------------------
# Suffix prefill and in-place continuation (conversation prefix reuse)
# ---------------------------------------------------------------------------

def _extend(model, embeds, valid_len, cache):
    B, S, _ = embeds.shape
    T, start, dev = cache.k.shape[2], cache.length, embeds.device
    attn_valid = (torch.arange(T, device=dev) < start + valid_len)[None].expand(B, T)
    hidden, cache = qwen2_forward(model, embeds, cache,
                                  start + torch.arange(S, device=dev), attn_valid,
                                  flash_suffix=True)
    return lm_logits(model, hidden[:, valid_len - 1])


@torch.inference_mode()
def prefill_extend(model: Qwen2Model, embeds: torch.Tensor, valid_len: int,
                   cache: KVCache, step_logits: list | None = None):
    """Append a prompt-suffix block after an already-prefilled cache: the
    incremental half of conversation prefix reuse (only the new tokens need
    a forward pass).

    embeds [B, S, D] right-padded, the first ``valid_len`` real; written at
    [cache.length, cache.length + S) with rope positions continuing from
    cache.length.  The cache below cache.length must be hole-free (every
    slot real).  Pads are masked as keys; their slots are reclaimed by the
    caller setting ``cache.length`` to the old length + ``valid_len``.  A
    block of 512 or more tokens takes the flash kernel at ``q_offset`` =
    cache.length over the cache's keys, shorter blocks the dense path.  Returns (tok [B], cache): the greedy token after
    the last real position; ``step_logits`` gets its fp32 logits."""
    logits = _extend(model, embeds, int(valid_len), cache)
    if step_logits is not None:
        step_logits.append(logits)
    return _argmax(logits), cache


@torch.inference_mode()
def prefill_extend_sampled(model: Qwen2Model, embeds: torch.Tensor,
                           valid_len: int, cache: KVCache, temperature: float,
                           top_p: float, generator: torch.Generator | None = None,
                           noise=None):
    """:func:`prefill_extend` with a SAMPLED last token, taking one Gumbel
    draw as :func:`sample_prefill` does.  Returns (tok [B], cache); the
    generator's state has advanced in place."""
    logits = _extend(model, embeds, int(valid_len), cache)
    return sample_token(logits, temperature, top_p,
                        _gumbel(logits, generator, noise)), cache


def _continue_setup(first_tok, cache: KVCache, max_new_tokens: int, chunk: int):
    T, L = cache.k.shape[2], cache.length
    n_chunks = -(-max_new_tokens // chunk)
    if L + n_chunks * chunk > T:
        raise ValueError(
            f"conversation cache needs >= {L + n_chunks * chunk} slots "
            f"(L={L} + {n_chunks}x{chunk}), got {T}")
    dev = cache.k.device
    tok = torch.as_tensor(first_tok, device=dev).reshape(1).long()
    pv = torch.ones(1, 1, dtype=torch.bool, device=dev)
    pos0 = torch.full((1,), L, dtype=torch.long, device=dev)
    return tok, pv, pos0, n_chunks


def _trim_at_eos(toks: np.ndarray, eos: int) -> np.ndarray:
    if eos in toks:
        toks = toks[: int(np.argmax(toks == eos))]
    return toks


def greedy_decode_continue_stream(model: Qwen2Model, first_tok, cache: KVCache,
                                  max_new_tokens: int,
                                  eos_token_id: int | None = None,
                                  chunk: int = 8, final: dict | None = None,
                                  step_logits: list | None = None):
    """Greedy decode continuing in place from a hole-free prefilled cache
    (every slot below cache.length real: the conversation-reuse invariant),
    as a generator of np.int32 [1, <= chunk] blocks, EOS-padded past the
    answer (:func:`stream_detokenize` consumes them).  Reuses
    :func:`decode_chunk` with an all-ones width-1 prompt mask, so validity is
    ``slot < cache.length + 1``; rope positions continue from cache.length.

    When ``final`` (a dict) is given it is filled with ``{"tokens": EOS-
    trimmed np array, "cache": cache}`` once the generator is exhausted: a
    consumer that abandons the stream never commits."""
    eos = model.cfg.eos_token_id if eos_token_id is None else eos_token_id
    tok, pv, pos0, n_chunks = _continue_setup(first_tok, cache, max_new_tokens, chunk)
    outs = []
    for blk in _blocks(
            lambda t, i0, done, n: decode_chunk(model, t, cache, pos0, i0, pv, done,
                                                chunk, eos, steps=n,
                                                step_logits=step_logits),
            tok, max_new_tokens, chunk, n_chunks):
        outs.append(blk[0])
        yield blk
    toks = np.concatenate(outs) if outs else np.zeros(0, np.int32)
    if final is not None:
        final["tokens"] = _trim_at_eos(toks, eos)
        final["cache"] = cache


def greedy_decode_continue(model: Qwen2Model, first_tok, cache: KVCache,
                           max_new_tokens: int, eos_token_id: int | None = None,
                           chunk: int = 32, step_logits: list | None = None):
    """:func:`greedy_decode_continue_stream` run to its end: returns
    (tokens np.int32 [<= max_new], EOS-trimmed, cache).  Steps run past the
    EOS write only slots the caller rewinds over."""
    final: dict = {}
    for _ in greedy_decode_continue_stream(model, first_tok, cache,
                                           max_new_tokens, eos_token_id, chunk,
                                           final, step_logits):
        pass
    return final["tokens"], final["cache"]


# ---------------------------------------------------------------------------
# Prompt-lookup speculative decode (B=1, exact greedy)
# ---------------------------------------------------------------------------

def build_spec_lookup(text_ids) -> tuple:
    """Pad a prompt's text token ids (media sentinels filtered out) into the
    lookup corpus of :func:`greedy_decode_speculative`, to a multiple of 128
    as the JAX package does.  Returns (lookup_ids [Lb] np.int32,
    lookup_valid [Lb] bool)."""
    lk = np.asarray(list(text_ids), np.int32)
    Lb = max(128, -(-len(lk) // 128) * 128)
    lookup = np.zeros(Lb, np.int32)
    lookup[: len(lk)] = lk
    return lookup, np.arange(Lb) < len(lk)


def _draft(hist, hvalid, prev: int, tok: int, d: int, eos: int) -> np.ndarray:
    """The ``d`` tokens that follow the most recent (prev, tok) 2-gram of
    ``hist`` (valid positions only), EOS where there is none."""
    H = len(hist)
    m = hvalid[:-1] & hvalid[1:] & (hist[:-1] == prev) & (hist[1:] == tok)
    p_best = int(np.flatnonzero(m)[-1]) if m.any() else -1
    idx = p_best + 2 + np.arange(d)
    didx = np.clip(idx, 0, H - 1)
    return np.where((p_best >= 0) & (idx < H) & hvalid[didx], hist[didx], eos)


@torch.inference_mode()
def greedy_decode_speculative(model: Qwen2Model, prompt_embeds: torch.Tensor,
                              prompt_valid: torch.Tensor, cache: KVCache,
                              max_new_tokens: int, lookup_ids, lookup_valid,
                              eos_token_id: int | None = None, draft_len: int = 8,
                              step_logits: list | None = None):
    """Greedy decode with prompt-lookup speculation: the same tokens as
    :func:`greedy_decode`, in fewer forward passes when drafts are accepted.

    Each round drafts the ``draft_len`` tokens that followed the most recent
    2-gram match of the last two emitted tokens in [``lookup_ids`` ++
    generated so far] (host side, a few hundred ids), verifies them in ONE
    forward over [current, draft_1..draft_d] (dense: d + 1 rows), accepts
    the longest prefix whose argmax agrees (never past an EOS), and rewinds
    ``cache.length`` over the rejected positions; their stale slots are
    overwritten by the next verify block before they are ever attendable.
    B must be 1; the cache must hold S + max_new_tokens + draft_len slots.

    Returns (tokens [max_new_tokens], n_valid, n_forward_passes).
    ``step_logits`` gets the fp32 [1, V] logits each emitted token was
    chosen from, in emission order."""
    eos = model.cfg.eos_token_id if eos_token_id is None else eos_token_id
    B, S, _ = prompt_embeds.shape
    if B != 1:
        raise ValueError("speculative decode is single-row (B=1)")
    T, d, dev = cache.k.shape[2], draft_len, prompt_embeds.device
    if T < S + max_new_tokens + d:
        raise ValueError(
            f"cache too small for speculation: need >= S+max_new+draft_len "
            f"= {S + max_new_tokens + d}, got {T}")
    logits, n_prompt = _prefill(model, prompt_embeds, prompt_valid, cache)
    if step_logits is not None:
        step_logits.append(logits)
    tok, pos0 = int(_argmax(logits[0])), int(n_prompt[0])

    lookup = np.asarray(lookup_ids, np.int64)
    lvalid = np.asarray(lookup_valid, bool)
    nz = np.flatnonzero(lvalid)
    prev0 = int(lookup[nz[-1]]) if nz.size else -1
    OUT = max_new_tokens + d + 2
    out = np.full(OUT, eos, np.int64)
    key_valid = _key_valid(prompt_valid, T)
    slots = torch.arange(T, device=dev)[None, :]
    rows = torch.arange(d + 1, device=dev)
    i, done, n_fwd = 0, False, 0
    while i < max_new_tokens and not done:
        drafts = _draft(np.concatenate([lookup, out]),
                        np.concatenate([lvalid, np.arange(OUT) < i]),
                        int(out[i - 1]) if i > 0 else prev0, tok, d, eos)
        # one verify forward over [tok, drafts]
        ids = torch.as_tensor(np.concatenate([[tok], drafts]), device=dev)
        emb = embed_tokens(model, ids)[None].to(prompt_embeds.dtype)
        L = cache.length
        h, _ = qwen2_forward(model, emb, cache, pos0 + i + rows,
                             key_valid & (slots < L + d + 1))
        logits = lm_logits(model, h[0])                               # [d+1, V]
        nxt = _argmax(logits).cpu().numpy()
        n_fwd += 1
        # nxt[j] is the model's token after position j (0 = tok, j = draft j):
        # accepted drafts (draft_j == nxt[j-1]) are the next outputs, and the
        # following round's tok is nxt[a]
        acc = np.cumprod(drafts == nxt[:-1])
        done_tok = done or tok == eos
        is_eos = drafts == eos
        pre_eos = np.cumsum(is_eos) - is_eos
        take = (acc == 1) & (pre_eos == 0) & (not done_tok)
        a = int(take.sum())
        out[i] = eos if done else tok
        out[i + 1:i + 1 + d] = np.where(take, drafts, eos)
        if step_logits is not None:
            for r in range(a + 1):
                step_logits.append(logits[r:r + 1])
        done = done_tok or bool((take & is_eos).any())
        tok = tok if done else int(nxt[a])
        cache.length = L + 1 + a
        i += 1 + a
    return (torch.as_tensor(out[:max_new_tokens], device=dev),
            min(i, max_new_tokens), n_fwd)
