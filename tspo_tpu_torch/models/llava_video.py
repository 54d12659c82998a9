"""LLaVA-Video-7B-Qwen2 backbone: SigLIP tower + projector + Qwen2 decoder,
the answer path, in PyTorch.

Counterpart of ``tspo_tpu/models/llava_video.py``:

  frames -> SigLIP (729 patches, ``vit_attention`` kernel) -> mlp2x_gelu
  projector -> 2x2 average pool (27x27 -> 13x13 = 169 tokens per frame) ->
  grid newline tokens (13 rows x (13 + 1) = 182 tokens per frame) -> spliced
  into the qwen_1_5 chat prompt at the <image> sentinel -> Qwen2 prefill
  (``flash_attention`` kernel from 512 tokens up) -> greedy decode.

As in the reference, frames go through tower and projector first and are
pooled afterwards.  The parameters live in one ``nn.Module``
(:class:`LlavaQwenNet`); :meth:`LLaVAVideoModel.from_torch_checkpoint` reads
the llava_qwen state-dict layout.

Out of scope here, queued in ROADMAP.md: sampled, streamed and speculative
generation, the audio track, multi-round conversations with prefix reuse,
batched generation, log-likelihood scoring and int8 weights.  Asking for one
of them raises ``NotImplementedError``; nothing runs another path instead.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch
from torch import nn

from ..utils.device import resolve_device
from .qwen2 import KVCache, Qwen2Config, Qwen2Model, embed_tokens, greedy_decode
from .siglip import SigLIPConfig, SigLIPVisionTower, siglip_preprocess

IMAGE_TOKEN_INDEX = -200
DEFAULT_IMAGE_TOKEN = "<image>"
# sentinel of the JAX package's audio extension; the port has no audio track
AUDIO_TOKEN_INDEX = -201
DEFAULT_AUDIO_TOKEN = "<audio>"

QWEN15_SYSTEM = "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"

_QUEUED = "not ported yet; queued in ROADMAP.md (Queue 1, left from the second slice)"


@dataclass(frozen=True)
class LLaVAVideoConfig:
    lm: Qwen2Config = field(default_factory=Qwen2Config.llava_video_7b)
    vision: SigLIPConfig = field(default_factory=SigLIPConfig)
    pool_stride: int = 2
    mm_newline_position: str = "grid"
    max_context: int = 16384

    @property
    def pooled_side(self) -> int:
        return self.vision.grid // self.pool_stride

    @property
    def tokens_per_frame(self) -> int:
        s = self.pooled_side
        return s * (s + 1) if self.mm_newline_position == "grid" else s * s

    @classmethod
    def tiny(cls) -> "LLaVAVideoConfig":
        return cls(lm=Qwen2Config.tiny(), vision=SigLIPConfig.tiny(),
                   max_context=512)

    @staticmethod
    def _linear_rope_factor(rope_scaling) -> float:
        """Factor from an HF ``rope_scaling`` dict, accepting only the
        "linear" scheme (``type``/``rope_type``, either key)."""
        if not rope_scaling:
            return 1.0
        kind = str(rope_scaling.get("type",
                                    rope_scaling.get("rope_type",
                                                     "linear"))).lower()
        if kind != "linear":
            raise ValueError(
                f"rope_scaling type {kind!r} is not supported (only HF "
                "'linear' scaling is implemented); refusing to misapply "
                f"factor={rope_scaling.get('factor')} as linear")
        return float(rope_scaling.get("factor", 1.0))

    @classmethod
    def from_hf_config(cls, hf: dict) -> "LLaVAVideoConfig":
        """Build from a LLaVA config.json: LlavaQwen (model_type llava_qwen)
        or the llama/vicuna/mistral family, LM fields at top level plus mm_*
        fields.  The family decides the defaults HF configs omit (qkv biases,
        eos, rope theta).  The SigLIP geometry is so400m-384 with the final
        layer dropped, unless the config carries an explicit
        ``mm_vision_config`` (synthetic rehearsal checkpoints)."""
        family = str(hf.get("model_type", "")).lower() + " " + \
            " ".join(hf.get("architectures", []) or []).lower()
        is_qwen = "qwen" in family or not family.strip()
        lm = Qwen2Config(
            vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            num_kv_heads=hf.get("num_key_value_heads",
                                hf["num_attention_heads"]),
            head_dim=hf.get("head_dim",
                            hf["hidden_size"] // hf["num_attention_heads"]),
            rope_theta=hf.get("rope_theta",
                              1_000_000.0 if is_qwen else 10_000.0),
            rms_eps=hf.get("rms_norm_eps", 1e-6 if is_qwen else 1e-5),
            max_position_embeddings=hf.get("max_position_embeddings",
                                           32768 if is_qwen else 4096),
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
            qkv_bias=hf.get("attention_bias", is_qwen),
            eos_token_id=hf.get("eos_token_id", 151645 if is_qwen else 2),
            sliding_window=hf.get("sliding_window")
            if "mistral" in family else None,
            rope_scaling_factor=cls._linear_rope_factor(
                hf.get("rope_scaling")))
        vision = (SigLIPConfig(**hf["mm_vision_config"])
                  if "mm_vision_config" in hf else SigLIPConfig())
        return cls(lm=lm, vision=vision,
                   pool_stride=hf.get("mm_spatial_pool_stride", 2),
                   mm_newline_position=hf.get("mm_newline_position", "grid"))


def build_qwen15_prompt(question: str,
                        trailer: str = "\nPlease answer with the option's "
                                       "letter from the given choices directly.") -> str:
    """chatml prompt of the reference trainer/demo: system + user(<image>\\n
    + question + trailer) + assistant stub."""
    q = DEFAULT_IMAGE_TOKEN + "\n" + question + trailer
    return (QWEN15_SYSTEM + f"<|im_start|>user\n{q}<|im_end|>\n"
            "<|im_start|>assistant\n")


def tokenize_with_image(prompt: str, encode: Callable, bos_token_id=None) -> list:
    """Split on <image> and insert IMAGE_TOKEN_INDEX (the reference's
    mm_utils tokenizer_image_token): with a BOS-emitting tokenizer every
    chunk starts with BOS and is stripped, so exactly one image token lands
    per <image>.  <audio> sentinels become AUDIO_TOKEN_INDEX, as in the JAX
    package, so the same prompt gives the same ids."""
    def encode_with_audio(text):
        if DEFAULT_AUDIO_TOKEN not in text:
            return encode(text)
        out = []
        for j, sub in enumerate(text.split(DEFAULT_AUDIO_TOKEN)):
            if j > 0:
                out.append(AUDIO_TOKEN_INDEX)
            toks = encode(sub)
            if j > 0 and bos_token_id is not None and toks \
                    and toks[0] == bos_token_id:
                toks = toks[1:]
            out.extend(toks)
        return out

    chunks = [encode_with_audio(chunk)
              for chunk in prompt.split(DEFAULT_IMAGE_TOKEN)]
    input_ids = []
    offset = 0
    if chunks and chunks[0] and bos_token_id is not None and chunks[0][0] == bos_token_id:
        offset = 1
        input_ids.append(chunks[0][0])
    for i, chunk in enumerate(chunks):
        if i > 0:
            input_ids.append(IMAGE_TOKEN_INDEX)
        input_ids.extend(chunk[offset:])
    return input_ids


# ---------------------------------------------------------------------------
# Vision pipeline
# ---------------------------------------------------------------------------

def pool_2d_average(feat: torch.Tensor, grid: int, stride: int) -> torch.Tensor:
    """[F, grid^2, D] -> [F, (grid//stride)^2, D] average pooling; odd edges
    dropped like torch avg_pool2d (27 -> 13)."""
    F, _, D = feat.shape
    s = grid // stride
    x = feat.reshape(F, grid, grid, D)[:, : s * stride, : s * stride]
    x = x.reshape(F, s, stride, s, stride, D)
    return x.mean(dim=(2, 4)).reshape(F, s * s, D)


def add_token_per_grid(feat: torch.Tensor, newline: torch.Tensor,
                       side: int) -> torch.Tensor:
    """[F, side^2, D] -> [F*side*(side+1), D]: image_newline after each row
    (frame-major, row-major)."""
    F, _, D = feat.shape
    x = feat.reshape(F, side, side, D)
    nl = newline.to(feat.dtype).expand(F, side, 1, D)
    return torch.cat([x, nl], dim=2).reshape(F * side * (side + 1), D)


def add_token_per_frame(feat: torch.Tensor, newline: torch.Tensor) -> torch.Tensor:
    """[F, N, D] -> [F*(N+1), D]: one newline per frame."""
    F, N, D = feat.shape
    nl = newline.to(feat.dtype).expand(F, 1, D)
    return torch.cat([feat, nl], dim=1).reshape(F * (N + 1), D)


class LlavaQwenNet(nn.Module):
    """Every parameter of the backbone: the Qwen2 LM, the truncated SigLIP
    tower, the mlp2x_gelu projector (exact-erf GELU; the tower's MLP uses the
    tanh form) and the grid newline embedding."""

    def __init__(self, cfg: LLaVAVideoConfig):
        super().__init__()
        W, D = cfg.vision.width, cfg.lm.hidden_size
        self.lm = Qwen2Model(cfg.lm)
        self.vision = SigLIPVisionTower(cfg.vision)
        self.projector = nn.Sequential(nn.Linear(W, D), nn.GELU(), nn.Linear(D, D))
        self.image_newline = nn.Parameter(torch.empty(D))


def _net_key(key: str) -> str | None:
    """llava_qwen state-dict key -> :class:`LlavaQwenNet` key (None: not a
    backbone weight, e.g. the TSPO selector's ``multiModal_align.*``)."""
    tower = "model.vision_tower.vision_tower."
    if key.startswith(tower):
        return "vision." + key[len(tower):]
    if key.startswith("model.mm_projector."):
        return "projector." + key[len("model.mm_projector."):]
    if key == "model.image_newline":
        return "image_newline"
    if key.startswith(("model.", "lm_head.")):
        return "lm." + key
    return None


def _empty_net(cfg: LLaVAVideoConfig, dtype, device) -> LlavaQwenNet:
    """Uninitialised parameters made directly on ``device`` in ``dtype``."""
    with torch.device("meta"):
        net = LlavaQwenNet(cfg)
    return net.to(dtype=dtype).to_empty(device=device).eval()


@dataclass
class LLaVAVideoModel:
    """Host orchestrator: vision encode (chunked), prompt splice, greedy
    decode.  ``encode``/``decode`` are tokenizer callables (an HF tokenizer
    for real checkpoints; stubs in tests and on the card)."""

    net: LlavaQwenNet
    cfg: LLaVAVideoConfig = field(default_factory=LLaVAVideoConfig)
    encode: Callable | None = None
    decode: Callable | None = None
    # frames per vision chunk: 64 selected frames encode as one chunk on an
    # 80 GB card (activations ~1 GB in bf16)
    batch_frames: int = 64
    max_new_tokens: int = 256
    conv_template: str = "qwen_1_5"
    # BOS id for tokenize_with_image (vicuna/llama tokenizers emit one)
    bos_token_id: int | None = None
    speculative: bool = False

    @property
    def device(self) -> torch.device:
        return self.net.image_newline.device

    @property
    def lm(self) -> Qwen2Model:
        return self.net.lm

    def to(self, device) -> "LLaVAVideoModel":
        """Move the parameters (in place) and return self."""
        self.net.to(resolve_device(device))
        return self

    def _prompt(self, question: str) -> str:
        """Eval-adapter prompt: <image> + question in the conv template, no
        trailer (task prompts carry their own instructions)."""
        from .conversation import build_prompt
        return build_prompt(question, self.conv_template)

    @torch.inference_mode()
    def encode_video(self, frames: np.ndarray) -> torch.Tensor:
        """[T, H, W, 3] uint8 -> [T*tokens_per_frame, D] spliceable tokens,
        ``batch_frames`` frames per tower call."""
        net, cfg = self.net, self.cfg
        feats = []
        for s in range(0, frames.shape[0], self.batch_frames):
            chunk = torch.as_tensor(np.asarray(frames[s:s + self.batch_frames]))
            pixels = siglip_preprocess(chunk.to(self.device), cfg.vision.image_size)
            feat = net.projector(net.vision(pixels))                  # [F, 729, D]
            feats.append(pool_2d_average(feat, cfg.vision.grid, cfg.pool_stride))
        feat = torch.cat(feats)
        if cfg.mm_newline_position == "grid":
            return add_token_per_grid(feat, net.image_newline, cfg.pooled_side)
        if cfg.mm_newline_position == "frame":
            return add_token_per_frame(feat, net.image_newline)
        return feat.reshape(-1, feat.shape[-1])   # no_token / one_token flat

    @torch.inference_mode()
    def splice_embeddings(self, input_ids: list,
                          video_tokens: torch.Tensor) -> torch.Tensor:
        """Replace the IMAGE_TOKEN_INDEX slot with the video tokens; returns
        [1, S, D] embeddings."""
        ids = np.asarray(input_ids)
        if (ids == AUDIO_TOKEN_INDEX).any():
            raise ValueError("prompt contains <audio> but no audio tokens "
                             "were provided")
        sentinel = ids == IMAGE_TOKEN_INDEX
        dev = self.device

        def emb(part):
            return embed_tokens(self.lm, torch.as_tensor(part, device=dev))

        if not sentinel.any():
            if int(video_tokens.shape[0]) > 0:
                raise ValueError("video tokens were provided but the prompt "
                                 "has no <image> sentinel to splice them at")
            return emb(ids)[None]
        parts, start = [], 0
        ref_dtype = self.lm.model.embed_tokens.weight.dtype
        for p in np.where(sentinel)[0]:
            if p > start:
                parts.append(emb(ids[start:int(p)]))
            parts.append(video_tokens)
            start = int(p) + 1
        if start < len(ids):
            parts.append(emb(ids[start:]))
        return torch.cat([x.to(ref_dtype) for x in parts])[None]

    def _prepare_generate(self, frames, question, max_new_tokens, prompt):
        """Prompt assembly, tokenize + video splice, and the max_context
        headroom clamp.  Returns (embeds [1,S,D], input_ids, clamped max_new)."""
        if self.encode is None or self.decode is None:
            raise ValueError("needs encode/decode tokenizer callables")
        max_new = self.max_new_tokens if max_new_tokens is None \
            else max_new_tokens
        if max_new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new}")
        prompt = prompt if prompt is not None else self._prompt(question)
        input_ids = tokenize_with_image(prompt, self.encode, self.bos_token_id)
        if frames is None or len(frames) == 0:
            # text-only path: the <image> slot splices to zero tokens
            video_tokens = torch.zeros((0, self.cfg.lm.hidden_size),
                                       device=self.device)
        else:
            video_tokens = self.encode_video(frames)
        embeds = self.splice_embeddings(input_ids, video_tokens)
        headroom = self.cfg.max_context - embeds.shape[1]
        if headroom < 1:
            raise ValueError(
                f"prompt is {embeds.shape[1]} tokens but max_context="
                f"{self.cfg.max_context}: no cache slot left to generate "
                "into (fewer frames, or raise max_context)")
        return embeds, input_ids, min(max_new, headroom)

    @torch.inference_mode()
    def generate(self, frames: np.ndarray, question: str,
                 max_new_tokens: int | None = None, prompt: str | None = None,
                 audio: np.ndarray | None = None, temperature: float = 0.0,
                 top_p: float = 1.0, seed: int | None = None) -> str:
        """Greedy answer to ``question`` about ``frames`` [T, H, W, 3] uint8:
        vision encode, splice, Qwen2 prefill and greedy decode; returns the
        decoded text without EOS tokens."""
        if temperature and temperature > 0:
            raise NotImplementedError(f"sampled generation (temperature > 0) "
                                      f"is {_QUEUED}")
        if audio is not None:
            raise NotImplementedError(f"the audio track is {_QUEUED}")
        if self.speculative:
            raise NotImplementedError(f"speculative decoding is {_QUEUED}")
        embeds, _, max_new = self._prepare_generate(frames, question,
                                                    max_new_tokens, prompt)
        S = embeds.shape[1]
        max_len = min(self.cfg.max_context, S + max_new + 8)
        cache = KVCache.create(self.cfg.lm, 1, max_len, embeds.dtype,
                               self.device)
        valid = torch.ones(1, S, dtype=torch.bool, device=self.device)
        toks, n = greedy_decode(self.lm, embeds, valid, cache, max_new)
        toks = toks[:n].cpu().numpy()
        toks = toks[toks != self.cfg.lm.eos_token_id]
        return self.decode(toks.tolist())

    # -- weights --------------------------------------------------------------

    @classmethod
    def from_torch_checkpoint(cls, sd: dict, cfg: LLaVAVideoConfig,
                              dtype=torch.bfloat16, device="cuda",
                              **kw) -> "LLaVAVideoModel":
        """Load a LlavaQwenForCausalLM state dict (tensors or ndarrays): the
        LM under ``model.``, the tower under
        ``model.vision_tower.vision_tower.`` (its last layer and head are
        dropped), the projector as ``model.mm_projector.{0,2}``, plus
        ``model.image_newline`` and ``lm_head``.  Other keys (the TSPO
        selector's) are ignored; a missing backbone weight raises."""
        device = resolve_device(device)
        net = _empty_net(cfg, dtype, device)
        own = net.state_dict()
        seen = set()
        with torch.no_grad():
            for key, val in sd.items():
                nk = _net_key(key)
                if nk is None or nk not in own:
                    continue
                src = torch.as_tensor(np.asarray(val) if not torch.is_tensor(val)
                                      else val)
                if tuple(src.shape) != tuple(own[nk].shape):
                    raise ValueError(f"{key}: shape {tuple(src.shape)} != "
                                     f"{tuple(own[nk].shape)}")
                own[nk].copy_(src)
                seen.add(nk)
        missing = sorted(set(own) - seen)
        if missing:
            raise KeyError(f"checkpoint lacks {len(missing)} backbone weights, "
                           f"e.g. {missing[:5]}")
        return cls(net=net, cfg=cfg, **kw)

    @classmethod
    def random_init(cls, generator: torch.Generator, cfg: LLaVAVideoConfig,
                    dtype=torch.bfloat16, device="cuda",
                    **kw) -> "LLaVAVideoModel":
        """Random weights drawn on ``device`` from ``generator`` (which must
        live there: a CUDA generator for the card, so the 7.6B values of the
        full model are drawn in seconds): norms 1 and 0, position embeddings
        N(0, 0.01^2), every other weight and bias N(0, 0.02^2)."""
        device = resolve_device(device)
        net = _empty_net(cfg, dtype, device)
        with torch.no_grad():
            for name, p in net.named_parameters():
                if "norm" in name:
                    p.fill_(1.0 if name.endswith("weight") else 0.0)
                elif "position_embedding" in name:
                    p.normal_(0.0, 0.01, generator=generator)
                else:
                    p.normal_(0.0, 0.02, generator=generator)
        return cls(net=net, cfg=cfg, **kw)
