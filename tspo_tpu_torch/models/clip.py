"""CLIP-ViT-L/14 text + vision towers as PyTorch modules.

Counterpart of ``tspo_tpu/models/clip.py``.  The module tree carries the
HuggingFace ``CLIPModel`` parameter names, so an HF state dict loads with
``load_state_dict`` (:func:`load_hf_state_dict`), and each layer is an element
of an ``nn.ModuleList``.  Numerics follow the JAX towers:

  - layer norm upcasts to fp32 with the population variance and applies scale
    and bias in fp32 before casting back;
  - patch embedding is an unfolded GEMM against the conv weight, no conv;
  - the vision tower's attention goes through ``ops/vit_attention.py`` (the
    Hopper kernel on the card); the last layer is computed for the class token
    only (``cls_fast``), with a plain einsum, as the JAX tower does;
  - the text tower's causal (+ pad) masked attention is plain torch;
  - frame preprocessing (shortest-edge Keys-cubic resize with antialiasing,
    centre crop, normalisation) runs on the tensor's device as two matmuls
    against the 1-D weight matrices ``jax.image.resize`` builds.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..configs import CLIPConfig, CLIPTextConfig, CLIPVisionConfig
from ..ops.vit_attention import vit_attention
from ..utils.hf_port import t2n

# OpenAI CLIP normalization constants (HF CLIPProcessor defaults).
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


# ---------------------------------------------------------------------------
# Core blocks
# ---------------------------------------------------------------------------

def layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + ln.eps)
    return (y * ln.weight.float() + ln.bias.float()).to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(width, width)
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None):
        """[B, S, W] -> [B, S, W].  Without a mask (the vision tower) the
        attention is :func:`vit_attention`; ``mask`` is an additive fp32 bias
        broadcastable to [B, 1, S, S] (the text tower)."""
        B, S, W = x.shape
        q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        if mask is None:
            ctx = vit_attention(q, k, v, self.heads)
        else:
            hd = W // self.heads
            qh = q.reshape(B, S, self.heads, hd)
            kh = k.reshape(B, S, self.heads, hd)
            vh = v.reshape(B, S, self.heads, hd)
            scores = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * (1.0 / np.sqrt(hd))
            scores = scores.float() + mask
            attn = torch.softmax(scores, dim=-1).to(x.dtype)
            ctx = torch.einsum("bhqk,bkhd->bqhd", attn, vh).reshape(B, S, W)
        return self.out_proj(ctx)


class CLIPMLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.fc1 = nn.Linear(width, 4 * width)
        self.fc2 = nn.Linear(4 * width, width)

    def forward(self, x):
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    """Pre-LN transformer layer with QuickGELU."""

    def __init__(self, width: int, heads: int, eps: float):
        super().__init__()
        self.self_attn = CLIPAttention(width, heads)
        self.layer_norm1 = nn.LayerNorm(width, eps=eps)
        self.mlp = CLIPMLP(width)
        self.layer_norm2 = nn.LayerNorm(width, eps=eps)

    def forward(self, x, mask=None):
        x = x + self.self_attn(layer_norm(x, self.layer_norm1), mask)
        return x + self.mlp(layer_norm(x, self.layer_norm2))

    def forward_cls(self, x: torch.Tensor) -> torch.Tensor:
        """This layer evaluated for the class token only: [B, S, W] -> [B, W].

        Only the pooled class token is consumed downstream, so in the last
        layer the q/o projections, attention rows and MLP of the patch tokens
        are dead compute.  K/V still cover every token.  Plain einsum with fp32
        scores, softmax and accumulation, as ``_cls_only_last_layer`` in the
        JAX tower."""
        B, S, W = x.shape
        a = self.self_attn
        hd = W // a.heads
        h = layer_norm(x, self.layer_norm1)
        q = a.q_proj(h[:, :1]).reshape(B, 1, a.heads, hd)
        k = a.k_proj(h).reshape(B, S, a.heads, hd)
        v = a.v_proj(h).reshape(B, S, a.heads, hd)
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / np.sqrt(hd))
        p = torch.softmax(s, dim=-1).to(x.dtype)
        ctx = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float())
        ctx = ctx.to(x.dtype).reshape(B, 1, W)
        cls = x[:, :1] + a.out_proj(ctx)
        cls = cls + self.mlp(layer_norm(cls, self.layer_norm2))
        return cls[:, 0]


class CLIPEncoder(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, eps: float):
        super().__init__()
        self.layers = nn.ModuleList(
            CLIPEncoderLayer(width, heads, eps) for _ in range(layers))


# ---------------------------------------------------------------------------
# Towers
# ---------------------------------------------------------------------------

class PatchEmbedding(nn.Module):
    """The HF conv weight [W, 3, P, P] (no bias), applied as one GEMM over the
    unfolded patches, whose (c, ph, pw) order matches the weight's."""

    def __init__(self, width: int, patch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(width, 3, patch, patch))

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        return patches @ self.weight.reshape(self.weight.shape[0], -1).T


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.empty(cfg.width))
        self.patch_embedding = PatchEmbedding(cfg.width, cfg.patch_size)
        self.position_embedding = nn.Embedding(cfg.seq_len, cfg.width)


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = CLIPVisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.width, eps=cfg.layer_norm_eps)
        self.encoder = CLIPEncoder(cfg.width, cfg.layers, cfg.heads,
                                   cfg.layer_norm_eps)
        self.post_layernorm = nn.LayerNorm(cfg.width, eps=cfg.layer_norm_eps)

    def forward(self, pixel_values: torch.Tensor, cls_fast: bool = True):
        """[B, 3, H, W] preprocessed pixels -> pooled, post-LN class state [B, W]."""
        cfg = self.cfg
        emb = self.embeddings
        B = pixel_values.shape[0]
        P, g = cfg.patch_size, cfg.grid
        x = pixel_values.reshape(B, 3, g, P, g, P)
        x = x.permute(0, 2, 4, 1, 3, 5).reshape(B, g * g, 3 * P * P)
        x = emb.patch_embedding(x.to(emb.patch_embedding.weight.dtype))
        cls = emb.class_embedding.expand(B, 1, cfg.width)
        x = torch.cat([cls, x], dim=1) + emb.position_embedding.weight
        x = layer_norm(x, self.pre_layrnorm)
        layers = self.encoder.layers
        if cls_fast and len(layers) > 1:
            for layer in layers[:-1]:
                x = layer(x)
            pooled = layers[-1].forward_cls(x)
        else:
            for layer in layers:
                x = layer(x)
            pooled = x[:, 0]
        return layer_norm(pooled, self.post_layernorm)


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.position_embedding = nn.Embedding(cfg.max_positions, cfg.width)


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = CLIPTextEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg.width, cfg.layers, cfg.heads,
                                   cfg.layer_norm_eps)
        self.final_layer_norm = nn.LayerNorm(cfg.width, eps=cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor | None = None) -> torch.Tensor:
        """[B, L] token ids -> pooled state at the first EOS [B, W]."""
        emb = self.embeddings
        B, L = input_ids.shape
        x = emb.token_embedding(input_ids) + emb.position_embedding.weight[:L]
        dev = x.device
        mask = torch.triu(torch.full((L, L), float("-inf"), device=dev), diagonal=1)
        mask = mask[None, None]
        if attention_mask is not None:
            pad = torch.where(attention_mask[:, None, None, :] > 0,
                              torch.zeros((), device=dev),
                              torch.full((), float("-inf"), device=dev))
            mask = mask + pad
        for layer in self.encoder.layers:
            x = layer(x, mask)
        x = layer_norm(x, self.final_layer_norm)
        eos_pos = torch.argmax((input_ids == self.cfg.eos_token_id).to(torch.int32),
                               dim=-1)
        return x[torch.arange(B, device=dev), eos_pos]


class CLIPModel(nn.Module):
    """Both towers and their projections, in HF ``CLIPModel`` key layout."""

    def __init__(self, cfg: CLIPConfig = CLIPConfig()):
        super().__init__()
        self.cfg = cfg
        self.text_model = CLIPTextTransformer(cfg.text)
        self.vision_model = CLIPVisionTransformer(cfg.vision)
        self.visual_projection = nn.Linear(cfg.vision.width,
                                           cfg.vision.projection_dim, bias=False)
        self.text_projection = nn.Linear(cfg.text.width, cfg.text.projection_dim,
                                         bias=False)
        self.logit_scale = nn.Parameter(torch.tensor(cfg.logit_scale_init))

    def encode_images(self, pixel_values: torch.Tensor,
                      cls_fast: bool = True) -> torch.Tensor:
        """[B, 3, H, W] preprocessed pixels -> [B, projection_dim] features."""
        return self.visual_projection(self.vision_model(pixel_values, cls_fast))

    def encode_text(self, input_ids: torch.Tensor,
                    attention_mask: torch.Tensor | None = None) -> torch.Tensor:
        """[B, L] token ids -> [B, projection_dim] text features."""
        return self.text_projection(self.text_model(input_ids, attention_mask))


def empty_clip_model(cfg: CLIPConfig = CLIPConfig()) -> CLIPModel:
    """A CLIPModel on the CPU with uninitialised fp32 parameters, to be
    filled by a loader (skips the default initialisation)."""
    with torch.device("meta"):
        model = CLIPModel(cfg)
    return model.to_empty(device="cpu")


def init_clip_model(cfg: CLIPConfig = CLIPConfig(),
                    generator: torch.Generator | None = None) -> CLIPModel:
    """Random fp32 weights with HF-CLIP-like scales, drawn on the CPU from
    ``generator``, so a seed gives the same weights on every device."""
    model = empty_clip_model(cfg)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("logit_scale"):
                p.fill_(cfg.logit_scale_init)
            elif "layer_norm" in name or "layrnorm" in name or "layernorm" in name:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias"):
                p.zero_()
            elif "position_embedding" in name:
                p.normal_(0.0, 0.01, generator=generator)
            else:
                p.normal_(0.0, 0.02, generator=generator)
    return model.eval()


def cosine_scores(image_features: torch.Tensor, text_features: torch.Tensor,
                  eps: float = 1e-8) -> torch.Tensor:
    """Per-frame CLIP score: cosine(text, frame) (ref temporal_agent.py:167).

    image_features [T, P], text_features [1, P] or [P] -> [T] fp32.  Each norm
    is clamped to eps before dividing, as torch ``CosineSimilarity`` does."""
    if text_features.dim() == 1:
        text_features = text_features[None]
    a = image_features.float()
    b = text_features.float()
    an = torch.clamp(torch.linalg.norm(a, dim=-1), min=eps)
    bn = torch.clamp(torch.linalg.norm(b, dim=-1), min=eps)
    return torch.sum(a * b, dim=-1) / (an * bn)


# ---------------------------------------------------------------------------
# Preprocessing
# ---------------------------------------------------------------------------

def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys cubic kernel with a = -0.5 (as jax.image's "cubic")."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(np.float32)


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[in_size, out_size] fp32 resampling matrix of ``jax.image.resize(...,
    method="cubic")`` along one axis: sample centres at (i+0.5)/scale - 0.5,
    the kernel widened by 1/scale when downsampling (antialias), weights
    normalised per output pixel, zero for samples outside the input."""
    scale = np.float32(out_size / in_size)
    inv_scale = np.float32(1.0) / scale
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv_scale
                - np.float32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) \
        / kernel_scale
    w = _keys_cubic(x.astype(np.float32))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def resized_size(H: int, W: int, image_size: int) -> tuple:
    """Shortest edge to ``image_size``; the long edge floored as HF does:
    int(S * long / short)."""
    if H < W:
        return image_size, max(int(W * image_size / H), image_size)
    return max(int(H * image_size / W), image_size), image_size


def _normalize(x: torch.Tensor, dtype) -> torch.Tensor:
    """[T, S, S, 3] fp32 in [0, 1] -> [T, 3, S, S] normalised pixels."""
    mean = torch.tensor(CLIP_IMAGE_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(CLIP_IMAGE_STD, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2).to(dtype)


def preprocess_frames(frames: torch.Tensor, image_size: int = 224,
                      dtype=torch.bfloat16) -> torch.Tensor:
    """[T, H, W, 3] uint8 frames -> [T, 3, S, S] normalised pixels, on the
    frames' device: shortest-edge Keys-cubic resize (antialiased), centre
    crop, rescale, normalise (CLIPProcessor semantics)."""
    T, H, W, _ = frames.shape
    x = frames.float() / 255.0
    nh, nw = resized_size(H, W, image_size)
    top, left = (nh - image_size) // 2, (nw - image_size) // 2
    dev = frames.device
    if nh != H:       # an axis whose size is unchanged is left as it is
        wh = torch.from_numpy(resize_weights(H, nh)[:, top:top + image_size]).to(dev)
        x = torch.einsum("thwc,hy->tywc", x, wh)
    else:
        x = x[:, top:top + image_size]
    if nw != W:
        ww = torch.from_numpy(resize_weights(W, nw)[:, left:left + image_size]).to(dev)
        x = torch.einsum("tywc,wx->tyxc", x, ww)
    else:
        x = x[:, :, left:left + image_size]
    return _normalize(x, dtype)


def normalize_frames(frames: torch.Tensor, image_size: int = 224,
                     dtype=torch.bfloat16) -> torch.Tensor:
    """[T, S, S, 3] uint8 (already resized and cropped) -> [T, 3, S, S]."""
    return _normalize(frames.float() / 255.0, dtype)


def host_resize_crop(frames: np.ndarray, image_size: int = 224) -> np.ndarray:
    """Host-side (cv2) shortest-edge resize + centre crop -> [T, S, S, 3] u8.

    Same geometry as :func:`preprocess_frames` but on the CPU: for datasets
    that mix resolutions; cuts host->device bytes ~4x."""
    import cv2
    T, H, W, _ = frames.shape
    nh, nw = resized_size(H, W, image_size)
    top, left = (nh - image_size) // 2, (nw - image_size) // 2
    out = np.empty((T, image_size, image_size, 3), np.uint8)
    for i in range(T):
        r = cv2.resize(frames[i], (nw, nh), interpolation=cv2.INTER_CUBIC)
        out[i] = r[top:top + image_size, left:left + image_size]
    return out


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def clip_config_from_state_dict(sd) -> CLIPConfig:
    """Infer the CLIPConfig from checkpoint tensor shapes (64-dim heads, the
    CLIP family rule), so merged TSPO-0.4B directories load without a
    parsable config.json."""
    t_vocab, t_width = sd["text_model.embeddings.token_embedding.weight"].shape
    t_pos = sd["text_model.embeddings.position_embedding.weight"].shape[0]
    t_proj = sd["text_projection.weight"].shape[0]
    t_layers = 1 + max(int(k.split(".")[3]) for k in sd
                       if k.startswith("text_model.encoder.layers."))
    v_width = sd["vision_model.embeddings.class_embedding"].shape[0]
    v_patch = sd["vision_model.embeddings.patch_embedding.weight"].shape[-1]
    v_pos = sd["vision_model.embeddings.position_embedding.weight"].shape[0]
    v_grid = int(round((v_pos - 1) ** 0.5))
    v_proj = sd["visual_projection.weight"].shape[0]
    v_layers = 1 + max(int(k.split(".")[3]) for k in sd
                       if k.startswith("vision_model.encoder.layers."))
    return CLIPConfig(
        text=CLIPTextConfig(vocab_size=t_vocab, width=t_width, layers=t_layers,
                            heads=max(t_width // 64, 1), max_positions=t_pos,
                            projection_dim=t_proj, eos_token_id=t_vocab - 1),
        vision=CLIPVisionConfig(width=v_width, layers=v_layers,
                                heads=max(v_width // 64, 1), patch_size=v_patch,
                                image_size=v_grid * v_patch,
                                projection_dim=v_proj),
    )


def load_hf_state_dict(model: CLIPModel, sd) -> CLIPModel:
    """Load an HF ``CLIPModel`` state dict (tensors or ndarrays) into ``model``.
    The ``position_ids`` buffers some HF versions save are not parameters here
    and are skipped; anything else missing or extra raises."""
    own = model.state_dict()
    tensors = {}
    for k, v in sd.items():
        if k.endswith("position_ids"):
            continue
        ref = own.get(k)
        t = torch.from_numpy(np.array(t2n(v)))
        tensors[k] = t.to(ref.dtype if ref is not None else torch.float32)
    model.load_state_dict(tensors, strict=True)
    return model
