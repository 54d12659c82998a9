"""SigLIP vision tower — LLaVA-Video-7B-Qwen2's frame encoder — as a
PyTorch module.

Counterpart of ``tspo_tpu/models/siglip.py``.  The LLaVA tower drops the
checkpoint's final transformer layer and the pooling head and emits the raw
hidden state of the remaining stack: 729 patch tokens per frame, no class
token, no final layer norm.  The module tree carries the HF
``SiglipVisionModel`` parameter names (``vision_model.embeddings...``,
``vision_model.encoder.layers.{i}...``) truncated to ``cfg.layers``, so an HF
state dict loads after the extra layer and head are dropped.  Numerics follow
the JAX tower:

  - fp32 layer norm (``models/clip.py::layer_norm``);
  - patch embedding as one GEMM over the unfolded patches, after cropping the
    384-px frame to the 27 * 14 = 378 px the stride-14 convolution reads;
  - attention through ``ops/vit_attention.py`` on the [B, 729, 1152] GEMM
    layout (the Hopper kernel on the card, hd = 72);
  - tanh-approximate GELU in the MLP (``gelu_pytorch_tanh``);
  - preprocessing: a direct Keys-cubic antialiased resize to 384 x 384 (not
    shortest-edge) and mean = std = 0.5.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from .clip import CLIPAttention, layer_norm, resize_weights


@dataclass(frozen=True)
class SigLIPConfig:
    width: int = 1152
    layers: int = 26            # 27 in the checkpoint; LLaVA drops the last
    heads: int = 16
    intermediate: int = 4304
    patch_size: int = 14
    image_size: int = 384
    layer_norm_eps: float = 1e-6

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid   # 729 for SO400M-384

    @classmethod
    def tiny(cls) -> "SigLIPConfig":
        return cls(width=64, layers=2, heads=4, intermediate=128, patch_size=8,
                   image_size=32)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``gelu_pytorch_tanh`` (jax.nn.gelu(approximate=True))."""
    return nn.functional.gelu(x, approximate="tanh")


class SiglipMLP(nn.Module):
    def __init__(self, width: int, intermediate: int):
        super().__init__()
        self.fc1 = nn.Linear(width, intermediate)
        self.fc2 = nn.Linear(intermediate, width)

    def forward(self, x):
        return self.fc2(gelu_tanh(self.fc1(x)))


class SiglipEncoderLayer(nn.Module):
    """Pre-LN transformer layer; the attention is CLIP's (same HF names,
    unmasked ``vit_attention``)."""

    def __init__(self, cfg: SigLIPConfig):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(cfg.width, eps=cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(cfg.width, cfg.heads)
        self.layer_norm2 = nn.LayerNorm(cfg.width, eps=cfg.layer_norm_eps)
        self.mlp = SiglipMLP(cfg.width, cfg.intermediate)

    def forward(self, x):
        x = x + self.self_attn(layer_norm(x, self.layer_norm1))
        return x + self.mlp(layer_norm(x, self.layer_norm2))


class SiglipPatchEmbedding(nn.Module):
    """The HF conv weight [W, 3, P, P] and bias, applied as one GEMM over the
    unfolded patches, whose (c, ph, pw) order matches the weight's."""

    def __init__(self, width: int, patch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(width, 3, patch, patch))
        self.bias = nn.Parameter(torch.empty(width))

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        return patches @ self.weight.reshape(self.weight.shape[0], -1).T + self.bias


class SiglipEmbeddings(nn.Module):
    def __init__(self, cfg: SigLIPConfig):
        super().__init__()
        self.patch_embedding = SiglipPatchEmbedding(cfg.width, cfg.patch_size)
        self.position_embedding = nn.Embedding(cfg.num_patches, cfg.width)


class SiglipEncoder(nn.Module):
    def __init__(self, cfg: SigLIPConfig):
        super().__init__()
        self.layers = nn.ModuleList(SiglipEncoderLayer(cfg)
                                    for _ in range(cfg.layers))


class SiglipVisionModel(nn.Module):
    def __init__(self, cfg: SigLIPConfig):
        super().__init__()
        self.embeddings = SiglipEmbeddings(cfg)
        self.encoder = SiglipEncoder(cfg)


class SigLIPVisionTower(nn.Module):
    """[B, 3, S, S] preprocessed pixels -> [B, grid^2, width] patch features
    (pre-layernorm hidden state of the truncated LLaVA tower)."""

    def __init__(self, cfg: SigLIPConfig = SigLIPConfig()):
        super().__init__()
        self.cfg = cfg
        self.vision_model = SiglipVisionModel(cfg)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        cfg, vm = self.cfg, self.vision_model
        B = pixel_values.shape[0]
        P, g = cfg.patch_size, cfg.grid
        # 384 px / patch 14 -> 27 x 27 patches covering only 378 px: the
        # stride-14 convolution never reads the last 6 rows and columns
        if pixel_values.shape[-1] != g * P:
            pixel_values = pixel_values[:, :, : g * P, : g * P]
        x = pixel_values.reshape(B, 3, g, P, g, P)
        x = x.permute(0, 2, 4, 1, 3, 5).reshape(B, g * g, 3 * P * P)
        emb = vm.embeddings
        x = emb.patch_embedding(x.to(emb.patch_embedding.weight.dtype))
        x = x + emb.position_embedding.weight
        for layer in vm.encoder.layers:
            x = layer(x)
        return x


def siglip_preprocess(frames: torch.Tensor, image_size: int = 384,
                      dtype=torch.bfloat16) -> torch.Tensor:
    """[T, H, W, 3] uint8 -> [T, 3, S, S] on the frames' device
    (SigLipImageProcessor semantics): a direct Keys-cubic antialiased resize
    to (S, S) as two matmuls against ``jax.image.resize``'s weight matrices,
    rescale, normalise with mean = std = 0.5.  ``dtype`` defaults to bf16 as
    in the JAX package, whose LLaVA pipeline rounds the pixels to bf16 before
    the tower casts them to its own type."""
    T, H, W, _ = frames.shape
    x = frames.float() / 255.0
    dev = frames.device
    if H != image_size:   # an axis whose size is unchanged is left as it is
        wh = torch.from_numpy(resize_weights(H, image_size)).to(dev)
        x = torch.einsum("thwc,hy->tywc", x, wh)
    if W != image_size:
        ww = torch.from_numpy(resize_weights(W, image_size)).to(dev)
        x = torch.einsum("tywc,wx->tyxc", x, ww)
    x = (x - 0.5) / 0.5
    return x.permute(0, 3, 1, 2).to(dtype)
