"""Port parity: tspo_tpu_torch.models.siglip against tspo_tpu.models.siglip.

One HF-layout SigLIP state dict made with numpy from a seed (biases
non-zero, one extra checkpoint layer that the LLaVA truncation drops) loads
into both packages.  Tolerances: tower features rtol = atol = 2e-4 in fp32
(the JAX package's own torch-parity tolerance for this tower); preprocessing
atol 1e-4 (the CLIP preprocessing tolerance: both resize with the same
Keys-cubic weights, summed in another order)."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tspo_tpu.models.siglip import SigLIPConfig as JSigLIPConfig
from tspo_tpu.models.siglip import siglip_encode, siglip_params_from_torch
from tspo_tpu.models.siglip import siglip_preprocess as jax_preprocess
from tspo_tpu_torch.models import siglip as ts

torch.set_num_threads(1)


def hf_siglip_state_dict(cfg, seed: int, extra_layers: int = 1) -> dict:
    """Random HF ``SiglipVisionModel`` state dict (numpy) with
    ``cfg.layers + extra_layers`` layers, a post layer norm and non-zero
    biases."""
    rng = np.random.default_rng(seed)
    W, I, P = cfg.width, cfg.intermediate, cfg.patch_size

    def nrm(*shape, s=0.05):
        return (rng.normal(size=shape) * s).astype(np.float32)

    sd = {"vision_model.embeddings.patch_embedding.weight": nrm(W, 3, P, P),
          "vision_model.embeddings.patch_embedding.bias": nrm(W),
          "vision_model.embeddings.position_embedding.weight": nrm(cfg.num_patches, W),
          "vision_model.post_layernorm.weight": 1 + nrm(W),
          "vision_model.post_layernorm.bias": nrm(W)}
    for i in range(cfg.layers + extra_layers):
        f = f"vision_model.encoder.layers.{i}"
        for ln in ("layer_norm1", "layer_norm2"):
            sd[f"{f}.{ln}.weight"] = 1 + nrm(W, s=0.1)
            sd[f"{f}.{ln}.bias"] = nrm(W, s=0.1)
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{f}.self_attn.{name}.weight"] = nrm(W, W)
            sd[f"{f}.self_attn.{name}.bias"] = nrm(W)
        sd[f"{f}.mlp.fc1.weight"] = nrm(I, W)
        sd[f"{f}.mlp.fc1.bias"] = nrm(I)
        sd[f"{f}.mlp.fc2.weight"] = nrm(W, I)
        sd[f"{f}.mlp.fc2.bias"] = nrm(W)
    return sd


def port_tower(cfg, sd) -> ts.SigLIPVisionTower:
    tower = ts.SigLIPVisionTower(cfg)
    own = tower.state_dict()
    tower.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()
                           if k in own}, strict=True)
    return tower.eval()


@pytest.mark.parametrize("image_size", [32, 36])
def test_tower_matches_siglip_encode(image_size):
    """36 px at patch 8 crops to the 32 px the convolution reads, as the
    so400m 384 px frame crops to 378."""
    cfg = dataclasses.replace(ts.SigLIPConfig.tiny(), image_size=image_size)
    jcfg = JSigLIPConfig(**dataclasses.asdict(cfg))
    sd = hf_siglip_state_dict(cfg, seed=image_size)
    params = siglip_params_from_torch(sd, jcfg, dtype=jnp.float32)
    pixels = np.random.default_rng(1).normal(
        size=(3, 3, image_size, image_size)).astype(np.float32)
    want = np.asarray(siglip_encode(params, jnp.asarray(pixels), jcfg))
    with torch.inference_mode():
        got = port_tower(cfg, sd)(torch.from_numpy(pixels)).numpy()
    assert got.shape == (3, cfg.num_patches, cfg.width)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("H,W,size", [(40, 56, 32), (480, 640, 384), (64, 64, 64)])
def test_preprocess_matches_jax(H, W, size):
    frames = np.random.default_rng(H).integers(0, 256, (2, H, W, 3), dtype=np.uint8)
    want = np.asarray(jax_preprocess(jnp.asarray(frames), size, dtype=jnp.float32))
    got = ts.siglip_preprocess(torch.from_numpy(frames), size,
                               dtype=torch.float32).numpy()
    assert got.shape == (2, 3, size, size)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_preprocess_default_rounds_to_bf16_like_jax():
    frames = np.random.default_rng(3).integers(0, 256, (1, 20, 24, 3), dtype=np.uint8)
    got = ts.siglip_preprocess(torch.from_numpy(frames), 16)
    want = np.asarray(jax_preprocess(jnp.asarray(frames), 16), np.float32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2, rtol=0)


def test_gelu_tanh_is_the_tanh_form():
    x = torch.linspace(-4, 4, 101)
    want = 0.5 * x * (1 + torch.tanh(np.sqrt(2 / np.pi) * (x + 0.044715 * x ** 3)))
    torch.testing.assert_close(ts.gelu_tanh(x), want, atol=1e-6, rtol=0)
    assert (ts.gelu_tanh(x) - torch.nn.functional.gelu(x)).abs().max() > 1e-4
