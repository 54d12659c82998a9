"""Port parity: tspo_tpu_torch.ops.vit_attention.

The plain version (what a CPU tensor takes) against the JAX Pallas kernel run
in interpret mode, at the real CLIP-L/14 (S=257, hd=64) and SigLIP (S=729,
hd=72) geometries, fp32, atol = rtol = 2e-5.  The CUDA kernel itself runs only
on the card: its test is marked ``cuda`` and skips here."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tspo_tpu.ops.vit_attention import vit_attention as jax_vit_attention
from tspo_tpu_torch.ops import vit_attention as va

torch.set_num_threads(1)


def _qkv(B, S, W, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, W)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("B,S,H,hd", [(2, 257, 16, 64), (1, 729, 16, 72)])
def test_plain_version_matches_pallas_interpret(B, S, H, hd):
    q, k, v = _qkv(B, S, H * hd, seed=S)
    want = np.asarray(jax_vit_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), H, impl="pallas",
                                        interpret=True))
    got = va.vit_attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), H).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_cpu_tensor_routes_to_plain_version_without_counting():
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 33, 64, seed=1))
    before = va.vit_attention.launches
    out = va.vit_attention(q, k, v, 4)
    assert va.vit_attention.launches == before       # no kernel launched
    torch.testing.assert_close(out, va.vit_attention_reference(q, k, v, 4),
                               atol=0, rtol=0)
    assert out.shape == q.shape and out.dtype == q.dtype


def test_plain_version_bf16_casts_probabilities():
    """bf16 in, bf16 out, fp32 softmax: close to the fp32 result at bf16
    precision."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 20, 32, seed=2))
    out = va.vit_attention_reference(q.bfloat16(), k.bfloat16(), v.bfloat16(), 2)
    assert out.dtype == torch.bfloat16
    ref = va.vit_attention_reference(q, k, v, 2)
    torch.testing.assert_close(out.float(), ref, atol=3e-2, rtol=3e-2)


def test_bad_width_and_shapes_raise():
    q = torch.zeros(1, 8, 100)
    with pytest.raises(ValueError):
        va.vit_attention(q, q, q, 16)
    with pytest.raises(ValueError):
        va.vit_attention(q, q, torch.zeros(1, 9, 100), 4)
    with pytest.raises(ValueError):
        va.vit_attention(torch.zeros(8, 100), torch.zeros(8, 100),
                         torch.zeros(8, 100), 4)


def test_launch_counter_is_a_plain_integer():
    assert isinstance(va.vit_attention.launches, int)


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an sm_90 CUDA card; run python3 chip_smoke.py on it")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, S, W, H in ((4, 257, 1024, 16), (2, 729, 1152, 16)):
        q, k, v = (torch.randn(B, S, W, device="cuda", generator=gen)
                   for _ in range(3))
        before = va.vit_attention.launches
        out = va.vit_attention(q, k, v, H)
        torch.cuda.synchronize()
        assert va.vit_attention.launches == before + 1
        torch.testing.assert_close(out, va.vit_attention_reference(q, k, v, H),
                                   atol=2e-5, rtol=0)
        qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
        ob = va.vit_attention(qb, kb, vb, H).float()
        rb = va.vit_attention_reference(qb, kb, vb, H).float()
        cos = torch.nn.functional.cosine_similarity(ob.reshape(-1, W),
                                                    rb.reshape(-1, W), dim=-1)
        assert cos.min().item() >= 0.9998
        assert (ob - rb).abs().max().item() <= 2e-2
