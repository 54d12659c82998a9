"""Port parity: tspo_tpu_torch.ops.vit_attention.

The plain version (what a CPU tensor takes) against the JAX Pallas kernel run
in interpret mode, at the real CLIP-L/14 (S=257, hd=64) and SigLIP (S=729,
hd=72) geometries and at the CUDA kernel's tile edges at a narrow width (2
heads; S of 1, 63, 65, 129), fp32, atol = rtol = 2e-5.  The poison cases the
card checks (a NaN frame beside a clean one, inf in the next head's columns)
on the plain version.  The CUDA kernel itself runs only on the card: its test
is marked ``cuda`` and skips here."""

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


# the main paths' geometries, then the wgmma kernel's tile edges (64-row
# query tiles, 128-key tiles, the 256-key box's tail) at 2 heads
PALLAS_CASES = [(2, 257, 16, 64), (1, 729, 16, 72)] + [
    (2, S, 2, hd) for hd in (64, 72) for S in (1, 63, 65, 129)]


@pytest.mark.parametrize("B,S,H,hd", PALLAS_CASES)
def test_plain_version_matches_pallas_interpret(B, S, H, hd):
    q, k, v = _qkv(B, S, H * hd, seed=S)
    want = np.asarray(jax_vit_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), H, impl="pallas",
                                        interpret=True))
    got = va.vit_attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), H).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def _poisoned(B, S, H, hd, poison, seed):
    """(q, k, v, the slices the plain version is held on): "frame" fills
    frame 1 with NaN and keeps frame 0; "head" fills head 1's columns with
    inf and keeps every other head."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(B, S, H * hd, seed))
    keep = torch.arange(H * hd)
    frames = slice(None)
    if poison == "frame":
        for x in (q, k, v):
            x[1] = float("nan")
        frames = slice(0, 1)
    else:
        for x in (q, k, v):
            x[..., hd:2 * hd] = float("inf")
        keep = torch.cat([keep[:hd], keep[2 * hd:]])
    return q, k, v, (frames, keep)


@pytest.mark.parametrize("poison", ["frame", "head"])
@pytest.mark.parametrize("hd", [64, 72])
def test_plain_version_keeps_poison_in_its_frame_and_head(poison, hd):
    """A NaN frame leaves the other frame's output finite and equal to that
    frame alone; inf in head 1's columns leaves every other head's output
    finite and equal to the heads alone (no head reads another's lanes)."""
    H = 3
    q, k, v, (frames, keep) = _poisoned(2, 65, H, hd, poison, seed=hd)
    out = va.vit_attention(q, k, v, H)
    got = out[frames][..., keep]
    assert torch.isfinite(got).all()
    clean = va.vit_attention_reference(*(x[frames][..., keep] for x in (q, k, v)),
                                       H - (poison == "head"))
    torch.testing.assert_close(got, clean, atol=0, rtol=0)
    want = np.asarray(jax_vit_attention(*(jnp.asarray(x[frames][..., keep].numpy())
                                          for x in (q, k, v)),
                                        H - (poison == "head"), impl="pallas",
                                        interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_route_arguments_are_checked_before_any_build():
    """kernel_name and kernel_attributes refuse a dtype or head dim the
    source does not take without building the library (none can be built
    here)."""
    with pytest.raises(ValueError, match="bf16 or fp32"):
        va.kernel_name(torch.float16, 64)
    with pytest.raises(ValueError, match="hd % 8"):
        va.kernel_attributes(torch.bfloat16, 68, 257)
    with pytest.raises(ValueError, match="hd % 8"):
        va.kernel_name(torch.float32, 136)
    assert va.KERNELS[0] == "vit_attention_wgmma_kernel"
    assert all("vit_attention" in name for name in va.KERNELS)   # profilers match on it


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
    """What ``chip_smoke.py`` phase 1 checks: bf16 at hd 64 and 72 runs
    vit_attention_wgmma_kernel (resident form for hd 64 up to S=264,
    streamed otherwise) within row cosine 0.9998 and 2e-2 of the plain
    version at the tile edges, the poison cases stay in their frame and
    head, and fp32 (and the other head dims) hold 2e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs an sm_90 CUDA card; run python3 chip_smoke.py on it")
    assert va.kernel_name(torch.bfloat16, 64) == "vit_attention_wgmma_kernel"
    assert va.kernel_name(torch.bfloat16, 72) == "vit_attention_wgmma_kernel"
    assert va.kernel_name(torch.bfloat16, 80) == "vit_attention_bf16_kernel"
    assert va.kernel_name(torch.float32, 64) == "vit_attention_f32_kernel"
    assert va.kernel_attributes(torch.bfloat16, 64, 257)["form"] == "resident"
    assert va.kernel_attributes(torch.bfloat16, 64, 265)["form"] == "streamed"
    assert va.kernel_attributes(torch.bfloat16, 72, 257)["form"] == "streamed"

    def held(out, ref, tol_fp32=None):
        o = out.float().reshape(-1, out.shape[-1])
        r = ref.float().reshape(-1, ref.shape[-1])
        assert torch.isfinite(o).all()
        if tol_fp32 is not None:
            assert (o - r).abs().max().item() <= tol_fp32
            return
        cos = torch.nn.functional.cosine_similarity(o, r, dim=-1)
        assert cos.min().item() >= 0.9998
        assert (o - r).abs().max().item() <= 2e-2

    gen = torch.Generator(device="cuda").manual_seed(0)
    for hd in (64, 72):
        for S in (1, 8, 63, 64, 65, 127, 128, 129, 255, 256, 257, 729, 730):
            for B in (1, 3):
                q, k, v = (torch.randn(B, S, 16 * hd, device="cuda",
                                       generator=gen).bfloat16() for _ in range(3))
                before = va.vit_attention.launches
                out = va.vit_attention(q, k, v, 16)
                torch.cuda.synchronize()
                assert va.vit_attention.launches == before + 1
                held(out, va.vit_attention_reference(q, k, v, 16))
        for poison in ("frame", "head"):
            q, k, v, (frames, keep) = _poisoned(2, 257, 3, hd, poison, seed=hd)
            q, k, v = (x.cuda().bfloat16() for x in (q, k, v))
            keep = keep.cuda()
            out = va.vit_attention(q, k, v, 3)
            held(out[frames][..., keep], va.vit_attention_reference(
                *(x[frames][..., keep] for x in (q, k, v)), 3 - (poison == "head")))
    for B, S, W, H in ((4, 257, 1024, 16), (2, 729, 1152, 16), (3, 257, 64, 4),
                       (3, 257, 512, 4)):
        q, k, v = (torch.randn(B, S, W, device="cuda", generator=gen)
                   for _ in range(3))
        held(va.vit_attention(q, k, v, H), va.vit_attention_reference(q, k, v, H), 2e-5)
