"""Port parity: tspo_tpu_torch.ops.flash_attention.

The plain version (what a CPU tensor takes) against the JAX Pallas kernel
``pallas_flash_attention`` run in interpret mode, fp32, rtol = atol = 2e-4
(the tolerance ``tests/test_pallas_attention.py`` holds the Pallas kernel
to): causal and not, GQA H=6 KV=2, ragged key lengths, ``q_offset`` suffix
prefill, a sliding ``window``, and bf16 inputs.  Rows with no valid key at
all (a window past the valid keys) hold tiling-dependent garbage on both
sides and are only checked to be finite.  The stale-tail contract the
kernel is held to on the card (k/v rows past ``lengths`` never reach the
output) is checked on the plain version: finite garbage there gives output
bit-identical to zeros there.  The CUDA kernel runs only on the card: its
test is marked ``cuda`` and skips here."""

import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tspo_tpu.ops.pallas_attention import pallas_flash_attention
from tspo_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)


def _inputs(B, Sq, Sk, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, Sk, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, Sk, KV, hd)).astype(np.float32)
    return q, k, v


def _live_rows(lengths, Sq, causal, window, q_offset):
    """[B, Sq] bool: the query row has at least one valid key."""
    k_pos = np.arange(max(lengths) + 1)[None, :]
    q_pos = q_offset + np.arange(Sq)[:, None]
    out = []
    for n in lengths:
        ok = (k_pos < n) & np.ones((Sq, 1), bool)
        if causal:
            ok = ok & (k_pos <= q_pos)
        if window is not None:
            ok = ok & (q_pos - k_pos < window)
        out.append(ok.any(axis=1))
    return np.stack(out)


CASES = [
    # B, Sq, Sk, H, KV, hd, causal, lengths, window, q_offset
    (1, 64, 64, 2, 2, 16, False, None, None, 0),
    (2, 100, 100, 3, 3, 8, True, None, None, 0),
    (2, 96, 96, 6, 2, 16, True, (60, 96), None, 0),
    (2, 96, 96, 6, 2, 16, False, (50, 81), None, 0),
    (2, 32, 96, 4, 2, 16, True, (72, 72), None, 40),
    (2, 130, 130, 4, 2, 16, True, (130, 90), 24, 0),
]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,lengths,window,q_offset", CASES)
def test_plain_version_matches_pallas_interpret(B, Sq, Sk, H, KV, hd, causal,
                                                lengths, window, q_offset):
    q, k, v = _inputs(B, Sq, Sk, H, KV, hd, seed=Sq + H)
    lens = np.full(B, Sk) if lengths is None else np.asarray(lengths)
    valid = np.arange(Sk)[None, :] < lens[:, None]
    want = np.asarray(pallas_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid),
        causal=causal, blk_q=32, blk_k=32, interpret=True, window=window,
        q_offset=q_offset))
    got = fa.flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lens), causal=causal, window=window,
        q_offset=q_offset, q_chunk=48).numpy()
    live = _live_rows(lens, Sq, causal, window, q_offset)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[live], want[live], rtol=2e-4, atol=2e-4)
    if window is not None:
        assert not live.all()          # the case does reach fully masked rows


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 40, 40, 6, 2, 16, seed=3))
    lens = torch.tensor([40, 23])
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, lens, causal=True)
    assert fa.flash_attention.launches == before
    torch.testing.assert_close(
        out, fa.flash_attention_reference(q, k, v, lens, causal=True),
        atol=0, rtol=0)
    assert out.shape == q.shape and out.dtype == q.dtype


def test_query_chunking_does_not_change_the_result():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 70, 70, 4, 1, 16, seed=4))
    a = fa.flash_attention_reference(q, k, v, causal=True, q_chunk=1024)
    b = fa.flash_attention_reference(q, k, v, causal=True, q_chunk=16)
    torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_cache_slice_with_batch_stride():
    """k/v as a slice of a longer cache (batch stride T*KV*hd) give the same
    result as contiguous copies."""
    q, _, _ = (torch.from_numpy(x) for x in _inputs(2, 24, 24, 4, 2, 16, seed=5))
    cache = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, 2, 40, 2, 16)).astype(np.float32))
    k_l, v_l = cache[0][:, :24], cache[1][:, :24]
    assert not k_l.is_contiguous()
    torch.testing.assert_close(
        fa.flash_attention(q, k_l, v_l, causal=True),
        fa.flash_attention(q, k_l.contiguous(), v_l.contiguous(), causal=True),
        atol=0, rtol=0)


def test_bf16_inputs_match_pallas_bf16():
    """bf16 in, bf16 out: probabilities cast to bf16 before P.V on both
    sides; agreement at bf16 precision (row cosine >= 0.9998, the tolerance
    the card holds the kernel to)."""
    q, k, v = _inputs(1, 128, 128, 4, 2, 32, seed=7)
    bf = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    want = np.asarray(pallas_flash_attention(*bf, causal=True, blk_q=32,
                                             blk_k=32, interpret=True),
                      np.float32)
    got = fa.flash_attention_reference(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v)), causal=True)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    a, b = got.reshape(-1, 32), want.reshape(-1, 32)
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
    assert cos.min() >= 0.9998
    assert np.abs(got - want).max() <= 2e-2


def test_bad_shapes_raise():
    q = torch.zeros(1, 8, 6, 16)
    with pytest.raises(ValueError):
        fa.flash_attention(q, torch.zeros(1, 8, 4, 16), torch.zeros(1, 8, 4, 16))
    with pytest.raises(ValueError):
        fa.flash_attention(q, torch.zeros(1, 8, 2, 8), torch.zeros(1, 8, 2, 8))
    with pytest.raises(ValueError):
        fa.flash_attention(q, torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 2, 16),
                           valid_k=torch.tensor([3, 4]))
    m = torch.zeros(1, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention(m, m, m)


def test_launch_counter_is_a_plain_integer():
    assert isinstance(fa.flash_attention.launches, int)


def test_kernel_names_are_the_sources_kernels():
    """``KERNELS`` (indexed by the source's route) names the CUDA source's
    kernels, and the answer profile counts each as a flash_attention
    kernel."""
    from tspo_tpu_torch.tools.profile_answer import _classify
    src = (Path(fa.__file__).parents[1] / "csrc" / "flash_attention.cu").read_text()
    assert "kRouteWgmma = 0, kRouteMmaSync = 1, kRouteFma = 2" in src
    for name in fa.KERNELS:
        assert re.search(rf"__global__ void (__launch_bounds__\([^)]*\)\s*)?{name}\(",
                         src), name
        assert _classify(f"void (anonymous namespace)::{name}<128>(Params)") == \
            "flash_attention kernel"
    with pytest.raises(ValueError, match="hd"):
        fa.kernel_name(torch.bfloat16, 32)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        fa.kernel_attributes(torch.float16, 128)


STALE_TAIL_CASES = [
    # B, Sq, Sk, H, KV, hd, causal, lengths, window, q_offset
    (2, 40, 40, 4, 2, 16, True, (40, 23), None, 0),
    (2, 24, 70, 6, 2, 16, True, (70, 51), None, 46),
    (2, 60, 60, 4, 1, 16, True, (60, 37), 9, 0),
    (3, 20, 90, 7, 1, 16, True, (90, 77, 65), 30, 70),
    (2, 33, 50, 4, 2, 16, False, (17, 50), None, 0),
]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,lengths,window,q_offset",
                         STALE_TAIL_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stale_cache_tail_does_not_reach_the_output(B, Sq, Sk, H, KV, hd, causal,
                                                    lengths, window, q_offset, dtype):
    """The contract the kernel is held to on the card: k/v rows at or past
    lengths[b] (stale KV-cache slots) do not change the output.  Finite
    garbage there (+-1e4) gives output bit-identical to zeros there."""
    q, k, v = (torch.from_numpy(x).to(dtype) for x in
               _inputs(B, Sq, Sk, H, KV, hd, seed=Sq + Sk))
    lens = torch.tensor(lengths)
    tail = torch.arange(Sk)[None, :, None, None] >= lens[:, None, None, None]
    rng = np.random.default_rng(B + Sk)
    garbage = [torch.from_numpy(rng.choice([-1e4, 1e4], size=k.shape)).to(dtype)
               for _ in range(2)]
    zeroed = [torch.where(tail, torch.zeros((), dtype=dtype), x) for x in (k, v)]
    stale = [torch.where(tail, gx, x) for gx, x in zip(garbage, (k, v))]
    call = dict(valid_len=lens, causal=causal, window=window, q_offset=q_offset)
    want = fa.flash_attention_reference(q, *zeroed, **call)
    got = fa.flash_attention_reference(q, *stale, **call)
    live = torch.from_numpy(_live_rows(lengths, Sq, causal, window, q_offset))
    assert torch.isfinite(got).all()
    assert torch.equal(got[live], want[live])
    assert not torch.equal(stale[0], zeroed[0])     # the tail really differs


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    """What ``chip_smoke.py`` phase 1 checks on the card: bf16 row cosine >=
    0.9998, max abs <= 2e-2 and per-row relative error <= 1e-2; fp32 max abs
    <= 5e-5 and per-row relative error <= 1e-3; all outputs finite; one
    launch per call; every instantiated head dim; bf16 at hd 64 and 128 on
    the wgmma kernel, at its tile edges (128 query rows, 128 keys a stage):
    Sq and Sk off a multiple of 128, lengths mid-tile and on a tile edge,
    q_offset off a multiple of 128, a window across tile edges, H/KV = 7,
    k/v as a slice of a longer cache, and NaN/inf in the cache rows at or
    past lengths[b] (held against the plain version on zeros there); hd=32
    raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs an sm_90 CUDA card; run python3 chip_smoke.py on it")
    assert fa.kernel_name(torch.bfloat16, 128) == "flash_wgmma_kernel"
    assert fa.kernel_name(torch.bfloat16, 64) == "flash_wgmma_kernel"
    assert fa.kernel_name(torch.bfloat16, 80) == "flash_bf16_kernel"
    assert fa.kernel_name(torch.float32, 128) == "flash_f32_kernel"
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16_only = [
        # B, Sq, Sk, H, KV, hd, causal, lengths, window, q_offset, k/v source
        (1, 129, 129, 28, 4, 128, True, None, None, 0, None),
        (1, 255, 4097, 28, 4, 128, False, None, None, 0, None),
        (3, 1024, 1024, 28, 4, 128, True, (1000, 640, 129), None, 0, None),
        (2, 300, 1000, 28, 4, 128, True, (1000, 900), None, 700, None),
        (2, 1500, 1500, 28, 4, 128, True, (1500, 1111), 200, 0, None),
        (2, 777, 777, 28, 4, 128, True, None, None, 0, "slice"),
        (2, 777, 777, 28, 4, 128, True, (700, 333), None, 0, "poison"),
        (2, 300, 1000, 28, 4, 128, True, (1000, 901), 450, 700, "poison"),
    ]
    both = [
        (1, 1000, 1000, 28, 4, 128, True, None, None, 0, None),
        (2, 700, 700, 28, 4, 128, True, (700, 333), None, 0, None),
        (1, 300, 300, 16, 16, 80, False, None, None, 0, None),
        (2, 260, 260, 8, 2, 64, True, (260, 200), 100, 0, None),
        (1, 333, 333, 6, 2, 16, True, None, None, 0, None),
    ]
    cases = ([(c, torch.bfloat16) for c in bf16_only]
             + [(c, dt) for c in both for dt in (torch.bfloat16, torch.float32)])
    for (B, Sq, Sk, H, KV, hd, causal, lens, window, off, source), dtype in cases:
        lengths = None if lens is None else torch.tensor(lens, device="cuda")
        q = torch.randn(B, Sq, H, hd, device="cuda", generator=gen).to(dtype)
        T = Sk if source is None else Sk + 64
        k, v = (torch.randn(B, T, KV, hd, device="cuda", generator=gen).to(dtype)
                for _ in range(2))
        if source == "poison":
            for x in (k, v):
                for b, n in enumerate(lens):
                    x[b, n::2] = float("nan")
                    x[b, n + 1::2] = float("inf")
        k, v = k[:, :Sk], v[:, :Sk]
        k_ref, v_ref = k, v
        if source == "poison":
            keep = (torch.arange(Sk, device="cuda")[None, :]
                    < lengths[:, None])[..., None, None]
            k_ref, v_ref = torch.where(keep, k, 0), torch.where(keep, v, 0)
        before = fa.flash_attention.launches
        out = fa.flash_attention(q, k, v, lengths, causal, window, off)
        torch.cuda.synchronize()
        assert fa.flash_attention.launches == before + 1
        ref = fa.flash_attention_reference(q, k_ref, v_ref, lengths, causal, window, off)
        live = torch.from_numpy(_live_rows(
            np.full(B, Sk) if lens is None else np.asarray(lens), Sq, causal,
            window, off)).cuda()
        assert torch.isfinite(out).all()
        o, r = out.float()[live], ref.float()[live]
        rel = ((o - r).reshape(-1, hd).norm(dim=-1)
               / r.reshape(-1, hd).norm(dim=-1)).max().item()
        if dtype == torch.float32:
            assert (o - r).abs().max().item() <= 5e-5
            assert rel <= 1e-3
        else:
            cos = torch.nn.functional.cosine_similarity(
                o.reshape(-1, hd), r.reshape(-1, hd), dim=-1)
            assert cos.min().item() >= 0.9998
            assert (o - r).abs().max().item() <= 2e-2
            assert rel <= 1e-2
    x = torch.zeros(1, 64, 4, 32, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="hd"):
        fa.flash_attention(x, x, x)
