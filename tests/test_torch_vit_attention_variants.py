"""Port parity: tspo_tpu_torch.ops.vit_attention_variants and the variant
bench tspo_tpu_torch.tools.bench_vit_attention_variants.

Every variant of scripts/bench_vit_attention_variants.py runs through the JAX
script's own ``make_variant`` in Pallas interpret mode, and through the port's
``make_variant`` on CPU tensors, which take the kernels' plain versions.  The
script is loaded as a module and only that module object's ``pl`` is replaced
by a stand-in whose ``pallas_call`` passes ``interpret=True`` (most variants
pass no ``interpret`` and cannot lower on the CPU otherwise); the file itself
is not changed.  Same inputs on both sides: normal * 0.3 from a numpy seed,
rounded to bf16.  Tolerances (port plain version against the JAX kernel):
exact attention and the nomax/nosm probes max abs <= 8e-3 and cosine >=
0.9999 (bf16 outputs, fp32 sums in another order); dma and the copy probe
bit-equal; gemm_inkernel and fullwidth max abs / max |ref| <= 1e-2.  The CUDA
kernels run only on the card: their test is marked ``cuda`` and skips here."""

import functools
import importlib.util
import re
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tspo_tpu_torch.ops import vit_attention_variants as vv
from tspo_tpu_torch.tools import bench_vit_attention_variants as bench

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SMALL = (4, 40, 128, 2)          # B, S, W, heads
BDP2 = (2, 17, 1024, 16)         # bdp2's head-pair count is fixed at W=1024
# one name for every family the JAX make_variant accepts, and how the port's
# plain version is held against it
JAX_CASES = {
    "lane": "attention", "lane_nt": "attention", "lane_par": "attention",
    "lane_nomax": "attention", "lane_nosm": "attention",
    "lane_f1": "attention", "lane_f2": "attention", "lane_f4": "attention",
    "lane_f2_nosm": "attention", "lane_f4_nosm": "attention",
    "grid_h2": "attention", "lane_packed": "attention", "bdp2": "attention",
    "manual_dma": "attention", "manual_dma_copy": "bit",
    "dma_only": "bit", "dma_s32": "bit", "dma_f2": "bit",
    "fullwidth": "relative", "gemm_inkernel": "relative",
}
JAX_ONLY = ("xla", "jax_flash", "jax_flash_pad")


@functools.lru_cache(maxsize=None)
def _jax_bench():
    spec = importlib.util.spec_from_file_location(
        "bench_vit_attention_variants_interpret",
        ROOT / "scripts" / "bench_vit_attention_variants.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    shim = types.SimpleNamespace(**vars(pl))
    shim.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    mod.pl = shim
    return mod


def _inputs(B, S, W, seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(B, S, W)) * 0.3).astype(np.float32) for _ in range(3)]


def _jax_out(name, B, S, W, heads, xs):
    f = _jax_bench().make_variant(name, B, S, W, heads)
    y = f(*(jnp.asarray(x, jnp.bfloat16) for x in xs))
    return np.asarray(y).astype(np.float32)


def _port_out(name, B, S, W, heads, xs):
    f = bench.make_variant(name, B, S, W, heads, "cpu")
    y = f(*(torch.from_numpy(x).bfloat16() for x in xs))
    assert y.dtype == torch.bfloat16
    return y.float().numpy()


def _assert_close(kind, got, want):
    assert got.shape == want.shape
    if kind == "bit":
        np.testing.assert_array_equal(got, want)
    elif kind == "relative":
        assert np.abs(got - want).max() / np.abs(want).max() <= 1e-2
    else:
        assert np.abs(got - want).max() <= 8e-3
        cos = float(got.ravel() @ want.ravel()
                    / (np.linalg.norm(got) * np.linalg.norm(want)))
        assert cos >= 0.9999


@pytest.mark.parametrize("name", sorted(JAX_CASES))
def test_plain_version_matches_pallas_interpret(name):
    B, S, W, heads = BDP2 if name == "bdp2" else SMALL
    xs = _inputs(B, S, W, seed=len(name))
    _assert_close(JAX_CASES[name], _port_out(name, B, S, W, heads, xs),
                  _jax_out(name, B, S, W, heads, xs))


@pytest.mark.parametrize("name", ["plain", "sdpa", "vit_attention"])
def test_yardsticks_match_the_jax_einsum_oracle(name):
    """``plain`` takes the place of the JAX bench's ``xla`` oracle; ``sdpa``
    and the production kernel compute the same attention."""
    B, S, W, heads = SMALL
    xs = _inputs(B, S, W, seed=7)
    _assert_close("attention", _port_out(name, B, S, W, heads, xs),
                  _jax_out("xla", B, S, W, heads, xs))


def test_every_jax_variant_name_is_accepted():
    B, S, W, heads = 8, 40, 128, 2
    for name in list(JAX_CASES) + ["lane_f8", "lane_f8_nosm", "dma_f4", "dma_s1"]:
        assert callable(bench.make_variant(name, B, S, W, heads, "cpu"))
    for name in JAX_ONLY + ("lane_x", "lane_f3", "lane_f2_max", "dma_s41", "nope"):
        with pytest.raises(ValueError):
            bench.make_variant(name, B, S, W, heads, "cpu")
    family = functools.partial(re.sub, r"\d+", "")       # lane_f2_nosm -> lane_f_nosm
    defaults = bench.default_variants(S)
    assert {family(n) for n in JAX_CASES} <= {family(d) for d in defaults}
    assert {"plain", "sdpa", "vit_attention"} <= set(defaults)


def test_run_on_cpu_gives_one_row_per_variant():
    names = ["plain", "lane", "lane_nosm", "fullwidth", "dma_s16", "gemm_inkernel"]
    rows = bench.run(names, B=2, S=17, W=128, heads=2, layers=2, iters=1,
                     device="cpu")
    assert [r["variant"] for r in rows] == names
    for r in rows:
        assert {"variant", "ms_per_call", "us_per_frame_24l", "eff_tflops",
                "cos_vs_plain", "launches", "bound_ms_per_call"} <= set(r)
        assert r["device"] == "cpu" and r["launches"] == 0   # plain versions
        assert r["ms_per_call"] > 0 and r["bound_ms_per_call"] > 0
    by = {r["variant"]: r for r in rows}
    assert by["lane"]["cos_vs_plain"] >= 0.9999
    assert by["plain"]["cos_vs_plain"] is None            # the oracle itself
    for name in ("lane_nosm", "dma_s16", "gemm_inkernel"):  # not parity-checked
        assert by[name]["cos_vs_plain"] is None


def test_bounds_count_the_functions_bytes_and_operations():
    B, S, W = 256, 257, 1024
    ms, by = bench.bound_ms("lane", B, S, W)
    assert by == "bytes" and ms == pytest.approx(4 * B * S * W * 2 / 3.35e9)
    assert bench.bound_ms("dma_only", B, S, W)[0] == pytest.approx(0.1207, abs=1e-4)
    assert bench.bound_ms("manual_dma_copy", B, S, W)[0] == pytest.approx(0.0804, abs=1e-4)
    ms, by = bench.bound_ms("gemm_inkernel", B, S, W)
    assert by == "operations" and ms == pytest.approx(0.4185, abs=1e-4)
    assert [bench.launches_per_call(n) for n in ("plain", "sdpa", "lane", "fullwidth")] \
        == [0, 0, 1, 3]


def test_cpu_tensors_route_to_plain_versions_without_counting():
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _inputs(2, 17, 128, 3))
    before = [fn.launches for fn in vv.WRAPPERS]
    ref = vv.lane_attention_reference(q, k, v, 2)
    for out in (vv.lane_attention(q, k, v, 2, transpose_k=True),
                vv.lane_attention(q, k, v, 2, frames=2, heads_per_block=1),
                vv.lane_packed_attention(torch.cat([q, k, v], -1), 2),
                vv.bdp2_attention(q, k, v, 2),
                vv.pipelined_attention(q, k, v, 2)):
        torch.testing.assert_close(out, ref, atol=0, rtol=0)
    assert torch.equal(vv.pipelined_attention(q, k, v, 2, copy=True), q)
    assert torch.equal(vv.dma_add(q, k, 9), (q[:, :9].float() + k[:, :9].float()).bfloat16())
    s = vv.gemm(q, k, trans_b=True, out_dtype=torch.float32)
    assert s.dtype == torch.float32 and s.shape == (2, 17, 17)
    torch.testing.assert_close(vv.gemm(vv.row_softmax(s, 0.125), v),
                               vv.fullwidth_reference(q, k, v, 2), atol=0, rtol=0)
    assert [fn.launches for fn in vv.WRAPPERS] == before   # no kernel launched


def test_bdp2_plain_version_equals_exact_attention():
    """The zero halves of the block-diagonal packing contribute exact zeros."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 9, 256, 4))
    torch.testing.assert_close(vv.bdp2_reference(q, k, v, 4),
                               vv.lane_attention_reference(q, k, v, 4),
                               atol=1e-6, rtol=1e-6)


def test_bad_arguments_raise():
    q = torch.zeros(3, 8, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="frames"):
        vv.lane_attention(q, q, q, 2, frames=2)
    with pytest.raises(ValueError, match="transpose_k"):
        vv.lane_attention(q, q, q, 2, mode="nomax", transpose_k=True)
    with pytest.raises(ValueError, match="mode"):
        vv.lane_attention(q, q, q, 2, mode="soft")
    with pytest.raises(ValueError, match="heads_per_block"):
        vv.lane_attention(q, q, q, 2, heads_per_block=3)
    with pytest.raises(ValueError, match="pairs"):
        vv.bdp2_attention(q, q, q, 1)
    with pytest.raises(ValueError, match="rows"):
        vv.dma_add(q, q, 9)
    with pytest.raises(ValueError, match="inner dims"):
        vv.gemm(q, q)
    with pytest.raises(ValueError, match="unknown source"):
        vv.build("vit_attention")


def test_launch_counters_are_plain_integers():
    assert all(isinstance(fn.launches, int) for fn in vv.WRAPPERS)


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card():
    """What ``chip_smoke.py`` phase 1b checks on the card, at a ragged size."""
    if not torch.cuda.is_available():
        pytest.skip("needs an sm_90 CUDA card; run python3 chip_smoke.py on it")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(3, 40, 1024, device="cuda", generator=gen).bfloat16()
               for _ in range(3))
    ref = vv.lane_attention_reference(q, k, v, 16)
    for out in (vv.lane_attention(q, k, v, 16, transpose_k=True),
                vv.lane_attention(q, k, v, 16, frames=3, heads_per_block=2),
                vv.lane_packed_attention(torch.cat([q, k, v], -1), 16),
                vv.bdp2_attention(q, k, v, 16),
                vv.pipelined_attention(q, k, v, 16)):
        cos = torch.nn.functional.cosine_similarity(out.float().reshape(-1, 1024),
                                                    ref.float().reshape(-1, 1024))
        assert cos.min().item() >= 0.9998
        assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert torch.equal(vv.pipelined_attention(q, k, v, 16, copy=True), q)
    assert torch.equal(vv.dma_add(q, k, 33), vv.dma_add_reference(q, k, 33))
    out = vv.fullwidth_attention(q, k, v, 16).float()
    want = vv.fullwidth_reference(q, k, v, 16).float()
    assert ((out - want).norm(dim=-1) / want.norm(dim=-1)).max().item() <= 1e-2
