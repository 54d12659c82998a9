"""The ViT-attention variant bench on the card: every variant of
``scripts/bench_vit_attention_variants.py`` through the port's Hopper kernels.

    python3 -m tspo_tpu_torch.tools.bench_vit_attention_variants [NAME ...]
        [--device cuda|cpu] [--seed N] [--tiny]

Each variant is one probe of where ``vit_attention``'s time goes at the
CLIP-L/14 scoring shape (B=256 frames, S=257, W=1024, 16 heads of hd=64,
bf16): the copy floor (``dma_*``), softmax cost (``lane_nomax``,
``lane_nosm``), per-block overhead (``lane_f{F}``, ``grid_h2``), one packed
input (``lane_packed``), an explicitly pipelined persistent grid
(``manual_dma``), two big products instead of per-head slices
(``fullwidth``), the in-kernel matrix rate (``gemm_inkernel``), and the
block-diagonal two-head packing (``bdp2``).  Beside them: ``plain`` (the
einsum oracle, in place of the JAX bench's ``xla``), ``sdpa``
(``F.scaled_dot_product_attention`` on [B, H, S, hd] views, a yardstick that
no port path calls, in place of ``jax_flash``) and ``vit_attention`` (the
production kernel).  ``jax_flash_pad`` has no counterpart: it padded S to the
TPU op's multiple of 128, and SDPA takes any S.

Like the JAX bench, each variant runs ``layers`` times in a chain (the
output, cut to [B, S, W], scaled by 0.01 and padded where its shape differs,
is the next step's q), once to warm up and then ``iters`` times, timed by CUDA
events around the timed calls; a parity probe at B=8 compares it with
``plain`` (not for the attribution-only ``lane_nosm``, ``lane_nomax``,
``dma_*`` and ``gemm_*``).  One JSON row per variant: ``ms_per_call``,
``us_per_frame_24l``, ``eff_tflops`` (4·B·S²·W·layers over the call time),
``cos_vs_plain``, ``launches`` (port kernel launches in the variant's calls)
and ``bound_ms_per_call`` (``layers`` times the least time the H100 could
take for one step's function: bytes over 3.35 TB/s or FLOP over
989 TFLOP/s, whichever is larger).  Inputs are normal·0.3 from ``--seed``,
as in the JAX bench.  Runs on the card unless given ``--device cpu`` (the
plain versions); ``--tiny`` takes B=4, S=40, W=128, 2 heads, 2 layers and one
timed call, a smoke run that the CPU finishes in seconds.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import vit_attention as va
from ..ops import vit_attention_variants as vv
from ..utils.device import resolve_device

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
PEAK_BF16_FLOPS = 989e12      # dense bf16 tensor-core rate
PARITY_FRAMES = 8
TINY = dict(B=4, S=40, W=128, heads=2, layers=2, iters=1)
# JAX variants with no kernel of the repository behind them
NOT_PORTED = {"xla": "plain", "jax_flash": "sdpa", "jax_flash_pad": "sdpa"}
# attribution variants the JAX bench does not hold against its oracle
NO_PARITY = ("lane_nosm", "lane_nomax")
NO_PARITY_PREFIXES = ("dma_", "gemm_")


def default_variants(S: int = 257) -> list[str]:
    """Every variant, in the order the bench runs them."""
    return ["plain", "sdpa", "vit_attention", "lane", "lane_nt", "lane_par",
            "lane_nomax", "lane_nosm", "lane_f1", "lane_f2", "lane_f4",
            "lane_f1_nosm", "lane_f2_nosm", "lane_f4_nosm", "grid_h2",
            "lane_packed", "bdp2", "manual_dma", "manual_dma_copy",
            "fullwidth", "dma_only", f"dma_s{max(1, (S - 1) // 8 * 8)}",
            "dma_f2", "gemm_inkernel"]


def _frames(name: str, prefix: str, B: int) -> int:
    F_ = int(name[len(prefix):].split("_")[0])
    if F_ <= 0 or B % F_:
        raise ValueError(f"{name}: batch {B} is not divisible by {F_} frames")
    return F_


def _plain(q, k, v, heads):
    """The einsum oracle with the JAX bench's ``xla`` numerics: bf16 scores,
    scaled in bf16, fp32 softmax rounded to bf16, bf16 output."""
    B, S, W = q.shape
    hd = W // heads
    qh, kh, vh = (x.reshape(B, S, heads, hd).float() for x in (q, k, v))
    sc = torch.einsum("bqhd,bkhd->bhqk", qh, kh).to(q.dtype)
    sc = (sc.float() * (1.0 / math.sqrt(hd))).to(q.dtype)
    a = torch.softmax(sc.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", a.float(), vh).to(q.dtype).reshape(B, S, W)


def _sdpa(q, k, v, heads):
    B, S, W = q.shape
    views = [x.view(B, S, heads, W // heads).transpose(1, 2) for x in (q, k, v)]
    return F.scaled_dot_product_attention(*views).transpose(1, 2).reshape(B, S, W)


def make_variant(name: str, B: int, S: int, W: int, heads: int,
                 device: str | torch.device = "cuda"):
    """The variant ``name`` as a function (q, k, v) -> y on [B, S, W] bf16
    inputs.  Accepts every name of the JAX bench's ``make_variant`` except
    those in ``NOT_PORTED``, plus ``plain``, ``sdpa`` and ``vit_attention``."""
    if name in NOT_PORTED:
        raise ValueError(f"{name} is not a kernel of the repository; the port's "
                         f"yardstick in its place is {NOT_PORTED[name]!r}")
    if name == "plain":
        return lambda q, k, v: _plain(q, k, v, heads)
    if name == "sdpa":
        return lambda q, k, v: _sdpa(q, k, v, heads)
    if name == "vit_attention":
        return lambda q, k, v: va.vit_attention(q, k, v, heads)
    if name.startswith("lane_f"):
        frames = _frames(name, "lane_f", B)
        if name not in (f"lane_f{frames}", f"lane_f{frames}_nosm"):
            raise ValueError(f"unknown variant {name!r}")
        mode = "none" if name.endswith("_nosm") else "max"
        return lambda q, k, v: vv.lane_attention(q, k, v, heads, mode=mode,
                                                 frames=frames)
    if name == "fullwidth":
        return lambda q, k, v: vv.fullwidth_attention(q, k, v, heads)
    if name.startswith("dma_s"):
        rows = int(name[5:])
        if not 0 < rows <= S:
            raise ValueError(f"{name}: rows must be in 1..{S}")
        return lambda q, k, v: vv.dma_add(q, k, rows)
    if name.startswith("dma_f"):
        _frames(name, "dma_f", B)
        return lambda q, k, v: vv.dma_add(q, k)
    if name == "dma_only":
        return lambda q, k, v: vv.dma_add(q, k)
    if name == "gemm_inkernel":
        w = torch.from_numpy(np.random.default_rng(1).normal(size=(W, 3 * W)) * 0.02)
        w = w.to(device=device, dtype=torch.bfloat16)
        return lambda q, k, v: vv.gemm(q.reshape(-1, W), w).reshape(B, S, 3 * W)
    if name == "lane_packed":
        return lambda q, k, v: vv.lane_packed_attention(torch.cat([q, k, v], -1),
                                                        heads)
    if name in ("manual_dma", "manual_dma_copy"):
        copy = name == "manual_dma_copy"
        return lambda q, k, v: vv.pipelined_attention(q, k, v, heads, copy=copy)
    if name == "bdp2":
        return lambda q, k, v: vv.bdp2_attention(q, k, v, heads)
    if name == "grid_h2":
        return lambda q, k, v: vv.lane_attention(q, k, v, heads, heads_per_block=2)
    opts = {"lane": dict(transpose_k=True), "lane_nt": {}, "lane_par": {},
            "lane_nomax": dict(mode="nomax"), "lane_nosm": dict(mode="none")}
    if name not in opts:
        raise ValueError(f"unknown variant {name!r}")
    kw = opts[name]
    return lambda q, k, v: vv.lane_attention(q, k, v, heads, **kw)


def launches_per_call(name: str) -> int:
    """Port kernel launches in one call of the variant."""
    if name in ("plain", "sdpa"):
        return 0
    return 3 if name == "fullwidth" else 1


def bound_ms(name: str, B: int, S: int, W: int) -> tuple:
    """(ms, "bytes" or "operations"): the least time the H100 could take
    for one call of the variant's function, its inputs read once and its
    output written once."""
    x = B * S * W * 2                      # bytes of one bf16 [B, S, W]
    flops = 4.0 * B * S * S * W            # q kᵀ and P v
    if name.startswith("dma_s"):
        nbytes, flops = 3 * x * int(name[5:]) / S, 0.0
    elif name.startswith("dma_"):
        nbytes, flops = 3 * x, 0.0
    elif name == "manual_dma_copy":
        nbytes, flops = 2 * x, 0.0
    elif name == "gemm_inkernel":
        nbytes, flops = 4 * x + W * 3 * W * 2, 2.0 * B * S * W * 3 * W
    else:
        nbytes = 4 * x
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def total_launches() -> int:
    """Launches so far of every kernel a variant can call."""
    return sum(fn.launches for fn in vv.WRAPPERS) + va.vit_attention.launches


def chained(f, q, k, v, layers: int) -> torch.Tensor:
    """``layers`` steps of f, each output feeding the next step's q."""
    x = q
    for _ in range(layers):
        y = f(x, k, v)
        if y.shape != x.shape:                 # attribution variants
            y = y[..., :x.shape[-1]] * 0.01
        if y.shape[1] != x.shape[1]:
            y = F.pad(y, (0, 0, 0, x.shape[1] - y.shape[1]))
        x = y.to(x.dtype)
    return x.float().mean()                    # scalar, full compute


def _time_ms(fn, iters: int, device: torch.device) -> float:
    """ms per call of fn: CUDA events around ``iters`` calls on the card, the
    host clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(stop) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def _inputs(B: int, S: int, W: int, seed: int, device: torch.device) -> list:
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.normal(size=(B, S, W)) * 0.3).astype(np.float32))
            .to(device=device, dtype=torch.bfloat16) for _ in range(3)]


def _cos(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().ravel(), b.double().ravel()
    return float(a @ b / (a.norm() * b.norm() + 1e-9))


def run(names=None, B: int = 256, S: int = 257, W: int = 1024, heads: int = 16,
        layers: int = 24, iters: int = 10, seed: int = 0,
        device: str | torch.device = "cuda") -> list[dict]:
    """Run each variant of ``names`` (all by default) as the JAX bench's
    ``main`` does; returns one row per variant."""
    dev = resolve_device(device)
    names = list(names or default_variants(S))
    nb = min(PARITY_FRAMES, B)
    fns = {n: (make_variant(n, B, S, W, heads, dev),
               make_variant(n, nb, S, W, heads, dev)) for n in names}
    q, k, v = _inputs(B, S, W, seed, dev)
    small = [x[:nb] for x in (q, k, v)]
    oracle = _plain(*small, heads)
    flops = 4.0 * B * S * S * W * layers
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    rows = []
    for name, (f, fs) in fns.items():
        before = total_launches()
        out_small = fs(*small)                                 # parity probe
        chained(f, q, k, v, layers)                            # warm-up
        ms = _time_ms(lambda: chained(f, q, k, v, layers), iters, dev)
        parity = not (name == "plain" or name in NO_PARITY
                      or name.startswith(NO_PARITY_PREFIXES))
        rows.append({
            "variant": name, "device": kind,
            "ms_per_call": ms, "us_per_frame_24l": ms / B * 1e3,
            "eff_tflops": flops / ms / 1e9,
            "cos_vs_plain": _cos(oracle, out_small) if parity else None,
            "launches": total_launches() - before, "calls": iters + 1,
            "layers": layers,
            "bound_ms_per_call": layers * bound_ms(name, B, S, W)[0]})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="*", help="variant names (default: all)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true",
                    help="B=4, S=40, W=128, 2 heads, 2 layers, one timed call")
    args = ap.parse_args(argv)
    shape = TINY if args.tiny else {}
    for row in run(args.variants, seed=args.seed, device=args.device, **shape):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
