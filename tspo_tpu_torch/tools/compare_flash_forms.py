"""Time one of the port's attention kernels beside other forms of its CUDA
source, in turns, in one process on one card.

    python3 -m tspo_tpu_torch.tools.compare_flash_forms OTHER.cu [OTHER.cu ...]
        [--kernel flash_attention|vit_attention] [--rounds 2] [--seed 0]
        [--out FILE]

Each ``OTHER.cu`` is another form of the kernel's source
(``csrc/flash_attention.cu``, the default, or ``csrc/vit_attention.cu``
with ``--kernel vit_attention``) with the same C entry point: for example an
earlier revision, ``git show REV:tspo_tpu_torch/csrc/flash_attention.cu >
build/forms/old.cu`` (``build/`` is listed in ``.gitignore``).  Each is
compiled with the port's nvcc flags (``utils/cuda_build.py``; one nvcc each,
all started together) and loaded beside the built kernel of the checkout.

``flash_attention``: at the answer path's prefill shape (B=1, 11784 query
rows and keys, the prompt of 64 frames; H=28, KV=4, hd=128, causal, bf16).
``vit_attention``: at both of its main-path shapes, CLIP-L/14 (B=256,
S=257, 16 heads of 64) and SigLIP (B=64, S=729, 16 heads of 72), bf16; at
the CLIP shape ``flash_attention``'s kernel on the same tensors viewed as
[B, S, H, hd] (non-causal, 16 KV heads) is timed too, as a reference point.
Inputs are normal from ``--seed``.  Every form is held against the plain
version (min row cosine, max abs, max per-row relative error) and against
the checkout's kernel (max abs difference, share of equal elements).  Then
all forms are timed by CUDA events, 30 launches each, in turns: per round
the checkout's kernel, the others, the others in reverse, the checkout's
again; then SDPA (``F.scaled_dot_product_attention`` on [B, H, S, hd]
views, a yardstick the port never calls).  Prints one JSON object with the
card's name and power limit, and writes it to ``--out`` when given.  Needs a
CUDA card.  Its launches do not count in the wrappers' ``launches``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CHECKOUT = "checkout"      # the form built from this checkout's csrc/
SEQ = 11784                # the answer path's prompt at 64 frames
ITERS = 30                 # launches a timing
KERNELS = ("flash_attention", "vit_attention")
# vit_attention's main-path shapes: name -> (B, S, heads, hd)
VIT_SHAPES = {"clip": (256, 257, 16, 64), "siglip": (64, 729, 16, 72)}


def _module(kernel: str):
    from ..ops import flash_attention as fa
    from ..ops import vit_attention as va
    return {"flash_attention": fa, "vit_attention": va}[kernel]


def load_form(src: Path, kernel: str = "flash_attention") -> ctypes.CDLL:
    """Compile another form of the kernel's source (once per content) and
    load it."""
    from ..utils import cuda_build
    lib = ctypes.CDLL(str(cuda_build.build(f"form_{src.stem}", src)))
    fn = getattr(lib, f"tspo_{kernel}")
    fn.argtypes = _module(kernel)._ARGTYPES
    fn.restype = ctypes.c_int
    return lib


def _errors(out, ref) -> dict:
    import torch.nn.functional as F
    o, r = out.float().reshape(-1, out.shape[-1]), ref.float().reshape(-1, ref.shape[-1])
    return {"max_abs_err": (o - r).abs().max().item(),
            "min_row_cos": F.cosine_similarity(o, r, dim=-1).min().item(),
            "max_row_rel_err": ((o - r).norm(dim=-1)
                                / r.norm(dim=-1).clamp_min(1e-30)).max().item()}


def _time_ms(fn, iters: int) -> float:
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _checks(outs: dict, ref) -> dict:
    return {name: {**_errors(out, ref),
                   "max_abs_vs_checkout": (out.float() - outs[CHECKOUT].float())
                   .abs().max().item(),
                   "equal_share_vs_checkout": (out == outs[CHECKOUT]).float().mean().item()}
            for name, out in outs.items()}


def _in_turns(runs: dict, names: list, rounds: int) -> tuple:
    order = []
    for _ in range(rounds):
        order += [CHECKOUT] + names + names[::-1] + [CHECKOUT]
    times: dict = {}
    for name in order:
        times.setdefault(name, []).append(_time_ms(runs[name], ITERS))
    return order, times


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def compare(others: list[Path], rounds: int = 2, seed: int = 0,
            kernel: str = "flash_attention") -> dict:
    import torch
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, not {kernel!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("compare_flash_forms needs a CUDA card")
    names = [p.name for p in others]
    if len(set(names)) != len(names) or CHECKOUT in names:
        raise ValueError(f"give each form a distinct file name, not {names}")
    with ThreadPoolExecutor(len(others)) as ex:          # one nvcc each, together
        built = list(ex.map(lambda p: load_form(p, kernel), others))
    forms = {CHECKOUT: _module(kernel)._load(), **dict(zip(names, built))}
    if kernel == "vit_attention":
        return _compare_vit(forms, names, rounds, seed)
    return _compare_flash(forms, names, rounds, seed)


def _compare_flash(forms: dict, names: list, rounds: int, seed: int) -> dict:
    import torch
    import torch.nn.functional as F
    from ..ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(1, SEQ, 28, 128, device="cuda", generator=gen).bfloat16()
    k, v = (torch.randn(1, SEQ, 4, 128, device="cuda", generator=gen).bfloat16()
            for _ in range(2))
    ref = fa.flash_attention_reference(q, k, v, causal=True)
    outs, runs = {}, {}
    for name, lib in forms.items():
        out = torch.empty_like(q)
        run = (lambda lib=lib, out=out:
               fa.launch(lib, q, k, v, out, None, True, None, 0))
        err = run()
        torch.cuda.synchronize()
        if err != 0:
            raise RuntimeError(f"form {name}: CUDA error {err}")
        outs[name], runs[name] = out, run
    checks = _checks(outs, ref)
    order, times = _in_turns(runs, names, rounds)
    views = [x.transpose(1, 2) for x in (q, k, v)]
    times["sdpa"] = [_time_ms(lambda: F.scaled_dot_product_attention(
        *views, is_causal=True, enable_gqa=True), ITERS) for _ in range(rounds)]
    flops = 4 * 128 * 28 * SEQ * (SEQ + 1) // 2          # causal: S(S+1)/2 keys
    return {"card": _card(), "kernel": "flash_attention",
            "shape": {"B": 1, "S": SEQ, "H": 28, "KV": 4, "hd": 128,
                      "causal": True, "dtype": "bf16"},
            "order": order, "iters": ITERS, "ms": times,
            "mean_ms": {n: sum(t) / len(t) for n, t in times.items()},
            "tflops": {n: flops / (sum(t) / len(t)) / 1e9 for n, t in times.items()},
            "checks": checks}


def _compare_vit(forms: dict, names: list, rounds: int, seed: int) -> dict:
    import torch
    import torch.nn.functional as F
    from ..ops import flash_attention as fa
    from ..ops import vit_attention as va
    gen = torch.Generator(device="cuda").manual_seed(seed)
    result = {"card": _card(), "kernel": "vit_attention", "iters": ITERS, "shapes": {}}
    for shape, (B, S, H, hd) in VIT_SHAPES.items():
        W = H * hd
        q, k, v = (torch.randn(B, S, W, device="cuda", generator=gen).bfloat16()
                   for _ in range(3))
        ref = va.vit_attention_reference(q, k, v, H)
        outs, runs = {}, {}
        for name, lib in forms.items():
            out = torch.empty_like(q)
            run = lambda lib=lib, out=out: va.launch(lib, q, k, v, out, H)
            err = run()
            torch.cuda.synchronize()
            if err != 0:
                raise RuntimeError(f"form {name} at {shape}: CUDA error {err}")
            outs[name], runs[name] = out, run
        checks = _checks(outs, ref)
        del ref
        order, times = _in_turns(runs, names, rounds)
        views = [x.view(B, S, H, hd).transpose(1, 2) for x in (q, k, v)]
        times["sdpa"] = [_time_ms(lambda: F.scaled_dot_product_attention(*views), ITERS)
                         for _ in range(rounds)]
        if hd in fa.HEAD_DIMS:
            q4, k4, v4 = (x.view(B, S, H, hd) for x in (q, k, v))
            o4, flash = torch.empty_like(q4), fa._load()
            times["flash_attention"] = [
                _time_ms(lambda: fa.launch(flash, q4, k4, v4, o4, None, False, None, 0),
                         ITERS) for _ in range(rounds)]
            checks["flash_attention"] = {"max_abs_vs_checkout": (
                o4.reshape(B, S, W).float() - outs[CHECKOUT].float()).abs().max().item()}
        flops = 4 * B * S * S * W
        result["shapes"][shape] = {
            "B": B, "S": S, "H": H, "hd": hd, "dtype": "bf16", "order": order,
            "ms": times, "mean_ms": {n: sum(t) / len(t) for n, t in times.items()},
            "tflops": {n: flops / (sum(t) / len(t)) / 1e9 for n, t in times.items()},
            "checks": checks}
        del q, k, v, outs, runs, views
        torch.cuda.empty_cache()
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("others", nargs="+", type=Path, help="other forms of the source")
    ap.add_argument("--kernel", choices=KERNELS, default="flash_attention")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    result = compare(args.others, args.rounds, args.seed, args.kernel)
    print(json.dumps(result, indent=1))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
