"""Time the port's ``flash_attention`` kernel beside other forms of its
CUDA source, in turns, in one process on one card.

    python3 -m tspo_tpu_torch.tools.compare_flash_forms OTHER.cu [OTHER.cu ...]
        [--rounds 2] [--seed 0] [--out FILE]

Each ``OTHER.cu`` is another form of ``csrc/flash_attention.cu`` with the
same C entry point, ``tspo_flash_attention``: for example an earlier revision,
``git show REV:tspo_tpu_torch/csrc/flash_attention.cu > build/forms/old.cu``
(``build/`` is listed in ``.gitignore``).  Each is compiled with the port's
nvcc flags (``utils/cuda_build.py``; one nvcc each, all started together)
and loaded beside the built kernel of the checkout.  At the answer path's prefill shape (B=1, 11784 query rows and
keys, the prompt of 64 frames; H=28, KV=4, hd=128, causal, bf16, normal
inputs from ``--seed``) every form is held against the plain version (min
row cosine, max abs, max per-row relative error) and against the checkout's
kernel (max abs difference, share of equal elements).  Then all forms are
timed by CUDA events, 30 launches each, in turns: per round the
checkout's kernel, the others, the others in reverse, the checkout's again;
then SDPA (``F.scaled_dot_product_attention`` on [B, H, S, hd] views, a
yardstick the port never calls).  Prints one JSON object with the card's name
and power limit, and writes it to ``--out`` when given.  Needs a CUDA card.
Its launches do not count in ``flash_attention.launches``.
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


def load_form(src: Path) -> ctypes.CDLL:
    """Compile another form of the source (once per content) and load it."""
    from ..ops import flash_attention as fa
    from ..utils import cuda_build
    lib = ctypes.CDLL(str(cuda_build.build(f"form_{src.stem}", src)))
    lib.tspo_flash_attention.argtypes = fa._ARGTYPES
    lib.tspo_flash_attention.restype = ctypes.c_int
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


def compare(others: list[Path], rounds: int = 2, seed: int = 0) -> dict:
    import torch
    import torch.nn.functional as F
    from ..ops import flash_attention as fa
    if not torch.cuda.is_available():
        raise RuntimeError("compare_flash_forms needs a CUDA card")
    names = [p.name for p in others]
    if len(set(names)) != len(names) or CHECKOUT in names:
        raise ValueError(f"give each form a distinct file name, not {names}")
    with ThreadPoolExecutor(len(others)) as ex:          # one nvcc each, together
        built = list(ex.map(load_form, others))
    forms = {CHECKOUT: fa._load(), **dict(zip(names, built))}
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
    checks = {name: {**_errors(out, ref),
                     "max_abs_vs_checkout": (out.float() - outs[CHECKOUT].float())
                     .abs().max().item(),
                     "equal_share_vs_checkout": (out == outs[CHECKOUT]).float().mean().item()}
              for name, out in outs.items()}
    order = []
    for _ in range(rounds):
        order += [CHECKOUT] + names + names[::-1] + [CHECKOUT]
    times: dict = {}
    for name in order:
        times.setdefault(name, []).append(_time_ms(runs[name], ITERS))
    views = [x.transpose(1, 2) for x in (q, k, v)]
    times["sdpa"] = [_time_ms(lambda: F.scaled_dot_product_attention(
        *views, is_causal=True, enable_gqa=True), ITERS) for _ in range(rounds)]
    flops = 4 * 128 * 28 * SEQ * (SEQ + 1) // 2          # causal: S(S+1)/2 keys
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    return {"card": card, "shape": {"B": 1, "S": SEQ, "H": 28, "KV": 4, "hd": 128,
                                    "causal": True, "dtype": "bf16"},
            "order": order, "iters": ITERS, "ms": times,
            "mean_ms": {n: sum(t) / len(t) for n, t in times.items()},
            "tflops": {n: flops / (sum(t) / len(t)) / 1e9 for n, t in times.items()},
            "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("others", nargs="+", type=Path, help="other forms of the source")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    result = compare(args.others, args.rounds, args.seed)
    print(json.dumps(result, indent=1))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
