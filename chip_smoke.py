#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tspo_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout, on a machine with one CUDA card.  Phases:

0. Card: the card's name and power limit (nvidia-smi), and the build of every
   Hopper kernel from ``tspo_tpu_torch/csrc`` (one nvcc per source, all
   started together).
1. Kernel: each kernel's wrapper against its plain PyTorch version, on the
   card, at the shapes the main path gives it (and the SigLIP geometry), in
   bf16 and fp32; kernel, plain-version and library-call times by CUDA events
   after warm-up, beside the least time the card could take (bound).
2. Parity at full width: a CLIP-ViT-L/14 + selector scorer in fp32 with
   random weights from ``--seed`` scores 8 frames of 480x640 on the card and,
   with the same port, on the CPU (plain versions); features, logits and the
   selected indices must agree.
3. Main path: the full-width scorer in bf16 with ``batch_frames=256`` scores
   a 300-frame video (bucket 512) with ``score_video_fused(sample_num=64)``,
   then encodes it once and scores 3 questions on the shared features.  Every
   kernel count is set to 0 just before and read just after each path.
4. One JSON line listing every ported kernel with its launches, error and
   times; then, as the last line, ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when no CUDA device is present or when
any check fails.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense): HBM bytes/s, and FLOP/s by operand type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}   # fp32 outside the tensor cores


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def smooth_frames(gen, n: int, h: int = 480, w: int = 640):
    """[n, h, w, 3] uint8 frames: random 12x16 colour fields upsampled by
    nearest neighbour, so frames differ in their content as video frames do."""
    import torch
    low = torch.randint(0, 256, (n, 12, 16, 3), generator=gen, dtype=torch.uint8)
    return low.repeat_interleave(h // 12, 1).repeat_interleave(w // 16, 2).numpy()


def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    from tspo_tpu_torch.ops import vit_attention as va
    builds = {"vit_attention": va.build}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as ex:
        libs = {name: ex.submit(fn) for name, fn in builds.items()}
        libs = {name: f.result() for name, f in libs.items()}
    print(f"phase 0 card: built {sorted(libs)} in "
          f"{time.perf_counter() - t0:.1f} s")
    return smi


def phase_kernel(seed: int) -> dict:
    """vit_attention against its plain version; returns the main-path row."""
    import torch
    import torch.nn.functional as F
    from tspo_tpu_torch.ops.vit_attention import (vit_attention,
                                                  vit_attention_reference)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    row = None
    for B, S, W, H in ((256, 257, 1024, 16), (32, 729, 1152, 16)):
        hd = W // H
        for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
            q, k, v = (torch.randn(B, S, W, device="cuda", generator=gen).to(dtype)
                       for _ in range(3))
            out = vit_attention(q, k, v, H)
            torch.cuda.synchronize()
            ref = vit_attention_reference(q, k, v, H)
            err = (out.float() - ref.float()).abs().max().item()
            cos = F.cosine_similarity(out.float().reshape(-1, W),
                                      ref.float().reshape(-1, W), dim=-1).min().item()
            check(torch.isfinite(out).all().item(), f"vit_attention {tag} finite")
            if tag == "bf16":
                check(cos >= 0.9998 and err <= 2e-2,
                      f"vit_attention bf16 B={B} S={S}: cos {cos} err {err}")
            else:
                check(err <= 2e-5, f"vit_attention fp32 B={B} S={S}: err {err}")
            views = [x.view(B, S, H, hd).transpose(1, 2) for x in (q, k, v)]
            ms = cuda_time_ms(lambda: vit_attention(q, k, v, H), 20)
            plain_ms = cuda_time_ms(lambda: vit_attention_reference(q, k, v, H), 5, 1)
            lib_ms = cuda_time_ms(
                lambda: F.scaled_dot_product_attention(*views), 20)
            nbytes = 4 * B * S * W * q.element_size()
            flops = 4 * B * S * S * W
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[tag] * 1e3
            bound_ms = max(t_bytes, t_ops)
            bound_by = "bytes" if t_bytes >= t_ops else "operations"
            print(json.dumps({"phase": 1, "kernel": "vit_attention", "B": B,
                              "S": S, "W": W, "heads": H, "dtype": tag,
                              "max_abs_err": err, "min_row_cos": cos,
                              "kernel_ms": ms, "plain_ms": plain_ms,
                              "library_ms": lib_ms, "bound_ms": bound_ms,
                              "bound_by": bound_by}))
            if (B, S, tag) == (256, 257, "bf16"):
                row = {"name": "vit_attention", "route": "cuda",
                       "source": "tspo_tpu_torch/csrc/vit_attention.cu",
                       "replaces": "tspo_tpu/ops/vit_attention.py:29",
                       "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "library_ms": lib_ms}
            del q, k, v, out, ref, views
    torch.cuda.empty_cache()
    return row


def phase_parity(seed: int):
    """Full-width fp32 scorer: card (kernel) against CPU (plain versions)."""
    import numpy as np
    import torch
    from tspo_tpu_torch.cli.common import _stub_tokenizer
    from tspo_tpu_torch.models.tspo_model import build_random_scorer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    frames = smooth_frames(torch.Generator().manual_seed(seed + 1), 8)
    out = {}
    for dev in ("cuda", "cpu"):
        scorer = build_random_scorer(torch.Generator().manual_seed(seed),
                                     dtype=torch.float32, device=dev,
                                     batch_frames=8, tokenize=_stub_tokenizer())
        feats = scorer.encode_frame_features(frames).cpu()
        idx, logits = scorer.score_video_fused(frames, "what happens in the video?",
                                               sample_num=4)
        out[dev] = (feats, idx, logits)
        del scorer
    (fc, ic, lc), (fh, ih, lh) = out["cuda"], out["cpu"]
    cos = torch.nn.functional.cosine_similarity(fc, fh, dim=-1).min().item()
    rel = float(np.abs(lc - lh).max() / np.abs(lh).max())
    print(json.dumps({"phase": 2, "feature_min_cos": cos, "logits_max_rel": rel,
                      "indices_card": ic.tolist(), "indices_cpu": ih.tolist()}))
    check(cos >= 0.9999, f"parity feature cosine {cos}")
    check(rel <= 1e-3, f"parity logits relative error {rel}")
    check(np.array_equal(ic, ih), f"parity indices {ic} vs {ih}")
    torch.cuda.empty_cache()


def phase_main(seed: int) -> int:
    """The main path at full width in bf16; returns the kernel's launches in
    the timed score_video_fused run."""
    import numpy as np
    import torch
    from tspo_tpu_torch.cli.common import _stub_tokenizer
    from tspo_tpu_torch.models.tspo_model import build_random_scorer
    from tspo_tpu_torch.ops.vit_attention import vit_attention
    T, k = 300, 64
    scorer = build_random_scorer(torch.Generator().manual_seed(seed),
                                 dtype=torch.bfloat16, device="cuda",
                                 batch_frames=256, tokenize=_stub_tokenizer())
    frames = smooth_frames(torch.Generator().manual_seed(seed + 2), T)
    questions = ["what is the person holding?", "where does the scene change?",
                 "how many people appear?"]
    scorer.score_video_fused(frames, questions[0], sample_num=k)   # warm-up
    torch.cuda.synchronize()

    vit_attention.launches = 0
    t0 = time.perf_counter()
    idx, logits = scorer.score_video_fused(frames, questions[0], sample_num=k)
    torch.cuda.synchronize()
    t_fused = time.perf_counter() - t0
    launches = vit_attention.launches
    check(launches == 46, f"score_video_fused launched vit_attention "
                          f"{launches} times, want 46 (2 chunks x 23 layers)")
    check(logits.shape == (T,) and np.isfinite(logits).all(), "fused logits")
    check(len(idx) == k and np.all(np.diff(idx) > 0) and idx[-1] < T,
          f"fused indices {idx}")

    vit_attention.launches = 0
    t0 = time.perf_counter()
    feats = scorer.encode_frame_features(frames)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    shared_launches = vit_attention.launches
    check(shared_launches == 46, f"encode launched {shared_launches}, want 46")
    t0 = time.perf_counter()
    shared = [scorer.score_features_fused(feats, q, sample_num=k)
              for q in questions]
    torch.cuda.synchronize()
    t_q = time.perf_counter() - t0
    check(vit_attention.launches == 46, "question scoring launched the kernel")
    check(feats.shape == (T, 768) and torch.isfinite(feats).all().item(),
          "shared features")
    check(np.array_equal(shared[0][0], idx),
          "shared-feature indices differ from score_video_fused's")
    for sidx, slog in shared:
        check(len(sidx) == k and np.isfinite(slog).all(), "shared scoring")
    print(json.dumps({"phase": 3, "frames": T, "bucket": 512, "sample_num": k,
                      "score_video_fused_s": t_fused,
                      "frames_per_s": T / t_fused,
                      "shared_encode_s": t_enc, "shared_3q_s": t_q,
                      "shared_frames_per_s": 3 * T / (t_enc + t_q),
                      "launches_fused": launches,
                      "launches_encode": shared_launches}))
    return launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "tspo_tpu_torch" / "csrc" / "vit_attention.cu").exists():
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    phase_card()
    row = phase_kernel(args.seed)
    phase_parity(args.seed)
    row["launches"] = phase_main(args.seed)
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
