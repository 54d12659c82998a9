"""Where the time goes in the port's main path on the card.

    python -m tspo_tpu_torch.tools.profile_scoring [--frames 300] [--seed 0]
        [--out profile_scoring.json]

Builds the full-width CLIP-L/14 + selector scorer in bf16 with random weights
(``batch_frames=256``), warms up, then:

1. times the stages of one ``score_video_fused`` call separately, each ended
   by ``torch.cuda.synchronize()``: host-to-device copy of the uint8 frames,
   device preprocess, vision tower, text tower, selector + top-k;
2. runs one whole call under ``torch.profiler`` and sums device time by
   kernel class (the vit_attention kernel, GEMMs, elementwise and
   reductions, copies, other), with the device-busy share (kernel time over
   the call's wall time).

Needs a CUDA card; prints one JSON object, and writes it to ``--out`` when
given.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import time


def _classify(name: str) -> str:
    n = name.lower()
    if "vit_attention" in n:
        return "vit_attention kernel"
    if re.search(r"gemm|xmma|cutlass|cublas|nvjet|sm90_|ampere_", n):
        return "gemm"
    if "memcpy" in n or "memset" in n:
        return "copy"
    if re.search(r"elementwise|vectorized|reduce|softmax|norm|cat|index|"
                 r"where|copy|fill|sort|arange", n):
        return "elementwise/reduction"
    return "other"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..cli.common import _stub_tokenizer
    from ..models.clip import preprocess_frames
    from ..models.tspo_model import build_random_scorer
    from ..ops.masking import bucket_for

    if not torch.cuda.is_available():
        raise SystemExit("profile_scoring needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    scorer = build_random_scorer(torch.Generator().manual_seed(args.seed),
                                 dtype=torch.bfloat16, device="cuda",
                                 batch_frames=256, tokenize=_stub_tokenizer())
    gen = torch.Generator().manual_seed(args.seed + 2)
    low = torch.randint(0, 256, (args.frames, 12, 16, 3), generator=gen,
                        dtype=torch.uint8)
    frames = low.repeat_interleave(40, 1).repeat_interleave(40, 2).numpy()
    q = "what is the person holding?"
    scorer.score_video_fused(frames, q, sample_num=64)          # warm-up
    torch.cuda.synchronize()

    # 1. stages, each ended by a synchronize
    stages = {"h2d": 0.0, "preprocess": 0.0, "vision": 0.0}
    sync = torch.cuda.synchronize
    t_all = time.perf_counter()
    with torch.inference_mode():
        t0 = time.perf_counter()
        ids, _ = scorer._ids(q, with_mask=False)
        txt = scorer.clip.encode_text(ids)
        sync()
        stages["text"] = time.perf_counter() - t0
        feats = []
        B = scorer.batch_frames
        for s in range(0, args.frames, B):
            t0 = time.perf_counter()
            chunk = torch.as_tensor(frames[s:s + B]).to("cuda")
            sync()
            t1 = time.perf_counter()
            pixels = preprocess_frames(chunk, 224, torch.bfloat16)
            sync()
            t2 = time.perf_counter()
            feats.append(scorer.clip.encode_images(pixels))
            sync()
            t3 = time.perf_counter()
            stages["h2d"] += t1 - t0
            stages["preprocess"] += t2 - t1
            stages["vision"] += t3 - t2
        t0 = time.perf_counter()
        bucket = -(-bucket_for(args.frames, scorer.frame_buckets) // B) * B
        feat_p, valid = scorer._padded(torch.cat(feats), bucket)
        scorer._fused_tail(feat_p, valid, txt, 64, None, None)
        sync()
        stages["selector_topk"] = time.perf_counter() - t0
    stages_total = time.perf_counter() - t_all

    # 2. one whole call under the profiler
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        scorer.score_video_fused(frames, q, sample_num=64)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_class: dict = {}
    top: dict = {}
    n_kernels = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        cls = _classify(e.name)
        by_class[cls] = by_class.get(cls, 0.0) + us / 1e3
        top[e.name] = top.get(e.name, 0.0) + us / 1e3
        n_kernels += 1
    busy_ms = sum(by_class.values())
    result = {
        "card": card, "frames": args.frames, "batch_frames": 256,
        "stages_s": stages, "stages_total_s": stages_total,
        "profiled_wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / (wall * 1e3),
        "device_ms_by_class": dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
        "device_events": n_kernels,
        "top_kernels_ms": dict(sorted(top.items(), key=lambda kv: -kv[1])[:15]),
    }
    print(json.dumps(result, indent=1))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
