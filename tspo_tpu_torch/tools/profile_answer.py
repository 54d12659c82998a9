"""Where the time goes in the port's answer path on the card.

    python -m tspo_tpu_torch.tools.profile_answer [--frames 64] [--new-tokens 16]
        [--seed 0] [--out profile_answer.json]

Builds LLaVA-Video-7B-Qwen2 (Qwen2-7B + SigLIP-so400m, full width and depth)
in bf16 with random weights drawn on the card, takes ``--frames`` frames of
480x640 made from the seed, warms up with one ``generate``, then:

1. times the stages of one answer: host-to-device copy of the uint8 frames,
   SigLIP preprocess, SigLIP tower, projector + pool + newline tokens and
   tokenize + splice, each ended by ``torch.cuda.synchronize()``; then
   ``greedy_decode`` itself (the call ``generate`` makes), its prefill with
   the first token and each decode step read from CUDA events recorded as
   each step's logits appear, so the loop runs as ``generate`` runs it;
2. runs one whole ``generate`` under ``torch.profiler`` and sums device time
   by kernel class (the flash_attention and vit_attention kernels, GEMMs,
   elementwise and reductions, copies, other), with the device-busy share
   (kernel time over the call's wall time), and the device time of the
   kernels that start after the prefill's last ``flash_attention`` launch:
   the decode steps, plus the rest of the prefill's last layer and its
   first-token logits.

Needs a CUDA card; prints one JSON object, and writes it to ``--out`` when
given.  The card's name and power limit are part of the result.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import time


class StepClock:
    """A ``step_logits`` sink for ``greedy_decode`` that keeps no logits: it
    records a CUDA event when made and one each time a step's logits are
    appended.  Event 0 ends the prefill (the first logits), event i ends
    decode step i."""

    def __init__(self):
        import torch
        self._new = lambda: torch.cuda.Event(enable_timing=True)
        self.start = self._new()
        self.start.record()
        self.events = []

    def append(self, logits):
        ev = self._new()
        ev.record()
        self.events.append(ev)


def timed_greedy_decode(model, embeds, max_new_tokens: int, valid=None):
    """``greedy_decode`` over ``embeds`` [B, S, D] with the cache
    ``LLaVAVideoModel.generate`` (B = 1, every position valid) or
    ``generate_batch_multi`` (``valid`` [B, S], ragged rows) gives it.
    Returns (token ids up to the last step, [S] for B = 1 and [B, steps]
    else, prefill + first-token ms, [ms of each decode step]), read from
    CUDA events: no synchronise is added inside the loop."""
    import torch

    from ..models.qwen2 import KVCache, greedy_decode
    B, S = embeds.shape[:2]
    cache = KVCache.create(model.cfg.lm, B,
                           min(model.cfg.max_context, S + max_new_tokens + 8),
                           embeds.dtype, model.device)
    if valid is None:
        valid = torch.ones(B, S, dtype=torch.bool, device=model.device)
    clock = StepClock()
    toks, n = greedy_decode(model.lm, embeds, valid, cache, max_new_tokens,
                            step_logits=clock)
    torch.cuda.synchronize()
    ev = clock.events
    return (toks[..., :n].cpu().tolist(), clock.start.elapsed_time(ev[0]),
            [a.elapsed_time(b) for a, b in zip(ev, ev[1:])])


def timed_answer(model, frames, question: str, max_new_tokens: int):
    """One greedy answer through the calls ``generate`` makes:
    ``_prepare_generate`` (vision encode, tokenize, splice) on the host clock
    ended by a synchronise, then :func:`timed_greedy_decode`.  Returns
    (token ids, stages in seconds, [ms of each decode step])."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    embeds, _, max_new = model._prepare_generate(frames, question,
                                                 max_new_tokens, None)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    toks, prefill_ms, steps = timed_greedy_decode(model, embeds, max_new)
    stages = {"prompt_tokens": embeds.shape[1], "encode_splice_s": t1 - t0,
              "prefill_first_token_s": prefill_ms / 1e3,
              "decode_s": sum(steps) / 1e3,
              "total_s": time.perf_counter() - t0}
    return toks, stages, steps


def timed_batch_answer(model, frames_list, questions, max_new_tokens: int):
    """The batched answer of ``generate_batch_multi`` through the calls it
    makes: ``_prepare_batch`` (each row's vision encode, tokenize, splice,
    right-padding) on the host clock, then :func:`timed_greedy_decode` over
    the ragged rows.  Returns (token ids [B, steps], stages in seconds, [ms
    of each decode step])."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    embeds, valid, max_new = model._prepare_batch(frames_list, questions,
                                                  max_new_tokens)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    toks, prefill_ms, steps = timed_greedy_decode(model, embeds, max_new, valid)
    stages = {"rows": embeds.shape[0], "prompt_tokens": embeds.shape[1],
              "encode_splice_s": t1 - t0,
              "prefill_first_token_s": prefill_ms / 1e3,
              "decode_s": sum(steps) / 1e3,
              "total_s": time.perf_counter() - t0}
    return toks, stages, steps


def _classify(name: str) -> str:
    n = name.lower()
    if re.search(r"flash_(wgmma|bf16|f32)_kernel", n):
        return "flash_attention kernel"
    if "vit_attention" in n:
        return "vit_attention kernel"
    if re.search(r"gemm|xmma|cutlass|cublas|nvjet|sm90_|ampere_|gemv", n):
        return "gemm"
    if "memcpy" in n or "memset" in n:
        return "copy"
    if re.search(r"elementwise|vectorized|reduce|softmax|norm|cat|index|"
                 r"where|copy|fill|sort|arange|argmax|gather|scatter", n):
        return "elementwise/reduction"
    return "other"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..cli.common import stub_qwen_tokenizer
    from ..models.llava_video import (LLaVAVideoConfig, LLaVAVideoModel,
                                      add_token_per_grid, pool_2d_average,
                                      tokenize_with_image)
    from ..models.siglip import siglip_preprocess

    if not torch.cuda.is_available():
        raise SystemExit("profile_answer needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    encode, decode = stub_qwen_tokenizer()
    cfg = LLaVAVideoConfig()
    model = LLaVAVideoModel.random_init(
        torch.Generator(device="cuda").manual_seed(args.seed), cfg,
        dtype=torch.bfloat16, device="cuda", encode=encode, decode=decode)
    gen = torch.Generator().manual_seed(args.seed + 2)
    low = torch.randint(0, 256, (args.frames, 12, 16, 3), generator=gen,
                        dtype=torch.uint8)
    frames = low.repeat_interleave(40, 1).repeat_interleave(40, 2).numpy()
    q = "what is the person holding?"
    n_new = args.new_tokens
    model.generate(frames, q, max_new_tokens=n_new)               # warm-up
    torch.cuda.synchronize()

    # 1. stages: the vision side each ended by a synchronize, then
    #    greedy_decode timed by its own events
    net = model.net
    sync = torch.cuda.synchronize
    with torch.inference_mode():
        t_all = t0 = time.perf_counter()
        chunk = torch.as_tensor(frames).to("cuda")
        sync()
        t1 = time.perf_counter()
        pixels = siglip_preprocess(chunk, cfg.vision.image_size)
        sync()
        t2 = time.perf_counter()
        feat = net.vision(pixels)
        sync()
        t3 = time.perf_counter()
        feat = pool_2d_average(net.projector(feat), cfg.vision.grid, cfg.pool_stride)
        video = add_token_per_grid(feat, net.image_newline, cfg.pooled_side)
        sync()
        t4 = time.perf_counter()
        ids = tokenize_with_image(model._prompt(q), encode)
        embeds = model.splice_embeddings(ids, video)
        sync()
        t5 = time.perf_counter()
        S = embeds.shape[1]
        _, prefill_ms, steps = timed_greedy_decode(model, embeds, n_new)
        t7 = time.perf_counter()
    t6 = t5 + prefill_ms / 1e3
    stages = {"h2d": t1 - t0, "siglip_preprocess": t2 - t1,
              "siglip_tower": t3 - t2, "projector_pool_newline": t4 - t3,
              "tokenize_splice": t5 - t4, "prefill_first_token": t6 - t5,
              "decode": sum(steps) / 1e3}
    stages_total = t7 - t_all

    # 2. one whole generate under the profiler
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.generate(frames, q, max_new_tokens=n_new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_class: dict = {}
    top: dict = {}
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    for e in kernels:
        ms = e.time_range.elapsed_us() / 1e3
        cls = _classify(e.name)
        by_class[cls] = by_class.get(cls, 0.0) + ms
        top[e.name] = top.get(e.name, 0.0) + ms
    busy_ms = sum(by_class.values())
    prefill_end = max(e.time_range.end for e in kernels
                      if _classify(e.name) == "flash_attention kernel")
    after_prefill_ms = sum(e.time_range.elapsed_us() for e in kernels
                           if e.time_range.start >= prefill_end) / 1e3
    result = {
        "card": card, "frames": args.frames, "prompt_tokens": S,
        "new_tokens": n_new, "batch_frames": model.batch_frames,
        "stages_s": stages, "stages_total_s": stages_total,
        "time_to_first_token_s": t6 - t_all,
        "decode_steps": len(steps),
        "decode_ms_per_step": sum(steps) / len(steps),
        "decode_step_ms": steps,
        "profiled_wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / (wall * 1e3),
        "device_ms_by_class": dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
        "device_events": len(kernels),
        "device_ms_after_last_flash": after_prefill_ms,
        "top_kernels_ms": dict(sorted(top.items(), key=lambda kv: -kv[1])[:15]),
    }
    print(json.dumps(result, indent=1))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
