#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tspo_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout, on a machine with one CUDA card.  Phases:

0. Card: the card's name and power limit (nvidia-smi), and the build of every
   Hopper kernel from ``tspo_tpu_torch/csrc`` (one nvcc per source, all six
   started together).
1. Kernels: each kernel's wrapper against its plain PyTorch version, on the
   card, at the shapes the main paths give it, in bf16 and fp32.
   ``vit_attention`` (``VIT_MAIN``, ``VIT_EDGE_S``) at the CLIP scoring
   shape and the SigLIP answer shape, the wgmma kernel's tile edges (bf16 at
   hd 64 and 72, S from 1 to 730, B of 1, 3, 44 and the main path's), a NaN
   frame beside a clean one, inf in the next head's columns, and the other
   head dims the source takes (16, 32, 80, 128) in both types, and the
   training path's shapes (SigLIP at B=16 and 8, CLIP at B=128 and at the
   ragged last chunk of a needle composite); each case names the CUDA kernel it ran and the
   wgmma kernel's form, and the registers, shared memory and blocks per SM
   of each kernel are printed; at the CLIP shape ``flash_attention``'s
   kernel on the same tensors is timed as a reference point.
   ``flash_attention`` (``FLASH_CASES``) at the answer path's prefill shape
   (the prompt length of phase 4), at each training rollout's prefill (16
   and 8 frames) alone and as one batched prefill of G=8 equal rows, at the
   harness's batched prefill of 4 ragged rows (phase 4c's first batch,
   12160-12288 tokens, ends on a 128-key tile edge and mid-tile; its
   library time is one masked SDPA call), the suffix prefill of phase 4d (a
   1024-row block at ``q_offset`` = the prompt length over K/V sliced from a
   cache with 256 spare slots; its library time is one SDPA call with the
   bottom-right causal mask ``causal_lower_right``), ragged B=2, a ``q_offset`` suffix, a
   sliding ``window``, the wgmma kernel's tile edges (Sq and Sk off a
   multiple of 128, lengths mid-tile and on a tile edge, ``q_offset`` off a
   multiple of 128, a window across tile edges, k/v as a slice of a longer
   cache, NaN and inf in the cache rows at or past the lengths), hd=80
   non-causal, fp32, and every other head dim the source instantiates (16,
   64) in both types; each line names the CUDA kernel the case ran, and the
   registers, shared memory and blocks per SM of each kernel are printed.
   Kernel, plain-version and library-call times by CUDA events after
   warm-up, beside the least time the card could take (bound).
1b. Variant kernels (``ops/vit_attention_variants.py``, the kernels of the
   ViT-attention variant bench): every wrapper against its plain version at
   the bench shape (B=256, S=257, W=1024, 16 heads, bf16) and at B=3, S=40,
   W=128, 2 heads (ragged S, odd B); ``bdp2`` at W=1024 only (B=3, S=40 as
   its small case); ``lane_f{2,4}`` also at B=4; the GEMM also at a ragged
   M.  Attention outputs: min row cosine >= 0.9998, max abs <= 2e-2, per-row
   relative error <= 1e-2; ``dma`` and the copy probe bit-exact; the GEMM
   per-row relative error <= 1e-2.  Times as in phase 1.
2. Parity at full width: a CLIP-ViT-L/14 + selector scorer in fp32 with
   random weights from ``--seed`` scores 8 frames of 480x640 on the card and,
   with the same port, on the CPU (plain versions); features, logits and the
   selected indices must agree.  Then LLaVA-Video at published widths and
   full vocabulary, cut to 2 SigLIP and 2 Qwen2 layers, fp32 with TF32 off,
   answers on 3 frames of 480x640 (a prompt of >= 512 tokens, so the flash
   path runs) on the CPU and on the card: first-step logits within 1e-3
   relative, and 8 greedy tokens equal wherever the top-2 logit margin
   exceeds the measured logit error.  The same for two ragged rows in one
   batched decode (the calls ``generate_batch_multi`` makes: one flash
   prefill), and ``loglikelihood`` of a continuation within 1e-3 relative.
3. Scoring main path: the full-width scorer in bf16 with ``batch_frames=256``
   scores a 300-frame video (bucket 512) with
   ``score_video_fused(sample_num=64)`` (its warm-up call under
   ``torch.profiler``: all 46 ``vit_attention`` launches run
   ``vit_attention_wgmma_kernel``), then encodes it once and scores 3
   questions on the shared features.
4. Answer main path: the scorer's 64 frames of that video go to
   LLaVA-Video-7B-Qwen2 (Qwen2-7B + SigLIP-so400m, full width and depth,
   bf16, random weights drawn on the card from ``--seed``), which answers
   with ``generate(max_new_tokens=16)`` and a stub Qwen tokenizer (its
   warm-up answer under ``torch.profiler``: all 28 flash launches run the
   wgmma kernel, all 26 ``vit_attention`` launches
   ``vit_attention_wgmma_kernel``); then the
   same answer three times through the calls ``generate`` makes, with
   ``greedy_decode``'s prefill and decode steps timed by CUDA events inside
   its own loop: stage times, time to first token, decode ms per step, peak
   memory.
4b. Training main path: ``TSPOTrainer.train_step`` on phase 3's scorer and
   phase 4's model, ``TrainConfig(num_generations=8, training_sample_len=16,
   window_size=12, grad_accum=2)``, 4 steps over the rows specific, general,
   specific, specific (``seeded_decoder`` stands in for the video decoder:
   seeded 480x640 frames; a specific row is a needle composite of 1-4 true
   and 12 distractor clips of 50 frames), each rollout answering in at most
   8 tokens; a step's 8 answers are one ``generate_batch`` call.  Each step
   launches exactly 23 ceil(T/256) + 8 x 26 ceil(K/64) ``vit_attention`` and
   28 ``flash_attention`` kernels (one batched prefill; step 1 under
   ``torch.profiler``: all on the wgmma kernels); loss and grad norm finite,
   grad norm > 0 on the specific steps; the selector unchanged after steps 1
   and 3 and changed after 2 and 4, CLIP unchanged; step 1's update repeated
   on a copy of the selector on the card and on the CPU at ``grad_accum`` 1
   (``_update_parity``); a checkpoint resumed by a fresh trainer, and the
   merged export read back by ``TSPOScorer.load`` with equal logits; the
   last step's batched rollouts against one ``generate`` each under the
   margin rule (``batch_vs_single``); one ``cross_batch_rollouts=True`` step
   of two rows (specific, general): one ``generate_batch_multi`` call of 16
   ragged rows and exactly 28 flash launches.  Stage times per step (decode
   + composite, features, sampling, rollouts, update), rollouts/s, peak
   memory, and the batched rollout call split as phase 4 splits an answer.
4c. Eval harness main path: ``eval.harness.evaluate_task`` over 8 VideoMME
   docs on 4 seeded videos of 300 frames (``seeded_frames`` stands in for
   the decoder), each doc's ``frame_idx`` the 64 frames phase 3's scorer
   picks for it, answered by phase 4's model in at most 16 tokens at
   ``batch_size`` 1 and 4: responses equal, or parted at a near-tie that
   ``batch_vs_single`` finds again; then 2 ``EgoSchema-ppl`` docs of 5
   choices through ``loglikelihood``.  Exact launches of each run, docs/s,
   peak memory.
4d. Conversation, sampling, streams and speculative decode on phase 4's
   model and frames, each user call's launches exact: (a) three rounds of
   at most 16 tokens through one ``ConversationState`` (round 1: 26
   ``vit_attention`` and 28 ``flash_attention``; rounds 2 and 3: none, the
   extension chunks are dense and the video is reused) against the
   stateless ``generate_multi_round``, equal or parted at a near-tie under
   ``margin_rule``, then both conversations again through the calls they
   make for time to first token, wall time and decode ms a step from CUDA
   events; (b) ``prefill_extend`` of a 1024-token block after the prompt
   (28 flash launches at ``q_offset`` = the prompt length), its last
   position's fp32 logits within 2e-2 relative of one prefill of all the
   tokens, the greedy token equal or at a near-tie; (c) ``generate`` at
   ``temperature=0.7, top_p=0.9`` twice at one seed (equal), its stream at
   that seed (joins to it), the greedy stream (joins to the greedy answer),
   ``top_p=1e-6`` (the greedy tokens or a tie), and the chunked decode's ms
   a step beside ``greedy_decode``'s; (d) ``generate`` with
   ``speculative=True`` (the greedy answer or a near-tie), its forward
   passes and decode ms a token beside greedy's.
   Every kernel count is set to 0 just before and read just after each
   path of phases 3 to 5.
5. Variant bench main path: ``tools/bench_vit_attention_variants.run`` over
   every variant at B=256, S=257, W=1024, 16 heads, 24 chained layers: each
   variant's launches equal its calls (24 a chained call, 3 x 24 for
   ``fullwidth``, plus one B=8 parity probe; none for ``plain`` and
   ``sdpa``), and the exact-attention variants agree with ``plain`` (cosine
   >= 0.9998 at B=8).
6. One JSON line listing every ported kernel with its launches, error and
   times (``vit_attention``'s row at the CLIP shape, with every main-path
   shape under ``shapes``; ``flash_attention``'s rollout and batched
   prefills and the suffix prefill under ``shapes``; the training, harness
   and phase-4d launches of each under ``train``, ``evaluate`` and
   ``conversation``); then, as the last line, ``{"ok":
   true, "device": {...}}``.

Exits non-zero, printing no result, when no CUDA device is present or when
any check fails.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from functools import partial, wraps
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense): HBM bytes/s, and FLOP/s by operand type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}   # fp32 outside the tensor cores
N_SELECT = 64                                   # frames the scorer picks
QUESTION = "what is the person holding?"
# phase 4b: the training rows' question (options and boilerplate as in the
# reference's jsonl), their types in step order, and the selector's subset
# size K for each type (training_sample_len 16; general rows take half)
TRAIN_QUESTION = ("<image>\nWhat is the person holding?\nA. a cup\nB. a phone\n"
                  "C. a book\nD. nothing\nPlease respond with only the letter of "
                  "the correct answer.")
TRAIN_TYPES = ("specific", "general", "specific", "specific")
TRAIN_K = {"specific": 16, "general": 8}
# phase 4c: VideoMME docs over seeded videos, answered at --batch 1 and 4;
# each question is padded so its prompt ends this many tokens past a
# 128-key tile edge E (the first batch: two mid-tile, two on an edge)
HARNESS_VIDEOS = 4
HARNESS_BATCH = 4
HARNESS_TAILS = (61, 0, 128, 93, 5, 40, 77, 100)
HARNESS_OPTIONS = ["A. a cup", "B. a phone", "C. a book", "D. nothing"]
# phase 4d: the conversation's three questions (follow-ups of a few dozen
# tokens), the suffix block prefilled after the answer prompt, and the
# sampler's settings
CONV_ROUNDS = (QUESTION, "And what does the person do with it next?",
               "Why might the person be doing that, judging by the scene?")
EXTEND_ROWS = 1024
SAMPLING = {"temperature": 0.7, "top_p": 0.9}


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def without_tf32(fn):
    """Run ``fn`` with TF32 off for matmuls and cuDNN (a check against fp32
    plain versions), and give the flags back as they were, so the phases
    that drive the main path run under the user's defaults."""
    @wraps(fn)
    def wrapped(*args, **kwargs):
        import torch
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return fn(*args, **kwargs)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved
    return wrapped


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


def bound(nbytes: float, flops: float, tag: str) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[tag] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def smooth_frames(gen, n: int, h: int = 480, w: int = 640):
    """[n, h, w, 3] uint8 frames: random 12x16 colour fields upsampled by
    nearest neighbour, so frames differ in their content as video frames do."""
    import torch
    low = torch.randint(0, 256, (n, 12, 16, 3), generator=gen, dtype=torch.uint8)
    return low.repeat_interleave(h // 12, 1).repeat_interleave(w // 16, 2).numpy()


def answer_prompt_len(n_frames: int, question: str = QUESTION) -> int:
    """Tokens of an answer's prompt: the qwen_1_5 prompt through the stub
    tokenizer, with the <image> sentinel replaced by the video tokens."""
    from tspo_tpu_torch.cli.common import stub_qwen_tokenizer
    from tspo_tpu_torch.models.conversation import build_prompt
    from tspo_tpu_torch.models.llava_video import (LLaVAVideoConfig,
                                                   tokenize_with_image)
    encode, _ = stub_qwen_tokenizer()
    ids = tokenize_with_image(build_prompt(question, "qwen_1_5"), encode)
    return len(ids) - 1 + n_frames * LLaVAVideoConfig().tokens_per_frame


def rollout_question() -> str:
    """The question each training rollout answers: the row's question without
    boilerplate, plus the trainer's letter-answer trailer."""
    from tspo_tpu_torch.train.rewards import clean_question
    from tspo_tpu_torch.train.trainer import ANSWER_TRAILER
    return clean_question(TRAIN_QUESTION) + ANSWER_TRAILER


def harness_docs() -> tuple:
    """(the VideoMME docs of phase 4c without their ``frame_idx``, each
    doc's prompt tokens at ``N_SELECT`` frames): questions padded so that
    the prompts end ``HARNESS_TAILS`` tokens past a tile edge."""
    from tspo_tpu_torch.eval.tasks import get_task
    task = get_task("VideoMME")

    def doc(i, question):
        return {"question_id": f"q{i}", "question": question,
                "options": HARNESS_OPTIONS, "answer": "ABCD"[i % 4],
                "duration": "long", "domain": "d", "sub_category": "s",
                "task_type": "t", "videoID": f"h{i % HARNESS_VIDEOS}.mp4"}

    def length(d):
        return answer_prompt_len(N_SELECT, task.doc_to_text(d))
    base = length(doc(0, ""))
    edge = 128 * -(-(base + 8) // 128)
    filler = "What is the person holding in this part of the video? " * 8
    docs = [doc(i, filler[:edge + tail - base]) for i, tail in enumerate(HARNESS_TAILS)]
    lens = [length(d) for d in docs]
    check(lens == [edge + t for t in HARNESS_TAILS],
          f"harness prompt lengths {lens}, want {edge} + {HARNESS_TAILS}")
    return docs, lens


def seeded_frames(seed: int, path: str, indices, h: int = 480, w: int = 640):
    """Frames ``indices`` of a seeded video named ``path``, each frame made
    from its own generator: the same frame for the same (seed, path, index)
    whatever else is asked for."""
    import zlib

    import numpy as np
    import torch
    base = seed * 7919 + zlib.crc32(path.encode())
    return np.concatenate([smooth_frames(torch.Generator().manual_seed(base + 104729 * int(i)),
                                         1, h, w) for i in indices])


def margin_rule(tokens_a, logits_a, tokens_b, logits_b, eos: int, tag: str) -> dict:
    """Greedy tokens of one row from two runs (``a`` the reference), with
    each step's [V] logits: equal up to the first EOS of ``a``, or, where
    they part, the reference's top-2 margin at that step within twice the
    logit difference there (a near-tie that rounding may flip).  Returns
    what was compared."""
    import torch
    n = min(len(tokens_a), len(logits_a), len(logits_b))
    compared, max_err = 0, 0.0
    for i in range(n):
        err = (logits_a[i].float() - logits_b[i].float()).abs().max().item()
        max_err = max(max_err, err)
        compared += 1
        if tokens_a[i] != tokens_b[i]:
            top2 = torch.topk(logits_a[i].float(), 2).values
            margin = (top2[0] - top2[1]).item()
            check(margin <= 2 * err,
                  f"{tag}: greedy token {i} differs ({tokens_b[i]} vs "
                  f"{tokens_a[i]}) with margin {margin} above twice the logit "
                  f"difference {err}")
            return {"tokens_compared": compared, "parted_at": i,
                    "margin": margin, "logit_max_abs_diff": max_err}
        if tokens_a[i] == eos:
            break
    return {"tokens_compared": compared, "parted_at": None,
            "logit_max_abs_diff": max_err}


def batch_vs_single(model, frames_list, questions, n_new: int) -> dict:
    """One batched greedy decode (the calls ``generate_batch_multi`` makes)
    against one decode a row (the calls ``generate`` makes), each row under
    :func:`margin_rule`; returns the rows and tokens compared, and the rows
    that parted at a near-tie."""
    import torch
    from tspo_tpu_torch.models.qwen2 import KVCache, greedy_decode
    cfg, dev = model.cfg, model.device
    eos = cfg.lm.eos_token_id
    embeds, valid, max_new = model._prepare_batch(frames_list, questions, n_new)
    B, S = valid.shape
    cache = KVCache.create(cfg.lm, B, min(cfg.max_context, S + max_new + 8),
                           embeds.dtype, dev)
    steps_b = []
    toks_b, _ = greedy_decode(model.lm, embeds, valid, cache, max_new,
                              step_logits=steps_b)
    toks_b = toks_b.reshape(B, -1).tolist()
    del embeds, cache
    rows = []
    for b in range(B):
        e1, _, mn = model._prepare_generate(frames_list[b], questions[b], n_new, None)
        cache = KVCache.create(cfg.lm, 1, min(cfg.max_context, e1.shape[1] + mn + 8),
                               e1.dtype, dev)
        steps_1 = []
        toks_1, n1 = greedy_decode(model.lm, e1, torch.ones(1, e1.shape[1], dtype=torch.bool,
                                                            device=dev),
                                   cache, mn, step_logits=steps_1)
        rows.append(margin_rule(toks_1[:n1].tolist(), [x[0] for x in steps_1],
                                toks_b[b], [x[b] for x in steps_b], eos,
                                f"batched row {b} vs its single decode"))
        del e1, cache, steps_1
    return {"rows": B, "prompt_tokens": valid.sum(1).tolist(),
            "parted_at": [r["parted_at"] for r in rows],
            "tokens_compared": sum(r["tokens_compared"] for r in rows),
            "rows_parted_at_near_tie": sum(r["parted_at"] is not None for r in rows),
            "logit_max_abs_diff": max(r["logit_max_abs_diff"] for r in rows)}


def cuda_kernels_run(prof, kernels) -> dict:
    """{kernel: launches} of the CUDA kernels in ``kernels`` that a
    torch.profiler trace saw run on the card, read from the trace's raw
    kineto events: parsing a GRPO step's trace into ``prof.events()`` took
    75 s."""
    import torch
    return dict(Counter(name for e in prof.profiler.kineto_results.events()
                        if e.device_type() == torch.autograd.DeviceType.CUDA
                        for name in kernels if name in e.name()))


def reset_counts():
    from tspo_tpu_torch.ops import flash_attention as fa
    from tspo_tpu_torch.ops import vit_attention as va
    from tspo_tpu_torch.ops import vit_attention_variants as vv
    va.vit_attention.launches = 0
    fa.flash_attention.launches = 0
    for fn in vv.WRAPPERS:
        fn.launches = 0


def read_counts() -> dict:
    from tspo_tpu_torch.ops import flash_attention as fa
    from tspo_tpu_torch.ops import vit_attention as va
    return {"vit_attention": va.vit_attention.launches,
            "flash_attention": fa.flash_attention.launches}


def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    from tspo_tpu_torch.ops import flash_attention as fa
    from tspo_tpu_torch.ops import vit_attention as va
    from tspo_tpu_torch.ops import vit_attention_variants as vv
    builds = {"vit_attention": va.build, "flash_attention": fa.build,
              **{src: partial(vv.build, src) for src in vv.SOURCES}}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as ex:
        libs = {name: ex.submit(fn) for name, fn in builds.items()}
        libs = {name: f.result() for name, f in libs.items()}
    print(f"phase 0 card: built {sorted(libs)} in "
          f"{time.perf_counter() - t0:.1f} s")
    return smi


# vit_attention's main-path shapes, name -> (B, S, W, heads): the scoring
# path's CLIP chunk and the answer path's SigLIP; the training path's
# SigLIP rollouts (K = 16 and 8 frames), a general row's one CLIP chunk of
# 128 decoded frames, and the ragged last CLIP chunk of a needle composite
# ((1 to 4 + 12) clips of 50 frames: T mod 256)
VIT_MAIN = {"clip": (256, 257, 1024, 16), "siglip": (N_SELECT, 729, 1152, 16),
            "siglip_k16": (16, 729, 1152, 16), "siglip_k8": (8, 729, 1152, 16),
            "clip_b128": (128, 257, 1024, 16),
            **{f"clip_tail_{t % 256}": (t % 256, 257, 1024, 16)
               for t in (650, 700, 750, 800)}}
# the wgmma kernel's tile edges: 64-row query tiles, the 256-key box and its
# tail (resident form, hd 64 up to S=264), 128-row and 128-key tiles
# (streamed form)
VIT_EDGE_S = (1, 8, 63, 64, 65, 127, 128, 129, 255, 256, 257, 729, 730)


def _vit_case(gen, B, S, H, hd, dtype, tag, poison=None):
    """One vit_attention case against the plain version; returns (out, ref,
    max abs, min row cosine) over the rows and heads the plain version is
    held on.  poison "frame": frame 1 is NaN, frame 0 is checked; "head":
    head 1's columns are inf, every other head is checked."""
    import torch
    import torch.nn.functional as F
    from tspo_tpu_torch.ops.vit_attention import vit_attention, vit_attention_reference
    W = H * hd
    q, k, v = (torch.randn(B, S, W, device="cuda", generator=gen).to(dtype)
               for _ in range(3))
    keep = torch.arange(W, device="cuda")
    frames = slice(None)
    if poison == "frame":
        for x in (q, k, v):
            x[1] = float("nan")
        frames = slice(0, 1)
    elif poison == "head":
        for x in (q, k, v):
            x[..., hd:2 * hd] = float("inf")
        keep = torch.cat([keep[:hd], keep[2 * hd:]])
    out = vit_attention(q, k, v, H)
    torch.cuda.synchronize()
    heads = H - (poison == "head")
    ref = vit_attention_reference(*(x[frames][..., keep] for x in (q, k, v)), heads)
    got = out[frames][..., keep]
    check(torch.isfinite(got).all().item(),
          f"vit_attention {tag} B={B} S={S} hd={hd} poison={poison}: not finite")
    o = got.float().reshape(-1, hd)
    r = ref.float().reshape(-1, hd)
    err = (o - r).abs().max().item()
    cos = F.cosine_similarity(o, r, dim=-1).min().item()
    if tag == "bf16":
        check(cos >= 0.9998 and err <= 2e-2,
              f"vit_attention bf16 B={B} S={S} hd={hd} poison={poison}: cos {cos} err {err}")
    else:
        check(err <= 2e-5, f"vit_attention fp32 B={B} S={S} hd={hd}: err {err}")
    return q, k, v, err, cos


@without_tf32
def phase_kernel_vit(seed: int) -> dict:
    """vit_attention against its plain version at the wgmma kernel's tile
    edges, both poison cases and every other head dim; times at both
    main-path shapes; returns the kernels-line row."""
    import torch
    import torch.nn.functional as F
    from tspo_tpu_torch.ops import flash_attention as fa
    from tspo_tpu_torch.ops import vit_attention as va
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}
    for tag, hd, S in (("bf16", 64, 257), ("bf16", 64, 729), ("bf16", 72, 729),
                       *((t, d, 257) for t in dtypes for d in (16, 32, 80, 128)),
                       ("fp32", 64, 257), ("fp32", 72, 729)):
        print(json.dumps({"phase": 1, "kernel": "vit_attention", "dtype": tag, "hd": hd,
                          "S": S, **va.kernel_attributes(dtypes[tag], hd, S)}))
    # tile edges, bf16 at hd 64 and 72, H=16 (W as the main paths' towers)
    n_cases = 0
    for hd in (64, 72):
        for S in VIT_EDGE_S:
            form = va.kernel_attributes(torch.bfloat16, hd, S)["form"]
            for B in (1, 3, 44, 256 if hd == 64 else N_SELECT):
                _, _, _, err, cos = _vit_case(gen, B, S, 16, hd, torch.bfloat16, "bf16")
                n_cases += 1
                print(json.dumps({"phase": 1, "kernel": "vit_attention", "case": "edge",
                                  "cuda_kernel": va.kernel_name(torch.bfloat16, hd),
                                  "form": form, "B": B, "S": S, "hd": hd, "dtype": "bf16",
                                  "max_abs_err": err, "min_row_cos": cos}))
    # poison: a NaN frame beside a clean one; inf in the next head's columns
    for poison, B, S, hd in (("frame", 2, 257, 64), ("frame", 2, 729, 72),
                             ("head", 3, 257, 64), ("head", 3, 729, 72)):
        _, _, _, err, cos = _vit_case(gen, B, S, 16, hd, torch.bfloat16, "bf16", poison)
        print(json.dumps({"phase": 1, "kernel": "vit_attention", "case": f"poison_{poison}",
                          "cuda_kernel": va.kernel_name(torch.bfloat16, hd), "B": B, "S": S,
                          "hd": hd, "dtype": "bf16", "max_abs_err": err, "min_row_cos": cos}))
    # the other head dims the source takes, both types
    for tag, dtype in dtypes.items():
        for hd in (16, 32, 80, 128):
            _, _, _, err, cos = _vit_case(gen, 3, 257, 4, hd, dtype, tag)
            print(json.dumps({"phase": 1, "kernel": "vit_attention", "case": "head_dim",
                              "cuda_kernel": va.kernel_name(dtype, hd), "B": 3, "S": 257,
                              "hd": hd, "dtype": tag, "max_abs_err": err, "min_row_cos": cos}))
    print(json.dumps({"phase": 1, "kernel": "vit_attention", "edge_cases": n_cases}))
    # the main-path shapes, both types: errors and times
    shapes = {}
    for name, (B, S, W, H) in VIT_MAIN.items():
        hd = W // H
        for tag, dtype in dtypes.items():
            q, k, v, err, cos = _vit_case(gen, B, S, H, hd, dtype, tag)
            cuda_kernel = va.kernel_name(dtype, hd)
            check(tag == "fp32" or cuda_kernel == "vit_attention_wgmma_kernel",
                  f"vit_attention bf16 hd={hd} routes to {cuda_kernel}")
            views = [x.view(B, S, H, hd).transpose(1, 2) for x in (q, k, v)]
            ms = cuda_time_ms(lambda: va.vit_attention(q, k, v, H), 20)
            plain_ms = cuda_time_ms(lambda: va.vit_attention_reference(q, k, v, H), 5, 1)
            lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(*views), 20)
            flash_ms = None
            if tag == "bf16" and hd in fa.HEAD_DIMS:
                # reference point: the flash kernel on the same tensors
                q4, k4, v4 = (x.view(B, S, H, hd) for x in (q, k, v))
                o4, lib = torch.empty_like(q4), fa._load()
                flash_ms = cuda_time_ms(
                    lambda: fa.launch(lib, q4, k4, v4, o4, None, False, None, 0), 20)
            bound_ms, bound_by = bound(4 * B * S * W * q.element_size(),
                                       4 * B * S * S * W, tag)
            print(json.dumps({"phase": 1, "kernel": "vit_attention", "case": name,
                              "cuda_kernel": cuda_kernel, "B": B, "S": S, "W": W,
                              "heads": H, "dtype": tag, "max_abs_err": err,
                              "min_row_cos": cos, "kernel_ms": ms, "plain_ms": plain_ms,
                              "library_ms": lib_ms, "flash_attention_ms": flash_ms,
                              "bound_ms": bound_ms, "bound_by": bound_by,
                              "tflops": 4 * B * S * S * W / ms / 1e9}))
            if tag == "bf16":
                shapes[name] = {"B": B, "S": S, "W": W, "heads": H, "max_abs_err": err,
                                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                "bound_by": bound_by, "library_ms": lib_ms}
            del q, k, v, views
            torch.cuda.empty_cache()
    clip = shapes["clip"]
    return {"name": "vit_attention", "route": "cuda",
            "source": "tspo_tpu_torch/csrc/vit_attention.cu",
            "replaces": "tspo_tpu/ops/vit_attention.py:29",
            **{key: clip[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")},
            "shapes": shapes}


def _live_keys(lengths, Sq: int, causal: bool, window, q_offset: int):
    """[B, Sq] count of the keys each query row attends (the work these
    inputs need)."""
    import torch
    q_pos = q_offset + torch.arange(Sq)
    out = []
    for n in lengths:
        hi = torch.clamp(q_pos + 1, max=n) if causal else torch.full_like(q_pos, n)
        lo = torch.clamp(q_pos - window + 1, min=0) if window else torch.zeros_like(q_pos)
        out.append(torch.clamp(hi - lo, min=0))
    return torch.stack(out)


# name, B, Sq, Sk, H, KV, hd, causal, lengths, window, q_offset, dtype, k/v
# source: None (their own tensors), "slice" (cache[:, :Sk] of a cache of
# Sk + 256 slots) or "poison" (that slice with NaN and inf in every row at or past
# lengths[b], held against the plain version on the tail zeroed)
FLASH_CASES = [
    ("main", 1, None, None, 28, 4, 128, True, None, None, 0, "bf16", None),
    ("ragged", 2, 4096, 4096, 28, 4, 128, True, (4096, 2500), None, 0, "bf16", None),
    ("q_offset", 1, 1024, 4096, 28, 4, 128, True, None, None, 3072, "bf16", None),
    ("window", 2, 4096, 4096, 28, 4, 128, True, (4096, 3000), 1024, 0, "bf16", None),
    # the wgmma kernel's tile edges (128 query rows, 128 keys a stage)
    ("rows_129", 1, 129, 129, 28, 4, 128, True, None, None, 0, "bf16", None),
    ("rows_255", 1, 255, 255, 28, 4, 128, False, None, None, 0, "bf16", None),
    ("rows_4097", 1, 4097, 4097, 28, 4, 128, True, None, None, 0, "bf16", None),
    ("lengths_edges", 3, 1024, 1024, 28, 4, 128, True, (1000, 640, 129), None, 0,
     "bf16", None),
    ("lengths_full_rows", 2, 300, 1100, 28, 4, 128, False, (1000, 512), None, 0,
     "bf16", None),
    ("q_offset_odd", 2, 300, 1000, 28, 4, 128, True, (1000, 900), None, 700, "bf16",
     None),
    ("window_edges", 2, 1500, 1500, 28, 4, 128, True, (1500, 1111), 200, 0, "bf16",
     None),
    ("cache_slice", 2, 777, 777, 28, 4, 128, True, None, None, 0, "bf16", "slice"),
    ("poison_causal", 2, 777, 777, 28, 4, 128, True, (700, 333), None, 0, "bf16",
     "poison"),
    ("poison_offset_window", 2, 300, 1000, 28, 4, 128, True, (1000, 901), 450, 700,
     "bf16", "poison"),
    ("hd80", 1, 4096, 4096, 16, 16, 80, False, None, None, 0, "bf16", None),
    ("fp32", 1, 2048, 2048, 28, 4, 128, True, None, None, 0, "fp32", None),
    # the other head dims the source instantiates, in both types
    ("hd80_fp32", 1, 1024, 1024, 16, 16, 80, False, None, None, 0, "fp32", None),
    ("hd64", 2, 1024, 1024, 8, 2, 64, True, (1024, 700), 300, 0, "bf16", None),
    ("hd64_rows_129", 2, 129, 300, 8, 2, 64, False, (300, 200), None, 0, "bf16", None),
    ("hd64_fp32", 2, 1024, 1024, 8, 2, 64, True, (1024, 700), 300, 0, "fp32", None),
    ("hd16", 1, 777, 777, 6, 2, 16, True, None, None, 0, "bf16", None),
    ("hd16_fp32", 1, 777, 777, 6, 2, 16, True, None, None, 0, "fp32", None),
]


def flash_inputs(gen, B, Sq, Sk, H, KV, hd, lens, dtype, source):
    """(q, k, v, k_ref, v_ref): k/v as the kernel gets them, and as the plain
    version is held on (the same but for a poisoned tail, zeroed there)."""
    import torch
    q = torch.randn(B, Sq, H, hd, device="cuda", generator=gen).to(dtype)
    T = Sk if source is None else Sk + 256
    k, v = (torch.randn(B, T, KV, hd, device="cuda", generator=gen).to(dtype)
            for _ in range(2))
    if source == "poison":
        bad = torch.tensor([float("nan"), float("inf"), -float("inf")], device="cuda")
        for x in (k, v):
            for b, n in enumerate(lens):
                x[b, n:] = bad[torch.arange(T - n, device="cuda") % 3, None, None].to(dtype)
    k, v = k[:, :Sk], v[:, :Sk]
    if source == "poison":
        keep = (torch.arange(Sk, device="cuda")[None, :]
                < torch.tensor(lens, device="cuda")[:, None])[..., None, None]
        return q, k, v, torch.where(keep, k, 0), torch.where(keep, v, 0)
    return q, k, v, k, v


@without_tf32
def phase_kernel_flash(seed: int, s_main: int, s_rollouts: dict,
                       harness_lens) -> dict:
    """flash_attention against its plain version, at every case of
    ``FLASH_CASES``, at each training rollout's prefill (``s_rollouts``:
    name -> prompt tokens) alone and as the batched prefill of G=8 equal
    rows, and at the harness's batched prefill of ``HARNESS_BATCH`` ragged
    rows (``harness_lens``); returns the main-path row, with the other
    main-path shapes under ``shapes``."""
    import torch
    import torch.nn.functional as F
    from tspo_tpu_torch.ops import flash_attention as fa
    from tspo_tpu_torch.ops.flash_attention import (flash_attention,
                                                    flash_attention_reference)
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    row = None
    x = torch.zeros(1, 64, 4, 32, device="cuda", dtype=torch.bfloat16)
    try:
        flash_attention(x, x, x)
    except ValueError:
        pass
    else:
        raise RuntimeError("check failed: flash_attention took hd=32, which "
                           "the source does not instantiate")
    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}
    for tag, dtype in dtypes.items():
        for hd in fa.HEAD_DIMS:
            print(json.dumps({"phase": 1, "kernel": "flash_attention", "dtype": tag,
                              "hd": hd, **fa.kernel_attributes(dtype, hd)}))
    rollout_cases = [(name, 1, sq, sq, 28, 4, 128, True, None, None, 0, "bf16", None)
                     for name, sq in s_rollouts.items()]
    rollout_cases += [(name.replace("rollout_", "rollouts_batched_"), 8, sq, sq, 28, 4,
                       128, True, None, None, 0, "bf16", None)
                      for name, sq in s_rollouts.items()]
    lens_h = tuple(harness_lens[:HARNESS_BATCH])
    rollout_cases.append(("harness_batched", HARNESS_BATCH, max(lens_h), max(lens_h),
                          28, 4, 128, True, lens_h, None, 0, "bf16", None))
    # phase 4d's suffix prefill: EXTEND_ROWS rows after the answer prompt,
    # K/V the cache's slots up to the block's end (prefill_extend)
    s_ext = s_main + EXTEND_ROWS
    rollout_cases.append(("extend_q_offset", 1, EXTEND_ROWS, s_ext, 28, 4, 128, True,
                          (s_ext,), None, s_main, "bf16", "slice"))
    shapes = {}
    for (name, B, Sq, Sk, H, KV, hd, causal, lens, window, off, tag,
         source) in FLASH_CASES + rollout_cases:
        Sq, Sk = Sq or s_main, Sk or s_main
        dtype = dtypes[tag]
        cuda_kernel = fa.kernel_name(dtype, hd)
        check(cuda_kernel == "flash_wgmma_kernel"
              or not (tag == "bf16" and hd in (64, 128)),
              f"flash_attention {name} routes to {cuda_kernel}")
        q, k, v, k_ref, v_ref = flash_inputs(gen, B, Sq, Sk, H, KV, hd, lens, dtype,
                                             source)
        lengths = None if lens is None else torch.tensor(lens, device="cuda")
        call = (lengths, causal, window, off)
        out = flash_attention(q, k, v, *call)
        torch.cuda.synchronize()
        ref = flash_attention_reference(q, k_ref, v_ref, *call)
        n_keys = _live_keys(lens or (Sk,) * B, Sq, causal, window, off)
        live = (n_keys > 0).cuda()
        o, r = out.float()[live], ref.float()[live]
        err = (o - r).abs().max().item()
        cos = F.cosine_similarity(o.reshape(-1, hd), r.reshape(-1, hd), dim=-1).min().item()
        # per-row relative error: sees a scale error on long rows, where
        # |o| ~ 1/sqrt(keys) falls below the absolute limit and cosine is blind
        rel = ((o - r).reshape(-1, hd).norm(dim=-1)
               / r.reshape(-1, hd).norm(dim=-1).clamp_min(1e-30)).max().item()
        check(torch.isfinite(out).all().item(), f"flash_attention {name} finite")
        if tag == "bf16":
            check(cos >= 0.9998 and err <= 2e-2 and rel <= 1e-2,
                  f"flash_attention {name}: cos {cos} err {err} row rel {rel}")
        else:
            check(err <= 5e-5 and rel <= 1e-3,
                  f"flash_attention {name}: err {err} row rel {rel}")
        ms = cuda_time_ms(lambda: flash_attention(q, k, v, *call), 10)
        plain_ms = cuda_time_ms(lambda: flash_attention_reference(q, k, v, *call), 2, 1)
        lib_ms = None
        if lens is None and window is None and off == 0:
            views = [x.transpose(1, 2) for x in (q, k, v)]
            lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
                *views, is_causal=causal, enable_gqa=True), 10)
        elif name == "harness_batched":
            # one SDPA call over the ragged rows: a boolean causal and
            # key-prefix mask, on k/v repeated to the query heads outside
            # the timed call (the memory-efficient kernel takes a mask; the
            # math fallback would hold [B, H, S, S] scores)
            from torch.nn.attention import SDPBackend, sdpa_kernel
            k_pos = torch.arange(Sk, device="cuda")
            mask = ((k_pos[None, :] <= torch.arange(Sq, device="cuda")[:, None])[None]
                    & (k_pos[None, None, :] < lengths[:, None, None]))[:, None]
            views = [q.transpose(1, 2)] + [x.repeat_interleave(H // KV, dim=2)
                                           .transpose(1, 2) for x in (k, v)]
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
                    *views, attn_mask=mask), 10)
            del views, mask
        elif name == "extend_q_offset":
            # the same function as one SDPA call: the bottom-right causal
            # mask over the valid keys, k/v repeated to the query heads
            # outside the timed call
            from torch.nn.attention.bias import causal_lower_right
            n = lens[0]
            views = [q.transpose(1, 2)] + [x[:, :n].repeat_interleave(H // KV, dim=2)
                                           .transpose(1, 2) for x in (k, v)]
            bias = causal_lower_right(Sq, n)
            lib_out = F.scaled_dot_product_attention(*views, attn_mask=bias)
            lib_err = (lib_out.transpose(1, 2).float() - ref.float()).abs().max().item()
            check(lib_err <= 2e-2, f"SDPA's bottom-right causal call is another "
                  f"function: max abs {lib_err} from the plain version")
            lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
                *views, attn_mask=bias), 10)
            del views, lib_out
        es = q.element_size()
        nbytes = (2 * B * Sq * H + 2 * B * Sk * KV) * hd * es
        flops = 4 * hd * H * int(n_keys.sum())
        bound_ms, bound_by = bound(nbytes, flops, tag)
        print(json.dumps({"phase": 1, "kernel": "flash_attention", "case": name,
                          "cuda_kernel": cuda_kernel,
                          "B": B, "Sq": Sq, "Sk": Sk, "H": H, "KV": KV, "hd": hd,
                          "causal": causal, "lengths": lens, "window": window,
                          "q_offset": off, "dtype": tag, "kv_source": source,
                          "rows_without_keys": int((~live).sum()),
                          "max_abs_err": err, "min_row_cos": cos,
                          "max_row_rel_err": rel,
                          "kernel_ms": ms, "plain_ms": plain_ms,
                          "library_ms": lib_ms, "bound_ms": bound_ms,
                          "bound_by": bound_by,
                          "tflops": flops / ms / 1e9}))
        if name == "main":
            row = {"name": "flash_attention", "route": "cuda",
                   "source": "tspo_tpu_torch/csrc/flash_attention.cu",
                   "replaces": "tspo_tpu/ops/pallas_attention.py:46",
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": lib_ms}
        if name in s_rollouts or name.startswith(("rollouts_batched", "harness",
                                                  "extend")):
            shapes[name] = {"B": B, "Sq": Sq, "Sk": Sk, "q_offset": off,
                            "lengths": lens, "max_abs_err": err,
                            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                            "bound_by": bound_by, "library_ms": lib_ms}
        del q, k, v, k_ref, v_ref, out, ref
    torch.cuda.empty_cache()
    row["shapes"] = shapes
    return row


BENCH_SCRIPT = "scripts/bench_vit_attention_variants.py"
# PERF.md kernel rows 3-11: the variant bench's Pallas kernels, the source of
# their port, the variant that stands for the row in the kernels line, and
# every bench variant whose launches the row counts
VARIANT_ROWS = [
    ("lane", "vit_attention_lane", 43,
     ("lane", "lane_nt", "lane_par", "lane_nomax", "lane_nosm")),
    ("lane_f2", "vit_attention_lane", 67,
     ("lane_f1", "lane_f2", "lane_f4", "lane_f1_nosm", "lane_f2_nosm",
      "lane_f4_nosm")),
    ("fullwidth", "inkernel_gemm", 85, ("fullwidth",)),
    ("dma_only", "dma_probe", 97, ("dma_only", "dma_s256", "dma_f2")),
    ("gemm_inkernel", "inkernel_gemm", 106, ("gemm_inkernel",)),
    ("bdp2", "vit_attention_lane", 114, ("bdp2",)),
    ("manual_dma", "vit_attention_pipelined", 152,
     ("manual_dma", "manual_dma_copy")),
    ("lane_packed", "vit_attention_lane", 212, ("lane_packed",)),
    ("grid_h2", "vit_attention_lane", 228, ("grid_h2",)),
]
# variants whose function is exact attention: held to cosine >= 0.9998
# against ``plain`` in the bench's B=8 parity probe
EXACT_VARIANTS = ("sdpa", "vit_attention", "lane", "lane_nt", "lane_par",
                  "lane_f1", "lane_f2", "lane_f4", "grid_h2", "lane_packed",
                  "bdp2", "manual_dma")


def _row_errors(out, ref) -> tuple:
    """(max abs, min row cosine, max row relative error) over the rows of
    the last dim."""
    import torch.nn.functional as F
    o = out.float().reshape(-1, out.shape[-1])
    r = ref.float().reshape(-1, ref.shape[-1])
    err = (o - r).abs().max().item()
    cos = F.cosine_similarity(o, r, dim=-1).min().item()
    rel = ((o - r).norm(dim=-1) / r.norm(dim=-1).clamp_min(1e-30)).max().item()
    return err, cos, rel


def _variant_cases(q, k, v, H, w):
    """(variant, kernel, plain version, library call or None, check) at one
    shape; check is "attention", "exact" or "gemm"."""
    import math
    import torch
    import torch.nn.functional as F
    from tspo_tpu_torch.ops import vit_attention_variants as vv
    B, S, W = q.shape
    views = [x.view(B, S, H, W // H).transpose(1, 2) for x in (q, k, v)]
    sdpa = partial(F.scaled_dot_product_attention, *views)
    ref = partial(vv.lane_attention_reference, q, k, v, H)
    qkv = torch.cat([q, k, v], -1)
    rows = (S - 1) // 8 * 8
    x2 = q.reshape(-1, W)
    one_head = [x[:, None] for x in (q, k, v)]
    cases = [
        ("lane", partial(vv.lane_attention, q, k, v, H, transpose_k=True), ref, sdpa, "attention"),
        ("lane_nt", partial(vv.lane_attention, q, k, v, H), ref, sdpa, "attention"),
        ("lane_nomax", partial(vv.lane_attention, q, k, v, H, mode="nomax"),
         partial(ref, mode="nomax"), sdpa, "attention"),
        ("lane_nosm", partial(vv.lane_attention, q, k, v, H, mode="none"),
         partial(ref, mode="none"), None, "attention"),
        ("grid_h2", partial(vv.lane_attention, q, k, v, H, heads_per_block=2), ref, sdpa,
         "attention"),
        ("lane_packed", partial(vv.lane_packed_attention, qkv, H),
         partial(vv.lane_packed_reference, qkv, H), sdpa, "attention"),
        ("manual_dma", partial(vv.pipelined_attention, q, k, v, H), ref, sdpa, "attention"),
        ("manual_dma_copy", partial(vv.pipelined_attention, q, k, v, H, copy=True),
         q.clone, q.clone, "exact"),
        ("fullwidth", partial(vv.fullwidth_attention, q, k, v, H),
         partial(vv.fullwidth_reference, q, k, v, H),
         partial(F.scaled_dot_product_attention, *one_head,
                 scale=1.0 / math.sqrt(W // H)), "attention"),
        ("dma_only", partial(vv.dma_add, q, k), partial(vv.dma_add_reference, q, k),
         lambda: q + k, "exact"),
        (f"dma_s{rows}", partial(vv.dma_add, q, k, rows),
         partial(vv.dma_add_reference, q, k, rows),
         lambda: q[:, :rows] + k[:, :rows], "exact"),
        ("gemm_inkernel", partial(vv.gemm, x2, w), partial(vv.gemm_reference, x2, w),
         partial(torch.matmul, x2, w), "gemm"),
    ]
    for F_ in (2, 4):
        if B % F_ == 0:
            cases.append((f"lane_f{F_}", partial(vv.lane_attention, q, k, v, H, frames=F_),
                          ref, sdpa, "attention"))
            cases.append((f"lane_f{F_}_nosm", partial(vv.lane_attention, q, k, v, H,
                                                      mode="none", frames=F_),
                          partial(ref, mode="none"), None, "attention"))
    if W == 1024 and H == 16:
        cases.append(("bdp2", partial(vv.bdp2_attention, q, k, v, H),
                      partial(vv.bdp2_reference, q, k, v, H), sdpa, "attention"))
    return cases


@without_tf32
def phase_kernel_variants(seed: int) -> dict:
    """Every variant-bench kernel against its plain version; returns the
    kernels-line row of each PERF.md row 3-11, keyed by its variant."""
    import numpy as np
    import torch
    from tspo_tpu_torch.ops import vit_attention_variants as vv
    from tspo_tpu_torch.tools.bench_vit_attention_variants import bound_ms
    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    main_shape = (256, 257, 1024, 16)
    shapes = [main_shape, (3, 40, 128, 2), (3, 40, 1024, 16), (4, 40, 128, 2)]
    picked = {row[0] for row in VARIANT_ROWS}
    rows = {}
    for B, S, W, H in shapes:
        q, k, v = (torch.randn(B, S, W, device="cuda", generator=gen).bfloat16()
                   for _ in range(3))
        w = torch.from_numpy(np.random.default_rng(1).normal(size=(W, 3 * W)) * 0.02
                             ).to("cuda", torch.bfloat16)
        is_main = (B, S, W, H) == main_shape
        for name, kern, plain, lib, kind in _variant_cases(q, k, v, H, w):
            if (B, S, W, H) == (3, 40, 1024, 16) and name != "bdp2":
                continue            # the W=1024 small case is bdp2's
            if B == 4 and not name.startswith("lane_f"):
                continue            # the B=4 case is lane_f{2,4}'s
            out = kern()
            torch.cuda.synchronize()
            ref = plain()
            check(out.shape == ref.shape and out.dtype == torch.bfloat16,
                  f"{name} B={B} S={S} W={W}: {tuple(out.shape)} {out.dtype}")
            check(torch.isfinite(out).all().item(), f"{name} B={B} S={S} finite")
            err, cos, rel = _row_errors(out, ref)
            if kind == "exact":
                check(torch.equal(out, ref), f"{name} B={B} S={S} W={W}: not "
                      f"bit-exact (max abs {err})")
            elif kind == "gemm":
                check(rel <= 1e-2, f"{name} B={B} S={S} W={W}: row rel {rel}")
            else:
                check(cos >= 0.9998 and err <= 2e-2 and rel <= 1e-2,
                      f"{name} B={B} S={S} W={W}: cos {cos} err {err} row rel {rel}")
            n_it = 20 if is_main else 5
            ms = cuda_time_ms(kern, n_it)
            plain_ms = cuda_time_ms(plain, 3 if is_main else 2, 1)
            lib_ms = None if lib is None else cuda_time_ms(lib, n_it)
            b_ms, b_by = bound_ms(name, B, S, W)
            print(json.dumps({"phase": "1b", "kernel": name, "B": B, "S": S, "W": W,
                              "heads": H, "dtype": "bf16", "max_abs_err": err,
                              "min_row_cos": cos, "max_row_rel_err": rel,
                              "kernel_ms": ms, "plain_ms": plain_ms,
                              "library_ms": lib_ms, "bound_ms": b_ms,
                              "bound_by": b_by}))
            if is_main and name in picked:
                src, line = next((r[1], r[2]) for r in VARIANT_ROWS if r[0] == name)
                rows[name] = {"name": name, "variant": name, "route": "cuda",
                              "source": f"tspo_tpu_torch/csrc/{src}.cu",
                              "replaces": f"{BENCH_SCRIPT}:{line}",
                              "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                              "bound_ms": b_ms, "bound_by": b_by,
                              "library_ms": lib_ms}
            del out, ref
        del q, k, v, w
        torch.cuda.empty_cache()
    check(set(rows) == picked, f"kernel rows {sorted(rows)}")
    for fn in vv.WRAPPERS:
        check(fn.launches > 0, f"{fn.__name__} was never launched in phase 1b")
    return rows


@without_tf32
def phase_parity_scorer(seed: int):
    """Full-width fp32 scorer: card (kernel) against CPU (plain versions)."""
    import numpy as np
    import torch
    from tspo_tpu_torch.cli.common import _stub_tokenizer
    from tspo_tpu_torch.models.tspo_model import build_random_scorer
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
    print(json.dumps({"phase": 2, "model": "scorer", "feature_min_cos": cos,
                      "logits_max_rel": rel, "indices_card": ic.tolist(),
                      "indices_cpu": ih.tolist()}))
    check(cos >= 0.9999, f"parity feature cosine {cos}")
    check(rel <= 1e-3, f"parity logits relative error {rel}")
    check(np.array_equal(ic, ih), f"parity indices {ic} vs {ih}")
    torch.cuda.empty_cache()


@without_tf32
def phase_parity_llava(seed: int):
    """LLaVA-Video at published widths, 2 + 2 layers, fp32: the same weights
    from the seed answer on the CPU (plain versions), then on the card
    (kernels)."""
    import torch
    from tspo_tpu_torch.cli.common import stub_qwen_tokenizer
    from tspo_tpu_torch.models.llava_video import LLaVAVideoConfig, LLaVAVideoModel
    from tspo_tpu_torch.models.qwen2 import KVCache, Qwen2Config, greedy_decode
    from tspo_tpu_torch.models.siglip import SigLIPConfig
    cfg = LLaVAVideoConfig(lm=dataclasses.replace(Qwen2Config(), num_layers=2),
                           vision=dataclasses.replace(SigLIPConfig(), layers=2))
    encode, decode = stub_qwen_tokenizer()
    t0 = time.perf_counter()
    model = LLaVAVideoModel.random_init(torch.Generator().manual_seed(seed + 3),
                                        cfg, dtype=torch.float32, device="cpu",
                                        encode=encode, decode=decode)
    t_init = time.perf_counter() - t0
    frames = smooth_frames(torch.Generator().manual_seed(seed + 4), 3)
    n_new = 8
    batch_frames = [frames, frames[:2]]
    batch_questions = [QUESTION, "where does the scene change?"]
    continuation = "a red cup"
    runs, batched, ll = {}, {}, {}
    for dev in ("cpu", "cuda"):
        model.to(dev)
        reset_counts()
        embeds, _, _ = model._prepare_generate(frames, QUESTION, n_new, None)
        S = embeds.shape[1]
        cache = KVCache.create(cfg.lm, 1, S + n_new + 8, torch.float32, dev)
        steps = []
        toks, n = greedy_decode(model.lm, embeds, torch.ones(1, S, dtype=torch.bool,
                                                             device=dev),
                                cache, n_new, step_logits=steps)
        runs[dev] = (toks.cpu().tolist(), [s[0].cpu() for s in steps], read_counts())
        # two ragged rows in one batched decode, then the teacher-forced
        # log-probability of a continuation
        reset_counts()
        embeds, valid, mn = model._prepare_batch(batch_frames, batch_questions, n_new)
        cache = KVCache.create(cfg.lm, len(batch_frames), embeds.shape[1] + mn + 8,
                               torch.float32, dev)
        steps = []
        toks, _ = greedy_decode(model.lm, embeds, valid, cache, mn, step_logits=steps)
        batched[dev] = (toks.cpu().tolist(), [s.cpu() for s in steps],
                        valid.sum(1).tolist(), read_counts())
        reset_counts()
        ll[dev] = (model.loglikelihood(frames, QUESTION, continuation), read_counts())
        del embeds, cache, steps
    (tc, lc, cc), (th, lh, ch) = runs["cuda"], runs["cpu"]
    check(cc == {"vit_attention": 2, "flash_attention": 2},
          f"parity run on the card launched {cc}, want 2 and 2")
    check(ch == {"vit_attention": 0, "flash_attention": 0},
          f"the CPU run launched kernels: {ch}")
    rel = ((lc[0] - lh[0]).abs().max() / lh[0].abs().max()).item()
    margins, errs, equal_upto = [], [], 0
    for i in range(min(len(lc), len(lh), n_new)):
        top2 = torch.topk(lh[i], 2).values
        margins.append((top2[0] - top2[1]).item())
        errs.append((lc[i] - lh[i]).abs().max().item())
        if tc[i] != th[i]:
            check(margins[i] <= 2 * errs[i],
                  f"greedy token {i} differs ({tc[i]} vs {th[i]}) with margin "
                  f"{margins[i]} above twice the logit error {errs[i]}")
            break     # later steps see different inputs
        equal_upto = i + 1
    print(json.dumps({"phase": 2, "model": "llava_video_2+2_layers",
                      "prompt_tokens": S, "init_s": t_init,
                      "first_logits_max_rel": rel, "tokens_card": tc,
                      "tokens_cpu": th, "tokens_equal_upto": equal_upto,
                      "top2_margins_cpu": margins, "logit_max_abs_err": errs,
                      "launches_card": cc}))
    check(S >= 512, f"parity prompt of {S} tokens does not reach the flash path")
    check(rel <= 1e-3, f"LLaVA first-step logits relative error {rel}")

    (btc, blc, lens, bcc), (bth, blh, _, bch) = batched["cuda"], batched["cpu"]
    eos = cfg.lm.eos_token_id
    rows = [margin_rule(bth[b], [x[b] for x in blh], btc[b], [x[b] for x in blc], eos,
                        f"batched parity row {b}") for b in range(len(lens))]
    brel = ((blc[0] - blh[0]).abs().max() / blh[0].abs().max()).item()
    (ll_c, greedy_c), llc = ll["cuda"]
    (ll_h, greedy_h), llh = ll["cpu"]
    ll_rel = abs(ll_c - ll_h) / abs(ll_h)
    print(json.dumps({"phase": 2, "model": "llava_video_2+2_layers",
                      "call": "generate_batch_multi", "rows": len(lens),
                      "prompt_tokens": lens, "first_logits_max_rel": brel,
                      "tokens_card": btc, "tokens_cpu": bth,
                      "tokens_compared": sum(r["tokens_compared"] for r in rows),
                      "rows_parted_at_near_tie": sum(r["parted_at"] is not None
                                                     for r in rows),
                      "launches_card": bcc}))
    print(json.dumps({"phase": 2, "model": "llava_video_2+2_layers",
                      "call": "loglikelihood", "continuation": continuation,
                      "logprob_card": ll_c, "logprob_cpu": ll_h, "rel_err": ll_rel,
                      "is_greedy_card": greedy_c, "is_greedy_cpu": greedy_h,
                      "launches_card": llc}))
    check(bcc == {"vit_attention": 2 * len(lens), "flash_attention": 2},
          f"batched parity on the card launched {bcc}, want vit_attention "
          f"{2 * len(lens)} (2 layers a row) and flash_attention 2 (one prefill)")
    check(llc == {"vit_attention": 2, "flash_attention": 2},
          f"loglikelihood on the card launched {llc}, want 2 and 2")
    check(bch == llh == {"vit_attention": 0, "flash_attention": 0},
          f"the CPU runs launched kernels: {bch}, {llh}")
    check(max(lens) >= 512 and len(set(lens)) == len(lens),
          f"batched parity rows {lens} are not ragged over the flash path")
    check(brel <= 1e-3, f"batched first-step logits relative error {brel}")
    check(ll_rel <= 1e-3, f"loglikelihood relative error {ll_rel} "
          f"({ll_c} on the card, {ll_h} on the CPU)")
    del model
    torch.cuda.empty_cache()


def phase_main_scoring(seed: int):
    """The scoring main path at full width in bf16; returns (launches of the
    timed score_video_fused run, its indices, the frames, the scorer)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from tspo_tpu_torch.cli.common import _stub_tokenizer
    from tspo_tpu_torch.models.tspo_model import build_random_scorer
    from tspo_tpu_torch.ops import vit_attention as va
    T, k = 300, N_SELECT
    scorer = build_random_scorer(torch.Generator().manual_seed(seed),
                                 dtype=torch.bfloat16, device="cuda",
                                 batch_frames=256, tokenize=_stub_tokenizer())
    frames = smooth_frames(torch.Generator().manual_seed(seed + 2), T)
    questions = [QUESTION, "where does the scene change?",
                 "how many people appear?"]
    # warm-up, under the profiler: which CUDA kernel each vit_attention
    # launch ran
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        scorer.score_video_fused(frames, questions[0], sample_num=k)
        torch.cuda.synchronize()
    ran = cuda_kernels_run(prof, va.KERNELS)
    check(ran == {"vit_attention_wgmma_kernel": 46},
          f"score_video_fused's vit_attention launches ran {ran}, want "
          f"vit_attention_wgmma_kernel 46 times")

    reset_counts()
    t0 = time.perf_counter()
    idx, logits = scorer.score_video_fused(frames, questions[0], sample_num=k)
    torch.cuda.synchronize()
    t_fused = time.perf_counter() - t0
    launches = read_counts()
    check(launches == {"vit_attention": 46, "flash_attention": 0},
          f"score_video_fused launched {launches}, want vit_attention 46 "
          f"(2 chunks x 23 layers) and flash_attention 0")
    check(logits.shape == (T,) and np.isfinite(logits).all(), "fused logits")
    check(len(idx) == k and np.all(np.diff(idx) > 0) and idx[-1] < T,
          f"fused indices {idx}")

    reset_counts()
    t0 = time.perf_counter()
    feats = scorer.encode_frame_features(frames)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    shared_launches = read_counts()["vit_attention"]
    check(shared_launches == 46, f"encode launched {shared_launches}, want 46")
    t0 = time.perf_counter()
    shared = [scorer.score_features_fused(feats, q, sample_num=k)
              for q in questions]
    torch.cuda.synchronize()
    t_q = time.perf_counter() - t0
    check(read_counts()["vit_attention"] == 46, "question scoring launched the kernel")
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
                      "launches_fused": launches["vit_attention"],
                      "launches_encode": shared_launches,
                      "vit_kernels_warmup": ran}))
    del feats
    torch.cuda.empty_cache()
    return launches["vit_attention"], idx, frames, scorer


def phase_main_answer(seed: int, frames, idx, s_expect: int):
    """The answer main path at full width and depth in bf16; returns the
    kernels' launches in the timed generate run, and the model."""
    import numpy as np
    import torch
    from tspo_tpu_torch.cli.common import stub_qwen_tokenizer
    from torch.profiler import ProfilerActivity, profile
    from tspo_tpu_torch.models.llava_video import LLaVAVideoConfig, LLaVAVideoModel
    from tspo_tpu_torch.ops import flash_attention as fa
    from tspo_tpu_torch.ops import vit_attention as va
    from tspo_tpu_torch.tools.profile_answer import timed_answer
    encode, decode = stub_qwen_tokenizer()
    cfg = LLaVAVideoConfig()
    sync = torch.cuda.synchronize
    t0 = time.perf_counter()
    model = LLaVAVideoModel.random_init(
        torch.Generator(device="cuda").manual_seed(seed + 5), cfg,
        dtype=torch.bfloat16, device="cuda", encode=encode, decode=decode)
    sync()
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.net.parameters())
    selected = frames[np.asarray(idx)]
    n_new = 16
    # warm-up, under the profiler: which CUDA kernel each flash launch ran
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.generate(selected, QUESTION, max_new_tokens=n_new)
        sync()
    ran = cuda_kernels_run(prof, fa.KERNELS)
    want = fa.kernel_name(torch.bfloat16, cfg.lm.head_dim)
    check(ran == {want: 28}, f"an answer's flash launches ran {ran}, "
          f"want {want} 28 times (one per layer)")
    ran_vit = cuda_kernels_run(prof, va.KERNELS)
    want_vit = va.kernel_name(torch.bfloat16, cfg.vision.width // cfg.vision.heads)
    check(want_vit == "vit_attention_wgmma_kernel"
          and ran_vit == {want_vit: 26 * -(-len(selected) // model.batch_frames)},
          f"an answer's vit_attention launches ran {ran_vit}, want {want_vit} "
          f"26 times a vision chunk")

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    answer = model.generate(selected, QUESTION, max_new_tokens=n_new)
    sync()
    t_generate = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    chunks = -(-len(selected) // model.batch_frames)
    check(launches == {"vit_attention": 26 * chunks, "flash_attention": 28},
          f"generate launched {launches}, want vit_attention {26 * chunks} "
          f"(26 layers x {chunks} chunk) and flash_attention 28 (one per layer)")
    toks = answer.split()
    check(1 <= len(toks) <= n_new
          and all(0 <= int(t) < cfg.lm.vocab_size for t in toks),
          f"answer {answer!r} is not 1 to {n_new} in-vocabulary tokens")

    # the same answer through the calls generate makes, three times: encode +
    # splice on the host clock, greedy_decode's prefill and each decode step
    # by CUDA events recorded inside its own loop
    runs = [timed_answer(model, selected, QUESTION, n_new) for _ in range(3)]
    for run_toks, stages, _ in runs:
        check(stages["prompt_tokens"] == s_expect,
              f"prompt of {stages['prompt_tokens']} tokens, phase 1 checked {s_expect}")
        check(" ".join(str(t) for t in run_toks if t != cfg.lm.eos_token_id)
              == answer, "a timed answer differs from generate's")
    med = {k: float(np.median([r[1][k] for r in runs]))
           for k in ("encode_splice_s", "prefill_first_token_s", "decode_s",
                     "total_s")}
    steps = [len(r[2]) for r in runs]
    print(json.dumps({"phase": 4, "frames": len(selected),
                      "prompt_tokens": s_expect, "new_tokens": n_new,
                      "params": n_params, "random_init_s": t_init,
                      "generate_s": t_generate,
                      "encode_splice_s": med["encode_splice_s"],
                      "prefill_first_token_s": med["prefill_first_token_s"],
                      "decode_s": med["decode_s"], "decode_steps": steps[0],
                      "staged_total_s": med["total_s"],
                      "time_to_first_token_s":
                          med["encode_splice_s"] + med["prefill_first_token_s"],
                      "decode_ms_per_step": med["decode_s"] * 1e3 / steps[0],
                      "decode_ms_per_step_runs":
                          [sum(r[2]) / len(r[2]) for r in runs],
                      "decode_step_ms_max": max(max(r[2]) for r in runs),
                      "prefill_tokens_per_s": s_expect / med["prefill_first_token_s"],
                      "max_memory_allocated_gb": peak / 1e9,
                      "host_cpus": os.cpu_count(),
                      "host_loadavg_1m": os.getloadavg()[0],
                      "launches": launches, "flash_kernels_warmup": ran,
                      "vit_kernels_warmup": ran_vit,
                      "answer_head": toks[:4]}))
    del runs
    torch.cuda.empty_cache()
    return launches, model, selected, answer


def seeded_decoder(seed: int):
    """A ``load_video`` in place of the decoder (the card's machine has no
    video decoder): seeded 480x640 frames for each path, up to 128 of them,
    the same for a path every time."""
    import zlib

    import torch

    def load_video(path, max_frames_num=256, fps=1, min_frames_num=50,
                   force_sample=False):
        gen = torch.Generator().manual_seed(seed * 7919 + zlib.crc32(path.encode()))
        return smooth_frames(gen, min(max_frames_num, 128)), None, None
    return load_video


@without_tf32
def _update_parity(update, trainer, args) -> dict:
    """One full-width ``selector_update_step`` at ``grad_accum`` 1 on a copy
    of the selector on the card (TF32 off) and on the CPU, from the same
    batch, subsets and rewards (step 1's): loss within 1e-5, grad norm within
    1e-4 relative, each parameter's gradient at cosine >= 0.9999 where its
    norm is at least 1e-3 of the largest (the key bias's exact gradient is
    0: a softmax ignores a shift common to its row; ``ffn_o`` is unused)
    and within 1e-5 of the largest entry elsewhere."""
    import copy

    import torch
    from tspo_tpu_torch.train import grpo
    batch, subsets, rewards, tau = args
    cfg1 = dataclasses.replace(trainer.cfg, grad_accum=1)
    out = {}
    for dev in ("cuda", "cpu"):
        sel = copy.deepcopy(trainer.scorer.selector).to(dev)
        opt = grpo.make_optimizer(cfg1, sel.parameters())
        m = update(sel, opt, grpo.TrainBatch(*(x.to(dev) for x in batch)),
                   grpo.SampledSubsets(*(x.to(dev) for x in subsets)),
                   rewards.to(dev), tau, train_cfg=cfg1,
                   window_size=trainer.cfg.window_size)
        out[dev] = ({k: float(v) for k, v in m.items()},
                    {n: p.grad.detach().double().cpu() for n, p in sel.named_parameters()})
        del sel, opt
    (mc, gc), (mh, gh) = out["cuda"], out["cpu"]
    norms = {n: g.norm().item() for n, g in gh.items()}
    top, top_abs = max(norms.values()), max(g.abs().max().item() for g in gh.values())
    cos, small = {}, {}
    for n in gh:
        if norms[n] >= 1e-3 * top:
            cos[n] = torch.nn.functional.cosine_similarity(
                gc[n].flatten(), gh[n].flatten(), dim=0).item()
        else:
            small[n] = (gc[n] - gh[n]).abs().max().item()
    res = {"loss_card": mc["loss"], "loss_cpu": mh["loss"],
           "grad_norm_card": mc["grad_norm"], "grad_norm_cpu": mh["grad_norm"],
           "grad_cos_min": min(cos.values()), "grad_cos": cos,
           "small_grad_max_abs_diff": small, "grad_norms_cpu": norms}
    check(abs(mc["loss"] - mh["loss"]) <= 1e-5, f"update parity loss {res}")
    check(abs(mc["grad_norm"] - mh["grad_norm"]) <= 1e-4 * mh["grad_norm"],
          f"update parity grad norm {res}")
    check(min(cos.values()) >= 0.9999 and all(d <= 1e-5 * top_abs for d in small.values()),
          f"update parity gradients {res}")
    return res


def phase_main_train(seed: int, scorer, model) -> dict:
    """The training main path at full width: ``TSPOTrainer.train_step`` on
    the phase-3 scorer (CLIP-ViT-L/14 bf16 + the fp32 selector) and the
    phase-4 LLaVA-Video-7B-Qwen2, G=8, four steps (specific, general,
    specific, specific) at ``grad_accum`` 2; returns the launches of the
    four steps."""
    import shutil
    from collections import defaultdict

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from tspo_tpu_torch.configs import TrainConfig
    from tspo_tpu_torch.models.selector import init_selector
    from tspo_tpu_torch.models.tspo_model import TSPOScorer
    from tspo_tpu_torch.ops import flash_attention as fa
    from tspo_tpu_torch.ops import vit_attention as va
    from tspo_tpu_torch.ops.masking import bucket_for
    from tspo_tpu_torch.tools.profile_answer import timed_batch_answer
    from tspo_tpu_torch.train import grpo
    from tspo_tpu_torch.train import trainer as trainer_mod
    from tspo_tpu_torch.video import reader
    sync = torch.cuda.synchronize
    t_phase = time.perf_counter()
    work = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(work, ignore_errors=True)
    cfg = TrainConfig(num_generations=8, training_sample_len=16, window_size=12,
                      grad_accum=2, seed=seed)
    G = cfg.num_generations
    rows = [{"video": "v0.mp4", "original_question": TRAIN_QUESTION,
             "solution": "<answer>A</answer>", "type": t} for t in TRAIN_TYPES]
    pool = [{"video": f"d{i}.mp4"} for i in range(8)]
    # the reference trainer passes no token budget: the model's attribute
    # bounds each rollout's answer
    model.max_new_tokens = 8
    saved = (trainer_mod.load_video, reader.load_video, trainer_mod.sample_subsets,
             trainer_mod.selector_update_step)
    clock, seen = defaultdict(float), {}

    def timed(name, fn):
        def run(*a, **k):
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            sync()
            clock[name] += time.perf_counter() - t0
            if name == "features":
                seen["T"] = int(out[0].shape[0])
            if name == "update" and "args" not in seen:
                seen["args"] = (a[2], a[3], a[4], a[5])
            if name == "rollouts":
                seen["rollout"] = a
            return out
        return run

    trainer_mod.load_video = reader.load_video = seeded_decoder(seed)
    trainer_mod.sample_subsets = timed("sampling", saved[2])
    trainer_mod.selector_update_step = timed("update", saved[3])
    model.generate_batch = timed("rollouts", model.generate_batch)
    try:
        trainer = trainer_mod.TSPOTrainer(
            scorer=scorer, backbone=model, dataset=rows, cfg=cfg,
            irrelevant_pool=pool, output_dir=str(work / "train"))
        trainer.prepare_sample = timed("decode_composite", trainer.prepare_sample)
        trainer.features = timed("features", trainer.features)
        clip_before = {k: v.clone() for k, v in scorer.clip.state_dict().items()}
        steps, parity, ran = [], None, None
        for i, row in enumerate(rows):
            sel_before = {k: v.clone() for k, v in scorer.selector.state_dict().items()}
            clock.clear()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            if i == 0:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    m = trainer.train_step(row)
                    sync()
            else:
                m = trainer.train_step(row)
                sync()
            wall = time.perf_counter() - t0
            launches = read_counts()
            trainer.step += 1
            T, K = seen["T"], int(m["ts_length"])
            check(K == TRAIN_K[row["type"]], f"step {i + 1}: K={K}")
            # one batched prefill for the G rollouts: 28 flash launches
            want = {"vit_attention": 23 * -(-T // scorer.batch_frames)
                    + G * 26 * -(-K // model.batch_frames),
                    "flash_attention": 28}
            check(launches == want, f"train step {i + 1} (T={T}, K={K}) launched "
                  f"{launches}, want {want}")
            if i == 0:
                t0 = time.perf_counter()
                ran = cuda_kernels_run(prof, va.KERNELS + fa.KERNELS)
                t_read = time.perf_counter() - t0
                check(ran == {"vit_attention_wgmma_kernel": want["vit_attention"],
                              "flash_wgmma_kernel": want["flash_attention"]},
                      f"train step 1's launches ran {ran}, want every one on "
                      "vit_attention_wgmma_kernel or flash_wgmma_kernel")
                del prof
            check(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]),
                  f"step {i + 1}: loss {m['loss']} grad norm {m['grad_norm']}")
            if row["type"] == "specific":
                check(m["grad_norm"] > 0, f"step {i + 1} (specific): grad norm 0 "
                      f"(rewards/temporal_reward {m['rewards/temporal_reward']})")
            changed = any(not torch.equal(v, sel_before[k])
                          for k, v in scorer.selector.state_dict().items())
            check(changed == ((i + 1) % cfg.grad_accum == 0),
                  f"step {i + 1}: selector changed={changed} at grad_accum "
                  f"{cfg.grad_accum}")
            if i == 0:
                t0 = time.perf_counter()
                parity = _update_parity(saved[3], trainer, seen["args"])
                t_parity = time.perf_counter() - t0
            stages = dict(clock)
            steps.append({"step": i + 1, "type": row["type"], "T": T,
                          "bucket": bucket_for(T, scorer.frame_buckets), "K": K,
                          "wall_s": wall, **{f"{k}_s": v for k, v in stages.items()},
                          "rollouts_per_s": G / stages["rollouts"],
                          "launches": launches, "loss": m["loss"],
                          "grad_norm": m["grad_norm"], "reward": m["reward"],
                          "reward_std": m["reward_std"],
                          "temporal_reward": m.get("rewards/temporal_reward"),
                          "selector_changed": changed, "profiled": i == 0,
                          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
            print(json.dumps({"phase": "4b", **steps[-1]}))
        check(all(torch.equal(v, clip_before[k])
                  for k, v in scorer.clip.state_dict().items()),
              "the CLIP parameters changed during training")
        del clip_before
        # where the rollouts' time goes: step 4's batched call again, through
        # the calls generate_batch makes, three times; then its rows against
        # one generate each, under the margin rule
        frames_r, question_r = seen["rollout"][:2]
        split = [timed_batch_answer(model, frames_r, [question_r] * G,
                                    model.max_new_tokens)[1] for _ in range(3)]
        rollout_split = {k: float(np.median([r[k] for r in split]))
                         for k in split[0]}
        t0 = time.perf_counter()
        vs_single = batch_vs_single(model, frames_r, [question_r] * G,
                                    model.max_new_tokens)
        vs_single["s"] = time.perf_counter() - t0

        # checkpoint: a fresh trainer (same CLIP, another selector) resumes
        t0 = time.perf_counter()
        trainer.save_checkpoint()
        fresh = trainer_mod.TSPOTrainer(
            scorer=TSPOScorer(scorer.clip, init_selector(
                scorer.selector_cfg, torch.Generator().manual_seed(seed + 9)),
                clip_cfg=scorer.clip_cfg, selector_cfg=scorer.selector_cfg,
                tokenize=scorer.tokenize, batch_frames=scorer.batch_frames,
                dtype=scorer.dtype, device="cuda"),
            backbone=model, dataset=rows, cfg=cfg, output_dir=trainer.output_dir)
        check(fresh.resume_from() == len(rows), "resumed step")
        check(all(torch.equal(a, b) for a, b in zip(
            scorer.selector.parameters(), fresh.scorer.selector.parameters())),
            "resumed selector parameters differ")
        st_a = grpo.optimizer_state(trainer.optimizer, scorer.selector)
        st_b = grpo.optimizer_state(fresh.optimizer, fresh.scorer.selector)
        check((st_a["step"], st_a["mini_step"]) == (st_b["step"], st_b["mini_step"])
              and all(np.array_equal(st_a[g][n], st_b[g][n])
                      for g in ("exp_avg", "exp_avg_sq", "acc_grads") for n in st_a[g]),
              "resumed optimizer state differs")
        t_ckpt = time.perf_counter() - t0
        del fresh

        # merged export, read back on the card
        t0 = time.perf_counter()
        path = trainer.export_merged(str(work / "merged"))
        loaded = TSPOScorer.load(path, clip_cfg=scorer.clip_cfg,
                                 dtype=scorer.dtype, device="cuda",
                                 tokenize=scorer.tokenize,
                                 batch_frames=scorer.batch_frames)
        sd_a, sd_b = scorer.clip.state_dict(), loaded.clip.state_dict()
        check(all(torch.equal(sd_a[k], sd_b[k]) for k in sd_a)
              and all(torch.equal(a, b) for a, b in zip(
                  scorer.selector.parameters(), loaded.selector.parameters())),
              "the exported weights differ")
        frames = smooth_frames(torch.Generator().manual_seed(seed + 8), 96)
        idx_a, log_a = scorer.score_video_fused(frames, QUESTION, sample_num=16)
        idx_b, log_b = loaded.score_video_fused(frames, QUESTION, sample_num=16)
        check(np.array_equal(idx_a, idx_b) and np.array_equal(log_a, log_b),
              f"exported scorer's logits differ by {np.abs(log_a - log_b).max()}")
        t_export = time.perf_counter() - t0
        del loaded, sd_a, sd_b

        # a batched step of two rows (specific, general) with cross-batch
        # rollouts: all 2 x G answers in one ragged generate_batch_multi call
        cross = trainer_mod.TSPOTrainer(
            scorer=scorer, backbone=model, dataset=rows,
            cfg=dataclasses.replace(cfg, cross_batch_rollouts=True, grad_accum=1),
            irrelevant_pool=pool, output_dir=str(work / "cross"))
        multi, rows_seen = model.generate_batch_multi, []

        def counted_multi(frames_list, questions, **kw):
            rows_seen.append(len(frames_list))
            return multi(frames_list, questions, **kw)
        model.generate_batch_multi = timed("cross_rollouts", counted_multi)
        pair = [rows[0], rows[1]]
        Ts = []
        feats = cross.features

        def features_seen(video, problem):
            out = feats(video, problem)
            Ts.append(int(out[0].shape[0]))
            return out
        cross.features = features_seen
        clock.clear()
        reset_counts()
        t0 = time.perf_counter()
        m = cross.train_step_batch(pair)
        sync()
        wall = time.perf_counter() - t0
        launches = read_counts()
        Ks = [TRAIN_K[r["type"]] for r in pair]
        want = {"vit_attention": sum(23 * -(-T // scorer.batch_frames) for T in Ts)
                + sum(G * 26 * -(-K // model.batch_frames) for K in Ks),
                "flash_attention": 28}
        check(rows_seen == [len(pair) * G], f"cross-batch rollouts made "
              f"generate_batch_multi calls of {rows_seen} rows, want one of "
              f"{len(pair) * G}")
        check(launches == want, f"cross-batch step (T={Ts}, K={Ks}) launched "
              f"{launches}, want {want}")
        check(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) and m["batch"] == 2,
              f"cross-batch step metrics {m}")
        cross_step = {"rows": len(pair), "T": Ts, "K": Ks, "wall_s": wall,
                      "rollouts_s": clock["cross_rollouts"],
                      "rollouts_per_s": len(pair) * G / clock["cross_rollouts"],
                      "launches": launches, "loss": m["loss"],
                      "grad_norm": m["grad_norm"], "reward": m["reward"]}
        print(json.dumps({"phase": "4b", "cross_batch_step": cross_step}))
        del cross
    finally:
        (trainer_mod.load_video, reader.load_video, trainer_mod.sample_subsets,
         trainer_mod.selector_update_step) = saved
        vars(model).pop("generate_batch", None)
        vars(model).pop("generate_batch_multi", None)
        shutil.rmtree(work, ignore_errors=True)
    timed_steps = steps[1:]                 # step 1 ran under the profiler
    mean = {k: float(np.mean([s[k] for s in timed_steps]))
            for k in ("wall_s", "decode_composite_s", "features_s", "sampling_s",
                      "rollouts_s", "update_s")}
    total = {k: sum(s["launches"][k] for s in steps) + cross_step["launches"][k]
             for k in steps[0]["launches"]}
    print(json.dumps({"phase": "4b", "summary": "train", "steps": len(steps),
                      "num_generations": G, "grad_accum": cfg.grad_accum,
                      "max_new_tokens": model.max_new_tokens,
                      "decode": "seeded frames",
                      "s_per_step_steps_2_4": mean["wall_s"],
                      "stage_s_steps_2_4": mean,
                      "rollouts_per_s_steps_2_4": G * len(timed_steps)
                      / sum(s["rollouts_s"] for s in timed_steps),
                      "T": [s["T"] for s in steps], "K": [s["K"] for s in steps],
                      "launches": total, "kernels_step_1": ran,
                      "grad_norm": [s["grad_norm"] for s in steps],
                      "loss": [s["loss"] for s in steps],
                      "peak_memory_gb": max(s["peak_memory_gb"] for s in steps),
                      "rollout_stages_s": rollout_split,
                      "batched_vs_single_rollouts": vs_single,
                      "cross_batch_step": cross_step,
                      "update_parity": parity, "update_parity_s": t_parity,
                      "profile_read_s": t_read, "checkpoint_resume_s": t_ckpt,
                      "export_load_s": t_export,
                      "phase_wall_s": time.perf_counter() - t_phase}))
    return total


def phase_main_harness(seed: int, scorer, model) -> dict:
    """The eval harness at full width: ``evaluate_task`` over the VideoMME
    docs of :func:`harness_docs` on ``HARNESS_VIDEOS`` seeded videos of 300
    frames, each doc's ``frame_idx`` the 64 frames phase 3's scorer picks
    for its question, answered by phase 4's LLaVA-Video-7B-Qwen2 in at most
    16 tokens at ``batch_size`` 1 and ``HARNESS_BATCH``; then 2
    ``EgoSchema-ppl`` docs of 5 choices through ``loglikelihood``.  The
    harness reads frames through ``load_video_indices``, which
    :func:`seeded_frames` stands in for (the card's machine has no video
    decoder).  Returns the launches of the three runs."""
    import numpy as np
    import torch
    from tspo_tpu_torch.eval import harness
    from tspo_tpu_torch.eval.tasks import clip_query_text, get_task
    sync = torch.cuda.synchronize
    t_phase = time.perf_counter()
    root, T, n_new = "seeded", 300, 16
    docs, lens = harness_docs()
    t0 = time.perf_counter()
    for v in range(HARNESS_VIDEOS):
        feats = scorer.encode_frame_features(
            seeded_frames(seed, os.path.join(root, f"h{v}.mp4"), range(T)))
        for d in docs[v::HARNESS_VIDEOS]:
            idx, _ = scorer.score_features_fused(feats, clip_query_text(d),
                                                 sample_num=N_SELECT)
            d["frame_idx"] = [int(i) for i in idx]
        del feats
    t_score = time.perf_counter() - t0
    ego = [{"video_idx": f"h{v}", "question": f"What does the person do with "
            f"the object in clip {v}?", "answer": v,
            "option": ["A. picks it up", "B. puts it down", "C. looks at it",
                       "D. hands it over", "E. ignores it"],
            "frame_idx": docs[v]["frame_idx"]} for v in range(2)]
    model.max_new_tokens = n_new
    saved = harness.load_video_indices
    harness.load_video_indices = partial(seeded_frames, seed)
    runs = {}
    try:
        for name, task, task_docs, bs in (
                ("batch_1", "VideoMME", docs, 1),
                (f"batch_{HARNESS_BATCH}", "VideoMME", docs, HARNESS_BATCH),
                ("egoschema_ppl", "EgoSchema-ppl", ego, 1)):
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            res = harness.evaluate_task(task, task_docs, model, video_root=root,
                                        max_frames_num=N_SELECT, on_error="raise",
                                        batch_size=bs)
            sync()
            wall = time.perf_counter() - t0
            runs[name] = {"res": res, "wall_s": wall, "launches": read_counts(),
                          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        # the batched run's rows against one answer each, under the margin
        # rule: the first batch always, a later one where a response differs
        task = get_task("VideoMME")
        one = [s["response"] for s in runs["batch_1"]["res"].samples]
        many = [s["response"] for s in runs[f"batch_{HARNESS_BATCH}"]["res"].samples]
        compared = []
        for c in range(0, len(docs), HARNESS_BATCH):
            chunk = docs[c:c + HARNESS_BATCH]
            differs = [one[c + i] != many[c + i] for i in range(len(chunk))]
            if c and not any(differs):
                continue
            frames = [harness.load_frames_by_index(task.resolve_video(d, root), d,
                                                   N_SELECT)[0] for d in chunk]
            t0 = time.perf_counter()
            vs = batch_vs_single(model, frames, [task.doc_to_text(d) for d in chunk],
                                 n_new)
            vs["s"] = time.perf_counter() - t0
            for i, d in enumerate(differs):
                check(not d or vs["parted_at"][i] is not None,
                      f"doc {c + i}: batched response {many[c + i]!r} differs from "
                      f"the single one {one[c + i]!r}, but a rerun parts at no "
                      "near-tie")
            compared.append({"docs": [c, c + len(chunk)], "responses_differ": differs,
                             **vs})
    finally:
        harness.load_video_indices = saved
    n_docs = {"batch_1": len(docs), f"batch_{HARNESS_BATCH}": len(docs),
              "egoschema_ppl": len(ego)}
    n_ll = sum(len(d["option"]) for d in ego)
    want = {"batch_1": {"vit_attention": 26 * len(docs), "flash_attention": 28 * len(docs)},
            f"batch_{HARNESS_BATCH}": {"vit_attention": 26 * len(docs),
                                       "flash_attention": 28 * -(-len(docs) // HARNESS_BATCH)},
            "egoschema_ppl": {"vit_attention": 26 * n_ll, "flash_attention": 28 * n_ll}}
    out = {}
    for name, r in runs.items():
        res = r["res"]
        check(r["launches"] == want[name], f"harness {name} launched {r['launches']}, "
              f"want {want[name]}")
        check(len(res.results) == n_docs[name] and len(res.samples) == n_docs[name]
              and not any(str(s["response"]).startswith("[error:") for s in res.samples),
              f"harness {name}: {len(res.results)} results")
        out[name] = {"docs": n_docs[name], "wall_s": r["wall_s"],
                     "docs_per_s": n_docs[name] / r["wall_s"],
                     "launches": r["launches"],
                     "launches_per_doc": {k: v / n_docs[name]
                                          for k, v in r["launches"].items()},
                     "peak_memory_gb": r["peak_memory_gb"], "metrics": res.metrics,
                     "responses": [s["response"] for s in res.samples]}
    ppl = runs["egoschema_ppl"]["res"]
    check(all(s["pred_answer"] in range(5) for s in ppl.samples),
          f"EgoSchema-ppl answers {[s['pred_answer'] for s in ppl.samples]}")
    if one == many:
        check(runs["batch_1"]["res"].metrics == runs[f"batch_{HARNESS_BATCH}"]["res"].metrics,
              "equal responses, different VideoMME metrics")
    total = {k: sum(r["launches"][k] for r in runs.values())
             for k in runs["batch_1"]["launches"]}
    print(json.dumps({"phase": "4c", "summary": "harness", "prompt_tokens": lens,
                      "max_new_tokens": n_new, "frames": N_SELECT,
                      "decode": "seeded frames", "scoring_s": t_score,
                      "runs": out, "batched_vs_single": compared,
                      "responses_equal": one == many, "launches": total,
                      "phase_wall_s": time.perf_counter() - t_phase}))
    return total


class LogitClock:
    """A ``step_logits`` sink: a CUDA event when made and one as each
    step's logits are appended (no synchronise in the loop), and each
    step's fp32 logits of row 0, for ``margin_rule``."""

    def __init__(self):
        import torch
        self._new = lambda: torch.cuda.Event(enable_timing=True)
        self.start = self._new()
        self.start.record()
        self.events, self.logits = [], []

    def append(self, logits):
        ev = self._new()
        ev.record()
        self.events.append(ev)
        self.logits.append(logits[0])

    def step_ms(self) -> list:
        """ms between consecutive logits: the decode steps (event 0 ends the
        prefill)."""
        return [a.elapsed_time(b) for a, b in zip(self.events, self.events[1:])]


def _drive(fn, want: dict, tag: str):
    """One user call with the kernel counts set to 0 just before and read
    just after: (its result, wall s, launches), the launches held to
    ``want``."""
    import torch
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_counts()
    check(got == want, f"{tag} launched {got}, want {want}")
    return out, wall, got


def phase_main_conversation(seed: int, model, frames, greedy_answer: str,
                            s_main: int) -> dict:
    """Phase 4d on phase 4's LLaVA-Video-7B-Qwen2 and its 64 frames: (a) a
    three-round conversation with and without a ``ConversationState``,
    (b) ``prefill_extend`` at full width, (c) sampling and the streams,
    (d) speculative decode.  Returns the launches of its user calls."""
    import dataclasses as dc

    import numpy as np
    import torch
    from tspo_tpu_torch.models import qwen2
    from tspo_tpu_torch.tools.profile_answer import timed_greedy_decode
    sync = torch.cuda.synchronize
    t_phase = time.perf_counter()
    n_new, eos, dev = 16, model.cfg.lm.eos_token_id, model.device
    answer = {"vit_attention": 26, "flash_attention": 28}
    none = {"vit_attention": 0, "flash_attention": 0}
    total = Counter()

    def drive(fn, want, tag):
        out, wall, got = _drive(fn, want, tag)
        total.update(got)
        return out, wall

    # (a) the conversation through the user calls, each with a LogitClock as
    # its step_logits sink: its start event is recorded as the call starts,
    # so start -> first logits is the time to first token
    state = model.new_conversation_state()
    turns, rounds = [], []

    def round_(tt, st):
        clock = LogitClock()
        return model.generate_multi_round(frames, tt, n_new, state=st,
                                          step_logits=clock), clock

    def answer_tokens(clock):
        """The greedy tokens of a round: each step's argmax, up to max_new,
        cut at the first EOS."""
        toks = [int(torch.argmax(lg)) for lg in clock.logits][:n_new]
        return toks[:toks.index(eos)] if eos in toks else toks

    for r, q in enumerate(CONV_ROUNDS):
        tt = [*turns, (q, None)]
        (stateless, clock_a), wall_sl = drive(lambda: round_(tt, None), answer,
                                              f"stateless round {r + 1}")
        (stateful, clock_b), wall_sf = drive(lambda: round_(tt, state),
                                             answer if r == 0 else none,
                                             f"stateful round {r + 1}")
        toks_a, toks_b = answer_tokens(clock_a), answer_tokens(clock_b)
        check(model.decode(toks_a) == stateless and model.decode(toks_b) == stateful,
              f"round {r + 1}: the logits sink disagrees with the answer")
        rule = margin_rule(toks_a + [eos], clock_a.logits, toks_b + [eos],
                           clock_b.logits, eos, f"stateful round {r + 1} vs stateless")
        check(rule["parted_at"] is not None or stateless == stateful,
              f"round {r + 1}: the answers differ but their tokens agree")
        steps_a, steps_b = clock_a.step_ms(), clock_b.step_ms()
        ttft = lambda c: c.start.elapsed_time(c.events[0]) / 1e3  # noqa: E731
        rounds.append({
            "round": r + 1, "prompt_tokens": state.covered - len(toks_b),
            "question_chars": len(q), "equal": stateless == stateful, **rule,
            "stateless": {"wall_s": wall_sl, "ttft_s": ttft(clock_a),
                          "decode_steps": len(steps_a),
                          "decode_ms_per_step": float(np.mean(steps_a))},
            "stateful": {"wall_s": wall_sf, "ttft_s": ttft(clock_b),
                         "decode_steps": len(steps_b),
                         "decode_ms_per_step": float(np.mean(steps_b)),
                         "cache_slots": int(state.cache.k.shape[2]),
                         "covered_after": state.covered}})
        print(json.dumps({"phase": "4d", "check": "conversation", **rounds[-1]}))
        turns.append((q, stateless))
        del clock_a, clock_b

    # (b) prefill_extend at full width: a 1024-token block after the prompt
    embeds, _, _ = model._prepare_generate(frames, QUESTION, n_new, None)
    check(embeds.shape[1] == s_main, f"prompt of {embeds.shape[1]} tokens, want {s_main}")
    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    block = qwen2.embed_tokens(model.lm, torch.randint(
        0, model.cfg.lm.vocab_size, (1, EXTEND_ROWS), generator=gen, device=dev)
    ).to(embeds.dtype)
    s_ext = s_main + EXTEND_ROWS
    cache = qwen2.KVCache.create(model.cfg.lm, 1, s_ext + 256, embeds.dtype, dev)
    qwen2.decode_prefill(model.lm, embeds, torch.ones(1, s_main, dtype=torch.bool,
                                                      device=dev), cache)
    ext_logits = []
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    (tok_ext, _), _ = drive(lambda: qwen2.prefill_extend(model.lm, block, EXTEND_ROWS, cache,
                                                         step_logits=ext_logits),
                            {"vit_attention": 0, "flash_attention": 28},
                            f"prefill_extend of {EXTEND_ROWS} rows at q_offset {s_main}")
    ev[1].record()
    check(cache.length == s_ext, f"cache length {cache.length} after the extension")
    del cache
    full_cache = qwen2.KVCache.create(model.cfg.lm, 1, s_ext + 8, embeds.dtype, dev)
    ref_logits = []
    ev[2].record()
    tok_full, _, _ = qwen2.decode_prefill(
        model.lm, torch.cat([embeds, block], dim=1),
        torch.ones(1, s_ext, dtype=torch.bool, device=dev), full_cache,
        step_logits=ref_logits)
    ev[3].record()
    sync()
    del full_cache
    a, b = ext_logits[0][0].float(), ref_logits[0][0].float()
    rel = ((a - b).norm() / b.norm()).item()
    check(math.isfinite(rel) and rel <= 2e-2,
          f"prefill_extend logits {rel} relative from one prefill of {s_ext} tokens")
    ext_rule = margin_rule([int(tok_full[0])], [b], [int(tok_ext[0])], [a], eos,
                           "prefill_extend's token vs one full prefill")
    extend = {"prompt_tokens": s_main, "block_rows": EXTEND_ROWS, "q_offset": s_main,
              "logits_rel_err": rel, "logits_max_abs_diff": (a - b).abs().max().item(),
              "token_equal": int(tok_ext[0]) == int(tok_full[0]), **ext_rule,
              "extend_ms": ev[0].elapsed_time(ev[1]),
              "full_prefill_ms": ev[2].elapsed_time(ev[3])}
    print(json.dumps({"phase": "4d", "check": "prefill_extend", **extend}))
    del a, b, ext_logits, ref_logits

    # (c) sampling and the streams
    sampled, wall_s1 = drive(lambda: model.generate(frames, QUESTION, n_new, seed=seed,
                                                    **SAMPLING), answer, "sampled generate")
    again, _ = drive(lambda: model.generate(frames, QUESTION, n_new, seed=seed, **SAMPLING),
                     answer, "sampled generate again")
    check(again == sampled, f"sampled answers at one seed differ: {sampled!r} {again!r}")
    streamed, _ = drive(lambda: "".join(model.generate_stream(frames, QUESTION, n_new,
                                                              seed=seed, **SAMPLING)),
                        answer, "sampled stream")
    check(streamed == sampled, f"the sampled stream {streamed!r} is not {sampled!r}")
    greedy_streamed, _ = drive(lambda: "".join(model.generate_stream(frames, QUESTION,
                                                                     n_new)),
                               answer, "greedy stream")
    check(greedy_streamed == greedy_answer,
          f"the greedy stream {greedy_streamed!r} is not {greedy_answer!r}")
    top1, _ = drive(lambda: model.generate(frames, QUESTION, n_new, temperature=0.7,
                                           top_p=1e-6, seed=seed),
                    answer, "top_p=1e-6 generate")
    # greedy and the vanishing nucleus through the calls generate makes: the
    # sampler's top-1 takes the higher index of an exact tie, argmax the lower
    embeds, _, _ = model._prepare_generate(frames, QUESTION, n_new, None)
    valid = torch.ones(1, s_main, dtype=torch.bool, device=dev)
    g_clock, s_clock = LogitClock(), LogitClock()
    g_toks, g_n = qwen2.greedy_decode(
        model.lm, embeds, valid, qwen2.KVCache.create(model.cfg.lm, 1, s_main + n_new + 8,
                                                      embeds.dtype, dev),
        n_new, step_logits=g_clock)
    s_toks, s_n = qwen2.sample_decode(
        model.lm, embeds, valid, qwen2.KVCache.create(model.cfg.lm, 1, s_main + n_new + 8,
                                                      embeds.dtype, dev),
        n_new, 0.7, 1e-6, generator=model._generator(seed), step_logits=s_clock)
    g_toks, s_toks = g_toks[:g_n].tolist(), s_toks[:s_n].tolist()
    check(model.decode([t for t in s_toks if t != eos]) == top1,
          "top_p=1e-6 through sample_decode answers otherwise than generate")
    top1_rule = margin_rule(g_toks, g_clock.logits, s_toks, s_clock.logits, eos,
                            "top_p=1e-6 vs greedy")
    del g_clock, s_clock
    # the chunked loop's steps beside greedy_decode's, on the same prompt
    _, _, greedy_steps = timed_greedy_decode(model, embeds, n_new)
    stream_clock = LogitClock()
    for _ in qwen2.greedy_decode_stream(
            model.lm, embeds, valid, qwen2.KVCache.create(model.cfg.lm, 1,
                                                          s_main + n_new + 8,
                                                          embeds.dtype, dev),
            n_new, chunk=8, step_logits=stream_clock):
        pass
    sync()
    chunk_steps = stream_clock.step_ms()
    del stream_clock
    sampling = {"settings": SAMPLING, "seed": seed, "sampled_head": sampled.split()[:4],
                "sampled_wall_s": wall_s1, "stream_equal": True,
                "greedy_stream_equal": True, "top_p_1e-6_equal_greedy": top1 == greedy_answer,
                "top_p_1e-6_rule": top1_rule,
                "greedy_decode_ms_per_step": float(np.mean(greedy_steps)),
                "chunked_ms_per_step": float(np.mean(chunk_steps)),
                "greedy_decode_steps": len(greedy_steps),
                "chunked_steps": len(chunk_steps)}
    print(json.dumps({"phase": "4d", "check": "sampling_streams", **sampling}))

    # (d) prompt-lookup speculative decode
    spec_model = dc.replace(model, speculative=True)
    spec_answer, wall_spec = drive(lambda: spec_model.generate(frames, QUESTION, n_new),
                                   answer, "speculative generate")
    from tspo_tpu_torch.models.llava_video import tokenize_with_image
    ids = tokenize_with_image(model._prompt(QUESTION), model.encode, model.bos_token_id)
    lookup, lvalid = qwen2.build_spec_lookup(t for t in ids if t >= 0)
    d = min(spec_model.draft_len, model.cfg.max_context - s_main - n_new)
    spec_clock = LogitClock()
    sp_toks, sp_n, n_fwd = qwen2.greedy_decode_speculative(
        model.lm, embeds, valid, qwen2.KVCache.create(model.cfg.lm, 1, s_main + n_new + d + 10,
                                                      embeds.dtype, dev),
        n_new, lookup, lvalid, draft_len=d, step_logits=spec_clock)
    sync()
    sp_toks = sp_toks[:sp_n].tolist()
    check(model.decode([t for t in sp_toks if t != eos]) == spec_answer,
          "speculative decode through its call answers otherwise than generate")
    g_clock = LogitClock()
    g_toks, g_n = qwen2.greedy_decode(
        model.lm, embeds, valid, qwen2.KVCache.create(model.cfg.lm, 1, s_main + n_new + 8,
                                                      embeds.dtype, dev),
        n_new, step_logits=g_clock)
    sync()
    g_toks = g_toks[:g_n].tolist()
    spec_rule = margin_rule(g_toks, g_clock.logits, sp_toks, spec_clock.logits, eos,
                            "speculative vs greedy")

    def decode_ms(clock):
        return clock.events[0].elapsed_time(clock.events[-1])
    spec = {"draft_len": d, "equal": spec_answer == greedy_answer, **spec_rule,
            "tokens": sp_n, "verify_forwards": n_fwd, "greedy_decode_forwards": g_n,
            "tokens_per_verify_forward": sp_n / max(n_fwd, 1),
            "speculative_decode_ms_per_token": decode_ms(spec_clock) / max(sp_n - 1, 1),
            "greedy_decode_ms_per_token": decode_ms(g_clock) / max(g_n - 1, 1),
            "speculative_generate_wall_s": wall_spec}
    print(json.dumps({"phase": "4d", "check": "speculative", **spec}))
    del g_clock, spec_clock, embeds
    torch.cuda.empty_cache()
    total = dict(total)
    print(json.dumps({"phase": "4d", "summary": "conversation", "launches": total,
                      "phase_wall_s": time.perf_counter() - t_phase}))
    return total


def phase_bench(seed: int, rows: dict):
    """The variant bench at full shape: launches and parity of every
    variant; fills each kernel row's launches."""
    import math
    from tspo_tpu_torch.ops import vit_attention_variants as vv
    from tspo_tpu_torch.tools.bench_vit_attention_variants import (
        default_variants, launches_per_call, run)
    names = default_variants(257)
    reset_counts()
    t0 = time.perf_counter()
    results = run(names, seed=seed)
    wall = time.perf_counter() - t0
    counts = {fn.__name__: fn.launches for fn in vv.WRAPPERS}
    by_name = {r["variant"]: r for r in results}
    check(list(by_name) == names, f"bench rows {list(by_name)}")
    for r in results:
        print(json.dumps({"phase": 5, **r}))
        want = launches_per_call(r["variant"]) * (r["layers"] * r["calls"] + 1)
        check(r["launches"] == want, f"bench {r['variant']} launched "
              f"{r['launches']} kernels, want {want}")
        check(math.isfinite(r["ms_per_call"]) and r["ms_per_call"] > 0,
              f"bench {r['variant']} time {r['ms_per_call']}")
        if r["variant"] in EXACT_VARIANTS:
            check(r["cos_vs_plain"] >= 0.9998,
                  f"bench {r['variant']} cos_vs_plain {r['cos_vs_plain']}")
    for fn_name, n in counts.items():
        check(n > 0, f"the bench never launched {fn_name}")
    port_total = sum(r["launches"] for r in results
                     if r["variant"] != "vit_attention")
    check(port_total == sum(counts.values()),
          f"bench rows count {port_total} launches, wrappers {counts}")
    for variant, _, _, members in VARIANT_ROWS:
        rows[variant]["launches"] = sum(by_name[m]["launches"] for m in members)
    print(json.dumps({"phase": 5, "variants": len(results), "wall_s": wall,
                      "wrapper_launches": counts}))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "tspo_tpu_torch" / "csrc" / "flash_attention.cu").exists():
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    phase_card()
    s_main = answer_prompt_len(N_SELECT)
    s_rollouts = {f"rollout_k{k}": answer_prompt_len(k, rollout_question())
                  for k in sorted(set(TRAIN_K.values()), reverse=True)}
    _, s_harness = harness_docs()
    vit_row = phase_kernel_vit(args.seed)
    flash_row = phase_kernel_flash(args.seed, s_main, s_rollouts, s_harness)
    variant_rows = phase_kernel_variants(args.seed)
    phase_parity_scorer(args.seed)
    phase_parity_llava(args.seed)
    n_score, idx, frames, scorer = phase_main_scoring(args.seed)
    answer, model, selected, greedy_answer = phase_main_answer(args.seed, frames, idx,
                                                               s_main)
    train = phase_main_train(args.seed, scorer, model)
    evaluate = phase_main_harness(args.seed, scorer, model)
    conversation = phase_main_conversation(args.seed, model, selected, greedy_answer,
                                           s_main)
    del scorer, model, selected
    torch.cuda.empty_cache()
    vit_row["shapes"]["clip"]["launches"] = n_score
    vit_row["shapes"]["siglip"]["launches"] = answer["vit_attention"]
    for row in (vit_row, flash_row):
        name = row["name"]
        row["launches"] = (answer[name] + train[name] + evaluate[name]
                           + conversation[name] + (n_score if name == "vit_attention" else 0))
        row["train"] = {"launches": train[name]}
        row["evaluate"] = {"launches": evaluate[name]}
        row["conversation"] = {"launches": conversation[name]}
    phase_bench(args.seed, variant_rows)
    print(json.dumps({"kernels": [vit_row, flash_row]
                      + [variant_rows[r[0]] for r in VARIANT_ROWS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
