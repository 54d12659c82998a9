"""Needle-in-a-haystack training composites.

The port's own copy of ``tspo_tpu/video/augment.py``: the same
``np.random.Generator`` calls in the same order, so one seed gives the same
composites and masks in both packages.  cv2 is imported only where a frame
is resized, and a frame already at the target size is not resized.

Host-side numpy augmentation matching reference ``src/open_tspo/trainer/utils.py``:
for "specific"-type samples, the true video is subsampled into 1-4 clips of 50
frames and shuffled among 12 distractor clips from unrelated videos; the
boolean mask marking true-clip positions grounds the temporal-localization
reward (tspo.py:146-159).
"""

from __future__ import annotations

import numpy as np


def repeat_videos(video: np.ndarray, repeat_times: int = 4, sample_len: int = 50,
                  rng: np.random.Generator | None = None) -> list:
    """``repeat_times`` random sorted subsamples of ``sample_len`` frames
    (ref trainer/utils.py:15-25)."""
    rng = rng or np.random.default_rng()
    if video.shape[0] <= sample_len:
        return [video for _ in range(repeat_times)]
    return [video[np.sort(rng.choice(video.shape[0], sample_len, replace=False))]
            for _ in range(repeat_times)]


def resize_video(video: np.ndarray, target_h: int = 480, target_w: int = 640) -> np.ndarray:
    """Bilinear resize of every frame (ref trainer/utils.py:75-85)."""
    import cv2
    return np.stack([
        cv2.resize(f, (target_w, target_h), interpolation=cv2.INTER_LINEAR)
        for f in video]).astype(np.uint8)


def resize_short(video: np.ndarray, target_size: int = 336) -> np.ndarray:
    """Short-side resize preserving aspect (ref trainer/utils.py:56-72)."""
    import cv2
    _, H, W, _ = video.shape
    if H < W:
        nh, nw = target_size, int(W * (target_size / H))
    else:
        nw, nh = target_size, int(H * (target_size / W))
    return np.stack([cv2.resize(f, (nw, nh), interpolation=cv2.INTER_LINEAR)
                     for f in video]).astype(np.uint8)


def shuffle_clips(true_groups: list, wrong_groups: list,
                  rng: np.random.Generator | None = None):
    """Interleave equal-length true/distractor clips in random order.

    Returns (composite video [sum_len, H, W, 3], mask [sum_len] bool with True
    at frames from the true video) — ref trainer/utils.py:177-200.
    """
    rng = rng or np.random.default_rng()
    len_group = len(true_groups[0])
    flags = np.array([1] * len(true_groups) + [0] * len(wrong_groups))
    order = rng.permutation(flags)
    total = (len(true_groups) + len(wrong_groups)) * len_group
    sample = true_groups[0]
    merged = np.zeros((total, *sample.shape[1:]), sample.dtype)
    mask = np.zeros(total, bool)
    ti, wi = 0, 0
    for i, flag in enumerate(order):
        seg = slice(i * len_group, (i + 1) * len_group)
        if flag == 1:
            merged[seg] = true_groups[ti]
            mask[seg] = True
            ti += 1
        else:
            merged[seg] = wrong_groups[wi]
            wi += 1
    return merged, mask


def shuffle_fixed_clips(true_groups: list, wrong_groups: list):
    """Deterministic layout: half the distractors, then all true clips, then
    the rest (toy example; ref trainer/utils.py:203-229)."""
    len_group = len(true_groups[0])
    nw = len(wrong_groups)
    order = [0] * (nw // 2) + [1] * len(true_groups) + [0] * (nw - nw // 2)
    total = (len(true_groups) + nw) * len_group
    sample = true_groups[0]
    merged = np.zeros((total, *sample.shape[1:]), sample.dtype)
    mask = np.zeros(total, bool)
    ti, wi = 0, 0
    for i, flag in enumerate(order):
        seg = slice(i * len_group, (i + 1) * len_group)
        if flag == 1:
            merged[seg] = true_groups[ti]
            mask[seg] = True
            ti += 1
        else:
            merged[seg] = wrong_groups[wi]
            wi += 1
    return merged, mask


def shuffle_clips_1fps(true_groups: list, wrong_groups: list,
                       rng: np.random.Generator | None = None):
    """Variable-length-clip variant (ref trainer/utils.py:232-261)."""
    rng = rng or np.random.default_rng()
    flags = np.array([1] * len(true_groups) + [0] * len(wrong_groups))
    order = rng.permutation(flags)
    total = sum(len(g) for g in true_groups) + sum(len(g) for g in wrong_groups)
    sample = true_groups[0]
    merged = np.zeros((total, *sample.shape[1:]), sample.dtype)
    mask = np.zeros(total, bool)
    ti, wi, cur = 0, 0, 0
    for flag in order:
        if flag == 1:
            g = true_groups[ti]
            ti += 1
            merged[cur:cur + len(g)] = g
            mask[cur:cur + len(g)] = True
        else:
            g = wrong_groups[wi]
            wi += 1
            merged[cur:cur + len(g)] = g
        cur += len(g)
    return merged.astype(np.uint8), mask


def sample_real_frames(data: list, root: str, sample_num: int,
                       target_h: int = 336, target_w: int = 336,
                       rng: np.random.Generator | None = None) -> np.ndarray:
    """Decode 50 frames from a random unrelated video and resize — the
    distractor source (ref trainer/utils.py:88-101)."""
    import os

    from .reader import load_video
    rng = rng or np.random.default_rng()
    line = data[int(rng.integers(len(data)))]
    path = os.path.join(root, line["video"])
    frames, _, _ = load_video(path, max_frames_num=max(50, sample_num), fps=1,
                              force_sample=False)
    # The reference always uses 50-frame clips; honoring sample_num keeps the
    # composite consistent for other clip lengths (tile short decodes).
    if len(frames) < sample_num:
        reps = -(-sample_num // len(frames))
        frames = np.tile(frames, (reps, 1, 1, 1))
    frames = frames[:sample_num]
    if frames.shape[1:3] == (target_h, target_w):
        # cv2.resize to the frame's own size is an exact copy
        return np.array(frames)
    import cv2
    return np.stack([cv2.resize(f, (target_w, target_h),
                                interpolation=cv2.INTER_LINEAR) for f in frames])
