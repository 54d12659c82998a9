"""Host-side video decode.

Replaces the reference's decord usage (trainer/utils.py:32-54 ``load_video``,
llava_vid_tspo.py:362-380 ``load_video_index``) with a two-backend design:

  1. native C++ ffmpeg decoder (native/decode.cpp via ctypes) — sequential
     demux + decode with in-loop swscale, frame-exact index gather, built for
     the 1-fps sampling pattern where seeking per frame loses to streaming;
  2. cv2 (OpenCV ffmpeg) fallback with identical semantics.

Semantics matched to the reference ``load_video``:
  - stride = round(container_fps / fps); candidates = range(0, n, stride)
  - if count > max_frames_num (or < min_frames_num, or force_sample):
    uniform linspace(0, n-1, max_frames_num)
"""

from __future__ import annotations

import numpy as np


def _cv2_capture(path):
    import cv2
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video: {path}")
    return cap, cv2


def video_info(path: str):
    """(num_frames, fps, width, height)."""
    from . import native
    if native.available():
        return native.info(path)
    cap, cv2 = _cv2_capture(path)
    try:
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
        w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        return n, fps, w, h
    finally:
        cap.release()


def _gather_cv2(path: str, indices: np.ndarray) -> np.ndarray:
    """Sequential decode, keeping only wanted frames (RGB uint8)."""
    cap, cv2 = _cv2_capture(path)
    wanted = {}
    order = np.asarray(indices, np.int64)
    need = sorted(set(int(i) for i in order))
    try:
        pos = 0
        need_iter = iter(need)
        nxt = next(need_iter, None)
        while nxt is not None:
            # grab() skips cheap; retrieve() only on wanted frames
            if pos < nxt:
                if not cap.grab():
                    break
                pos += 1
                continue
            ok, frame = cap.read()
            if not ok:
                break
            wanted[pos] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            pos += 1
            nxt = next(need_iter, None)
    finally:
        cap.release()
    if not wanted:
        raise IOError(f"no frames decoded: {path}")
    # Missing tail indices (corrupt containers over-report counts): clamp to
    # the last decoded frame, mirroring decord's EOF-retry tolerance.
    last = max(wanted)
    return np.stack([wanted.get(int(i), wanted[last]) for i in order])


def load_video_indices(path: str, indices) -> np.ndarray:
    """Decode exactly the given frame indices -> [len(indices), H, W, 3] RGB."""
    indices = np.asarray(indices, np.int64)
    from . import native
    if native.available():
        try:
            return native.gather(path, indices)
        except OSError:   # the native decoder refused this file: try cv2
            pass
    return _gather_cv2(path, indices)


def sample_indices(total: int, container_fps: float, fps: int = 1,
                   max_frames_num: int = 256, min_frames_num: int = 50,
                   force_sample: bool = False):
    """Frame-index schedule of reference ``load_video`` (trainer/utils.py:38-46)."""
    stride = max(int(round(container_fps / fps)), 1)
    frame_idx = list(range(0, total, stride))
    frame_time = [i / stride for i in frame_idx]
    if len(frame_idx) > max_frames_num or force_sample or len(frame_idx) < min_frames_num:
        frame_idx = np.linspace(0, total - 1, max_frames_num, dtype=int).tolist()
        frame_time = [i / container_fps for i in frame_idx]
    return frame_idx, frame_time


def load_video(path: str, max_frames_num: int = 256, fps: int = 1,
               min_frames_num: int = 50, force_sample: bool = False):
    """1-fps candidate decode with the uniform-resample fallback of
    :func:`sample_indices`.

    Returns (frames [T, H, W, 3] uint8 RGB, frame_time str, video_time
    float).  A video that cannot be read gives zeros, as the reference's
    training path does: (max_frames_num, 336, 336, 3) uint8 and None, None."""
    try:
        if max_frames_num == 0:
            return np.zeros((1, 336, 336, 3), np.uint8), None, None
        total, container_fps, _, _ = video_info(path)
        container_fps = container_fps or 30.0
        video_time = total / container_fps
        frame_idx, frame_time = sample_indices(total, container_fps, fps,
                                               max_frames_num, min_frames_num,
                                               force_sample)
        frames = load_video_indices(path, frame_idx)
        time_str = ",".join(f"{t:.2f}s" for t in frame_time)
        return frames, time_str, video_time
    except (OSError, ValueError):
        return np.zeros((max_frames_num, 336, 336, 3), np.uint8), None, None
