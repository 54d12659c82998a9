"""Per-question CLIP-feature cache.

Mirrors the reference's ``<save_root>/<dataset>/<index>.pth`` cache
(mp_tools/vlmeval/vlm/gen_id_tspo.py:68-79): scoring a 50k-frame video costs
minutes of decode+encode, so phase-1 evaluation caches
(image_features, text_features, clip_scores, sampled_idx) per question and
reruns are skip-and-continue.  Stored as npz, the same files the JAX package writes.
"""

from __future__ import annotations

import os

import numpy as np


class FeatureCache:
    def __init__(self, root: str):
        self.root = root

    def _path(self, dataset: str, index) -> str:
        return os.path.join(self.root, dataset, f"{index}.npz")

    def has(self, dataset: str, index) -> bool:
        return os.path.exists(self._path(dataset, index))

    def load(self, dataset: str, index) -> dict:
        with np.load(self._path(dataset, index)) as z:
            return {k: z[k] for k in z.files}

    def save(self, dataset: str, index, *, image_features, text_features=None,
             clip_scores=None, sampled_idx=None, **extra):
        """text_features/clip_scores are optional: video-level blobs
        (question-independent image features shared across a video's
        questions) carry image_features + sampled_idx only."""
        path = self._path(dataset, index)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        payload = dict(
            image_features=np.asarray(image_features, np.float32),
            **{k: np.asarray(v) for k, v in extra.items()},
        )
        if text_features is not None:
            payload["text_features"] = np.asarray(text_features, np.float32)
        if clip_scores is not None:
            payload["clip_scores"] = np.asarray(clip_scores, np.float32)
        if sampled_idx is not None:
            payload["sampled_idx"] = np.asarray(sampled_idx, np.int64)
        tmp = path + ".tmp.npz"  # crash-safe: write-then-rename
        np.savez(tmp, **payload)
        os.replace(tmp, path)
