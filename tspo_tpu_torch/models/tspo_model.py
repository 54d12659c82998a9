"""TSPO merged model: CLIP-L/14 towers + MultiModalAlign selector + selection.

Counterpart of ``tspo_tpu/models/tspo_model.py`` (reference
``TSPOModel(CLIPModel)``, model/temporal_agent.py:146-231).  The scoring
pipeline per video:

  host frames [T, H, W, 3] u8
    -> device preprocess (resize/crop/normalise, models/clip.py)
    -> CLIP vision tower, ``batch_frames`` frames per chunk; attention through
       the Hopper ``vit_attention`` kernel on the card
    -> CLIP text tower (question)
    -> selector logits over a padded frame bucket
    -> top-k / bin-max on the device, AKS on the host

PyTorch runs eagerly, so the vision tower encodes only the real frames, chunk
by chunk, and the bucket padding of the features is zero-filled.  Padded
features never reach a valid logit: the selector masks them through
``valid``.  Checkpoints are the JAX package's ``tspo_params.npz`` +
``config.json`` (``format: tspo_tpu-merged-v1``), so each package reads the
other's.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable

import numpy as np
import torch

from ..configs import CLIPConfig, SelectorConfig
from ..interop import (
    clip_tree_from_hf_state_dict,
    hf_state_dict_from_clip_tree,
    selector_state_dict_from_tree,
    selector_tree_from_state_dict,
)
from ..ops.masking import bucket_for
from ..ops.selection import aks_select, bin_max_select, topk_select
from ..utils.device import resolve_device
from ..utils.hf_port import state_dict_of
from .clip import (
    CLIPModel,
    cosine_scores,
    empty_clip_model,
    host_resize_crop,
    init_clip_model,
    load_hf_state_dict,
    normalize_frames,
    preprocess_frames,
)
from .selector import (
    MultiModalAlign,
    init_selector,
    load_reference_state_dict,
    score_frames,
)

_NEG = -1e30


def flatten_tree(tree: dict, prefix: str, out: dict):
    """Nested dict of arrays -> ``out["<prefix>/<key>/..."]`` as fp32 numpy:
    the npz key layout of both packages' checkpoints."""
    for key in sorted(tree):
        val = tree[key]
        name = f"{prefix}/{key}"
        if isinstance(val, dict):
            flatten_tree(val, name, out)
        else:
            out[name] = np.asarray(val, np.float32)


def unflatten_tree(data, prefix: str) -> dict:
    """Inverse of :func:`flatten_tree` over the keys of an opened npz."""
    out: dict = {}
    for key in data.files:
        if not key.startswith(prefix + "/"):
            continue
        parts = key[len(prefix) + 1:].split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = np.asarray(data[key], np.float32)
    return out


class TSPOScorer:
    """Host-side orchestrator around the scoring pipeline.

    ``tokenize``: callable str -> (input_ids [1, L], attention_mask [1, L]).
    ``batch_frames`` is the CLIP chunk size (device batch).  The selector is
    kept in fp32 whatever ``dtype``, and is the only part with gradients.
    ``device`` defaults to ``"cuda"`` and raises when no card is present;
    pass ``device="cpu"`` for the CPU, where the attention takes its plain
    PyTorch version.
    """

    def __init__(self, clip: CLIPModel, selector: MultiModalAlign,
                 clip_cfg: CLIPConfig = CLIPConfig(),
                 selector_cfg: SelectorConfig = SelectorConfig(),
                 tokenize: Callable | None = None, batch_frames: int = 256,
                 dtype=torch.bfloat16,
                 frame_buckets: tuple = (64, 128, 256, 512, 1024, 2048, 4096, 8192),
                 preprocess: str = "device", device="cuda"):
        self.device = resolve_device(device)
        self.clip_cfg = clip_cfg
        self.selector_cfg = selector_cfg
        self.tokenize = tokenize
        self.batch_frames = batch_frames
        self.dtype = dtype
        self.frame_buckets = tuple(frame_buckets)
        self.preprocess = preprocess   # "device" resize, or "host" (cv2)
        # the CLIP towers are frozen; the selector (fp32) is what GRPO trains
        self.clip = clip.to(device=self.device, dtype=dtype).eval().requires_grad_(False)
        selector.cfg = selector_cfg
        self.selector = selector.to(device=self.device, dtype=torch.float32).eval()

    # -- feature extraction -------------------------------------------------

    def _pad_ids(self, ids, mask=None):
        """Right-pad token ids (and mask) to the text tower's max_positions.
        Exact: the tower is causal and pools at the first EOS."""
        ids = np.atleast_2d(np.asarray(ids))
        if mask is not None:
            mask = np.atleast_2d(np.asarray(mask))
        L = self.clip_cfg.text.max_positions
        if ids.shape[-1] < L:
            pad = [(0, 0), (0, L - ids.shape[-1])]
            ids = np.pad(ids, pad)
            if mask is not None:
                mask = np.pad(mask, pad)
        return ids[:, :L], (None if mask is None else mask[:, :L])

    def _ids(self, problem, with_mask: bool):
        if isinstance(problem, str):
            if self.tokenize is None:
                raise ValueError("TSPOScorer needs a tokenize fn for raw text")
            ids, mask = self.tokenize(problem)
        else:
            ids, mask = problem, None
        ids, mask = self._pad_ids(ids, mask if with_mask else None)
        ids_t = torch.as_tensor(ids.astype(np.int64), device=self.device)
        mask_t = None if mask is None else torch.as_tensor(mask, device=self.device)
        return ids_t, mask_t

    @torch.inference_mode()
    def encode_text_features(self, problem: str | np.ndarray) -> torch.Tensor:
        ids, mask = self._ids(problem, with_mask=True)
        return self.clip.encode_text(ids, mask)

    def _encode(self, frames, preprocess: str) -> torch.Tensor:
        if preprocess == "host":
            frames = host_resize_crop(np.asarray(frames),
                                      self.clip_cfg.vision.image_size)
            prep = normalize_frames
        else:
            prep = preprocess_frames
        T, B = frames.shape[0], self.batch_frames
        outs = []
        for start in range(0, T, B):
            chunk = torch.as_tensor(frames[start:start + B]).to(self.device)
            pixels = prep(chunk, self.clip_cfg.vision.image_size, self.dtype)
            outs.append(self.clip.encode_images(pixels))
        if not outs:
            return torch.empty(0, self.clip_cfg.vision.projection_dim,
                               dtype=self.dtype, device=self.device)
        return torch.cat(outs)

    @torch.inference_mode()
    def encode_frame_features(self, frames) -> torch.Tensor:
        """[T, H, W, 3] uint8 -> [T, proj] image features (chunked)."""
        return self._encode(frames, self.preprocess)

    @torch.inference_mode()
    def extract_features(self, frames, problem):
        """Mirror of reference ``TSPOModel.extract_feature``: returns
        (image_feat [T, P], text_feat [1, P], clip_scores [T])."""
        image_feat = self.encode_frame_features(frames)
        text_feat = self.encode_text_features(problem)
        return image_feat, text_feat, cosine_scores(image_feat, text_feat)

    # -- scoring + selection ------------------------------------------------

    def _on_device(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device)

    def _padded(self, x, bucket: int):
        """Zero-pad the leading axis to ``bucket`` (fp32); returns
        (padded, valid[bucket])."""
        x = self._on_device(x).float()
        n = x.shape[0]
        out = torch.zeros((bucket, *x.shape[1:]), dtype=torch.float32,
                          device=self.device)
        out[:n] = x
        return out, torch.arange(bucket, device=self.device) < n

    def _logits(self, feat_p, valid, text_feat, clip_sc_p, window_size, score_tau):
        ws = self.selector_cfg.window_size if window_size is None else window_size
        tau = self.selector_cfg.score_tau if score_tau is None else score_tau
        logits, _ = score_frames(self.selector, feat_p, self._on_device(text_feat),
                                 clip_sc_p, window_size=ws, score_tau=tau,
                                 valid=valid)
        return logits

    @torch.inference_mode()
    def score(self, image_feat, text_feat, clip_sc, *, window_size=None,
              score_tau=None) -> np.ndarray:
        """Selector logits for the true length T (bucket-padded internally)."""
        T = int(image_feat.shape[0])
        bucket = bucket_for(T, self.frame_buckets)
        feat_p, valid = self._padded(image_feat, bucket)
        sc_p, _ = self._padded(clip_sc, bucket)
        logits = self._logits(feat_p, valid, text_feat, sc_p, window_size,
                              score_tau)
        return logits[:T].cpu().numpy()

    def _fused_tail(self, feat_p, valid, text_feat, k, window_size, score_tau):
        """cosine + selector + top-k over a padded bucket of features."""
        csc = cosine_scores(feat_p, text_feat)
        logits = self._logits(feat_p, valid, text_feat, csc, window_size,
                              score_tau)
        masked = torch.where(valid, logits, torch.full_like(logits, _NEG))
        idx, count = topk_select(masked, k, valid)
        return idx[: int(count)].cpu().numpy(), logits

    @torch.inference_mode()
    def score_features_fused(self, image_feat, problem, *, sample_num=64,
                             window_size=None, score_tau=None,
                             method: str = "topk", **method_kwargs):
        """Per-question scoring of PRECOMPUTED image features: text encode +
        cosine + selector + top-k (the warm path of the video-level feature
        cache).  Returns (indices, logits[:T]); non-topk methods select on the
        host from the same logits."""
        ids, _ = self._ids(problem, with_mask=False)
        T = int(image_feat.shape[0])
        feat_p, valid = self._padded(image_feat, bucket_for(T, self.frame_buckets))
        txt = self.clip.encode_text(ids)
        # k <= bucket; the valid count already truncates short videos
        k = min(int(sample_num), int(feat_p.shape[0]))
        idx, logits = self._fused_tail(feat_p, valid, txt, k, window_size,
                                       score_tau)
        logits_t = logits[:T].cpu().numpy()
        if method == "topk":
            return idx, logits_t
        return (self.select(logits_t, sample_num, method, **method_kwargs),
                logits_t)

    @torch.inference_mode()
    def score_video_fused(self, frames, problem, *, sample_num=64,
                          window_size=None, score_tau=None):
        """Top-k scoring of one video: text encode, chunked device preprocess
        + vision tower, cosine, selector and top-k.  Returns (indices,
        logits[:T])."""
        ids, _ = self._ids(problem, with_mask=False)
        T = frames.shape[0]
        bucket = bucket_for(T, self.frame_buckets)
        bucket = -(-bucket // self.batch_frames) * self.batch_frames
        txt = self.clip.encode_text(ids)
        feat_p, valid = self._padded(self._encode(frames, "device"), bucket)
        k = min(int(sample_num), bucket)
        idx, logits = self._fused_tail(feat_p, valid, txt, k, window_size,
                                       score_tau)
        return idx, logits[:T].cpu().numpy()

    def select(self, logits: np.ndarray, sample_num: int,
               method: str = "topk", **method_kwargs) -> np.ndarray:
        """Dispatch matching reference ``inference_ts`` (llava_qwen.py:146-176).
        With T <= k, topk and bin-max both select every frame."""
        T = len(logits)
        if T <= sample_num:
            return np.arange(T)
        if method in ("topk", "bin-max"):
            fn = topk_select if method == "topk" else bin_max_select
            idx, count = fn(torch.as_tensor(np.asarray(logits, np.float32)),
                            sample_num)
            return idx[: int(count)].numpy()
        if method == "aks":
            # method_kwargs: t1 / all_depth (per-dataset, utils.py:131-133)
            return np.asarray(aks_select(np.asarray(logits), sample_num,
                                         **method_kwargs))
        raise ValueError(f"unknown selection method: {method}")

    def temporal_sampling(self, image_feat, text_feat, clip_sc, *,
                          method="topk", window_size=None, sample_num=64,
                          **method_kwargs):
        logits = self.score(image_feat, text_feat, clip_sc,
                            window_size=window_size)
        return self.select(logits, sample_num, method, **method_kwargs), logits

    def __call__(self, frames, problem, *, sample_num=64, window_size=12,
                 method="topk"):
        """Full reference ``TSPOModel.forward`` (temporal_agent.py:177-184)."""
        image_feat, text_feat, clip_sc = self.extract_features(frames, problem)
        return self.temporal_sampling(image_feat, text_feat, clip_sc,
                                      method=method, window_size=window_size,
                                      sample_num=sample_num)

    # -- checkpoints ----------------------------------------------------------

    def save(self, directory: str):
        """Save the merged checkpoint in the JAX package's layout: one npz of
        flattened fp32 trees + config json."""
        os.makedirs(directory, exist_ok=True)
        flat: dict = {}
        flatten_tree(clip_tree_from_hf_state_dict(self.clip.state_dict(), self.clip_cfg),
                 "clip", flat)
        flatten_tree(selector_tree_from_state_dict(self.selector.state_dict()),
                 "selector", flat)
        np.savez(os.path.join(directory, "tspo_params.npz"), **flat)
        with open(os.path.join(directory, "config.json"), "w") as f:
            json.dump({"format": "tspo_tpu-merged-v1",
                       "selector": {"dim": self.selector_cfg.dim,
                                    "num_heads": self.selector_cfg.num_heads}}, f)

    @classmethod
    def from_state_dicts(cls, clip_sd: dict, selector_sd: dict,
                         clip_cfg=CLIPConfig(), selector_cfg=SelectorConfig(),
                         dtype=torch.bfloat16, device="cuda", **kw) -> "TSPOScorer":
        """From an HF ``CLIPModel`` state dict and a reference
        ``MultiModal_Align`` state dict (tensors or ndarrays)."""
        device = resolve_device(device)
        clip = load_hf_state_dict(empty_clip_model(clip_cfg), clip_sd)
        with torch.device("meta"):
            sel = MultiModalAlign(selector_cfg)
        sel = load_reference_state_dict(sel.to_empty(device="cpu"), selector_sd)
        return cls(clip, sel, clip_cfg=clip_cfg, selector_cfg=selector_cfg,
                   dtype=dtype, device=device, **kw)

    @classmethod
    def load(cls, directory: str, clip_cfg=CLIPConfig(),
             selector_cfg=SelectorConfig(), dtype=torch.bfloat16,
             device="cuda", **kw) -> "TSPOScorer":
        """Load a ``save()`` checkpoint (of either package).  ``config.json``
        overrides the selector geometry: all selector params are dim x dim,
        so a wrong head count would load without a shape error."""
        cfg_path = os.path.join(directory, "config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                saved = json.load(f).get("selector", {})
            if saved:
                selector_cfg = dataclasses.replace(selector_cfg, **saved)
        with np.load(os.path.join(directory, "tspo_params.npz")) as data:
            clip_tree = unflatten_tree(data, "clip")
            sel_tree = unflatten_tree(data, "selector")
        return cls.from_state_dicts(
            hf_state_dict_from_clip_tree(clip_tree, clip_cfg),
            selector_state_dict_from_tree(sel_tree), clip_cfg=clip_cfg,
            selector_cfg=selector_cfg, dtype=dtype, device=device, **kw)

    @classmethod
    def from_torch_merged(cls, model_or_sd, clip_cfg=CLIPConfig(),
                          selector_cfg=SelectorConfig(), dtype=torch.bfloat16,
                          device="cuda", **kw) -> "TSPOScorer":
        """Load a reference merged TSPO-0.4B checkpoint: an HF CLIPModel state
        dict plus ``selector.*`` keys (scripts/merge_weights.py:31-58)."""
        sd = state_dict_of(model_or_sd)
        sel_sd = {k[len("selector."):]: v for k, v in sd.items()
                  if k.startswith("selector.")}
        clip_sd = {k: v for k, v in sd.items() if not k.startswith("selector.")}
        return cls.from_state_dicts(clip_sd, sel_sd, clip_cfg=clip_cfg,
                                    selector_cfg=selector_cfg, dtype=dtype,
                                    device=device, **kw)


def build_random_scorer(generator: torch.Generator | None = None,
                        clip_cfg=CLIPConfig(), selector_cfg=SelectorConfig(),
                        dtype=torch.float32, device="cuda", **kw) -> TSPOScorer:
    """Random-weight scorer (tests, benchmarks).  Weights are drawn on the CPU
    from ``generator`` (seed 0 when None), so one seed gives the same weights
    on every device."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    clip = init_clip_model(clip_cfg, generator)
    sel = init_selector(selector_cfg, generator)
    return TSPOScorer(clip, sel, clip_cfg=clip_cfg, selector_cfg=selector_cfg,
                      dtype=dtype, device=device, **kw)
