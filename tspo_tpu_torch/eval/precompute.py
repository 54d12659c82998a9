"""Phase-1 evaluation: frame-index precompute.

Counterpart of ``tspo_tpu/eval/precompute.py`` (reference mp_tools pipeline):
per question, decode all 1-fps candidate frames (<= max_frames), extract CLIP
features once (cached), run the selector, emit *absolute* frame indices.
Results checkpoint incrementally to ``<work_dir>/<name>_<dataset>_supp.pkl``
so reruns skip and continue (run_hzf.py:88-102,148-173), and merge into
``*_frameIdx.json`` (change_score_tch.py).

One host process feeds the card, with a decode prefetch thread; scale-out
shards the question list by ``(rank, world)``, one checkpoint file per rank.
"""

from __future__ import annotations

import logging
import os
import pickle
import queue
import threading

import numpy as np

from ..configs import PrecomputeConfig
from ..models.tspo_model import TSPOScorer
from ..video.cache import FeatureCache
from ..video.reader import load_video_indices, sample_indices, video_info
from .datasets import VideoQuestionDataset, merge_frame_indices


def select_method_for(dataset: str, cfg: PrecomputeConfig) -> str:
    """topk everywhere except VideoMME -> bin-max (gen_id_tspo.py:83)."""
    return "bin-max" if dataset == "VideoMME" else cfg.method


# AKS thresholds per benchmark (model/utils.py:131-133 comments:
# "t1 videomme: 0.8; LVB: 0.2", "all_depth videomme: 5; LVB: 3")
AKS_PARAMS = {"VideoMME": {"t1": 0.8, "all_depth": 5},
              "LongVideoBench": {"t1": 0.2, "all_depth": 3}}


def candidate_schedule(video_path: str, max_frames: int):
    """Absolute frame indices of the 1-fps candidates (gen_id_tspo load_video:
    min_frames_num is NOT applied in the precompute variant)."""
    total, fps, _, _ = video_info(video_path)
    idx, _ = sample_indices(total, fps or 30.0, fps=1, max_frames_num=max_frames,
                            min_frames_num=0, force_sample=False)
    return np.asarray(idx, np.int64)


class FrameIndexPrecompute:
    def __init__(self, scorer: TSPOScorer, cache: FeatureCache,
                 cfg: PrecomputeConfig = PrecomputeConfig(),
                 work_dir: str = "work_dir", name: str = "TSPO",
                 prefetch: int = 2, decode_workers: int = 1):
        self.scorer = scorer
        self.cache = cache
        self.cfg = cfg
        self.work_dir = work_dir
        self.name = name
        self.prefetch = prefetch
        # >1 routes host decode through the native C++ pool
        # (video/native.py::DecodePool): N videos decode concurrently on
        # multi-core hosts.  Memory note: each in-flight video holds its full
        # candidate buffer, so size workers to host RAM for very long videos.
        self.decode_workers = decode_workers
        # (video key, device features, host features, sampled_idx) of the
        # last video encoded: its next question reuses them as they are
        self._vid_memo = None

    # -- persistence --------------------------------------------------------
    #
    # Multi-rank safety: each (rank, world) shard checkpoints to ITS OWN
    # file — a shared supp.pkl would be last-writer-wins across ranks,
    # silently dropping shards (the same per-rank-file rule eval/caching.py
    # follows).  Readers (load_results/load_errors without a shard) merge
    # the legacy single file plus every rank file.

    def _supp_path(self, dataset: str, shard: tuple = (0, 1)) -> str:
        rank, world = shard
        if world == 1:
            return os.path.join(self.work_dir,
                                f"{self.name}_{dataset}_supp.pkl")
        return os.path.join(
            self.work_dir,
            f"{self.name}_{dataset}_supp_rank{rank}of{world}.pkl")

    def _errors_path(self, dataset: str, shard: tuple = (0, 1)) -> str:
        rank, world = shard
        if world == 1:
            return os.path.join(self.work_dir,
                                f"{self.name}_{dataset}_errors.pkl")
        return os.path.join(
            self.work_dir,
            f"{self.name}_{dataset}_errors_rank{rank}of{world}.pkl")

    def _load_merged(self, dataset: str, kind: str,
                     shard: tuple | None) -> dict:
        import glob
        base = os.path.join(self.work_dir, f"{self.name}_{dataset}_{kind}")
        if shard is None:                    # merge view: legacy + all ranks
            paths = sorted(glob.glob(base + "*.pkl"))
        else:                                # one rank's resume view
            paths = [base + ".pkl"]
            rank_path = (self._supp_path if kind == "supp"
                         else self._errors_path)(dataset, shard)
            if rank_path not in paths:
                paths.append(rank_path)
        out: dict = {}
        for path in paths:
            if os.path.exists(path):
                with open(path, "rb") as f:
                    out.update(pickle.load(f))
        return out

    def load_results(self, dataset: str, shard: tuple | None = None) -> dict:
        return self._load_merged(dataset, "supp", shard)

    def load_errors(self, dataset: str, shard: tuple | None = None) -> dict:
        """{question_id: error string} of questions that failed permanently
        (e.g. corrupt video).  Unlike the reference — which either raises with
        the path (gen_id_tspo.py:36-38) or leaves the question looking
        "not yet done" forever — failures are recorded and visible, and a
        resume skips them instead of re-decoding a broken file every run."""
        return self._load_merged(dataset, "errors", shard)

    def _atomic_dump(self, path: str, obj):
        os.makedirs(self.work_dir, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(obj, f)
        os.replace(tmp, path)

    def _checkpoint(self, dataset: str, results: dict, shard: tuple = (0, 1)):
        self._atomic_dump(self._supp_path(dataset, shard), results)

    # -- per-question scoring ----------------------------------------------

    def _decode_candidates(self, video_path: str):
        """(frames, sampled_idx) for one video: compute the 1-fps schedule
        ONCE and gather exactly those indices — one container open, and
        len(frames) == len(sampled_idx) by construction.  (The old
        schedule-then-load_video pair re-derived the schedule internally and
        degraded to a max_frames-long zeros buffer on mid-stream decode
        failure — a ~17 GB allocation whose length no longer matched the
        schedule.)  Raises on decode failure; callers record the error."""
        sampled_idx = candidate_schedule(video_path, self.cfg.max_frames)
        frames = load_video_indices(video_path, sampled_idx)
        if frames.shape[0] != len(sampled_idx):
            raise IOError(f"decoded {frames.shape[0]} of {len(sampled_idx)} "
                          f"candidate frames from {video_path}")
        return frames, sampled_idx

    def _shard_structs(self, structs: list, rank: int, world: int) -> list:
        """This rank's question slice.  Plain ``i % world`` striping (the
        reference shards questions over GPU workers, run_hzf.py:107-133)
        scatters a video's questions across ranks, defeating the video-level
        feature reuse — so with share_video_features, questions are grouped
        by video and whole GROUPS are dealt round-robin by size order
        (largest-first greedy -> balanced question counts per rank)."""
        if world <= 1:
            return list(structs)
        if not self._share():
            return [s for i, s in enumerate(structs) if i % world == rank]
        groups: dict = {}
        for i, s in enumerate(structs):
            groups.setdefault(str(s.get("video_path")), []).append((i, s))
        loads = [0] * world
        mine = []
        # deterministic: sort by (size desc, first appearance) then greedy
        # least-loaded; ties by rank index
        for key in sorted(groups, key=lambda k: (-len(groups[k]),
                                                 groups[k][0][0])):
            r = loads.index(min(loads))
            loads[r] += len(groups[key])
            if r == rank:
                mine.extend(groups[key])
        mine.sort(key=lambda t: t[0])  # keep dataset order within the rank
        return [s for _, s in mine]

    def _video_key(self, video_path) -> str:
        """Cache index for the question-independent video-level blob:
        basename stem + short path hash (stems can repeat across dirs)."""
        import hashlib
        stem = os.path.splitext(os.path.basename(str(video_path)))[0]
        h = hashlib.sha1(str(video_path).encode()).hexdigest()[:10]
        return f"_vid_{stem}_{h}"

    def _share(self) -> bool:
        return self.cfg.share_video_features

    def _compute_features(self, struct, dataset: str, decoded=None):
        """Encode-or-reuse features for one question and write its
        reference-format per-question cache blob.

        With share_video_features, the expensive decode + vision-tower encode
        happens once per VIDEO (the reference repeats it once per question,
        gen_id_tspo.py:68-73); only the text tower + cosine + selector are
        per-question.  ``decoded`` carries an already-decoded
        (frames, sampled_idx) from the prefetch producer."""
        import torch

        from ..models.clip import cosine_scores
        vkey = self._video_key(struct["video_path"]) if self._share() else None
        memo = self._vid_memo
        if vkey is not None and memo is not None and memo[0] == vkey:
            # grouped sharding processes a video's questions consecutively:
            # keep the LAST video's features resident (device tensor + host
            # float32) instead of re-reading the npz and re-uploading per
            # question
            _, img_j, img, sampled_idx = memo
        elif vkey is not None and self.cache.has(dataset, vkey):
            blob = self.cache.load(dataset, vkey)
            img = blob["image_features"]
            sampled_idx = blob["sampled_idx"]
            img_j = torch.from_numpy(img).to(self.scorer.device)
        else:
            frames, sampled_idx = (decoded if decoded is not None
                                   else self._decode_candidates(
                                       struct["video_path"]))
            img_j = self.scorer.encode_frame_features(frames)
            img = img_j.float().cpu().numpy()
            if vkey is not None:
                self.cache.save(dataset, vkey, image_features=img,
                                sampled_idx=sampled_idx)
        if vkey is not None:
            self._vid_memo = (vkey, img_j, img, sampled_idx)
        txt_j = self.scorer.encode_text_features(struct["problem"])
        csc_j = cosine_scores(img_j, txt_j)
        txt = txt_j.float().cpu().numpy()
        csc = csc_j.float().cpu().numpy()
        self.cache.save(dataset, struct["index"], image_features=img,
                        text_features=txt, clip_scores=csc,
                        sampled_idx=sampled_idx)
        return img, txt, csc, sampled_idx

    def features_for(self, struct, dataset: str):
        """Cache-or-compute (image_feat, text_feat, clip_scores, sampled_idx)
        for one question (gen_id_tspo.py:66-79)."""
        index = struct["index"]
        if self.cache.has(dataset, index):
            blob = self.cache.load(dataset, index)
            return (blob["image_features"], blob["text_features"],
                    blob["clip_scores"], blob["sampled_idx"])
        return self._compute_features(struct, dataset)

    def _select_abs_ids(self, img, txt, csc, sampled_idx,
                        dataset: str) -> list:
        """Selector + method dispatch + absolute-index gather — the single
        implementation shared by frame_indices_for and run()'s consumer."""
        sampled_idx = np.asarray(sampled_idx, np.int64)
        method = select_method_for(dataset, self.cfg)
        extra = AKS_PARAMS.get(dataset, {}) if method == "aks" else {}
        if len(img) > self.cfg.sample_num:
            ts_ids, _ = self.scorer.temporal_sampling(
                img, txt, csc, method=method,
                window_size=self.cfg.window_size,
                sample_num=self.cfg.sample_num, **extra)
            abs_ids = sampled_idx[np.asarray(ts_ids)]
        else:
            abs_ids = sampled_idx
        return [float(x) for x in abs_ids]

    def frame_indices_for(self, struct, dataset: str) -> list:
        """Absolute selected frame ids as floats (gen_id_tspo.py:81-92)."""
        img, txt, csc, sampled_idx = self.features_for(struct, dataset)
        return self._select_abs_ids(img, txt, csc, sampled_idx, dataset)

    # -- dataset run --------------------------------------------------------

    def run(self, dataset: VideoQuestionDataset, shard: tuple = (0, 1),
            rerun: bool = False, progress=None) -> dict:
        """Score this rank's slice of the question list; returns
        {question_id: [abs frame ids]} merged with prior results."""
        rank, world = shard
        results = {} if rerun else self.load_results(dataset.name, shard)
        errors = {} if rerun else self.load_errors(dataset.name, shard)
        structs = self._shard_structs(list(dataset.iter_structs()),
                                      rank, world)
        # resume filter uses the MERGED view (all ranks + legacy): shard
        # assignment can change between runs (world size, or the
        # share_video_features grouped sharding), so a question finished by
        # another rank's file must not be recomputed here
        done_all = {} if rerun else self.load_results(dataset.name, None)
        err_all = {} if rerun else self.load_errors(dataset.name, None)
        todo = [s for s in structs if s["question_id"] not in results
                and s["question_id"] not in errors
                and s["question_id"] not in done_all
                and s["question_id"] not in err_all]

        # Host decode prefetch thread: ffmpeg overlaps with device compute.
        # The producer only touches the cache index and the decoder; all
        # device work (CLIP encode, selector) stays on the consumer side.
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)

        def producer():
            # videos already enqueued this run: by the time a later question
            # of the same video reaches the consumer, the earlier one has
            # populated the video blob / memo (and if it errored, the
            # consumer's vidhit path decodes for itself) — so the producer
            # must not decode the same video once per question
            enqueued_vids = set()
            for s in todo:
                if self.cache.has(dataset.name, s["index"]):
                    q.put((s, "cached", None))
                    continue
                if self._share():
                    vkey = self._video_key(s["video_path"])
                    if vkey in enqueued_vids or self.cache.has(dataset.name,
                                                               vkey):
                        q.put((s, "vidhit", None))
                        continue
                    enqueued_vids.add(vkey)
                try:
                    q.put((s, "frames",
                           self._decode_candidates(s["video_path"])))
                except Exception as e:  # keep the run alive (run_hzf resume)
                    q.put((s, "error", e))
            q.put(None)

        def producer_pooled():
            """Cross-video decode via the native C++ worker pool: a window of
            decode jobs runs concurrently; results feed the consumer in
            submission order (same queue contract as ``producer``)."""
            import collections

            from ..video.native import DecodePool
            enqueued_vids = set()   # same contract as producer()
            with DecodePool(self.decode_workers) as pool:
                window: collections.deque = collections.deque()
                it = iter(todo)
                exhausted = False

                def refill():
                    nonlocal exhausted
                    while (not exhausted
                           and len(window) <= self.decode_workers):
                        s = next(it, None)
                        if s is None:
                            exhausted = True
                            break
                        if self.cache.has(dataset.name, s["index"]):
                            window.append((s, "cached", None))
                            continue
                        if self._share():
                            vkey = self._video_key(s["video_path"])
                            if vkey in enqueued_vids or self.cache.has(
                                    dataset.name, vkey):
                                window.append((s, "vidhit", None))
                                continue
                            enqueued_vids.add(vkey)
                        try:
                            sampled_idx = candidate_schedule(
                                s["video_path"], self.cfg.max_frames)
                            job = pool.submit(s["video_path"],
                                              np.asarray(sampled_idx))
                            window.append((s, "job", (job, sampled_idx)))
                        except Exception as e:
                            window.append((s, "error", e))

                refill()
                while window:
                    s, kind, payload = window.popleft()
                    if kind == "job":
                        job, sampled_idx = payload
                        try:
                            frames = pool.result(job)
                            if frames.shape[0] != len(sampled_idx):
                                raise IOError(
                                    f"pool decoded {frames.shape[0]} of "
                                    f"{len(sampled_idx)} frames")
                            q.put((s, "frames", (frames, sampled_idx)))
                        except Exception as e:
                            # record like the non-pooled path — never feed a
                            # frames/schedule length mismatch downstream
                            q.put((s, "error", e))
                    else:
                        q.put((s, kind, payload))
                    refill()
            q.put(None)

        from ..video import native as _native
        use_pool = self.decode_workers > 1 and _native.pool_available()
        t = threading.Thread(target=producer_pooled if use_pool else producer,
                             daemon=True)
        t.start()

        done_since_ckpt = 0
        while True:
            item = q.get()
            if item is None:
                break
            s, kind, payload = item
            if kind != "error":
                # consumer-side failures (cache blob corruption, device
                # errors) must also land in the errors record instead of
                # killing the run — same record-and-skip contract as the
                # producer (load_errors docstring)
                try:
                    if kind == "cached":
                        blob = self.cache.load(dataset.name, s["index"])
                        img, txt, csc, sampled_idx = (
                            blob["image_features"], blob["text_features"],
                            blob["clip_scores"], blob["sampled_idx"])
                    else:
                        # "frames" (decoded payload) or "vidhit" (video-level
                        # feature reuse, no decode)
                        img, txt, csc, sampled_idx = self._compute_features(
                            s, dataset.name, decoded=payload)
                    results[s["question_id"]] = self._select_abs_ids(
                        img, txt, csc, sampled_idx, dataset.name)
                except Exception as e:  # noqa: BLE001 — recorded below
                    kind, payload = "error", e
            if kind == "error":
                qid = s["question_id"]
                logging.getLogger(__name__).warning(
                    "precompute failed for %s (%s): %r", qid,
                    s.get("video_path"), payload)
                errors[qid] = repr(payload)
                self._atomic_dump(self._errors_path(dataset.name, shard),
                                  errors)
                continue
            done_since_ckpt += 1
            if progress:
                progress(s["question_id"])
            if done_since_ckpt >= self.cfg.checkpoint_every:
                self._checkpoint(dataset.name, results, shard)
                done_since_ckpt = 0
        t.join()
        self._checkpoint(dataset.name, results, shard)
        return results

    def emit_frame_idx_json(self, dataset: str, anno: list, out_path: str) -> list:
        from .datasets import dump_json
        merged = merge_frame_indices(anno, self.load_results(dataset), dataset)
        dump_json(merged, out_path)
        return merged
