"""Phase-2 evaluation harness: run a backbone over precomputed frame indices.

The port's counterpart of ``tspo_tpu/eval/harness.py``, the same flow
without the audio track.  Rebuild of the lmms-eval flow the reference uses
(SURVEY.md §3.4): question records carry ``frame_idx`` (from phase 1); the
harness gathers exactly those frames, builds the task prompt, asks the
backbone for a greedy answer, parses the letter, and aggregates
per-benchmark metrics.  Backbones plug in through ``BackboneAdapter``
(``models/llava_video.py``'s ``LLaVAVideoModel`` on the card);
uniform-sampling mode reproduces the reference "original_*" baselines.

A producer thread decodes frames into numpy arrays and never touches the
card; the backbone runs on the calling thread.  Where the reference shards
requests over 8 accelerate ranks with NCCL gathers (evaluator.py:469-626), a
rank here is (rank, world) slicing of the doc list and metric merge is a
host-side dict merge (:func:`merge_shards`).  The audio track is not ported:
an audio-capable backbone on an audio task raises.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Callable, Protocol

import numpy as np

from ..video.reader import load_video_indices, sample_indices, video_info
from .datasets import DOC_ID_KEY
from .tasks import BenchmarkTask, get_task


class BackboneAdapter(Protocol):
    def generate(self, frames: np.ndarray, prompt: str) -> str:
        """Greedy answer for a frame set + question prompt.  A backbone
        exposing ``supports_audio = True`` takes an audio track the port
        cannot decode yet: on a wants_audio task the harness raises."""
        ...


def load_frames_by_index(video_path: str, doc: dict, max_frames_num: int):
    """Gather doc['frame_idx'][:N] sorted; uniform fallback when the index
    list is shorter than N (llava_vid_tspo.py:362-380)."""
    frame_idx = sorted(int(i) for i in doc["frame_idx"][:max_frames_num])
    if len(frame_idx) < max_frames_num:
        total, _, _, _ = video_info(video_path)
        frame_idx = np.linspace(0, total - 1, max_frames_num, dtype=int).tolist()
    return load_video_indices(video_path, frame_idx), frame_idx


def load_frames_uniform(video_path: str, max_frames_num: int):
    """1-fps then uniform-cap decode (llava_vid_tspo.py:315-333) — the
    is_uniform=True baseline path."""
    total, fps, _, _ = video_info(video_path)
    frame_idx, _ = sample_indices(total, fps or 30.0, fps=1,
                                  max_frames_num=max_frames_num,
                                  min_frames_num=0, force_sample=False)
    return load_video_indices(video_path, frame_idx), frame_idx


@dataclass
class EvalResult:
    results: list
    metrics: dict
    samples: list = field(default_factory=list)


# unique-id fallbacks for tasks not in DOC_ID_KEY (MVBench, EgoSchema,
# NExT-QA, ...).  Deliberately excludes non-unique keys like video_name —
# a doc with no unique id gets None and is simply never response-cached.
_ID_FALLBACKS = ("question_id", "id", "qid", "video_idx", "index", "uid")


def _doc_id(doc: dict, id_key: str):
    v = doc.get(id_key)
    if v is not None:
        return v
    for k in _ID_FALLBACKS:
        if doc.get(k) is not None:
            return doc[k]
    return None


def evaluate_task(task_name: str, docs: list, backbone: BackboneAdapter,
                  video_root: str = "", max_frames_num: int = 64,
                  is_uniform: bool = False, limit: int | None = None,
                  shard: tuple = (0, 1), log_samples: bool = True,
                  seed: int = 1234, progress: Callable | None = None,
                  on_error: str = "skip", response_cache=None,
                  scorer=None, live_method: str = "topk",
                  live_max_candidates: int = 50000,
                  specific_kwargs: dict | None = None,
                  request_type: str | None = None,
                  batch_size: int = 1) -> EvalResult:
    """Run one benchmark slice.  ``is_uniform=True`` reproduces the baseline
    (no TSPO) rows of the results table.  ``response_cache`` (eval/caching.py)
    skips regeneration on resume — responses are deterministic (greedy,
    frozen backbone).

    ``scorer`` (a TSPOScorer) enables *live scoring*: docs without a
    precomputed ``frame_idx`` get 1-fps candidates scored by the temporal
    agent on the fly — the single-phase path of the reference adapter
    (llava_vid_tspo.py:335-360 ``load_video_sampled``).

    ``batch_size`` > 1 batches consecutive plain ``generate_until`` docs
    through ``backbone.generate_batch_multi`` (ragged mixed-question
    batching — models/llava_video.py): single-row decode is weight-read
    bound at ~95% of the HBM roofline, so co-decoding B rows amortizes the
    weight stream (docs/KERNELS.md phase-2 roofline).  Cached, audio,
    multi-round, and loglikelihood docs flush the pending batch and run
    singly; a failed batched call degrades to per-doc generates so
    per-sample ``[error: ...]`` semantics are preserved."""
    task: BenchmarkTask = get_task(task_name)
    rng = random.Random(seed)
    # audio-visual tasks + audio-capable backbone: the reference hands the
    # task's audio to generate(audio=...); the port has no audio decoder, so
    # it fails loudly instead of a video-only run that looks audio-fed
    _reqtype = request_type or task.output_type
    use_audio = bool(getattr(task, "wants_audio", False)
                     and getattr(backbone, "supports_audio", False)
                     and _reqtype == "generate_until")
    if use_audio:
        raise NotImplementedError(
            "task wants audio and the backbone supports it, but the audio "
            "track is not ported yet (ROADMAP.md Queue 1 item 5); evaluate "
            "with a video-only backbone for a frames-only run")
    id_key = DOC_ID_KEY.get(task_name, "question_id")
    rank, world = shard

    picked = [d for i, d in enumerate(docs[:limit] if limit else docs)
              if i % world == rank]

    # Host decode prefetch: the next doc's frame gather (ffmpeg) overlaps the
    # current doc's backbone generate on device (same pattern as phase-1).
    import queue
    import threading

    q: queue.Queue = queue.Queue(maxsize=max(2, batch_size))
    def producer():
        for doc in picked:
            if response_cache is not None and _doc_id(doc, id_key) is not None \
                    and response_cache.get(_doc_id(doc, id_key)) is not None:
                q.put((doc, "cached", None))
                continue
            try:
                path = task.resolve_video(doc, video_root)
                if is_uniform:
                    frames, frame_idx = load_frames_uniform(path, max_frames_num)
                elif "frame_idx" in doc:
                    frames, frame_idx = load_frames_by_index(path, doc,
                                                             max_frames_num)
                elif scorer is not None:
                    # live scoring: decode all 1-fps candidates; the consumer
                    # runs the temporal agent on device
                    from ..eval.precompute import candidate_schedule
                    from ..video.reader import load_video
                    cand_idx = candidate_schedule(path, live_max_candidates)
                    cands, _, _ = load_video(path,
                                             max_frames_num=live_max_candidates,
                                             fps=1, min_frames_num=0)
                    q.put((doc, "candidates", (cands, cand_idx)))
                    continue
                else:
                    frames, frame_idx = load_frames_uniform(path, max_frames_num)
                q.put((doc, "frames", (frames, frame_idx)))
            except Exception as e:
                q.put((doc, "error", e))
        q.put(None)

    threading.Thread(target=producer, daemon=True).start()

    results, samples = [], []

    def _emit(doc, response, frame_idx, rounds_detail=None):
        # all fallible work FIRST, mutations last: _emit_safe retries a
        # failed _emit with an [error:] response, so an exception escaping
        # after results.append would double-count the doc in every metric
        # denominator on the retry
        rec = task.process_response(doc, response, rng)
        sample = None
        if log_samples:
            sample = {"doc_id": _doc_id(doc, id_key), "response": response,
                      "frame_idx": frame_idx, **rec}
            if rounds_detail is not None:
                sample["rounds"] = rounds_detail
        if response_cache is not None and _doc_id(doc, id_key) is not None \
                and not str(response).startswith("[error:"):
            response_cache.put(_doc_id(doc, id_key), response)
        results.append(rec)
        if sample is not None:
            samples.append(sample)
        if progress:
            try:
                progress(_doc_id(doc, id_key))
            except Exception as e:  # noqa: BLE001 — display-only callback:
                import sys           # the record is already emitted, so a
                print(f"[harness] progress callback failed: {e}",  # retry
                      file=sys.stderr)                # would double-append

    pending: list = []   # (doc, frames, frame_idx, prompt) awaiting batch

    def _flush():
        if not pending:
            return
        batch, outs = pending[:], None
        pending.clear()
        if len(batch) > 1:
            try:
                outs = backbone.generate_batch_multi(
                    [f for _, f, _, _ in batch], [p for *_, p in batch])
            except Exception:
                if on_error == "raise":
                    raise
                outs = None   # degrade to per-doc generates below
        def _emit_safe(d, resp, fi):
            # a process_response/progress/cache failure for ONE doc must not
            # abort the rest of the batch: the outer per-doc handler only
            # knows the CURRENT doc, so an escape here would silently drop
            # the other pending docs from every metric's denominator
            try:
                _emit(d, resp, fi)
            except Exception as e:  # noqa: BLE001
                if on_error == "raise":
                    raise
                try:
                    _emit(d, f"[error: {e}]", [])
                except Exception:   # noqa: BLE001 — malformed doc: record
                    import sys
                    print(f"[harness] dropping doc {_doc_id(d, id_key)}: "
                          f"process_response failed twice: {e}",
                          file=sys.stderr)

        if outs is not None:
            for (d, _, fi, _), resp in zip(batch, outs):
                _emit_safe(d, resp, fi)
            return
        for d, fr, fi, pr in batch:
            try:
                resp = backbone.generate(fr, pr)
            except Exception as e:
                if on_error == "raise":
                    raise
                resp, fi = f"[error: {e}]", []
            _emit_safe(d, resp, fi)

    while True:
        item = q.get()
        if item is None:
            break
        doc, kind, payload = item
        rounds_detail = None
        try:
            if kind == "cached":
                response = response_cache.get(_doc_id(doc, id_key))
                frame_idx = doc.get("frame_idx", [])
            elif kind == "error":
                raise payload
            else:
                if kind == "candidates":
                    cands, cand_idx = payload
                    if len(cands) > max_frames_num:
                        # the CLIP query is the bare question with options
                        # text stripped — the same rule phase-1 applies
                        # (tasks.clip_query_text; gen_id_tspo.py:62-65)
                        from ..eval.tasks import clip_query_text
                        query = (task.clip_query(doc)
                                 if task.clip_query is not None
                                 else clip_query_text(doc))
                        sel, _ = scorer(cands, query,
                                        sample_num=max_frames_num,
                                        method=live_method)
                        frames = cands[np.asarray(sel)]
                        frame_idx = [int(cand_idx[i]) for i in sel]
                    else:
                        frames, frame_idx = cands, [int(i) for i in cand_idx]
                    payload = (frames, frame_idx)
                frames, frame_idx = payload
                if task.transform_frames is not None:
                    frames = task.transform_frames(doc, frames, frame_idx)
                prompt = task.doc_to_text(doc, specific_kwargs)
                reqtype = request_type or task.output_type
                if reqtype == "generate_until_multi_round":
                    # multi-round chat (api/model.py:82-103): each round's
                    # answer becomes conversation context for the next; the
                    # FINAL answer is what process_results scores, rounds
                    # ride the sample record
                    turns, round_answers = [], []
                    # per-doc conversation KV state: later rounds prefill
                    # only the new turn instead of the full video history
                    # (models/llava_video.py::ConversationState)
                    mr_state = (backbone.new_conversation_state()
                                if hasattr(backbone,
                                           "new_conversation_state") else None)
                    for r in range(max(int(task.num_rounds), 1)):
                        rq = (task.round_prompt(doc, r, list(round_answers),
                                                specific_kwargs)
                              if task.round_prompt is not None else prompt)
                        if hasattr(backbone, "generate_multi_round"):
                            ans = (backbone.generate_multi_round(
                                       frames, [*turns, (rq, None)],
                                       state=mr_state)
                                   if mr_state is not None else
                                   backbone.generate_multi_round(
                                       frames, [*turns, (rq, None)]))
                        else:
                            # single-turn backbones: plain-text transcript
                            transcript = "".join(f"{u}\n{a}\n"
                                                 for u, a in turns)
                            ans = backbone.generate(frames, transcript + rq)
                        turns.append((rq, ans))
                        round_answers.append(ans)
                    response = round_answers[-1]
                    rounds_detail = turns
                elif reqtype == "loglikelihood":
                    # request-type dispatch (evaluator.py:501): score each
                    # choice's continuation logprob, answer = argmax letter.
                    # ll_length_normalize ranks by per-token mean — the
                    # reference mc_ppl rule (argmin of mean CE loss)
                    choices = task.doc_to_choices(doc)
                    enc = getattr(backbone, "encode", None)
                    lls = []
                    for c in choices:
                        ll = backbone.loglikelihood(frames, prompt, c)[0]
                        if task.ll_length_normalize and enc is not None:
                            ll = ll / max(len(enc(c)), 1)
                        lls.append(ll)
                    response = chr(ord("A") + int(np.argmax(lls)))
                elif batch_size > 1 and hasattr(backbone,
                                                "generate_batch_multi"):
                    pending.append((doc, frames, frame_idx, prompt))
                    if len(pending) >= batch_size:
                        _flush()
                    continue
                else:
                    response = backbone.generate(frames, prompt)
        except Exception as e:
            if on_error == "raise":
                raise
            # keep the run alive, emit an error response like the reference
            # adapter (llava_vid_tspo.py:499-508)
            response, frame_idx = f"[error: {e}]", []
        _flush()   # earlier batched docs emit before this one (doc order)
        _emit(doc, response, frame_idx, rounds_detail)
    _flush()
    return EvalResult(results=results, metrics=task.aggregate(results),
                      samples=samples)


def merge_shards(task_name: str, shards: list) -> EvalResult:
    """Rank-0 merge of per-rank EvalResults (replaces the NCCL gather_object
    of evaluator.py:602-626)."""
    task = get_task(task_name)
    results = [r for s in shards for r in s.results]
    samples = [r for s in shards for r in s.samples]
    return EvalResult(results=results, metrics=task.aggregate(results),
                      samples=samples)
