"""Benchmark task registry: prompts, answer parsing, metric aggregation.

Re-implements the per-benchmark logic of the reference's vendored lmms-eval
tasks for the four TSPO benchmarks (SURVEY.md C32):
  - LongVideoBench: letter parse with random fallback, plain accuracy
    (tasks/longvideobench/utils.py:196-256)
  - MLVU dev: micro-average over 7 task types (tasks/mlvu/utils.py:109-148)
  - VideoMME: accuracy by duration x domain x sub_category x task_type
    (tasks/videomme/utils.py:260-340)
  - LVBench: plain accuracy over the meta jsonl questions
"""

from __future__ import annotations

import random
import re
from dataclasses import dataclass
from typing import Callable

_ANSWER_PREFIXES = [
    "The best answer is",
    "The correct answer is",
    "The answer is",
    "The answer",
    "The best option is",
    "The correct option is",
    "Best answer:",
    "Best option:",
]

# several reference task files (egoplan, mmworld, longtimescope, videomathqa)
# carry a variant of the list with two pairs IMPLICITLY CONCATENATED — a
# reference bug preserved verbatim because it changes which prefixes strip
CONCAT_QUIRK_ANSWER_PREFIXES = [
    "The best answer is",
    "The correct answer is",
    "The answer is",
    "The answer",
    "The best option is" "The correct option is",
    "Best answer:" "Best option:",
]


def extract_answer_letter(response: str, letters: str = "ABCD",
                          prefixes=None) -> str:
    """Letter parse shared by the extract_characters_regex family: strip
    known prefixes, fail to "" on long answers without a letter, else first
    letter.  The DEFAULT separate prefix list matches video-tt/utils.py:126;
    videomme/mlvu (utils.py:232-239) and the egoplan family carry the
    concatenated prefix-pair quirk — those call sites pass
    ``prefixes=CONCAT_QUIRK_ANSWER_PREFIXES`` (fuzz-verified per flavor,
    tests/test_parser_fuzz.py)."""
    s = response.strip()
    for prefix in (prefixes if prefixes is not None else _ANSWER_PREFIXES):
        s = s.replace(prefix, "")
    if len(s.split()) > 10 and not re.search(f"[{letters}]", s):
        return ""
    m = re.search(f"[{letters}]", s)
    return m[0] if m else ""


def parse_multi_choice_response(response: str, all_choices: list,
                                rng: random.Random | None = None) -> str:
    """LongVideoBench-style parse (tasks/longvideobench/utils.py:196-223):
    random choice fallback when no letter found (original paper behavior).

    The regex class is the FIXED ``[ABCDE]`` of the reference — even a
    4-option doc parses a stray capital E (e.g. "Either...") as the
    prediction "E" rather than falling to the random choice
    (longvideobench/utils.py:218-222); ``all_choices`` only feeds the
    fallback (fuzz-verified, tests/test_parser_fuzz.py)."""
    rng = rng or random
    s = response.strip()
    for prefix in _ANSWER_PREFIXES:
        s = s.replace(prefix, "")
    if len(s.split()) > 10 and not re.search("[ABCDE]", s):
        return rng.choice(all_choices)
    m = re.search("[ABCDE]", s)
    if m is None:
        return rng.choice(all_choices)
    return m[0]


def _accuracy(results: list) -> float:
    if not results:
        return 0.0
    return 100.0 * sum(r["pred_answer"] == r["answer"] for r in results) / len(results)


def aggregate_accuracy(results: list) -> dict:
    return {"overall": _accuracy(results)}


MLVU_DEV_TASK_TYPES = ("anomaly_reco", "count", "ego", "needle", "order",
                       "plotQA", "topic_reasoning")


def aggregate_mlvu_dev(results: list) -> dict:
    """Micro-average + per-task-type accuracy (tasks/mlvu/utils.py:109-148)."""
    out = {}
    for t in MLVU_DEV_TASK_TYPES:
        sub = [r for r in results if r.get("task_type") == t]
        out[t] = _accuracy(sub)
    out["overall"] = _accuracy(results)
    return out


VIDEOMME_DURATIONS = ("short", "medium", "long")


def aggregate_videomme(results: list) -> dict:
    """Overall + per-duration accuracy; per-category available under
    'categories' (tasks/videomme/utils.py:281-340)."""
    out = {}
    for d in VIDEOMME_DURATIONS:
        sub = [r for r in results if r.get("duration") == d]
        out[d] = _accuracy(sub)
    cats = {}
    for r in results:
        cats.setdefault(r.get("category", "?"), []).append(r)
    out["categories"] = {k: _accuracy(v) for k, v in sorted(cats.items())}
    out["overall"] = _accuracy(results)
    return out


# ---------------------------------------------------------------------------
# Per-benchmark doc handling for phase-2
# ---------------------------------------------------------------------------

# Per-task lmms_eval_specific_kwargs defaults.  The reference selects the
# model-name key when it matches exactly, else merges in "default"
# (api/task.py:793-800); the TSPO adapters are named llava_vid_tspo /
# qwen2_5_vl_tspo — neither matches a yaml key — so "default" applies.
LVB_DEFAULT_KWARGS = {
    # longvideobench_val_v.yaml:24-27
    "pre_prompt": "",
    "post_prompt": "Answer with the option's letter from the given choices "
                   "directly.\n",
}
VIDEOMME_DEFAULT_KWARGS = {
    # videomme.yaml lmms_eval_specific_kwargs.default (NOT the llava_vid key,
    # which only applies to the exact model name "llava_vid")
    "pre_prompt": "",
    "post_prompt": "\nAnswer with the option's letter from the given choices "
                   "directly.",
}


def _lvb_doc_to_text(doc, lmms_eval_specific_kwargs=None) -> str:
    """longvideobench_doc_to_text (tasks/longvideobench/utils.py:114-142),
    non-subtitle branch."""
    kw = {**LVB_DEFAULT_KWARGS, **(lmms_eval_specific_kwargs or {})}
    cands = doc.get("candidates") or []
    q = doc["question"] + "\n" + "\n".join(
        f"{chr(ord('A') + i)}. {c}" for i, c in enumerate(cands))
    return f"{kw['pre_prompt']}{q}\n{kw['post_prompt']}"


def _mlvu_doc_to_text(doc, lmms_eval_specific_kwargs=None) -> str:
    """mlvu_doc_to_text (tasks/mlvu/utils.py:63-67) — ignores the yaml
    kwargs entirely; option_prompt is hardcoded empty."""
    return "\n" + doc["question"] + "\nOnly give the best option.\n" + "\nBest option: ("


def _videomme_doc_to_text(doc, lmms_eval_specific_kwargs=None) -> str:
    """videomme_doc_to_text (tasks/videomme/utils.py:150-158)."""
    kw = {**VIDEOMME_DEFAULT_KWARGS, **(lmms_eval_specific_kwargs or {})}
    option_prompt = ("Select the best answer to the following multiple-choice "
                     "question based on the video and the subtitles. Respond "
                     "with only the letter (A, B, C, or D) of the correct option.")
    question = doc["question"] + "\n" + "\n".join(doc.get("options", []))
    return option_prompt + "\n" + question + "\n" + kw["post_prompt"]


def _lvb_process(doc, response, rng=None) -> dict:
    cands = doc.get("candidates") or []
    all_choices = [chr(ord("A") + i) for i in range(len(cands))]
    pred = parse_multi_choice_response(response, all_choices or list("ABCD"), rng)
    answer = chr(ord("A") + int(doc["correct_choice"])) \
        if "correct_choice" in doc else doc.get("answer")
    return {"id": doc.get("id"), "pred_answer": pred, "answer": answer}


def _mlvu_process(doc, response, rng=None) -> dict:
    # mlvu's extract_characters_regex carries the CONCATENATED prefix-pair
    # quirk (mlvu/utils.py:71-78): "Best answer: C" parses as "B" from the
    # unstripped "Best" — preserved (tests/test_parser_fuzz.py)
    return {"question_id": doc.get("question_id"),
            "task_type": doc.get("task_type"),
            "pred_answer": extract_answer_letter(
                response, "ABCD", CONCAT_QUIRK_ANSWER_PREFIXES),
            "answer": doc.get("answer")}


def _videomme_process(doc, response, rng=None) -> dict:
    # videomme/utils.py:232-239 has the same concatenated prefix-pair quirk
    return {"question_id": doc.get("question_id"),
            "duration": doc.get("duration"),
            "category": doc.get("domain"),
            "sub_category": doc.get("sub_category"),
            "task_type": doc.get("task_type"),
            "pred_answer": extract_answer_letter(
                response, "ABCD", CONCAT_QUIRK_ANSWER_PREFIXES),
            "answer": doc.get("answer")}


def _lvbench_process(doc, response, rng=None) -> dict:
    return {"question_id": doc.get("question_id"),
            "pred_answer": extract_answer_letter(response),
            "answer": doc.get("answer")}


def default_doc_to_choices(doc) -> list:
    """Continuation strings for loglikelihood-style multiple choice
    (evaluator.py:501 request-type dispatch; api/task.py construct_requests).
    LVB docs carry ``candidates`` (bare texts); VideoMME/MLVU docs carry
    ``options`` ("A. text" strings)."""
    if doc.get("candidates"):
        return [str(c) for c in doc["candidates"]]
    if doc.get("options"):
        return [str(o) for o in doc["options"]]
    raise KeyError("doc has neither 'candidates' nor 'options'")


def clip_query_text(doc) -> str:
    """CLIP query for live scoring: the SAME strip rule phase-1 applies to
    its prompt (datasets.py::problem_text, matching gen_id_tspo.py:62-65) —
    drop image tokens, the "Question: " prefix, and everything from
    "\\nOptions" on.  Keeps live-scored frame indices identical to
    precomputed ones for docs whose question field embeds options text."""
    q = str(doc.get("question", ""))
    q = q.replace("<image>\n", "").replace("<image>", "")
    # replace EVERYWHERE, not just a leading prefix — datasets.py:95 uses
    # str.replace, and a pre_prompt can push the marker mid-string
    q = q.replace("Question: ", "")
    return q.split("\nOptions")[0]


@dataclass(frozen=True)
class BenchmarkTask:
    name: str
    doc_to_text: Callable
    process_response: Callable
    aggregate: Callable
    video_path_keys: tuple = ("video_path",)
    # lmms-eval output_type: "generate_until" (all 4 TSPO tasks) or
    # "loglikelihood" (choice scored by continuation logprob, argmax wins)
    output_type: str = "generate_until"
    doc_to_choices: Callable = default_doc_to_choices
    # rank loglikelihood choices by per-token mean instead of sum — the
    # reference mc_ppl adapters return the mean CE loss per choice and argmin
    # it (llava_vid.py loglikelihood), i.e. length-normalized ranking
    ll_length_normalize: bool = False
    # fixed directory between video_root and the doc's video name (MVBench
    # keeps one folder per sub-task, mvbench/utils.py DATA_LIST)
    video_subdir: str = ""
    # appended when the doc's video name has no extension (EgoSchema and
    # PerceptionTest docs carry bare ids, egoschema/utils.py:38)
    video_suffix: str = ""
    # optional (doc, frames, frame_idx) -> frames hook applied after frame
    # loading — PLM-VideoBench STC tasks draw per-frame bounding boxes on the
    # gathered frames (plm_videobench/eval_utils.py::draw_bounding_boxes)
    transform_frames: Callable | None = None
    # multi-round chat tasks (lmms api/model.py generate_until_multi_round):
    # with output_type "generate_until_multi_round" the harness asks
    # num_rounds questions over the same video, feeding each round's answer
    # back as conversation context; round_prompt(doc, round_idx, responses,
    # specific_kwargs) builds the per-round question (doc_to_text when None)
    num_rounds: int = 1
    round_prompt: Callable | None = None
    # CUVA fallback: when the resolved path is missing, retry with "mp4"
    # replaced by "MP4" everywhere, exactly like cuva_doc_to_visual
    # (cuva/utils.py:108-118)
    upper_ext_fallback: bool = False
    # audio-visual tasks (WorldSense / AV-Odyssey): the harness extracts the
    # video's audio track (native/audio.cpp) and passes it to audio-capable
    # backbones (generate(audio=...)); video-only backbones run as before
    wants_audio: bool = False
    # (doc, video_root) -> audio file path or None, for tasks whose audio is
    # a STANDALONE clip rather than the video's own track (AV-Odyssey
    # audio_path files); None = use the video's track
    resolve_audio: Callable | None = None
    # (doc) -> str hook overriding the live-scoring CLIP query; default is
    # clip_query_text (the phase-1 "\nOptions"-strip rule) so live and
    # precomputed frame indices agree
    clip_query: Callable | None = None

    def resolve_video(self, doc, video_root: str = "") -> str:
        import os
        for key in self.video_path_keys:
            if key in doc and doc[key]:
                val = doc[key]
                # AV-Odyssey docs carry media-path LISTS (av_odyssey/utils.py
                # doc_to_visual); the harness consumes the first video
                name = str(val[0]) if isinstance(val, (list, tuple)) else str(val)
                if self.video_suffix and not os.path.splitext(name)[1]:
                    name += self.video_suffix
                path = os.path.join(video_root, self.video_subdir, name)
                if self.upper_ext_fallback and not os.path.exists(path) \
                        and os.path.exists(path.replace("mp4", "MP4")):
                    path = path.replace("mp4", "MP4")
                return path
        raise KeyError(f"no video path in doc (tried {self.video_path_keys})")


TASK_REGISTRY = {
    "LongVideoBench": BenchmarkTask(
        name="LongVideoBench", doc_to_text=_lvb_doc_to_text,
        process_response=_lvb_process, aggregate=aggregate_accuracy,
        video_path_keys=("video_path",)),
    "MLVU": BenchmarkTask(
        name="MLVU", doc_to_text=_mlvu_doc_to_text,
        process_response=_mlvu_process, aggregate=aggregate_mlvu_dev,
        video_path_keys=("video_name", "video_path")),
    "VideoMME": BenchmarkTask(
        name="VideoMME", doc_to_text=_videomme_doc_to_text,
        process_response=_videomme_process, aggregate=aggregate_videomme,
        video_path_keys=("videoID", "video_path")),
    # LVBench phase-2 is an EXTENSION: the reference evaluates only
    # LVB/MLVU/VideoMME (evaluation/TSPO_llava_video.sh exits "doesn't
    # support this dataset"; its lmms-eval ships no lvbench task dir) — the
    # reference stops at LVBench frame-index precompute.  The prompt format
    # here (VideoMME-style options + letter instruction) is pinned by
    # tests/test_task_prompts.py so it cannot drift silently.
    "LVBench": BenchmarkTask(
        name="LVBench", doc_to_text=_videomme_doc_to_text,
        process_response=_lvbench_process, aggregate=aggregate_accuracy,
        video_path_keys=("video_path", "key")),
}


def _register_subtitle_variants():
    """Subtitle variants (videomme_w_subtitle / longvideobench_val_i):
    pass subtitle_root (+ video_root, frame_num for VideoMME) through
    lmms_eval_specific_kwargs — e.g. ``tspo-evaluate --task
    VideoMME-subtitles --subtitle-root <dir>``."""
    from .subtitles import (lvb_doc_to_text_interleaved,
                            videomme_doc_to_text_subtitle)
    TASK_REGISTRY["VideoMME-subtitles"] = BenchmarkTask(
        name="VideoMME-subtitles", doc_to_text=videomme_doc_to_text_subtitle,
        process_response=_videomme_process, aggregate=aggregate_videomme,
        video_path_keys=("videoID", "video_path"))
    TASK_REGISTRY["LongVideoBench-interleaved"] = BenchmarkTask(
        name="LongVideoBench-interleaved",
        doc_to_text=lvb_doc_to_text_interleaved,
        process_response=_lvb_process, aggregate=aggregate_accuracy,
        video_path_keys=("video_path",))


_register_subtitle_variants()


def make_judged_task(name: str, judge, doc_to_text: Callable | None = None,
                     question_key: str = "question",
                     answer_key: str = "answer",
                     video_path_keys: tuple = ("video_path",),
                     custom_prompt: str | None = None) -> BenchmarkTask:
    """Build an open-ended task graded by an LLM judge (SURVEY.md C35).

    Many lmms-eval tasks score free-form answers with a model judge instead
    of letter parsing (lmms_eval/llm_judge used from task process_results).
    ``judge`` is any eval.llm_judge.JudgeProvider; each response is graded
    binary against the gold answer and the aggregate is mean judge accuracy
    (plus a judge_failures count — failed judge calls score 0 but are
    reported, never silently dropped)."""
    if doc_to_text is None:
        def doc_to_text(doc, lmms_eval_specific_kwargs=None):
            kw = lmms_eval_specific_kwargs or {}
            return (kw.get("pre_prompt", "") + str(doc[question_key])
                    + kw.get("post_prompt", ""))

    def process(doc, response, rng=None):
        res = judge.evaluate_binary(str(doc[question_key]),
                                    str(doc[answer_key]), response,
                                    custom_prompt=custom_prompt)
        return {"question_id": doc.get("question_id", doc.get("id")),
                "pred_answer": response, "answer": doc.get(answer_key),
                "judge_score": int(res.parsed or 0),
                "judge_success": bool(res.success),
                "judge_raw": res.content}

    def aggregate(results: list) -> dict:
        if not results:
            return {"overall": 0.0, "judge_failures": 0}
        return {"overall": 100.0 * sum(r["judge_score"] for r in results)
                / len(results),
                "judge_failures": sum(not r["judge_success"]
                                      for r in results)}

    return BenchmarkTask(name=name, doc_to_text=doc_to_text,
                         process_response=process, aggregate=aggregate,
                         video_path_keys=video_path_keys)


def register_judged_task(name: str, judge, **kw) -> BenchmarkTask:
    """Create + register a judge-graded task under ``name``."""
    task = make_judged_task(name, judge, **kw)
    TASK_REGISTRY[name] = task
    return task


def get_task(name: str) -> BenchmarkTask:
    return TASK_REGISTRY[name]


# widen the registry (MVBench/EgoSchema/NExT-QA/PerceptionTest, TempCompass
# rule-only — the CLI re-registers TempCompass with a judge when --judge is
# given); imported last so these modules can import the dataclass + helpers
from . import camerabench as _camerabench  # noqa: E402,F401
from . import extra_tasks as _extra_tasks  # noqa: E402,F401
from . import more_tasks as _more_tasks  # noqa: E402,F401
from . import timescope_cinepile as _timescope_cinepile  # noqa: E402,F401
from . import tomato_vinoground as _tomato_vinoground  # noqa: E402,F401
from . import videomathqa as _videomathqa  # noqa: E402,F401
from . import video_tt as _video_tt  # noqa: E402,F401
from . import videommmu as _videommmu  # noqa: E402,F401
from . import vitatecs as _vitatecs  # noqa: E402,F401
from . import spatial_tasks as _spatial_tasks  # noqa: E402,F401
from . import tempcompass as _tempcompass  # noqa: E402,F401
from . import grounding_tasks as _grounding_tasks  # noqa: E402,F401
from . import worldsense as _worldsense  # noqa: E402,F401
from . import av_odyssey as _av_odyssey  # noqa: E402,F401
from . import captioning_tasks as _captioning_tasks  # noqa: E402,F401
from . import mmvu as _mmvu  # noqa: E402,F401
from . import plm_videobench as _plm_videobench  # noqa: E402,F401
from . import funqa as _funqa  # noqa: E402,F401
