"""WorldSense: audio-visual MC benchmark, rebuilt video-side.

Reference: lmms-eval/lmms_eval/tasks/worldsense/utils.py (370 LoC) +
worldsense{,_w_subtitle}.yaml.  The benchmark pairs every video with audio
and subtitles; the *task layer* (prompts, MMMU-style letter parse, the
category x domain x duration x audio-class aggregation) is model-agnostic —
the reference drives it with video-only backbones too, whose audio-dependent
categories simply score lower.  This module rebuilds that task layer with
byte/value parity; the tasks are registered ``wants_audio`` — the harness
extracts the video's audio track (native/audio.cpp) and feeds it to
audio-capable backbones (models/llava_video.py supports_audio), while
video-only backbones run frames-only like the reference's.

Parity notes:
  - ``worldsense_doc_to_text`` (utils.py:188-196) uses FRAMES_TMPL_AUDIO even
    though the adapter may feed frames only; kept byte-identical.
  - The subtitle flavor (utils.py:148-186) picks the subtitle windows covering
    ``frame_num`` uniformly-sampled frames, SORTS the window indices (unlike
    videomme, which keeps raw set order) and joins the RAW subtitle text (no
    <font> filtering).
  - Reference bug preserved-by-intent: utils.py:157-185 NameErrors when the
    subtitle file is missing or ``frame_num`` is absent (``subtitle =
    subtitle_text`` runs unconditionally).  We emit the dead-code intent
    string "No subtitles available" instead of crashing.
  - ``parse_multi_choice_response`` (utils.py:200-254) is the MMMU flavor:
    unguarded bare-letter first pass that *also* sets ans_with_brack, content
    match only past 5 words, deterministic "A" fallback (random.choice is
    commented out in the reference), argmax-rfind tie-break with "(X)"
    probes.
"""

from __future__ import annotations

import os

import numpy as np

from .subtitles import extract_subtitles
from .tasks import TASK_REGISTRY, BenchmarkTask

TASK_CATEGORIES = [
    "Anomaly Recognition", "Event Recognition", "Attribute Recognition",
    "Human Interaction", "Temporal Localization", "Video Emotions",
    "Event Sorting", "Hallucination", "Text and Diagram Understanding",
    "Attribute Reasoning", "Causal Reasoning", "Object Counting",
    "Action Counting", "Temporal Prediction", "Emotion Change",
    "Audio Counting", "Scene Recognition", "Human-object Interaction",
    "Human Emotions", "Object State Change", "Relation Reasoning",
    "Spatial Relation", "Audio Source Localization", "Audio Recognition",
    "Object Existence Recognition", "Audio Change",
]

DOMAINS = ["Tech & Science", "Culture & Politics", "Daily Life", "Film & TV",
           "Performance", "Games", "Sports", "Music"]

BASE_SYS = "Carefully watch this video and pay attention to every detail. "
SYS = (BASE_SYS + "Based on your observations, select the best option that "
       "accurately addresses the question.")

FRAMES_TMPL_NOSUB = """
These are the frames of a video. \
Select the best answer to the following multiple-choice question based on the video. \
Respond with only the letter (A, B, C, or D) of the correct option.
"""

FRAMES_TMPL_SUB = """
These are the frames of a video. \
This video's subtitles are listed below:
"{}"
Select the best answer to the following multiple-choice question based on the video. \
Respond with only the letter (A, B, C, or D) of the correct option.
"""

FRAMES_TMPL_AUDIO = """
These are the frames of a video and the corresponding audio. \
Select the best answer to the following multiple-choice question based on the video. \
Respond with only the letter (A, B, C, or D) of the correct option.
"""


def parse_multi_choice_response(response: str, all_choices: list,
                                index2ans: dict) -> str:
    """worldsense/utils.py:200-254.  The identical function appears verbatim
    in av_odyssey/utils.py:141-196 AND tomato/utils.py:218-273 — the
    codebase keeps ONE implementation, ``tomato_parse_choice``
    (eval/tomato_vinoground.py), delegated to here (module-attr access:
    tomato_vinoground may still be mid-import when this module loads)."""
    from . import tomato_vinoground as _tomato
    return _tomato.tomato_parse_choice(response, all_choices, index2ans)


def _question_block(doc) -> str:
    parts = [doc["question"] + "\n"]
    for op in doc["candidates"]:
        parts.append(op + "\n")
    return "".join(parts)


def worldsense_doc_to_text(doc, lmms_eval_specific_kwargs=None) -> str:
    """worldsense_doc_to_text (utils.py:188-196)."""
    return SYS + FRAMES_TMPL_AUDIO + _question_block(doc)


def worldsense_subtitles_for_frames(video_path: str, subtitle_path: str,
                                    frame_num: int) -> str:
    """Raw subtitle text covering ``frame_num`` uniformly-sampled frames
    (utils.py:160-180): window indices deduped AND sorted, raw text joined —
    both unlike the videomme flavor."""
    subtitle_by_frame, total_frame = extract_subtitles(video_path,
                                                       subtitle_path)
    if frame_num == -1:
        frame_num = total_frame
    uniform = np.linspace(0, total_frame - 1, frame_num, dtype=int).tolist()
    picked = []
    for frame_idx in uniform:
        for idx, (s, e, _) in enumerate(subtitle_by_frame):
            if s <= frame_idx < e:
                picked.append(idx)
    return "\n".join(subtitle_by_frame[idx][2] for idx in sorted(set(picked)))


def worldsense_doc_to_text_subtitle(doc, lmms_eval_specific_kwargs=None) -> str:
    """worldsense_doc_to_text_subtitle (utils.py:148-186).  Path resolution
    via lmms_eval_specific_kwargs "video_root"/"subtitle_root" (the reference
    resolves from $HF_HOME cache_dir); frame_num defaults to the yaml's
    lmms_eval_specific_kwargs.default (worldsense_w_subtitle.yaml:27)."""
    kw = lmms_eval_specific_kwargs or {}
    subtitle_path = kw.get("subtitle_path")
    video_path = kw.get("video_path")
    if subtitle_path is None and kw.get("subtitle_root") \
            and doc.get("subtitle_path"):
        subtitle_path = os.path.join(kw["subtitle_root"], doc["subtitle_path"])
    if video_path is None and kw.get("video_root") and doc.get("video_path"):
        video_path = os.path.join(kw["video_root"], doc["video_path"])
    if subtitle_path and os.path.exists(subtitle_path) and video_path \
            and os.path.exists(video_path):
        # reference byte parity incl. the empty case: a subtitle file with
        # no cue overlapping any sampled frame formats "" into the template
        # (utils.py:180-185)
        subtitle = worldsense_subtitles_for_frames(
            video_path, subtitle_path, int(kw.get("frame_num", 32)))
    else:
        # the reference NameErrors here (utils.py:157-185 dead-intent bug);
        # we emit the intended placeholder instead of crashing
        subtitle = "No subtitles available"
    return SYS + FRAMES_TMPL_SUB.format(subtitle) + _question_block(doc)


def worldsense_process(doc, response, rng=None) -> dict:
    """worldsense_process_results (utils.py:256-285): 3- vs 4-option branch,
    option text stripped of its "A. " prefix for the content pass."""
    options = doc["candidates"]
    letters = ["A", "B", "C"] if len(options) == 3 else ["A", "B", "C", "D"]
    option_list = {letters[i]: options[i][3:] for i in range(len(letters))}
    answer = parse_multi_choice_response(response, letters, option_list)
    gt = doc["answer"]
    assert answer in ["A", "B", "C", "D"] and gt in ["A", "B", "C", "D"]
    return {"question_id": doc.get("index"), "pred_answer": answer,
            "answer": gt, "score": 1.0 if answer == gt else 0.0,
            "category": doc.get("task_type"),
            "domain": doc.get("task_domain"),
            "duration": doc.get("duration"),
            "audio_class": doc.get("audio_class") or []}


def _first_score_means(results: list, key: str) -> dict:
    """Per-group mean over question-dedup'd scores x100
    (utils.py:295-365: each breakdown keeps score[0] per question_id)."""
    group: dict = {}
    for r in results:
        group.setdefault(r[key], {}).setdefault(r["question_id"],
                                                []).append(r["score"])
    return {g: 100.0 * sum(v[0] for v in qs.values()) / len(qs)
            for g, qs in group.items()}


def aggregate_worldsense(results: list) -> dict:
    """worldsense_aggregate_results (utils.py:288-370): overall = mean over
    questions x100, plus category/domain/duration/audio_class breakdowns."""
    if not results:
        return {"overall": 0.0}
    out = {
        "task_categories": _first_score_means(results, "category"),
        "domains": _first_score_means(results, "domain"),
        "durations": _first_score_means(results, "duration"),
    }
    audio: dict = {}
    for r in results:
        for a in r["audio_class"]:
            audio.setdefault(a, {}).setdefault(r["question_id"],
                                               []).append(r["score"])
    out["audio_classes"] = {a: 100.0 * sum(v[0] for v in qs.values()) / len(qs)
                            for a, qs in audio.items()}
    # the reference totals over category2score: one count per
    # (category, question_id) pair, first score wins (utils.py:325-333)
    seen: dict = {}
    for r in results:
        seen.setdefault((r["category"], r["question_id"]), r["score"])
    out["overall"] = 100.0 * sum(seen.values()) / len(seen)
    return out


def register_worldsense() -> None:
    TASK_REGISTRY["WorldSense"] = BenchmarkTask(
        name="WorldSense", doc_to_text=worldsense_doc_to_text,
        process_response=worldsense_process, aggregate=aggregate_worldsense,
        video_path_keys=("video_path",), wants_audio=True)
    TASK_REGISTRY["WorldSense-subtitles"] = BenchmarkTask(
        name="WorldSense-subtitles",
        doc_to_text=worldsense_doc_to_text_subtitle,
        process_response=worldsense_process, aggregate=aggregate_worldsense,
        video_path_keys=("video_path",), wants_audio=True)


register_worldsense()
