"""TimeScope / LongTimeScope (long-video needle benchmarks) and CinePile.

TimeScope-family benchmarks probe exactly the capability TSPO exists for —
finding the relevant moment in hours-long video — so they run naturally on
TSPO-selected frames (``frame_idx`` docs) through the same harness.

Reference sources:
  - lmms-eval/lmms_eval/tasks/{timescope,longtimescope}/utils.py — prompt is
    the bare ``input`` doc field (yaml ``doc_to_text: input``); the A-F
    letter parser differs between the two: timescope fixed the
    implicitly-concatenated prefix strings that longtimescope (and
    egoplan/mmworld) still carry — both flavors preserved here; accuracy
    with per-(length x task_type) breakdown (:83-142).
  - lmms-eval/lmms_eval/tasks/cinepile/utils.py — subtitle-conditioned
    5-option MC with "- X) option" bullets (:47-74), answer extracted by
    ``normalize_string`` ("Answer: X) text" / bare letter) and matched on
    letter+text (:87-131), per-category x hard-split aggregation
    (:153-201).
"""

from __future__ import annotations

import re

from .tasks import TASK_REGISTRY, BenchmarkTask

# ---------------------------------------------------------------------------
# TimeScope / LongTimeScope
# ---------------------------------------------------------------------------

from .tasks import _ANSWER_PREFIXES as _TS_PREFIXES  # timescope: fixed list
from .tasks import CONCAT_QUIRK_ANSWER_PREFIXES as _LTS_PREFIXES  # longtimescope
from .tasks import extract_answer_letter as _extract


def timescope_extract_letter(s: str, prefixes=_TS_PREFIXES) -> str:
    """{long,}timescope extract_characters_regex: A-F letters; timescope
    uses the fixed prefix list, longtimescope the concatenated-quirk one
    (the two reference files genuinely differ there)."""
    return _extract(s, "ABCDEF", prefixes)


def timescope_doc_to_text(doc, lmms_eval_specific_kwargs=None) -> str:
    """yaml ``doc_to_text: input`` — the bare field, kwargs unused."""
    return doc["input"]


def _make_timescope_process(prefixes):
    def process(doc, response, rng=None) -> dict:
        return {"id": doc.get("id"), "length": doc.get("length"),
                "video": doc.get("video"), "task_type": doc.get("type"),
                "pred_answer": timescope_extract_letter(response, prefixes),
                "answer": doc.get("answer")}
    return process


def aggregate_timescope(results: list) -> dict:
    """accuracy + per-(length x task_type) and per-length breakdowns
    ({long,}timescope_aggregate_results)."""
    def acc(rows):
        return (100.0 * sum(str(r["pred_answer"]).lower()
                            == str(r["answer"]).lower() for r in rows)
                / len(rows)) if rows else 0.0
    out = {}
    by_len: dict = {}
    by_key: dict = {}
    for r in results:
        by_len.setdefault(r.get("length"), []).append(r)
        by_key.setdefault(f"{r.get('length')}_{r.get('task_type')}",
                          []).append(r)
    for k, rows in sorted(by_key.items(), key=lambda kv: str(kv[0])):
        out[k] = acc(rows)
    for ln, rows in sorted(by_len.items(), key=lambda kv: str(kv[0])):
        out[f"length_{ln}"] = acc(rows)
    out["overall"] = acc(results)
    return out


# ---------------------------------------------------------------------------
# CinePile
# ---------------------------------------------------------------------------

CINEPILE_CATEGORIES = ["Character and\nRelationship Dynamics",
                       "Narrative and\nPlot Analysis",
                       "Setting and\nTechnical Analysis", "Temporal",
                       "Theme Exploration"]
CINEPILE_PRE_PROMPT = (
    "You will be provided with subtitles from a specific scene of a movie "
    "and all the video frames from that scene. After going through the "
    "movie scene and seeing the frames, please answer the question that "
    "follows. The question will have five possible answers labeled A, B, "
    "C, D, and E, please try to provide the most probable answer in your "
    "opinion. Your output should be just one of A,B,C,D,E and nothing "
    "else.\n**Output Format:**\n\t**Answer:** <Option_key>")
CINEPILE_POST_PROMPT = (
    "Note: Follow the output format strictly. Only answer with the option "
    "key (A, B, C, D, E) and nothing else.")


def format_question_and_options(question: str, options: list) -> str:
    """cinepile/utils.py:47-62 — "- X) option" bullet lines."""
    out = f"{question}\n"
    for label, option in zip((chr(ord("A") + i) for i in range(len(options))),
                             options):
        out += f"- {label}) {option}\n"
    return out


def cinepile_doc_to_text(doc, lmms_eval_specific_kwargs=None) -> str:
    kw = lmms_eval_specific_kwargs or {}
    pre = kw.get("pre_prompt", CINEPILE_PRE_PROMPT)
    post = kw.get("post_prompt", CINEPILE_POST_PROMPT)
    q = format_question_and_options(doc["question"], doc["choices"])
    return f"{pre}\n\n**Subtitles:**\n{doc['subtitles']}\n\n{q}\n{post}"


def cinepile_normalize(input_string: str):
    """cinepile/utils.py:87-105 ``normalize_string``: (letter, text)."""
    input_string = input_string.replace("*", "").strip()
    if re.match(r"^[A-E]$", input_string, re.IGNORECASE):
        return input_string.upper(), ""
    m = re.search(r"Answer:\s*([A-E])\)?\.?\s*(.*)", input_string,
                  re.IGNORECASE)
    if m:
        return m.group(1).upper(), m.group(2).strip()
    return None, input_string.strip()


def cinepile_eval_response(response: str, answer_letter: str,
                           answer_text: str) -> int:
    """cinepile/utils.py:108-131 ``evaluate_semantic_similarity``."""
    num, text = cinepile_normalize(response)
    if answer_letter and num:
        if answer_letter == num:
            if answer_text and text:
                return int(answer_text.lower() == text.lower())
            return 1
    elif answer_text.lower() == text.lower():
        return 1
    return 0


def _cinepile_process(doc, response, rng=None) -> dict:
    answer_letter = {0: "A", 1: "B", 2: "C", 3: "D", 4: "E"}[
        doc["answer_key_position"]]
    return {"question": doc.get("question"),
            "question_category": doc.get("question_category"),
            "hard_split": doc.get("hard_split"),
            "pred_answer": response, "answer": answer_letter,
            "correct": cinepile_eval_response(response, answer_letter,
                                              doc["answer_key"])}


def aggregate_cinepile(results: list) -> dict:
    def acc(rows):
        return (100.0 * sum(r["correct"] for r in rows) / len(rows)
                if rows else 0.0)
    out = {}
    for cat in CINEPILE_CATEGORIES:
        rows = [r for r in results if r.get("question_category") == cat]
        if rows:
            key = cat.replace("\n", " ")
            out[key] = acc(rows)
            hard = [r for r in rows if str(r.get("hard_split")) == "True"]
            if hard:
                out[f"{key} (hard)"] = acc(hard)
    out["overall"] = acc(results)
    return out


def register_timescope_cinepile() -> None:
    TASK_REGISTRY["TimeScope"] = BenchmarkTask(
        name="TimeScope", doc_to_text=timescope_doc_to_text,
        process_response=_make_timescope_process(_TS_PREFIXES),
        aggregate=aggregate_timescope,
        video_path_keys=("video", "video_path"))
    TASK_REGISTRY["LongTimeScope"] = BenchmarkTask(
        name="LongTimeScope", doc_to_text=timescope_doc_to_text,
        process_response=_make_timescope_process(_LTS_PREFIXES),
        aggregate=aggregate_timescope,
        video_path_keys=("video", "video_path"))
    TASK_REGISTRY["CinePile"] = BenchmarkTask(
        name="CinePile", doc_to_text=cinepile_doc_to_text,
        process_response=_cinepile_process, aggregate=aggregate_cinepile,
        video_path_keys=("videoID", "video_path"), video_suffix=".mp4")


register_timescope_cinepile()
