"""Video-TT (Video Turing Test) — adversarial web-video QA.

Reference: lmms-eval/lmms_eval/tasks/video-tt/utils.py — prompt is
``pre + "\\n" + question + "\\n" + question_prompt + "\\n" + post`` with
"The best answer is:" as the default post (:76-85); letters parse with the
FIXED prefix list over A-E (:124-144); accuracy with a per-capability
breakdown over the 18 capability categories (:193-225).  The open-ended
variant's aggregate consumes an externally-produced ``correctness`` field
(1-5, counted correct at >=3, :228-261) — here docs carrying
``correctness`` aggregate the same way, and docs without it can be graded
first through a judged task.
"""

from __future__ import annotations

from .tasks import TASK_REGISTRY, BenchmarkTask, extract_answer_letter

VIDEOTT_CATEGORIES = [
    "Objective Causality",
    "Objective Causality (Videography Phenomenon & Illusion)",
    "Element Attributes (Optical Illusion)",
    "Displacement Attribute",
    "Plot Attribute (Montage)",
    "Plot Attribute",
    "Element Attributes",
    "Element Counting",
    "Professional Knowledge",
    "Character Motivation Causality",
    "Element Localization",
    "Character Reaction Causality",
    "Event Counting",
    "Local Event Attribute",
    "Event Localization",
    "Positional Relationship",
    "Event Duration & Speed Attribute",
    "Character Emotion Attribute",
]


# videott_all.yaml default kwargs: BOTH prompts empty — the in-function
# "The best answer is:" fallback only fires when post_prompt is absent from
# the merged kwargs, which never happens on a default run
VIDEOTT_DEFAULT_KWARGS = {"pre_prompt": "", "post_prompt": ""}


def videott_doc_to_text(doc, lmms_eval_specific_kwargs=None) -> str:
    """utils.py:76-85."""
    kw = {**VIDEOTT_DEFAULT_KWARGS, **(lmms_eval_specific_kwargs or {})}
    question = doc["question"] + "\n" + doc["question_prompt"]
    post = kw["post_prompt"] if "post_prompt" in kw else "The best answer is:"
    pre = kw["pre_prompt"]
    return pre + "\n" + question + "\n" + post


def _videott_process(doc, response, rng=None) -> dict:
    return {"video_id": doc.get("video_id"),
            "capability": doc.get("capability"),
            "pred_answer": extract_answer_letter(response, "ABCDE"),
            "answer": doc.get("answer")}


def _videott_process_oe(doc, response, rng=None) -> dict:
    """utils.py:176-190: raw response kept; ``correctness`` (1-5) is
    carried from the doc when an external grading step supplied it."""
    rec = {"video_id": doc.get("video_id"),
           "capability": doc.get("capability"),
           "pred_answer": response, "answer": doc.get("answer")}
    if "correctness" in doc:
        rec["correctness"] = doc["correctness"]
    return rec


def _aggregate(results: list, correct_fn) -> dict:
    # the reference rolls categories up by SUBSTRING containment
    # (``if category in k``, utils.py:210): umbrella categories like
    # "Plot Attribute" include their parenthesized variants
    out = {}
    for cat in VIDEOTT_CATEGORIES:
        rows = [r for r in results
                if cat in str(r.get("capability", ""))]
        if rows:
            out[cat] = 100.0 * sum(correct_fn(r) for r in rows) / len(rows)
    out["overall"] = (100.0 * sum(correct_fn(r) for r in results)
                      / len(results) if results else 0.0)
    return out


def aggregate_videott(results: list) -> dict:
    return _aggregate(results, lambda r: r["pred_answer"] == r["answer"])


def aggregate_videott_oe(results: list) -> dict:
    """utils.py:228-261: correctness >= 3 counts correct.  Docs never graded
    (no ``correctness``) are surfaced, not silently scored wrong."""
    out = _aggregate(results, lambda r: int(r.get("correctness", 0)) >= 3)
    out["ungraded"] = sum(1 for r in results if "correctness" not in r)
    return out


def register_video_tt() -> None:
    TASK_REGISTRY["Video-TT"] = BenchmarkTask(
        name="Video-TT", doc_to_text=videott_doc_to_text,
        process_response=_videott_process, aggregate=aggregate_videott,
        video_path_keys=("video_id", "video_path"), video_suffix=".mp4")
    TASK_REGISTRY["Video-TT-oe"] = BenchmarkTask(
        name="Video-TT-oe", doc_to_text=videott_doc_to_text,
        process_response=_videott_process_oe, aggregate=aggregate_videott_oe,
        video_path_keys=("video_id", "video_path"), video_suffix=".mp4")


register_video_tt()
