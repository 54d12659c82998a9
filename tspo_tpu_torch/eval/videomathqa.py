"""VideoMathQA — mathematical reasoning over video, MCQ + multi-binary.

Reference: lmms-eval/lmms_eval/tasks/videomathqa/utils.py —
  - prompt picks its option instruction by option count (2 -> "A or B",
    else "A, B, C, D or E") and renders option strings verbatim (:113-124);
    the CoT yamls swap the post prompt for a think-step-by-step instruction;
  - the letter parser is the egoplan-family regex, A-E, concatenated-prefix
    quirk included (:200-219);
  - MCQ aggregation is accuracy over a (length x category) grid with
    per-length/per-category rollups (:247-296); the multi-binary ("mbin")
    variant groups the rephrased yes/no probes of one question by
    question_id and requires ALL of them correct (:299-347).
"""

from __future__ import annotations


from .tasks import TASK_REGISTRY, BenchmarkTask

VIDEO_LENGTH = ["short", "medium", "long"]
CATEGORIES = ["Geometry Angle", "Geometry Area", "Geometry Length", "Chart",
              "Statistics", "Arithmetic", "Topology", "Graph Theory",
              "Counting", "Puzzle"]

COT_POST_PROMPT = ("First please perform reasoning, and think step by step "
                   "to provide best answer to the following question with "
                   "the option's letter (A, B, C, D or E) from the given "
                   "choices.")

def videomathqa_extract_letter(s: str) -> str:
    """utils.py:200-219 (A-E) — the shared parser with the reference's
    concatenated-prefix quirk."""
    from .tasks import CONCAT_QUIRK_ANSWER_PREFIXES, extract_answer_letter
    return extract_answer_letter(s, "ABCDE", CONCAT_QUIRK_ANSWER_PREFIXES)


def videomathqa_doc_to_text(doc, lmms_eval_specific_kwargs=None) -> str:
    """utils.py:113-124."""
    kw = lmms_eval_specific_kwargs or {}
    if len(doc["options"]) == 2:
        option_prompt = ("Select the best answer to the following "
                         "multiple-choice question based on the video. "
                         "Respond with the letter (A or B) of the correct "
                         "option.")
    else:
        option_prompt = ("Select the best answer to the following "
                         "multiple-choice question based on the video. "
                         "Respond with the letter (A, B, C, D or E) of the "
                         "correct option.")
    question = doc["question"] + "\n" + "\n".join(doc["options"])
    post = kw.get("post_prompt", "The best answer is:")
    return option_prompt + "\n" + question + "\n" + post


def _process(doc, response, rng=None) -> dict:
    return {"question_id": doc.get("question_id"),
            "duration": doc.get("length"), "category": doc.get("category"),
            "pred_answer": videomathqa_extract_letter(response),
            "answer": doc.get("answer")}


def _grid_rollup(per_key: dict) -> dict:
    out = {}
    for ln in VIDEO_LENGTH:
        c = sum(v["correct"] for k, v in per_key.items() if ln in k)
        a = sum(v["answered"] for k, v in per_key.items() if ln in k)
        if a:
            out[ln] = 100.0 * c / a
    for cat in CATEGORIES:
        c = sum(v["correct"] for k, v in per_key.items() if cat in k)
        a = sum(v["answered"] for k, v in per_key.items() if cat in k)
        if a:
            out[cat] = 100.0 * c / a
    c = sum(v["correct"] for v in per_key.values())
    a = sum(v["answered"] for v in per_key.values())
    out["overall"] = 100.0 * c / a if a else 0.0
    return out


def aggregate_videomathqa_mcq(results: list) -> dict:
    per_key: dict = {}
    for r in results:
        key = f"{r['duration']}_{r['category']}"
        d = per_key.setdefault(key, {"correct": 0, "answered": 0})
        d["answered"] += 1
        d["correct"] += r["pred_answer"] == r["answer"]
    return _grid_rollup(per_key)


def aggregate_videomathqa_mbin(results: list) -> dict:
    """multi-binary: group the rephrased probes by question_id; a question
    counts only if EVERY probe is right (utils.py:299-347)."""
    grouped: dict = {}
    for r in results:
        grouped.setdefault(r["question_id"], []).append(r)
    per_key: dict = {}
    for group in grouped.values():
        meta = group[0]
        key = f"{meta['duration']}_{meta['category']}"
        d = per_key.setdefault(key, {"correct": 0, "answered": 0})
        d["answered"] += 1
        d["correct"] += all(g["pred_answer"] == g["answer"] for g in group)
    return _grid_rollup(per_key)


def register_videomathqa() -> None:
    TASK_REGISTRY["VideoMathQA"] = BenchmarkTask(
        name="VideoMathQA", doc_to_text=videomathqa_doc_to_text,
        process_response=_process, aggregate=aggregate_videomathqa_mcq,
        video_path_keys=("videoID", "video_path"), video_suffix=".mp4")
    TASK_REGISTRY["VideoMathQA-mbin"] = BenchmarkTask(
        name="VideoMathQA-mbin", doc_to_text=videomathqa_doc_to_text,
        process_response=_process, aggregate=aggregate_videomathqa_mbin,
        video_path_keys=("videoID", "video_path"), video_suffix=".mp4")


register_videomathqa()
