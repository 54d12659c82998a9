"""VSIBench (visual-spatial intelligence) + EgoPlan benchmark tasks.

Reference sources:
  - lmms-eval/lmms_eval/tasks/vsibench/utils.py — two answer modes:
    multiple-choice types scored by fuzzy exact match (:80-85, :113-117) and
    numeric-answer types scored by Mean Relative Accuracy over the .5:.95:.05
    confidence sweep (:88-96); per-type aggregation merges the three
    rel_direction difficulties and averages everything into ``overall``
    (:130-164).  Prompts: :57-70 + vsibench.yaml defaults.
  - lmms-eval/lmms_eval/tasks/egoplan/utils.py — prompt built from
    ``task_goal`` with the -ing/goal phrasing branches and a HARDCODED post
    prompt (:138-166 — the yaml kwargs are ignored by the function);
    letter parse :169-189 keeps the reference's quirk of two
    implicitly-concatenated prefix strings; accuracy vs
    ``golden_choice_idx`` (:192-207).
"""

from __future__ import annotations

import os

import numpy as np

from .tasks import TASK_REGISTRY, BenchmarkTask

# ---------------------------------------------------------------------------
# VSIBench
# ---------------------------------------------------------------------------

MCA_QUESTION_TYPES = [
    "object_rel_direction_easy",
    "object_rel_direction_medium",
    "object_rel_direction_hard",
    "object_rel_distance",
    "route_planning",
    "obj_appearance_order",
]
NA_QUESTION_TYPES = [
    "object_abs_distance",
    "object_counting",
    "object_size_estimation",
    "room_size_estimation",
]


def vsibench_doc_to_text(doc, lmms_eval_specific_kwargs=None) -> str:
    """vsibench/utils.py:57-70 (yaml defaults when kwargs are empty)."""
    kw = lmms_eval_specific_kwargs or {}
    pre = kw.get("pre_prompt", "") or "These are frames of a video."
    q = doc["question"]
    if doc["question_type"] in NA_QUESTION_TYPES:
        post = kw.get("na_post_prompt", "") or \
            "Please answer the question using a single word or phrase."
        return pre + "\n" + q + "\n" + post
    if doc["question_type"] in MCA_QUESTION_TYPES:
        options = "Options:\n" + "\n".join(doc["options"])
        post = kw.get("mca_post_prompt", "") or \
            "Answer with the option's letter from the given choices directly."
        return "\n".join([pre, q, options, post])
    raise ValueError(f"Unknown question type: {doc['question_type']}")


def fuzzy_matching(pred: str) -> str:
    """utils.py:80-81: first whitespace token, trailing period stripped."""
    return pred.split(" ")[0].rstrip(".").strip()


def mean_relative_accuracy(pred: float, target: float, start=0.5, end=0.95,
                           interval=0.05) -> float:
    """utils.py:88-96: fraction of confidence thresholds theta in
    linspace(.5,.95) where |pred-target|/target <= 1-theta.  NB the
    reference's ``int((end-start)/interval + 2)`` truncates 10.999... to 10
    points (float quirk) — reproduced, since it changes every score."""
    num_pts = (end - start) / interval + 2
    thresholds = np.linspace(start, end, int(num_pts))
    rel_err = abs(pred - target) / target
    return float((rel_err <= 1 - thresholds).mean())


def _to_float(x):
    try:
        return float(x)
    except Exception:  # noqa: BLE001 — reference catches BaseException
        return None


def _vsibench_process(doc, response, rng=None) -> dict:
    qt = doc["question_type"]
    rec = {"question_id": doc.get("id", doc.get("question_id")),
           "question_type": qt, "prediction": response,
           "ground_truth": doc["ground_truth"]}
    if qt in MCA_QUESTION_TYPES:
        rec["accuracy"] = 1.0 if (fuzzy_matching(response).lower()
                                  == str(doc["ground_truth"]).lower()) else 0.0
    elif qt in NA_QUESTION_TYPES:
        pred = _to_float(fuzzy_matching(response))
        tgt = _to_float(doc["ground_truth"])
        try:
            rec["mra"] = mean_relative_accuracy(pred, tgt)
        except TypeError:
            rec["mra"] = 0.0          # WORST_CASE (utils.py:99-102,120-123)
    else:
        raise ValueError(f"Unknown question type: {qt}")
    return rec


def aggregate_vsibench(results: list) -> dict:
    """utils.py:130-164: per-type means, rel_direction merged, flat mean
    overall."""
    out = {}
    by_type: dict = {}
    for r in results:
        by_type.setdefault(r["question_type"], []).append(r)
    for qt, rows in by_type.items():
        if qt in MCA_QUESTION_TYPES:
            out[f"{qt}_accuracy"] = float(np.mean([r["accuracy"]
                                                   for r in rows]))
        else:
            out[f"{qt}_MRA:.5:.95:.05"] = float(np.mean([r["mra"]
                                                         for r in rows]))
    dir_keys = [f"object_rel_direction_{d}_accuracy"
                for d in ("easy", "medium", "hard")]
    if all(k in out for k in dir_keys):
        out["object_rel_direction_accuracy"] = \
            sum(out.pop(k) for k in dir_keys) / 3.0
    out["overall"] = (sum(out.values()) / len(out)) if out else 0.0
    return out


class _VSIBenchTask(BenchmarkTask):
    """video at <root>/<dataset>/<scene_name>.mp4 (utils.py:46-54)."""

    def resolve_video(self, doc, video_root: str = "") -> str:
        if doc.get("video_path"):
            return os.path.join(video_root, str(doc["video_path"]))
        return os.path.join(video_root, doc["dataset"],
                            doc["scene_name"] + ".mp4")


# ---------------------------------------------------------------------------
# EgoPlan
# ---------------------------------------------------------------------------

def egoplan_doc_to_text(doc, lmms_eval_specific_kwargs=None) -> str:
    """egoplan/utils.py:138-166 — NOTE the function ignores the yaml kwargs
    and hardcodes its post prompt (without the trailing ' directly.')."""
    task_goal = doc["task_goal"]
    if "goal" in task_goal:
        task_goal = task_goal.split("to", 1)[1].strip()
    if task_goal.split()[0].endswith("ing"):
        pattern = ("I am tasked with {}. "
                   "The task's progress is demonstrated in the provided "
                   "video. My current field of view is shown in the "
                   "provided image. What should be my next action? "
                   "Please output the most reasonable action you think, "
                   "expressed in a short phrase.")
    else:
        pattern = ("My current task is to {}. "
                   "The task's progress is demonstrated in the provided "
                   "video. My current field of view is shown in the "
                   "provided image. What should be my next action? "
                   "Please output the most reasonable action you think, "
                   "expressed in a short phrase.")
    question = pattern.format(task_goal)
    for c in ["A", "B", "C", "D"]:
        question += "\n" + f"{c}. " + doc[f"choice_{c.lower()}"]
    return question + "\nAnswer with the option's letter from the given choices"


def egoplan_extract_letter(s: str) -> str:
    """egoplan/utils.py:169-189 — the shared parser with the reference's
    concatenated-prefix quirk (tasks.CONCAT_QUIRK_ANSWER_PREFIXES)."""
    from .tasks import CONCAT_QUIRK_ANSWER_PREFIXES, extract_answer_letter
    return extract_answer_letter(s, "ABCD", CONCAT_QUIRK_ANSWER_PREFIXES)


def _egoplan_process(doc, response, rng=None) -> dict:
    return {"question_id": doc.get("sample_id"),
            "pred_answer": egoplan_extract_letter(response),
            "answer": doc.get("golden_choice_idx")}


def aggregate_egoplan(results: list) -> dict:
    correct = sum(r["pred_answer"] == r["answer"] for r in results)
    return {"overall": 100.0 * correct / max(len(results), 1)}


def register_spatial_tasks() -> None:
    TASK_REGISTRY["VSIBench"] = _VSIBenchTask(
        name="VSIBench", doc_to_text=vsibench_doc_to_text,
        process_response=_vsibench_process, aggregate=aggregate_vsibench,
        video_path_keys=("video_path", "scene_name"))
    TASK_REGISTRY["EgoPlan"] = BenchmarkTask(
        name="EgoPlan", doc_to_text=egoplan_doc_to_text,
        process_response=_egoplan_process, aggregate=aggregate_egoplan,
        video_path_keys=("sample_id", "video_path"), video_suffix=".mp4")


register_spatial_tasks()
