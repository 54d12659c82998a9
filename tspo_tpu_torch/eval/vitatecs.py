"""VITATECS — temporal-concept caption vs counterfactual A/B test.

Reference: lmms-eval/lmms_eval/tasks/vitatecs/utils.py — each doc carries a
caption and a minimally-edited counterfactual; the A/B assignment is
DETERMINISTIC per doc (random seeded with the char-sum of
caption+counterfactual, :91-105), so the question, gold letter, and option
texts are exactly reproducible.  Scoring (:113-134): option-text substring
rules first (the matching texts are lowercased, period-stripped), then bare
or decorated letters, then a TempCompass-style Correct/Incorrect judge
fallback (:176-218); accuracy ×100 over all records (:221-230), with
per-aspect/src_dataset breakdowns carried on the records.
"""

from __future__ import annotations

import random

from .llm_judge import JudgeProvider
from .tasks import TASK_REGISTRY, BenchmarkTask
from .tempcompass import JUDGE_SYS_PROMPT, rating_from_judge_reply


def _option_for_question(sent: str) -> str:
    if not sent.endswith("."):
        sent += "."
    return sent.capitalize()


def _option_for_matching(sent: str) -> str:
    if sent.endswith("."):
        sent = sent[:-1]
    return sent.lower()


def format_question_and_answer(doc):
    """utils.py:91-105 — the seeded shuffle, reproduced exactly."""
    seed = sum(ord(c) for c in doc["caption"] + doc["counterfactual"]) % 100
    rng = random.Random()
    rng.seed(seed)
    if rng.random() > 0.5:
        option_a = _option_for_question(doc["caption"])
        option_b = _option_for_question(doc["counterfactual"])
        answer = "(A) " + option_a
    else:
        option_a = _option_for_question(doc["counterfactual"])
        option_b = _option_for_question(doc["caption"])
        answer = "(B) " + option_b
    options = [_option_for_matching(doc["caption"]),
               _option_for_matching(doc["counterfactual"])]
    question = ("Which of the following best describes the content of the "
                f"video: \n(A) {option_a} \n(B) {option_b}")
    return question, answer, options


# _default_template_yaml:6-9 — the default kwargs every non-matching model
# name (incl. the TSPO adapters) receives
VITATECS_DEFAULT_KWARGS = {
    "pre_prompt": "",
    "post_prompt": "\nPlease response with a single letter (A or B):",
}


def vitatecs_doc_to_text(doc, lmms_eval_specific_kwargs=None) -> str:
    kw = {**VITATECS_DEFAULT_KWARGS, **(lmms_eval_specific_kwargs or {})}
    question, _, _ = format_question_and_answer(doc)
    return f"{kw['pre_prompt']}{question}{kw['post_prompt']}"


def vitatecs_rule_rating(pred: str, answer: str, options: list):
    """utils.py:119-134: returns 0/1, or None when rules fail."""
    if options[0] in pred.lower() and options[1] not in pred.lower():
        return 1
    if options[1] in pred.lower() and options[0] not in pred.lower():
        return 0
    if pred in ["A", "B"]:
        return 1 if pred == answer[1] else 0
    if any(pred.startswith(p) for p in ["A.", "B."]):
        return 1 if pred.split(".")[0] == answer[1] else 0
    if any(pred.startswith(p) for p in ["A)", "B)"]):
        return 1 if pred.split(")")[0] == answer[1] else 0
    if any(pred.startswith(p) for p in ["(A)", "(B)"]):
        return 1 if pred.split(")")[0][1] == answer[1] else 0
    return None


def vitatecs_judge_prompt(question: str, answer: str, pred: str) -> str:
    """utils.py:137-140 — byte-equivalent."""
    base = ('You will receive a caption matching question, the ground-truth '
            'answer and the prediction from a question answering (QA) '
            'model. Your task is to determine whether QA model prediction '
            'is correct, based on the question and ground-truth answer. If '
            'the prediction is correct, respond "Correct". If the '
            'prediction is incorrect, respond "Incorrect". ')
    return (f"{base}\n\nCaption Matching Question: {question}\n\n"
            f"Ground-Truth Answer: {answer}\n\nModel Prediction: {pred}")


def make_vitatecs_task(judge: JudgeProvider | None = None) -> BenchmarkTask:
    def process(doc, response, rng=None) -> dict:
        question, answer, options = format_question_and_answer(doc)
        rating = vitatecs_rule_rating(response, answer, options)
        rec = {"src_dataset": doc.get("src_dataset"),
               "video_id": doc.get("video_name"), "question": question,
               "pred_answer": response, "answer": answer,
               "aspect": doc.get("aspect"), "match_success": rating is not None}
        if rating is None:
            if judge is not None:
                res = judge._complete_with_retry(
                    vitatecs_judge_prompt(question, answer, response),
                    system_prompt=JUDGE_SYS_PROMPT)
                reply = res.content.strip() if res.success else ""
                rating = rating_from_judge_reply(reply) if reply else 0
                rec["chatgpt_response"] = reply
            else:
                rating = 0
                rec["judge_unavailable"] = True
        rec["rating"] = rating
        return rec

    def aggregate(results: list) -> dict:
        def acc(rows):
            return (100.0 * sum(r["rating"] == 1 for r in rows) / len(rows)
                    if rows else 0.0)
        out = {"overall": acc(results)}
        aspects: dict = {}
        for r in results:
            if r.get("aspect"):
                aspects.setdefault(r["aspect"], []).append(r)
        if aspects:
            out["aspects"] = {a: acc(rows)
                              for a, rows in sorted(aspects.items())}
        out["judge_unavailable"] = sum(1 for r in results
                                       if r.get("judge_unavailable"))
        return out

    return _VITATECSTask(name="VITATECS", doc_to_text=vitatecs_doc_to_text,
                         process_response=process, aggregate=aggregate,
                         video_path_keys=("video_name", "video_path"))


class _VITATECSTask(BenchmarkTask):
    """videos nest per source dataset: <root>/<src_dataset>/<video_name>
    (vitatecs_doc_to_visual utils.py:55-62)."""

    def resolve_video(self, doc, video_root: str = "") -> str:
        import os
        if doc.get("video_path"):
            return os.path.join(video_root, str(doc["video_path"]))
        return os.path.join(video_root, str(doc.get("src_dataset", "")),
                            str(doc["video_name"]))


def register_vitatecs(judge: JudgeProvider | None = None) -> None:
    TASK_REGISTRY["VITATECS"] = make_vitatecs_task(judge)


register_vitatecs()
