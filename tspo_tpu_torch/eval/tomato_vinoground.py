"""TOMATO and Vinoground benchmark tasks.

Reference sources:
  - lmms-eval/lmms_eval/tasks/tomato/utils.py — frame-count-aware prompt
    with the ``index2ans`` dict rendered via str() (:86-120); default parse
    path is its own MMMU flavor (:218-273): a FIRST pass that matches the
    bare letter anywhere in the response, "A" (not random) as the
    no-candidate fallback, argmax-rfind tie-break; per reason_type /
    demonstration_type means + overall (:335-369).  The optional GPT-parser
    path (USE_GPT_PARSER) maps to an llm_judge provider here.
  - lmms-eval/lmms_eval/tasks/vinoground/utils.py — counterfactual
    text/video/group scoring: each of 500 caption pairs is probed 4 ways
    (pos/neg x textscore/videoscore); text score needs both text probes
    right, video score both video probes, group needs all four (:61-124).
    The reference reads GT from side-car score jsons; here each doc carries
    its own ``GT`` (our docs are self-contained jsonl), the scoring math is
    identical.
"""

from __future__ import annotations

import re

import numpy as np

from .llm_judge import JudgeProvider
from .tasks import TASK_REGISTRY, BenchmarkTask

# ---------------------------------------------------------------------------
# TOMATO
# ---------------------------------------------------------------------------

TOMATO_NUM_FRAMES = 16      # utils.py:26 (paper setting)


def tomato_construct_prompt(question: str, options: list,
                            num_frames: int = TOMATO_NUM_FRAMES):
    """utils.py:86-120 — returns (prompt, all_choices, index2ans); the
    template lives in tomato_prompt.py, extracted byte-exact (the reference
    leaves trailing spaces on several lines)."""
    from .tomato_prompt import TOMATO_PROMPT_TEMPLATE
    all_choices = [f"{chr(65 + i)}" for i in range(len(options))]
    index2ans = {all_choices[i]: options[i] for i in range(len(options))}
    prompt = TOMATO_PROMPT_TEMPLATE.format(
        num_frames=num_frames, question=question, index2ans=index2ans)
    return prompt, all_choices, index2ans


def tomato_doc_to_text(doc, lmms_eval_specific_kwargs=None) -> str:
    prompt, _, _ = tomato_construct_prompt(doc["question"], doc["options"])
    return prompt


def tomato_parse_choice(response: str, all_choices: list,
                        index2ans: dict) -> str:
    """utils.py:218-273 — TOMATO's MMMU flavor: bare-letter-anywhere first
    pass, " X "-bounded second pass, content fallback, then the CONSTANT
    "A" (the reference comments out random.choice); ties argmax-rfind."""
    for ch in [",", ".", "!", "?", ";", ":", "'"]:
        response = response.strip(ch)
    response = " " + response + " "
    index_ans = True
    ans_with_brack = False
    candidates = []
    for c in all_choices:
        if f"{c}" in response:
            candidates.append(c)
            ans_with_brack = True
    if not candidates:
        for c in all_choices:
            if f" {c} " in response:
                candidates.append(c)
    if not candidates and len(response.split()) > 5:
        for idx, ans in index2ans.items():
            if ans.lower() in response.lower():
                candidates.append(idx)
                index_ans = False
    if not candidates:
        return "A"
    if len(candidates) == 1:
        return candidates[0]
    if index_ans:
        probe = (lambda c: f"({c})") if ans_with_brack else (lambda c: f" {c} ")
        positions = [response.rfind(probe(c)) for c in candidates]
    else:
        positions = [response.lower().rfind(index2ans[c].lower())
                     for c in candidates]
    return candidates[int(np.argmax(positions))]


def tomato_pre_parse(response: str, all_choices: list,
                     index2ans: dict) -> str:
    """utils.py:274-295 — strict pre-parser for the GPT-parser path."""
    response = response.strip()
    full_choices = [f"{k}: {v}" for k, v in index2ans.items()]
    m = re.match(r"^Answer is:?[\(]?([A-Fa-f])[\)]?$", response)
    if len(response) == 1 and response.upper() in all_choices:
        return response.upper()
    if response.upper() in full_choices:
        return response[0].upper()
    if m:
        return m.group(1).upper()
    return ""


def make_tomato_task(judge: JudgeProvider | None = None) -> BenchmarkTask:
    """``judge`` enables the reference's USE_GPT_PARSER path (strict
    pre-parse, then ask the judge to extract the letter, "A"-fallback);
    default is the rule parser like the reference default."""

    def process(doc, response, rng=None) -> dict:
        _, all_choices, index2ans = tomato_construct_prompt(
            doc["question"], doc["options"])
        gt_letter = chr(65 + int(doc["answer"]))
        if judge is not None:
            parsed = tomato_pre_parse(response, all_choices, index2ans)
            if parsed not in all_choices:
                for _ in range(5):                  # MAX_ITER utils.py:27
                    res = judge._complete_with_retry(
                        f"You are given a response, a list of multiple-choice "
                        f"options, and a index2answer mapping. You are "
                        f"required to extract the letter option from the "
                        f"GPT. \n    \n    response: {response}\n\n    "
                        f"all_choices: {all_choices}\n\n    "
                        f"index2answer: {index2ans}\n\nOnly output the "
                        f"single parsed letter from the response. No other "
                        f"texts are needed. \n\nIf you think no options can "
                        f"match the index2answer dictionary, randomly select "
                        f"one letter. \n\nYour extracted letter is: \n")
                    if res.success and res.content.strip() in all_choices:
                        parsed = res.content.strip()
                        break
                if parsed not in all_choices:
                    parsed = (rng.choice(all_choices) if rng is not None
                              else "A")
        else:
            parsed = tomato_parse_choice(response, all_choices, index2ans)
        return {"question_id": doc.get("id"),
                "pred_answer": parsed, "answer": gt_letter,
                "score": 1.0 if parsed == gt_letter else 0.0,
                "reason_type": doc.get("reason_type"),
                "demonstration_type": doc.get("demonstration_type")}

    def aggregate(results: list) -> dict:
        out = {}
        for key in ("reason_type", "demonstration_type"):
            groups: dict = {}
            for r in results:
                if r.get(key):
                    groups.setdefault(r[key], []).append(r["score"])
            for g, scores in sorted(groups.items()):
                out[f"{key}/{g}"] = 100.0 * sum(scores) / len(scores)
        out["overall"] = (100.0 * sum(r["score"] for r in results)
                          / len(results) if results else 0.0)
        return out

    return BenchmarkTask(name="TOMATO", doc_to_text=tomato_doc_to_text,
                         process_response=process, aggregate=aggregate,
                         video_path_keys=("video_path", "video", "id"))


# ---------------------------------------------------------------------------
# Vinoground
# ---------------------------------------------------------------------------

def vinoground_doc_to_text(doc, lmms_eval_specific_kwargs=None) -> str:
    """utils.py:52-58 — question + the fixed one-character instruction (the
    question text lives on the doc here instead of the side-car json)."""
    return doc["question"] + "\nPlease only output one English character."


def _vinoground_process(doc, response, rng=None) -> dict:
    """utils.py:61-72 (+ GT carried on the doc)."""
    parts = doc["index"].split("_")
    idx, question_type = "_".join(parts[:2]), parts[2]
    categories = ["all", doc["major"]]
    if doc.get("minor") is not None:
        categories.extend(doc["minor"].split(";"))
    first = response[0].lower() if response else ""
    return {"index": idx, "categories": categories,
            "question_type": question_type, "pred": response,
            "correct": int(first == str(doc["GT"]).lower())}


def aggregate_vinoground(results: list) -> dict:
    """utils.py:75-124: per-pair text/video scores need BOTH the pos and neg
    probe right; the group score needs all four."""
    if not results:
        return {"text": 0.0, "video": 0.0, "group": 0.0}
    n = max(int(r["index"].split("_")[0]) for r in results) + 1
    matrix = np.zeros((n, 7), dtype=np.int8)
    index_to_categories = {}
    for r in results:
        col = 0 if "pos" in r["index"] else 1
        if r["question_type"] == "video":
            col += 3
        i = int(r["index"].split("_")[0])
        matrix[i, col] = r["correct"]
        index_to_categories.setdefault(i, r["categories"])
    matrix[:, 2] = matrix[:, 0] & matrix[:, 1]
    matrix[:, 5] = matrix[:, 3] & matrix[:, 4]
    matrix[:, 6] = matrix[:, 2] & matrix[:, 5]
    # denominator = pairs actually probed (the reference hardcodes its 500
    # full-set rows; a subset/sharded run must not count unprobed pairs as
    # failures)
    probed = np.array(sorted(index_to_categories), dtype=int)
    matrix = matrix[probed]

    cat_all: dict = {}
    cat_scores = {"text": {}, "video": {}, "group": {}}
    for row, i in enumerate(probed):
        for cat in index_to_categories[int(i)]:
            cat_all[cat] = cat_all.get(cat, 0) + 1
            cat_scores["text"][cat] = cat_scores["text"].get(cat, 0) \
                + int(matrix[row, 2])
            cat_scores["video"][cat] = cat_scores["video"].get(cat, 0) \
                + int(matrix[row, 5])
            cat_scores["group"][cat] = cat_scores["group"].get(cat, 0) \
                + int(matrix[row, 6])
    out = {"text": float(matrix[:, 2].mean() * 100),
           "video": float(matrix[:, 5].mean() * 100),
           "group": float(matrix[:, 6].mean() * 100)}
    out["categories"] = {
        cat: {kind: 100.0 * cat_scores[kind][cat] / cat_all[cat]
              for kind in ("text", "video", "group")}
        for cat in sorted(cat_all)}
    return out


def register_tomato_vinoground(judge: JudgeProvider | None = None) -> None:
    TASK_REGISTRY["TOMATO"] = make_tomato_task(judge)
    TASK_REGISTRY["Vinoground"] = BenchmarkTask(
        name="Vinoground", doc_to_text=vinoground_doc_to_text,
        process_response=_vinoground_process, aggregate=aggregate_vinoground,
        video_path_keys=("video_name", "video_path"))


register_tomato_vinoground()
