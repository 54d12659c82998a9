"""Additional lmms-eval video benchmarks: MVBench, EgoSchema, NExT-QA (MC),
PerceptionTest (val MC) — prompts, parsers, and aggregations rebuilt with
reference fidelity (byte-exact doc_to_text and parse-parity tests in
tests/test_more_tasks.py).

These widen phase-2 beyond the four TSPO benchmarks: any of them can run
with TSPO-selected frames (``frame_idx`` docs), live scoring, or uniform
baseline through the same ``evaluate_task`` harness.

Reference sources:
  - lmms-eval/lmms_eval/tasks/mvbench/utils.py (prompt :93-102, mcq_acc
    :105-154, process :157-180, aggregate :183-197, DATA_LIST :18-39)
  - lmms-eval/lmms_eval/tasks/egoschema/utils.py (prompt :50-66, MMMU-style
    parse :101-175, process :179-189, accuracy :219-229, choices :232-233)
  - lmms-eval/lmms_eval/tasks/nextqa/utils.py (MC prompt :60-72, parse
    :85-140, process :75-82; the open-ended WUPS variant needs
    pywsd/nltk-wordnet, absent from this image — use a judged task
    (tasks.make_judged_task) for open-ended NExT-QA instead)
  - lmms-eval/lmms_eval/tasks/perceptiontest/val/utils.py (prompt :49-72,
    process :110-137, aggregate :140-148, choices :151-153)
"""

from __future__ import annotations

import random
import re
import string

import numpy as np

from .tasks import (TASK_REGISTRY, BenchmarkTask, aggregate_accuracy,
                    _accuracy)

# ---------------------------------------------------------------------------
# MVBench (20 sub-tasks; one video folder each — mvbench/utils.py:18-39)
# ---------------------------------------------------------------------------

MVBENCH_DATA_LIST = {
    "object_interaction": "star/Charades_segment",
    "action_sequence": "star/Charades_segment",
    "action_prediction": "star/Charades_segment",
    "action_localization": "sta/sta_video_segment",
    "moving_count": "clevrer/video_validation",
    "fine_grained_pose": "nturgbd_convert",
    "character_order": "perception/videos",
    "object_shuffle": "perception/videos",
    "egocentric_navigation": "vlnqa",
    "moving_direction": "clevrer/video_validation",
    "episodic_reasoning": "tvqa/video_fps3_hq_segment",
    "fine_grained_action": "Moments_in_Time_Raw/videos",
    "scene_transition": "scene_qa/video",
    "state_change": "perception/videos",
    "moving_attribute": "clevrer/video_validation",
    "action_antonym": "ssv2_video_mp4",
    "unexpected_action": "FunQA_test/test",
    "counterfactual_inference": "clevrer/video_validation",
    "object_existence": "clevrer/video_validation",
    "action_count": "perception/videos",
}

# every mvbench_<sub>.yaml sets the same default post_prompt
MVBENCH_POST_PROMPT = "Only give the best option.\n"


def mvbench_doc_to_text(doc, lmms_eval_specific_kwargs=None) -> str:
    """mvbench_doc_to_text (mvbench/utils.py:93-102): ``(A) opt`` lines."""
    kw = lmms_eval_specific_kwargs or {}
    post = kw.get("post_prompt", MVBENCH_POST_PROMPT)
    opts = "".join(f"({string.ascii_uppercase[i]}) {c}\n"
                   for i, c in enumerate(doc["candidates"]))
    return "Question:" + doc["question"] + "\nOption:\n" + opts + post


_MCQ_PERIOD = re.compile(r"(?!<=\d)(\.)(?!\d)")
_MCQ_COMMA = re.compile(r"(\d)(\,)(\d)")
_MCQ_PUNCT = [";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+",
              "\\", "_", "-", ">", "<", "@", "`", ",", "?", "!"]


def mcq_normalize(text: str) -> str:
    """The normalizer inside mcq_acc (mvbench/utils.py:110-144): a leading
    "X. ..." option wins; otherwise strip punctuation/quotes, lowercase, and
    fall back to any standalone A-E letter, else the cleaned content."""
    m = re.match(r"^([A-E])\.\s*(.+)$", text.strip(), re.IGNORECASE)
    if m:
        return m.group(1).upper()
    s = text.replace("\n", " ").replace("\t", " ").strip()
    # context checks run against the UNMUTATED input (reference
    # processPunctuation tests inText while rewriting outText)
    orig = s
    for p in _MCQ_PUNCT:
        if (p + " " in orig or " " + p in orig) or _MCQ_COMMA.search(orig):
            s = s.replace(p, "")
        else:
            s = s.replace(p, " ")
    # NB: the reference passes re.UNICODE as re.sub's *count* argument —
    # a cap of 32 substitutions; reproduced for exactness
    s = _MCQ_PERIOD.sub("", s, re.UNICODE)
    s = s.strip("'").strip('"').strip(")").strip("(").strip().lower()
    m = re.search(r"\b([A-E])\b", s, re.IGNORECASE)
    return m.group(1).upper() if m else s


def mcq_acc(answer: str, pred: str) -> int:
    """mvbench/utils.py:105-154: normalized exact match."""
    return int(mcq_normalize(pred) == mcq_normalize(answer))


def _mvbench_process(doc, response, rng=None) -> dict:
    gt_letter = None
    for i, cand in enumerate(doc["candidates"]):
        if cand == doc["answer"]:
            gt_letter = string.ascii_uppercase[i]
            break
    return {"question_id": doc.get("question_id", doc.get("id")),
            "pred_answer": response,
            "answer": gt_letter,
            "score": mcq_acc(gt_letter or "", response)}


def aggregate_mvbench(results: list) -> dict:
    """mvbench_aggregate_results (mvbench/utils.py:183-197): accuracy over
    non-empty predictions only."""
    answered = [r for r in results if r["pred_answer"] != ""]
    correct = sum(r["score"] for r in answered)
    return {"overall": 100.0 * correct / len(answered) if answered else 0.0}


# ---------------------------------------------------------------------------
# EgoSchema
# ---------------------------------------------------------------------------

def egoschema_doc_to_text(doc, lmms_eval_specific_kwargs=None) -> str:
    """egoschema_doc_to_text (egoschema/utils.py:50-66): when options are
    present the post prompt is FORCED to the letter instruction, overriding
    the yaml kwargs."""
    kw = lmms_eval_specific_kwargs or {}
    pre, post = kw.get("pre_prompt", ""), kw.get("post_prompt", "")
    q = doc["question"]
    if "option" in doc:
        for op in doc["option"]:
            q += "\n" + op
        post = "\nAnswer with the option's letter from the given choices directly."
    return f"{pre}{q}{post}"


def egoschema_parse_choice(response: str, all_choices: list,
                           index2ans: dict, rng=None):
    """MMMU-derived parser, egoschema flavor (egoschema/utils.py:101-175).

    Quirks preserved exactly: the "(A)" / "A " / "A." passes all ACCUMULATE
    (no early exit), multi-candidate ties resolve to the letter whose LAST
    occurrence is earliest (argmin over rfind), and a long answer with no
    letter falls back to option-content substring match, then random."""
    for ch in [",", ".", "!", "?", ";", ":", "'"]:
        response = response.strip(ch)
    response = " " + response + " "
    index_ans = True
    candidates = []
    for c in all_choices:
        if f"({c})" in response:
            candidates.append(f"({c})")
    for c in all_choices:
        if f"{c} " in response:
            candidates.append(f"{c} ")
    for c in all_choices:
        if f"{c}." in response:
            candidates.append(f"{c}.")
    if not candidates and len(response.split()) > 5:
        for idx, ans in index2ans.items():
            if ans.lower() in response.lower():
                candidates.append(idx)
                index_ans = False
    if not candidates:
        return (rng or random).choice(all_choices)
    if len(candidates) == 1:
        pick = candidates[0]
    else:
        if index_ans:
            positions = [response.rfind(c) for c in candidates]
        else:
            positions = [response.lower().rfind(index2ans[c].lower())
                         for c in candidates]
        pick = candidates[int(np.argmin(positions))]
    return pick.replace("(", "").replace(")", "").replace(".", "").strip()


_EGO_OPTIONS = ["A", "B", "C", "D", "E"]


def _egoschema_process(doc, response, rng=None) -> dict:
    """egoschema_process_results_generation (egoschema/utils.py:179-189):
    letter -> option index (-1 when unparseable), scored vs the gt index."""
    index2ans = {_EGO_OPTIONS[i]: doc["option"][i].strip() for i in range(5)}
    letter = egoschema_parse_choice(response, list(_EGO_OPTIONS), index2ans,
                                    rng)
    idx = {"A": 0, "B": 1, "C": 2, "D": 3, "E": 4}.get(letter, -1)
    return {"question_id": doc.get("video_idx"),
            "pred_answer": idx, "answer": doc["answer"],
            "submission": {doc.get("video_idx"): idx}}


def aggregate_egoschema(results: list) -> dict:
    """egoschema_aggregate_score (egoschema/utils.py:219-229) — reference
    reports a 0-1 fraction; scaled here to % for registry consistency, plus
    the combined submission dict (egoschema_aggregate_submissions)."""
    correct = sum(str(r["answer"]) == str(r["pred_answer"]) for r in results)
    submission = {}
    for r in results:
        submission.update(r.get("submission", {}))
    return {"overall": 100.0 * correct / len(results) if results else 0.0,
            "submission": submission}


def egoschema_doc_to_choices(doc) -> list:
    """egoschema_doc_to_choice (utils.py:232-233): strip the "X. " prefix."""
    return [op.split(".")[1].strip() for op in doc["option"]]


# ---------------------------------------------------------------------------
# NExT-QA multiple choice
# ---------------------------------------------------------------------------

def nextqa_doc_to_text_mc(doc, lmms_eval_specific_kwargs=None) -> str:
    """nextqa_doc_to_text_mc (nextqa/utils.py:60-72).  nextqa_mc_test.yaml
    carries no kwargs: the prompt is bare question + "A. ..." lines."""
    kw = lmms_eval_specific_kwargs or {}
    lines = [doc["question"].strip()]
    lines += [f"{_EGO_OPTIONS[i]}. {doc[f'a{i}'].strip()}" for i in range(5)]
    text = "\n".join(lines)
    if kw.get("pre_prompt", ""):
        text = f"{kw['pre_prompt']}{text}"
    if kw.get("post_prompt", ""):
        text = f"{text}{kw['post_prompt']}"
    return text


def nextqa_parse_choice(response: str, all_choices: list, index2ans: dict,
                        rng=None):
    """nextqa parse_multi_choice_response (nextqa/utils.py:85-140).

    Differs from the egoschema flavor on every quirk: candidate passes are
    GUARDED (later passes only on miss), candidates hold bare letters, and
    ties resolve to the LAST occurrence (argmax; ``" X "`` probe when the
    match came from the space/dot passes)."""
    for ch in [",", ".", "!", "?", ";", ":", "'"]:
        response = response.strip(ch)
    response = " " + response + " "
    index_ans = True
    ans_with_brack = False
    candidates = []
    for c in all_choices:
        if f"({c})" in response:
            candidates.append(c)
            ans_with_brack = True
    if not candidates:
        for c in all_choices:
            if f"{c} " in response:
                candidates.append(c)
    if not candidates:
        for c in all_choices:
            if f"{c}." in response:
                candidates.append(c)
    if not candidates and len(response.split()) > 5:
        for idx, ans in index2ans.items():
            if ans.lower() in response.lower():
                candidates.append(idx)
                index_ans = False
    if not candidates:
        return (rng or random).choice(all_choices)
    if len(candidates) == 1:
        return candidates[0]
    if index_ans:
        probe = (lambda c: f"({c})") if ans_with_brack else (lambda c: f" {c} ")
        positions = [response.rfind(probe(c)) for c in candidates]
    else:
        positions = [response.lower().rfind(index2ans[c].lower())
                     for c in candidates]
    return candidates[int(np.argmax(positions))]


def _nextqa_mc_process(doc, response, rng=None) -> dict:
    """nextqa_mc_process_results (nextqa/utils.py:75-82): exact_match vs the
    gt letter (doc['answer'] is an index into a0..a4)."""
    index2ans = {_EGO_OPTIONS[i]: doc[f"a{i}"].strip() for i in range(5)}
    pred = nextqa_parse_choice(response, list(_EGO_OPTIONS), index2ans, rng)
    gt = _EGO_OPTIONS[int(doc["answer"])]
    return {"question_id": doc.get("qid", doc.get("question_id")),
            "pred_answer": pred, "answer": gt}


def nextqa_doc_to_choices(doc) -> list:
    return [doc[f"a{i}"].strip() for i in range(5)]


# ---------------------------------------------------------------------------
# PerceptionTest (val, multiple choice)
# ---------------------------------------------------------------------------

def perceptiontest_doc_to_text(doc, lmms_eval_specific_kwargs=None) -> str:
    """perceptiontest_val_doc_to_text (perceptiontest/val/utils.py:49-72):
    options lettered A/B/C (everything past the 2nd gets "C."), post prompt
    forced to the letter instruction when options exist."""
    kw = lmms_eval_specific_kwargs or {}
    pre, post = kw.get("pre_prompt", ""), kw.get("post_prompt", "")
    q = doc["question"]
    if "options" in doc:
        for i, op in enumerate(doc["options"]):
            letter = "A" if i == 0 else ("B" if i == 1 else "C")
            q += "\n" + letter + ". " + op
        post = "\nAnswer with the option's letter from the given choices directly."
    return f"{pre}{q}{post}"


def _perceptiontest_process(doc, response, rng=None) -> dict:
    """perceptiontest_val_process_results_mc (val/utils.py:110-137):
    standalone A-D letter -> index, -1 otherwise; compared to answer_id."""
    m = re.search(r"\b([A-D])\b", response.strip())
    idx = {"A": 0, "B": 1, "C": 2, "D": 3}.get(m.group(1).upper() if m else "",
                                               -1)
    return {"question_id": doc.get("question_id"),
            "area": doc.get("area"), "tag": doc.get("tag"),
            "pred_answer": idx, "answer": int(doc["answer_id"]),
            "correct": int(idx == int(doc["answer_id"]))}


def aggregate_perceptiontest(results: list) -> dict:
    """perceptiontest_val_aggregate_accuracy (val/utils.py:140-148), plus
    per-area/tag breakdowns available in the records."""
    out = {"overall": _accuracy(results)}
    areas = {}
    for r in results:
        if r.get("area"):
            areas.setdefault(r["area"], []).append(r)
    if areas:
        out["areas"] = {k: _accuracy(v) for k, v in sorted(areas.items())}
    return out


def perceptiontest_doc_to_choices(doc) -> list:
    return list(doc["options"])


def bare_question_doc_to_text(doc, lmms_eval_specific_kwargs=None) -> str:
    """mc_ppl prompt: the yamls set ``doc_to_text: "question"`` — the bare
    field, no options, no letter instruction (egoschema_mcppl.yaml:6,
    perceptiontest_mcppl.yaml:6)."""
    return doc["question"]


# ---------------------------------------------------------------------------
# registration
# ---------------------------------------------------------------------------

def register_more_tasks() -> None:
    TASK_REGISTRY["MVBench"] = BenchmarkTask(
        name="MVBench", doc_to_text=mvbench_doc_to_text,
        process_response=_mvbench_process, aggregate=aggregate_mvbench,
        video_path_keys=("video", "video_path"))
    for sub, folder in MVBENCH_DATA_LIST.items():
        TASK_REGISTRY[f"MVBench_{sub}"] = BenchmarkTask(
            name=f"MVBench_{sub}", doc_to_text=mvbench_doc_to_text,
            process_response=_mvbench_process, aggregate=aggregate_mvbench,
            video_path_keys=("video", "video_path"), video_subdir=folder)
    TASK_REGISTRY["EgoSchema"] = BenchmarkTask(
        name="EgoSchema", doc_to_text=egoschema_doc_to_text,
        process_response=_egoschema_process, aggregate=aggregate_egoschema,
        video_path_keys=("video_idx", "video_path"), video_suffix=".mp4",
        doc_to_choices=egoschema_doc_to_choices)
    # mc_ppl flavor (egoschema_mcppl.yaml): prompt is the BARE question
    # (doc_to_text: "question" in the yaml — no options, no letter
    # instruction), choices scored by continuation loglikelihood ranked
    # per-token (the reference adapter's mean-CE argmin); the harness's
    # argmax letter goes through the same parse
    TASK_REGISTRY["EgoSchema-ppl"] = BenchmarkTask(
        name="EgoSchema-ppl", doc_to_text=bare_question_doc_to_text,
        process_response=_egoschema_process, aggregate=aggregate_egoschema,
        video_path_keys=("video_idx", "video_path"), video_suffix=".mp4",
        output_type="loglikelihood", doc_to_choices=egoschema_doc_to_choices,
        ll_length_normalize=True)
    TASK_REGISTRY["NExT-QA"] = BenchmarkTask(
        name="NExT-QA", doc_to_text=nextqa_doc_to_text_mc,
        process_response=_nextqa_mc_process, aggregate=aggregate_accuracy,
        video_path_keys=("video", "video_path"), video_suffix=".mp4",
        doc_to_choices=nextqa_doc_to_choices)
    TASK_REGISTRY["PerceptionTest"] = BenchmarkTask(
        name="PerceptionTest", doc_to_text=perceptiontest_doc_to_text,
        process_response=_perceptiontest_process,
        aggregate=aggregate_perceptiontest,
        video_path_keys=("video_name", "video_path"), video_suffix=".mp4",
        doc_to_choices=perceptiontest_doc_to_choices)
    TASK_REGISTRY["PerceptionTest-ppl"] = BenchmarkTask(
        name="PerceptionTest-ppl", doc_to_text=bare_question_doc_to_text,
        process_response=_perceptiontest_process,
        aggregate=aggregate_perceptiontest,
        video_path_keys=("video_name", "video_path"), video_suffix=".mp4",
        output_type="loglikelihood",
        doc_to_choices=perceptiontest_doc_to_choices,
        ll_length_normalize=True)


register_more_tasks()
