"""TempCompass — temporal-understanding benchmark, four answer formats.

Faithful rebuild of `lmms-eval/lmms_eval/tasks/tempcompass/utils.py`:
  - multi-choice:     hand-crafted letter rules, judge fallback (:127-182)
  - yes_no:           startswith yes/no, judge fallback (:186-235, :461-469)
  - caption_matching: option/sentence/index word-match rules `eval_rule`,
                      judge fallback (:239-288, :438-457)
  - captioning:       the description is graded by asking the judge the
                      paired multi-choice question against it (:292-434)

Rule-based matching is attempted first; only unmatched responses go to the
judge (the reference calls ChatGPT there).  Judge prompts are byte-equivalent
(tests mock the reference's requests.post and diff the payload); replies are
rated by the reference's Correct/Incorrect rules (:501-511).  The reference
pins the judge to gpt-3.5-turbo-1106 at temperature 1.0 — configure the same
via JudgeConfig(model_name=..., temperature=1.0) when reproducing its
numbers.  With no judge configured, unmatched responses rate 0 and are
counted in ``judge_unavailable``.

Aggregation: avg accuracy + per-``dim`` accuracy over rating==1
(:515-525; captioning's rating==-1 "invalid request" records count as 0,
matching tempcompass_aggregate_rating).
"""

from __future__ import annotations

import logging

from .llm_judge import JudgeProvider
from .tasks import TASK_REGISTRY, BenchmarkTask

logger = logging.getLogger(__name__)

# _default_template_yaml lmms_eval_specific_kwargs.default.post_prompt
TEMPCOMPASS_POST_PROMPTS = {
    "multi-choice": "\nPlease directly give the best option:",
    "yes_no": "\nPlease answer yes or no:",
    "caption_matching": "\nPlease directly give the best option:",
    "captioning": "",
}

JUDGE_SYS_PROMPT = "You are an AI assistant for question answering."

# utils.py:146-150 — note the reference's triple-quoted string with
# line continuations: leading newline + 8-space indents preserved
_BASE_PROMPT = (
    "\n        You will receive a {kind}, the ground-truth answer and the "
    "prediction from a question answering (QA) model.         Your task is "
    "to determine whether QA model prediction is correct, based on the "
    "question and ground-truth answer.         If the prediction is correct, "
    'respond "Correct". If the prediction is incorrect, respond '
    '"Incorrect".\n        ')

_KIND = {"multi-choice": "multi-choice question",
         "yes_no": "Yes/No question",
         "caption_matching": "caption matching question"}
_HEADER = {"multi-choice": "Multi-Choice Question",
           "yes_no": "Yes/No Question",
           "caption_matching": "Caption Matching Question"}


def judge_fallback_prompt(task_type: str, question: str, answer: str,
                          pred: str) -> str:
    """utils.py:146-151 / :199-204 / :252-257 — byte-equivalent."""
    base = _BASE_PROMPT.format(kind=_KIND[task_type])
    return (f"{base}\n{_HEADER[task_type]}:\n{question}"
            f"\nGround-Truth Answer: {answer}\nModel Prediction: {pred}")


# utils.py:295-335 — the captioning grader prompt (byte-preserved, including
# the reference's typos "palying"/"backwark"/"coices")
CAPTION_EVAL_PROMPT = """
    You will receive a video description and a multi-choice question. Your task is to choose the correct answer and briefly explain the reason why you choose the answer. \
    If none of the choice candidates are correct or the video description lacks enough information to answer the question, just answer "None of the choices are correct". \
    Please organize your response in this format:
    ```
    Reasoning: [Your reason to obtain the answer]
    Answer: [Your answer]
    ```

    Here are some examples of video description, multi-choice question and the expected answer:
    ```
    Video Description: A person is palying football.
    Multi-Choice Question:
    What is the person doing in the video?
    A. cooking
    B. palying football
    C. playing basketball
    D. reading book
    Reasoning: The video description mentions that the person is playing football.
    Answer: B. palying football

    Video Description: A bird is flying clockwise.
    Multi-Choice Question:
    In which direction is the bird flying?
    A. backwark
    B. counter-clockwise
    C. clockwise
    D. downward
    Reasoning: The video description mentions that the bird is flying clockwise
    Answer: C. clockwise

    Video Description: An air balloon is inflating.
    Multi-Choice Question:
    What is happening to the air balloon?
    A. exploding
    B. getting smaller
    C. flying
    Reasoning: The video description mentions that the air balloon is inflating, while none of the coices can be explained as inflating.
    Answer: None of the choices are correct
    ```
    """


def captioning_judge_prompt(pred: str, mc_question: str) -> str:
    """utils.py:337 — byte-equivalent."""
    return (f"{CAPTION_EVAL_PROMPT}\nVideo Description:{pred}"
            f"\nMulti-Choice Question:\n{mc_question}\nAnswer:")


def make_doc_to_text(task_type: str):
    def doc_to_text(doc, lmms_eval_specific_kwargs=None) -> str:
        kw = lmms_eval_specific_kwargs or {}
        pre = kw.get("pre_prompt", "")
        post = kw.get("post_prompt")
        if isinstance(post, dict):                  # the yaml dict form
            post = post.get(task_type, "")
        elif post is None:
            post = TEMPCOMPASS_POST_PROMPTS[task_type]
        return f"{pre}{doc['question']}{post}"
    return doc_to_text


# ---------------------------------------------------------------------------
# rule-based matchers (exact ports; parity-tested vs the reference)
# ---------------------------------------------------------------------------

def mc_rule_rating(pred: str, answer: str):
    """utils.py:133-144: returns 0/1, or None when rules fail to match."""
    if pred == answer:
        return 1
    if pred in ["A", "B", "C", "D"]:
        return 1 if pred == answer[0] else 0
    if any(pred.startswith(p) for p in ["A.", "B.", "C.", "D."]):
        return 1 if pred.split(".")[0] == answer[0] else 0
    if any(pred.startswith(p) for p in ["A)", "B)", "C)", "D)"]):
        return 1 if pred.split(")")[0] == answer[0] else 0
    return None


def extract_yes_no(pred: str):
    """utils.py:461-469."""
    s = pred.lower()
    if s.startswith("yes"):
        return "yes"
    if s.startswith("no"):
        return "no"
    return False


def caption_matching_rule(pred: str, question: str, answer: str):
    """utils.py:438-457 ``eval_rule`` — the last matching rule wins; returns
    0/1 or None when nothing matches ("fail")."""
    option_strs = question.split("\n")[1:]
    option_sents = [o.split(": ")[1] for o in option_strs]
    option_inds = ([o.split(": ")[0] for o in option_strs]
                   + [o.split(": ")[0].replace("Sentence ", "")
                      .replace("Option ", "").replace("Caption ", "")
                      for o in option_strs])
    matched = None
    for o in option_strs:
        if o == pred:
            matched = o
    for s in option_sents:
        if s == pred or (") " in pred and s == pred.split(") ")[1]):
            matched = s
    for ind in option_inds:
        if ind == pred or ind == pred.replace(".", ""):
            matched = ind
    if matched is None:
        return None
    return 1 if (matched == answer or matched == answer.split(":")[0]
                 or matched == answer.split(": ")[1]
                 or matched == answer.split(": ")[0].split()[1]) else 0


def rating_from_judge_reply(reply: str) -> int:
    """utils.py:501-511 ``llm_output_to_rating`` (the reference asserts one
    of the words is present and retries otherwise — here an unmatched reply
    rates 0, logged)."""
    if "Correct" not in reply and "Incorrect" not in reply:
        logger.error("judge reply has no Correct/Incorrect: %r", reply[:200])
        return 0
    if reply.startswith("Correct"):
        return 1
    if reply.startswith("Incorrect"):
        return 0
    if "Correct" in reply and "Incorrect" not in reply:
        return 1
    return 0


def parse_captioning_reply(reply: str, gt_answer: str) -> dict:
    """utils.py:366-393 ``parse_llm_output_for_captioning``."""
    if not reply or reply == "invalid_request_error":
        return {"rating": -1, "chatgpt-answer": None,
                "chatgpt-reasoning": None}
    out = {}
    for line in reply.split("\n"):
        line = line.strip()
        if "Reasoning" in line:
            out["chatgpt-reasoning"] = line.replace("Reasoning:", "").strip()
        if "Answer" in line:
            out["chatgpt-answer"] = line.replace("Answer:", "").strip()
    out.setdefault("chatgpt-answer", reply)
    out.setdefault("chatgpt-reasoning", None)
    n_letters = sum(out["chatgpt-answer"].count(p)
                    for p in ["A.", "B.", "C.", "D."])
    ok = (out["chatgpt-answer"].split(". ")[0] == gt_answer.split(". ")[0]
          and n_letters == 1)
    out["rating"] = 1 if ok else 0
    return out


# ---------------------------------------------------------------------------
# task construction
# ---------------------------------------------------------------------------

def _record(doc, pred, rating, match_success, judge_reply=None) -> dict:
    rec = {"video_id": doc.get("video_id"), "question": doc.get("question"),
           "gt-answer": doc.get("answer"), "video-llm-prediction": pred,
           "match_success": match_success, "rating": rating,
           "dim": doc.get("dim")}
    if judge_reply is not None:
        rec["chatgpt_response"] = judge_reply
    return rec


def aggregate_tempcompass(results: list) -> dict:
    """avg + per-dim accuracy (rating==1 over all records,
    tempcompass_aggregate_rating utils.py:515-525)."""
    def acc(rows):
        return (100.0 * sum(r["rating"] == 1 for r in rows) / len(rows)
                if rows else 0.0)
    dims = {}
    for r in results:
        dims.setdefault(r.get("dim") or "?", []).append(r)
    out = {f"{d}_accuracy": acc(rows) for d, rows in sorted(dims.items())}
    out["overall"] = acc(results)
    out["judge_unavailable"] = sum(1 for r in results
                                   if r.get("judge_unavailable"))
    return out


def make_tempcompass_task(task_type: str,
                          judge: JudgeProvider | None = None) -> BenchmarkTask:
    def ask_judge(prompt: str):
        if judge is None:
            return None
        res = judge._complete_with_retry(prompt,
                                         system_prompt=JUDGE_SYS_PROMPT)
        # the reference strips the completion before rating/parsing
        # (get_llm_output utils.py:496, get_llm_output_for_captioning :411)
        return res.content.strip() if res.success else None

    if task_type == "captioning":
        def process(doc, response, rng=None) -> dict:
            reply = ask_judge(captioning_judge_prompt(response,
                                                      doc["mc_question"]))
            parsed = parse_captioning_reply(reply or "", doc["mc_answer"])
            rec = _record(doc, response, parsed["rating"], True)
            rec.update({"gt-answer": doc["mc_answer"],
                        "chatgpt-answer": parsed["chatgpt-answer"],
                        "chatgpt-reasoning": parsed["chatgpt-reasoning"],
                        "judge_unavailable": judge is None})
            return rec
    else:
        rules = {"multi-choice":
                 lambda doc, pred: mc_rule_rating(pred, doc["answer"]),
                 "yes_no":
                 lambda doc, pred: (1 if extract_yes_no(pred) == doc["answer"]
                                    else 0) if extract_yes_no(pred) else None,
                 "caption_matching":
                 lambda doc, pred: caption_matching_rule(
                     pred, doc["question"], doc["answer"])}[task_type]

        def process(doc, response, rng=None) -> dict:
            rating = rules(doc, response)
            if rating is not None:
                return _record(doc, response, rating, True)
            reply = ask_judge(judge_fallback_prompt(
                task_type, doc["question"], doc["answer"], response))
            rec = _record(doc, response,
                          rating_from_judge_reply(reply) if reply else 0,
                          False, judge_reply=reply)
            rec["judge_unavailable"] = judge is None
            return rec

    return BenchmarkTask(
        name=f"TempCompass-{task_type}", doc_to_text=make_doc_to_text(task_type),
        process_response=process, aggregate=aggregate_tempcompass,
        video_path_keys=("video_id", "video_path"), video_suffix=".mp4")


def register_tempcompass(judge: JudgeProvider | None = None) -> None:
    for t in ("multi-choice", "yes_no", "caption_matching", "captioning"):
        task = make_tempcompass_task(t, judge)
        TASK_REGISTRY[task.name] = task


# rule-only registration at import (judge wired in by the CLI when --judge
# is given); unmatched responses then rate 0 and count in judge_unavailable
register_tempcompass()
