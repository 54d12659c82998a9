"""FunQA — counter-intuitive video QA (humor/creative/magic), judge-scored.

Reference: lmms-eval/lmms_eval/tasks/funqa/utils.py
  - three judge system messages keyed by the task-code digit ("2" describe,
    "3" explain, "4" title), byte-exact (:66-100);
  - ``get_eval`` (:168-210): per-task candidate truncation (max_len map
    :174), content = doc["prompt"] + "[" + candidate + "]", judge at
    temperature 0.2, score = last number in the reply (:103-113).
    **Reference bug, documented + NOT replicated:** utils.py:199 gates the
    return on ``score != 0`` where ``score`` is an undefined name — the
    NameError is swallowed by the retry except-block, so every reference
    judge call exhausts its retries and returns ("", "", 0): the shipped
    funqa_gpt metric always scores 0.  We implement the evident intent:
    a non-empty reply parsing to a non-zero score is recorded; an empty or
    zero-parse reply yields ("", 0) WITHOUT retry — mirroring the intended
    control flow's ``break`` (no retry on a successful-but-unscorable
    call, only on transport failures).  A regression test points at the
    reference line.
  - aggregation (:303-349): per-task-code mean, then mean over the 8 codes;
  - BLEU-4 / ROUGE-L via pycocoevalcap (:132-165) — rebuilt as pure Python
    in eval/text_metrics.py (see that module's parity notes); BLEURT
    (:271-300) needs the downloadable lucadiliello/BLEURT-20 torch
    checkpoint and stays gated: ``funqa_bleurt_scores`` raises with the
    runbook instruction in this zero-egress build.
"""

from __future__ import annotations

import os
import re

import numpy as np

from .llm_judge import JudgeConfig, JudgeProvider, create_provider
from .tasks import TASK_REGISTRY, BenchmarkTask
from .text_metrics import bleu4, rouge_l

FUNQA_TASK_CODES = ("H2", "H3", "H4", "C2", "C3", "C4", "M2", "M3")

# funqa/utils.py:174 — per-task candidate truncation lengths
MAX_LEN = {"H2": 150, "H3": 180, "H4": 40, "C2": 390, "C3": 310, "C4": 30,
           "M2": 180, "M3": 130}

# funqa/utils.py:66-100 — byte-exact (triple-quoted with leading newline and
# trailing spaces/newline preserved)
SYSTEM_MESSAGES = {
    "2": """
        You will be given two text segments in the following format: [text1][text2]. These two texts will be descriptions of a counterintuitive (humorous, creative, or magical) video. For text2, your task is to provide a score based on the following criteria:
        1. Content: Score out of 20 points. If the content is nearly identical, award 20 points. If the content differs slightly, deduct 5 points. If the content differs significantly, deduct 10 points. If the content differs greatly, deduct 15 points. If the content is completely different, deduct 20 points.
        2. Details: Score out of 50 points. Describe the video's details, including characters, scenes, actions, dialogues, etc. Deduct 5 points for each differing detail. Clearly identify and count the differing details to calculate the final score.
        3. Logic: Score out of 20 points. The description should be logically consistent without any unreasonable situations. If the logic is nearly identical, award 20 points. If the logic is generally consistent but differs in details, award 15 points. If there are some differences in logic but still similar overall, award 10 points. If there are significant differences in logic, award 5 points.
        4. Language Expression: Score out of 10 points. Evaluate the fluency and word usage of the text. If the language expression is at a consistent level, award 10 points. If there are minor differences in language expression, award 5 points. If there are significant differences in language expression, award 0 points.
        Note: If the content differs significantly, multiply the total score by 0.5. If the content differs greatly, multiply the total score by 0.25.
        The output format is (remember not to have any comments, directly output scores) :
        [Content: Score], [Details: Score], [Logic: Score], [Language: Score], [Factor: 1 or 0.5 or 0.25]
        [Final Score]
        """,
    "3": """
        You will be given two text segments in the following format: [text1][text2]. These two texts will be explanations for a counterintuitive video (humorous, creative, or magical). For text2, your task is to provide a score based on the following criteria:
        1. Language Expression: Score out of 5 points. Evaluate the fluency and word usage of the text. If the language expression is at a consistent level, award 5 points. If there are significant differences in language expression, award 0 points.
        2. Logic: Score out of 10 points. The explanation should be logically sound, preferably with logical words and cause-effect relationships. If the logic is nearly identical, award 10 points. If the logic is generally consistent but differs in details, award 5 points. If there are some differences in logic but still similar overall, award 5 points. If there are significant differences in logic, award 0 points.
        3. Common Sense Errors: Score out of 10 points. The explanation should not contain any obvious common sense errors. Deduct 5 points for each occurrence of a common sense error.
        4. Understanding of Humor, Creativity, or Magic: Score out of 40 points. If the explanation focuses on the same key points as the reference answer, award 35 points or above. If the explanation provides reasons for the counterintuitive phenomenon but differs from the reference answer, award between 15-35 points based on the difference. If the explanation provides reasons for the counterintuitive phenomenon but differs greatly from the reference answer, award between 0-15 points.
        5. Details: Score out of 35 points. While providing the explanation, include video details that contribute to the humor, creativity, or magical effect. Deduct 5 points for each additional or missing detail compared to the reference answer.
        6. If the explanation differs significantly from the reference answer and includes descriptive details not mentioned in the reference answer, multiply the total score by 0.5.
        7. The minimum score is 0, and the maximum score is 100.
        The output format is (remember not to have any comments, directly output scores) :
        [Language: Score], [Logic: Score], [Common Sense Errors: Score], [Understanding: Score], [Details: Score], [Factor: 1 or 0.5 or 0.25]
        [Final Score]
        """,
    "4": """
        You will be given four text segments in the following format: [Description][Explanation][text1][text2]. The first two texts are descriptions of a video and its explanation, respectively. The third text is a reference title. Your task is to evaluate whether the fourth text is a good title. Note that the fourth text may not be a title but a statement including the video. In that case, extract the actual title and evaluate it. Consider the following points while assigning a score:
        1. The title should mention the content of the video.
        2. A title with a certain level of humor or creativity is preferable.
        Provide a score ranging from 0 to 100, considering the above criteria and tell the reason.
        The output format is:
        [Final Score]
        ('Final Score' are in square brackets remember! Just one line! Remember not to have any comments, directly output scores. Remember DO NOT GIVE ME EXPLANATION!!!!!!!!!) :
        """,
}

_LAST_NUMBER_RE = re.compile(r"\d+(\.\d*)?(?=[^\d.]*$)")


def extract_last_number(string: str) -> float:
    """funqa/utils.py:103-113 — the last number in the string, else 0."""
    m = _LAST_NUMBER_RE.search(string)
    return float(m.group()) if m else 0


def build_judge_content(doc_prompt: str, candidate: str, task: str) -> str:
    """funqa/utils.py:174-177 — truncate the candidate to the task's cap and
    append it in brackets to the doc's pre-built prompt."""
    if len(candidate) > MAX_LEN[task]:
        candidate = candidate[: MAX_LEN[task]]
    return doc_prompt + "[" + candidate + "]"


def funqa_doc_to_text(doc, lmms_eval_specific_kwargs=None) -> str:
    """funqa/utils.py:238-240 — the bare question (yaml pre/post are "")."""
    return doc["question"]


def _default_judge() -> JudgeProvider:
    return create_provider(config=JudgeConfig(
        model_name=os.environ.get("MODEL_VERSION", "gpt-4o-2024-11-20"),
        temperature=0.2, max_tokens=1024))


def make_funqa_task(judge: JudgeProvider | None = None) -> BenchmarkTask:
    if judge is None:
        judge = _default_judge()

    def process(doc, response, rng=None) -> dict:
        task = doc["task"]
        content = build_judge_content(doc["prompt"], response, task)
        res = judge._complete_with_retry(
            content, system_prompt=SYSTEM_MESSAGES[task[1]])
        if res.success and res.content.strip():
            eval_answer = res.content.strip()
            gpt_score = extract_last_number(eval_answer)
            if gpt_score == 0:
                # intended-reference path returns ("", "", 0) for
                # unscorable replies (utils.py:199-201 break)
                eval_answer = ""
        else:
            eval_answer, gpt_score = "", 0
        return {"video_name": doc.get("video_name"),
                "pred_answer": response, "answer": doc["answer"],
                "task": task, "eval_answer": eval_answer,
                "gpt_score": gpt_score,
                "judge_success": bool(res.success)}

    def aggregate(results: list) -> dict:
        """Per-task-code means then mean-of-means (funqa/utils.py:303-349);
        BLEU/ROUGE over the same grouping via text_metrics."""
        if not results:
            return {"overall": 0.0, "gpt": {}, "BLEU4": {}, "ROUGE_L": {}}
        by_task: dict = {t: [] for t in FUNQA_TASK_CODES}
        for r in results:
            by_task.setdefault(r["task"], []).append(r)
        def task_means(fn):
            means = {t: (float(np.mean([fn(r) for r in rs])) if rs else 0)
                     for t, rs in by_task.items()}
            means["mean"] = sum(means[t] for t in by_task) / len(by_task)
            return means
        gpt = task_means(lambda r: r["gpt_score"])
        bleu = task_means(lambda r: bleu4(r["answer"], r["pred_answer"]))
        rouge = task_means(lambda r: rouge_l(r["answer"], r["pred_answer"]))
        return {"overall": gpt["mean"], "gpt": gpt, "BLEU4": bleu,
                "ROUGE_L": rouge,
                "judge_failures": sum(not r["judge_success"]
                                      for r in results),
                "bleurt": "gated: needs lucadiliello/BLEURT-20 weights "
                          "(see funqa_bleurt_scores)"}

    return BenchmarkTask(name="FunQA", doc_to_text=funqa_doc_to_text,
                         process_response=process, aggregate=aggregate,
                         video_path_keys=("video_name", "video_path"))


def funqa_bleurt_scores(results: list, model_dir: str | None = None) -> dict:
    """BLEURT per-task means (funqa/utils.py:271-300).  Requires the
    lucadiliello/BLEURT-20 checkpoint on local disk (``model_dir``) — the
    reference downloads it from the hub, which a zero-egress deployment
    cannot; run ``huggingface-cli download lucadiliello/BLEURT-20`` on a
    connected host and point ``model_dir`` at it."""
    if model_dir is None or not os.path.isdir(model_dir):
        raise RuntimeError(
            "BLEURT scoring needs the lucadiliello/BLEURT-20 checkpoint: "
            "download it on a connected host and pass model_dir")
    import torch
    from transformers import AutoModelForSequenceClassification, AutoTokenizer
    model = AutoModelForSequenceClassification.from_pretrained(model_dir)
    tok = AutoTokenizer.from_pretrained(model_dir)
    model.eval()
    by_task: dict = {t: [] for t in FUNQA_TASK_CODES}
    for r in results:
        with torch.no_grad():
            inputs = tok([r["answer"]], [r["pred_answer"]],
                         padding="longest", return_tensors="pt")
            by_task.setdefault(r["task"], []).append(
                model(**inputs).logits.flatten().tolist()[0])
    means = {t: (float(np.mean(v)) if v else 0) for t, v in by_task.items()}
    means["mean"] = sum(means[t] for t in FUNQA_TASK_CODES) / \
        len(FUNQA_TASK_CODES)
    return means


def register_funqa(judge: JudgeProvider | None = None) -> None:
    TASK_REGISTRY["FunQA"] = make_funqa_task(judge)


register_funqa()
