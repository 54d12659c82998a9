"""MMVU (Measuring Expert-Level Multi-Discipline Video Understanding) — val
split, direct + CoT flavors, LLM-judge scored.

Reference: lmms-eval/lmms_eval/tasks/mmvu/utils.py
  - prompt templates (:50-89) — four byte-exact variants keyed by
    question_type x CoT (note each template begins AND ends with a newline:
    they are triple-quoted with surrounding blank lines);
  - judge call (:131-186): ``server.evaluate_binary(question=...,
    answer=..., prediction=..., output_format="0/1", custom_prompt=...)``.
    **Reference quirk, preserved:** the custom prompts contain no ``{}``
    placeholders, and the judge-prompt builder returns
    ``custom_prompt.format(question=..., ...)`` verbatim when a custom
    prompt is given (llm_judge/utils.py:17-18) — so the judge request
    carries ONLY the rubric text, never the actual question/answer/
    prediction.  We replicate byte-for-byte because score parity with the
    reference matters more than judge quality; pass
    ``include_context=True`` to the factory for the evidently-intended
    behavior (rubric as system prompt + Q/A/prediction as user content).
  - scoring (:174-186): the judge reply must strip() to exactly "1";
  - aggregation (:233-300): 27 categories → 4 super-categories via
    TASK_MAP; docs with unknown categories are dropped from the totals.
"""

from __future__ import annotations

import os
import re

from .llm_judge import JudgeConfig, JudgeProvider, create_provider
from .tasks import TASK_REGISTRY, BenchmarkTask

MULTIPLE_CHOICE_PROMPT = """
Question:{question}
A: {a}
B: {b}
C: {c}
D: {d}
E: {e}
Visual Information: processed video
Do not generate any intermediate reasoning process. Answer directly with the option letter from the
given choices.
"""

OPEN_ENDED_PROMPT = """
Question:{question}
Visual Information: processed video
Do not generate any intermediate reasoning process. Directly output the final answer.
"""

MULTIPLE_CHOICE_PROMPT_COT = """
Question:{question}
A: {a}
B: {b}
C: {c}
D: {d}
E: {e}
Visual Information: processed video
Answer the given multiple-choice question step by step. Begin by explaining your reasoning process
clearly. Conclude by stating the final answer using the following format: "Therefore, the final answer
is: $LETTER" (without quotes), where $LETTER is one of the options. Think step by step before
answering.
"""

OPEN_ENDED_PROMPT_COT = """
Question:{question}
Visual Information: processed video
Answer the given question step by step. Begin by explaining your reasoning process clearly. Conclude
by stating the final answer using the following format: "Therefore, the final answer is: "Answer:
$ANSWER" (without quotes), where $ANSWER is the final answer of the question. Think step by
step before answering.
"""

MC_JUDGE_PROMPT = """You are a strict evaluator assessing answer correctness. You must output 1 for fully correct answers and 0 for any other case.

# Evaluation Rules for Multiple Choice Questions
- The model prediction may contain reasoning, but focus on the final answer.
- Score 1 if the predicted answer matches the ground truth answer.
- The answer can be given as just the letter (A, B, C, D, E) or include the full option text.
- Ignore minor differences in formatting, capitalization, or spacing.
- Score 0 for any incorrect answer, even if the reasoning process seems correct.

Return only "1" or "0" with no additional text or formatting."""

OPEN_JUDGE_PROMPT = """You are a strict evaluator assessing answer correctness. You must output 1 for fully correct answers and 0 for any other case.

# Evaluation Rules for Open-Ended Questions
- The model prediction may contain reasoning, focus on extracting the final answer.
- Score 1 if the prediction matches the answer semantically, even if in different format.
- Score 0 for partially correct answers or answers with extra incorrect information.
- Ignore minor differences in formatting, capitalization, or spacing.
- Treat numerical answers as correct if they match within reasonable precision.
- For questions requiring units, both value and unit must be correct.

Return only "1" or "0" with no additional text or formatting."""

# mmvu/utils.py:241-269 — 27 fine categories → 4 super-categories
TASK_MAP = {
    "Biology": "Science", "Chemistry": "Science",
    "Modern_Physics": "Science", "Astronomy": "Science",
    "Geography": "Science", "Materials_Science": "Science",
    "Neurobiology": "Science", "Electromagnetism": "Science",
    "Thermodynamics": "Science", "Mechanics": "Science",
    "Civil_Engineering": "Engineering",
    "Electrical_Engineering": "Engineering",
    "Mechanical_Engineering": "Engineering",
    "Biomedical_Engineering": "Engineering",
    "Electronics_and_Communication": "Engineering",
    "Computer_Science": "Engineering",
    "Clinical_Medicine": "Healthcare", "Basic_Medicine": "Healthcare",
    "Preventive_Medicine": "Healthcare", "Pharmacy": "Healthcare",
    "Dentistry": "Healthcare",
    "Art": "Humanities_and_Social_Science",
    "Literature": "Humanities_and_Social_Science",
    "History": "Humanities_and_Social_Science",
    "Law": "Humanities_and_Social_Science",
    "Economics": "Humanities_and_Social_Science",
    "Management": "Humanities_and_Social_Science",
}


def _fill(template: str, doc) -> str:
    if doc["question_type"] == "multiple-choice":
        c = doc["choices"]
        return template.format(question=doc["question"], a=c["A"], b=c["B"],
                               c=c["C"], d=c["D"], e=c["E"])
    return template.format(question=doc["question"])


def mmvu_doc_to_text(doc, lmms_eval_specific_kwargs=None) -> str:
    """mmvu/utils.py:92-101."""
    t = (MULTIPLE_CHOICE_PROMPT if doc["question_type"] == "multiple-choice"
         else OPEN_ENDED_PROMPT)
    return _fill(t, doc)


def mmvu_doc_to_text_cot(doc, lmms_eval_specific_kwargs=None) -> str:
    """mmvu/utils.py:104-113."""
    t = (MULTIPLE_CHOICE_PROMPT_COT
         if doc["question_type"] == "multiple-choice"
         else OPEN_ENDED_PROMPT_COT)
    return _fill(t, doc)


def construct_question_prompt(doc) -> str:
    """mmvu/utils.py:116-128."""
    if doc["question_type"] == "multiple-choice":
        c = doc["choices"]
        return (f"Question: {doc['question']}\nA: {c['A']}\nB: {c['B']}\n"
                f"C: {c['C']}\nD: {c['D']}\nE: {c['E']}")
    return f"Question: {doc['question']}"


def extract_category(doc) -> str:
    """mmvu/utils.py:189-191 — second-to-last path component."""
    return doc["video_path"].split("/")[-2]


def _default_judge() -> JudgeProvider:
    return create_provider(config=JudgeConfig(
        model_name=os.environ.get("MODEL_VERSION", "gpt-4o-2024-11-20"),
        max_tokens=16))


def make_mmvu_task(name: str, judge: JudgeProvider | None = None,
                   cot: bool = False,
                   include_context: bool = False) -> BenchmarkTask:
    if judge is None:
        judge = _default_judge()

    def process(doc, response, rng=None) -> dict:
        pred = response[0] if isinstance(response, list) else response
        pred = str(pred)
        answer = doc["answer"]
        if doc["question_type"] == "multiple-choice":
            full_answer = (f"{answer}: {doc['choices'][answer]}"
                           if answer in doc.get("choices", {})
                           else str(answer))
            rubric = MC_JUDGE_PROMPT
        else:
            full_answer = str(answer)
            rubric = OPEN_JUDGE_PROMPT
        question = construct_question_prompt(doc)
        if include_context:
            # fixed variant: rubric as system prompt, real content as user
            res = judge._complete_with_retry(
                f"Question: {question}\nGround truth: {full_answer}\n"
                f"Prediction: {pred}", system_prompt=rubric)
        else:
            res = judge.evaluate_binary(question=question, answer=full_answer,
                                        prediction=pred, output_format="0/1",
                                        custom_prompt=rubric)
        # mmvu/utils.py:175-186: exact "1" after strip, anything else is 0
        correct = bool(res.success) and res.content.strip() == "1"
        if doc["question_type"] == "multiple-choice":
            m = re.search(r"\b([A-E])\b", pred)
            extracted = m.group(1) if m else "N/A"
        else:
            extracted = pred[:100] + "..." if len(pred) > 100 else pred
        return {"question_id": doc.get("id"),
                "category": extract_category(doc),
                "pred_answer": extracted, "answer": answer,
                "correct": int(correct),
                "judge_success": bool(res.success)}

    def aggregate(results: list) -> dict:
        groups = sorted(set(TASK_MAP.values()))
        score = {g: {"correct": 0, "answered": 0} for g in groups}
        for r in results:
            g = TASK_MAP.get(r["category"])
            if g is None:  # unknown category → dropped (utils.py:279)
                continue
            score[g]["answered"] += 1
            score[g]["correct"] += r.get("correct", 0)
        out = {g: (100.0 * s["correct"] / s["answered"]
                   if s["answered"] else 0.0) for g, s in score.items()}
        tot_c = sum(s["correct"] for s in score.values())
        tot_a = sum(s["answered"] for s in score.values())
        out["overall"] = 100.0 * tot_c / tot_a if tot_a else 0.0
        out["judge_failures"] = sum(not r["judge_success"] for r in results)
        return out

    return BenchmarkTask(
        name=name,
        doc_to_text=mmvu_doc_to_text_cot if cot else mmvu_doc_to_text,
        process_response=process, aggregate=aggregate,
        video_path_keys=("video_path",))


def register_mmvu(judge: JudgeProvider | None = None, **kw) -> None:
    TASK_REGISTRY["MMVU"] = make_mmvu_task("MMVU", judge, cot=False, **kw)
    TASK_REGISTRY["MMVU-cot"] = make_mmvu_task("MMVU-cot", judge, cot=True,
                                               **kw)


register_mmvu()
