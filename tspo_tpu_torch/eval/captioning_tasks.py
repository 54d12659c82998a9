"""YouCook2 + CUVA: caption/anomaly free-text tasks scored by n-gram metrics.

Round-2 status called these "legitimately gated" on pycocoevalcap (+ the
CoreNLP Java jar) and the BLEURT checkpoint.  The gate was wider than it had
to be: everything except METEOR (Java) and BLEURT (downloadable torch
checkpoint) is plain algorithmic scoring, rebuilt pure-Python in
eval/text_metrics.py (corpus BLEU_1..4, ROUGE-L, CIDEr).

References:
  - youcook2 (lmms-eval/lmms_eval/tasks/youcook2/utils.py): one-sentence
    captioning; process keeps {answer, pred (ascii-filtered), video,
    timestamp}; aggregation groups by video, PTB-tokenizes, runs each coco
    scorer over the video's segment pairs, reports the mean over videos x100
    (utils.py:64-101).
  - cuva (lmms-eval/lmms_eval/tasks/cuva/utils.py): anomaly
    Description/Cause/Result prompts (:123-131); BLEU-4 and ROUGE-L scored
    per sample via single-pair pycocoevalcap (:60-94), averaged per task
    then across the three tasks (:149-172); BLEURT (:175-200) stays gated on
    the lucadiliello/BLEURT-20 checkpoint in this zero-egress build.
"""

from __future__ import annotations

from .tasks import TASK_REGISTRY, BenchmarkTask
from .text_metrics import bleu4, cider, corpus_bleu, rouge_l

YOUCOOK2_PROMPT = "Provide a one-sentence caption for the provided video."

CUVA_QUESTIONS = {
    "Description": ("Watch the video and describe any anomaly events you see "
                    "in the order they happen. Focus on what is different "
                    "from normal, like who or what is involved and their "
                    "actions."),
    "Cause": ("Explain why the anomaly in the video are happening. Use what "
              "you see in the video to make logical reasoning about the root "
              "reasons behind these anomalies.Please ensure that your "
              "response is logically rigorous and directly related to the "
              "abnormal events in the video and the potential reasons behind "
              "them."),
    "Result": ("Figure out what results and effect these anomalies have. "
               "Link the anomaly directly to their outcomes, like how they "
               "affect people or the environment. Your answer should be as "
               "clear and specific as possible, avoiding generalities and "
               "focusing directly on the video rather than summarizing the "
               "impact of a type of event on society."),
}

METEOR_GATED_NOTE = ("gated: METEOR requires the CoreNLP/METEOR Java jar "
                     "pycocoevalcap ships (no JVM in this build)")
BLEURT_GATED_NOTE = ("gated: needs lucadiliello/BLEURT-20 weights (see "
                     "funqa_bleurt_scores for the download runbook)")


def remove_nonascii(text: str) -> str:
    """youcook2/utils.py:20-21."""
    return "".join(i if ord(i) < 128 else " " for i in text)


# ---------------------------------------------------------------------------
# YouCook2
# ---------------------------------------------------------------------------

def youcook2_doc_to_text(doc, lmms_eval_specific_kwargs=None) -> str:
    """youcook2_doc_to_text (utils.py:46-50)."""
    kw = lmms_eval_specific_kwargs or {}
    return kw.get("prompt", YOUCOOK2_PROMPT)


def youcook2_process(doc, response, rng=None) -> dict:
    """youcook2_process_results (utils.py:53-60): one record fans out to all
    coco metrics in the reference; here a single record serves them all."""
    return {"question_id": doc.get("youtube_id"),
            "video": doc["youtube_id"], "timestamp": doc.get("segment"),
            "answer": remove_nonascii(doc["sentence"]),
            "pred": remove_nonascii(response or "")}


def aggregate_youcook2(results: list) -> dict:
    """youcook2_aggregate_results (utils.py:64-101): per-video corpus scores
    averaged over videos, x100.  CIDEr inherits pycocoevalcap's per-call df
    corpus (the video's segments).  "overall" = CIDEr.

    Reference quirk preserved for the Bleu_N keys: every Bleu_N metric maps
    to the same ``Bleu(4)`` scorer whose compute_score returns the 4-element
    cumulative list, and ``np.mean(all_scores)`` flattens the list-of-lists
    (utils.py:64-101) — so the reference reports ONE number, the grand mean
    of BLEU-1..4 over videos, under all four keys.  The true per-order
    corpus means are additionally exposed under "Bleu_per_order"."""
    if not results:
        return {"overall": 0.0}
    by_vid: dict = {}
    for r in results:
        by_vid.setdefault(r["video"], []).append(([r["answer"]], r["pred"]))
    bleu_sums = [0.0] * 4
    rouge_sum, cider_sum = 0.0, 0.0
    for pairs in by_vid.values():
        bleus = corpus_bleu(pairs)
        for k in range(4):
            bleu_sums[k] += bleus[k]
        # coco Rouge.compute_score = mean over the call's pairs
        rouge_sum += sum(rouge_l(refs[0], hyp)
                         for refs, hyp in pairs) / len(pairs)
        cider_sum += cider(pairs)
    nv = len(by_vid)
    bleu_ref_quirk = 100.0 * sum(bleu_sums) / (4 * nv)
    out = {f"Bleu_{k+1}": bleu_ref_quirk for k in range(4)}
    out["Bleu_per_order"] = {f"Bleu_{k+1}": 100.0 * bleu_sums[k] / nv
                             for k in range(4)}
    out["ROUGE_L"] = 100.0 * rouge_sum / nv
    out["CIDEr"] = 100.0 * cider_sum / nv
    out["METEOR"] = METEOR_GATED_NOTE
    out["overall"] = out["CIDEr"]
    return out


# ---------------------------------------------------------------------------
# CUVA
# ---------------------------------------------------------------------------

def cuva_doc_to_text(doc, lmms_eval_specific_kwargs=None) -> str:
    """cuva_doc_to_text (utils.py:123-131)."""
    return CUVA_QUESTIONS[doc["task"]]


def cuva_process(doc, response, rng=None) -> dict:
    """cuva_process_results (utils.py:140-147)."""
    return {"question_id": doc.get("question_id", doc.get("video_name")),
            "pred": response or "", "answer": doc["answer"],
            "task": doc["task"]}


def _cuva_task_means(results: list, score_fn) -> dict:
    """Per-task means over {Description, Cause, Result} (empty -> 0), plus
    their plain mean (utils.py:149-172)."""
    per = {"Description": [], "Cause": [], "Result": []}
    for r in results:
        per[r["task"]].append(score_fn(r["answer"], r["pred"]))
    means = {t: (sum(v) / len(v) if v else 0) for t, v in per.items()}
    means["mean"] = sum(means.values()) / 3
    return means


def aggregate_cuva(results: list) -> dict:
    if not results:
        return {"overall": 0.0}
    bleu = _cuva_task_means(results, bleu4)
    rouge = _cuva_task_means(results, rouge_l)
    return {"BLEU": bleu, "ROUGE": rouge, "bleurt": BLEURT_GATED_NOTE,
            "overall": bleu["mean"]}


def register_captioning_tasks() -> None:
    TASK_REGISTRY["YouCook2"] = BenchmarkTask(
        name="YouCook2", doc_to_text=youcook2_doc_to_text,
        process_response=youcook2_process, aggregate=aggregate_youcook2,
        video_path_keys=("video_path",))
    TASK_REGISTRY["CUVA"] = BenchmarkTask(
        name="CUVA", doc_to_text=cuva_doc_to_text,
        process_response=cuva_process, aggregate=aggregate_cuva,
        video_path_keys=("video_name", "video_path"),
        upper_ext_fallback=True)


register_captioning_tasks()
