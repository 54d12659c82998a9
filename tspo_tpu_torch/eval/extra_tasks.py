"""TemporalBench, MMWorld, and VideoEvalPro benchmark tasks.

Reference sources:
  - lmms-eval/lmms_eval/tasks/temporalbench/utils.py — binary QA scored by
    the FIRST CHARACTER of the response vs GT (:107-113), plus Multiple
    Binary Accuracy (a video counts only if every one of its questions is
    right, :115-131) and per-dataset/category breakdowns; the short/long
    captioning variant needs sentence-transformers (absent from this
    zero-egress image) — use a judged task for captions instead.
  - lmms-eval/lmms_eval/tasks/mmworld/utils.py — VideoMME-style option
    prompt but with ``str(doc["options"])`` (the python list repr!) and a
    "The best answer is:" default post prompt (:85-93); EgoPlan's parser
    with the concatenated-prefix quirk (:96-114); per-discipline breakdown,
    overall accuracy ×100 (:141-169).
  - lmms-eval/lmms_eval/tasks/videoevalpro/utils.py — open-ended QA graded
    by a SimpleQA-style CORRECT/INCORRECT/NOT_ATTEMPTED judge returning
    A/B/C (:56-100, prompt extracted byte-exact into
    videoevalpro_prompt.py); per-qa_type + overall fraction (:126-149).
"""

from __future__ import annotations

import os

from .llm_judge import JudgeConfig, JudgeProvider, create_provider
from .spatial_tasks import egoplan_extract_letter
from .tasks import TASK_REGISTRY, BenchmarkTask
from .videoevalpro_prompt import VEP_JUDGE_PROMPT_TEMPLATE

# ---------------------------------------------------------------------------
# TemporalBench
# ---------------------------------------------------------------------------


def temporalbench_doc_to_text(doc, lmms_eval_specific_kwargs=None) -> str:
    """temporalbench/utils.py:43-44: the bare question field."""
    return doc["question"]


def _temporalbench_process(doc, response, rng=None) -> dict:
    # utils.py:111: first character vs GT, case-insensitive.  (The reference
    # would IndexError on an empty response; "" scores wrong instead.)
    first = response[0].lower() if response else ""
    return {"idx": doc.get("idx"), "video_name": doc.get("video_name"),
            "dataset": doc.get("dataset"), "category": doc.get("category"),
            "pred_answer": response,
            "answer": doc.get("GT"),
            "correct": int(first == str(doc.get("GT", "")).lower())}


def aggregate_temporalbench(results: list) -> dict:
    """utils.py:90-200: Binary Accuracy + Multiple Binary Accuracy (all
    questions of a video must be right) + per-dataset/category breakdowns
    (the reference only logs the breakdowns; returned here)."""
    out = {}
    if not results:
        return {"binary_accuracy": 0.0, "multiple_binary_accuracy": 0.0}
    correct = sum(r["correct"] for r in results)
    out["binary_accuracy"] = 100.0 * correct / len(results)
    per_video: dict = {}
    for r in results:
        v = r["video_name"]
        per_video[v] = per_video.get(v, True) and bool(r["correct"])
    out["multiple_binary_accuracy"] = \
        100.0 * sum(per_video.values()) / len(per_video)
    for key in ("dataset", "category"):
        groups: dict = {}
        for r in results:
            if r.get(key):
                groups.setdefault(r[key], []).append(r)
        if groups:
            out[f"per_{key}"] = {
                g: 100.0 * sum(r["correct"] for r in rows) / len(rows)
                for g, rows in sorted(groups.items())}
    return out


# ---------------------------------------------------------------------------
# TemporalBench captioning (similarity-scored)
# ---------------------------------------------------------------------------

def embed_mean_pooled(texts: list, path: str, batch_size: int = 64):
    """Sentence embeddings from a LOCAL sentence-transformers-layout
    checkpoint dir (config.json + weights + tokenizer): last_hidden_state
    mean-pooled over the attention mask, L2-normalized — exactly what
    all-MiniLM-L6-v2's SentenceTransformer module stack computes, without
    the (download-gated) sentence-transformers package."""
    import numpy as np
    import torch
    from transformers import AutoModel, AutoTokenizer
    tok = AutoTokenizer.from_pretrained(path)
    model = AutoModel.from_pretrained(path).eval()
    out = []
    for s in range(0, len(texts), batch_size):
        enc = tok(texts[s:s + batch_size], padding=True, truncation=True,
                  return_tensors="pt")
        with torch.no_grad():
            h = model(**enc).last_hidden_state
        m = enc["attention_mask"].unsqueeze(-1).to(h.dtype)
        e = (h * m).sum(1) / m.sum(1).clamp(min=1e-9)
        out.append(torch.nn.functional.normalize(e, dim=-1).numpy())
    return np.concatenate(out, axis=0)


def _temporalbench_caption_process(doc, response, rng=None) -> dict:
    return {"idx": doc.get("idx"), "video_name": doc.get("video_name"),
            "dataset": doc.get("dataset"),
            "pred_answer": response, "answer": doc.get("GT")}


def make_temporalbench_caption_aggregate(embedder_path: str | None = None):
    """temporalbench_caption_aggregate_results (utils.py:54-87): mean
    cosine(pred, GT) x 100 under a MiniLM sentence embedder.  The reference
    hardcodes a sentence-transformers download ("all-MiniLM-L6-v2"); here
    any local checkpoint in that layout plugs in via ``embedder_path`` or
    TSPO_EMBEDDER_PATH (round-3 VERDICT next-step #8)."""

    def aggregate(results: list) -> dict:
        if not results:
            return {"similarity": 0.0}
        path = embedder_path or os.environ.get("TSPO_EMBEDDER_PATH")
        if not path:
            raise RuntimeError(
                "TemporalBench-captioning needs a sentence embedder. "
                "Runbook: download any sentence-transformers-layout "
                "checkpoint dir (the reference uses "
                "sentence-transformers/all-MiniLM-L6-v2 — files config.json,"
                " model.safetensors, tokenizer.json/vocab.txt) and pass it "
                "via TSPO_EMBEDDER_PATH=<dir> or "
                "register_extra_tasks(embedder_path=<dir>).")
        preds = [str(r["pred_answer"]) for r in results]
        gts = [str(r["answer"]) for r in results]
        emb = embed_mean_pooled(preds + gts, path)
        n = len(preds)
        sims = (emb[:n] * emb[n:]).sum(axis=-1)   # rows are L2-normalized
        return {"similarity": float(sims.mean() * 100.0)}

    return aggregate


# ---------------------------------------------------------------------------
# MMWorld
# ---------------------------------------------------------------------------

MMWORLD_DISCIPLINES = ["Tech & Engineering", "Science", "Health & Medicine",
                       "Sports & Arts", "Game", "Business", "Embodied Tasks"]


def mmworld_doc_to_text(doc, lmms_eval_specific_kwargs=None) -> str:
    """mmworld/utils.py:85-93 — options rendered via str(list) on purpose."""
    kw = lmms_eval_specific_kwargs or {}
    option_prompt = ("Select the best answer to the following multiple-choice "
                     "question based on the video and the subtitles. Respond "
                     "with only the letter (A, B, C, or D) of the correct "
                     "option.")
    question = doc["question"] + "\n" + str(doc["options"])
    post = kw.get("post_prompt", "The best answer is:")
    return option_prompt + "\n" + question + "\n" + post


def _mmworld_process(doc, response, rng=None) -> dict:
    # same parser as EgoPlan (mmworld/utils.py:96-114 is an exact copy,
    # concatenated-prefix quirk included)
    return {"video_id": doc.get("video_id"),
            "discipline": doc.get("discipline"),
            "pred_answer": egoplan_extract_letter(response),
            "answer": str(doc.get("correct_answer_label", "")).upper()}


def aggregate_mmworld(results: list) -> dict:
    out = {}
    for d in MMWORLD_DISCIPLINES:
        rows = [r for r in results if r.get("discipline") == d]
        if rows:
            out[d] = 100.0 * sum(r["pred_answer"] == r["answer"]
                                 for r in rows) / len(rows)
    out["overall"] = (100.0 * sum(r["pred_answer"] == r["answer"]
                                  for r in results) / len(results)
                      if results else 0.0)
    return out


# ---------------------------------------------------------------------------
# VideoEvalPro
# ---------------------------------------------------------------------------

VEP_TASK_TYPES = ("Local Perception", "Local Reasoning",
                  "Holistic Perception", "Holistic Reasoning")


def vep_judge_prompt(question: str, target: str, predicted_answer: str) -> str:
    return VEP_JUDGE_PROMPT_TEMPLATE.format(
        question=question, target=target, predicted_answer=predicted_answer)


def videoevalpro_doc_to_text(doc, lmms_eval_specific_kwargs=None) -> str:
    kw = lmms_eval_specific_kwargs or {}
    return (f"{kw.get('pre_prompt', '')}{doc['question']}"
            f"{kw.get('post_prompt', '')}")


def make_videoevalpro_task(judge: JudgeProvider | None = None) -> BenchmarkTask:
    if judge is None:
        judge = create_provider(config=JudgeConfig(
            model_name=os.environ.get("MODEL_VERSION", "gpt-4o-2024-11-20"),
            max_tokens=5))

    def process(doc, response, rng=None) -> dict:
        q = (doc.get("question") or "").strip()
        gt = (doc.get("answer_text") or "").strip()
        res = judge._complete_with_retry(vep_judge_prompt(q, gt, response))
        # utils.py:103: grade A == CORRECT; any failure counts incorrect
        ok = bool(res.success and res.content.strip()[:1].upper() == "A")
        return {"question": q, "task_type": (doc.get("qa_type") or "").strip(),
                "text_gt": gt, "pred_ans": response, "judge_result": ok}

    def aggregate(results: list) -> dict:
        out = {}
        for t in VEP_TASK_TYPES:
            rows = [r for r in results if r["task_type"] == t]
            out[t] = (sum(r["judge_result"] for r in rows) / len(rows)
                      if rows else 0.0)
        out["overall"] = (sum(r["judge_result"] for r in results)
                          / len(results) if results else 0.0)
        return out

    return BenchmarkTask(name="VideoEvalPro",
                         doc_to_text=videoevalpro_doc_to_text,
                         process_response=process, aggregate=aggregate,
                         video_path_keys=("video", "video_path"))


def register_extra_tasks(judge: JudgeProvider | None = None,
                         embedder_path: str | None = None) -> None:
    TASK_REGISTRY["TemporalBench"] = BenchmarkTask(
        name="TemporalBench", doc_to_text=temporalbench_doc_to_text,
        process_response=_temporalbench_process,
        aggregate=aggregate_temporalbench,
        video_path_keys=("video_name", "video_path"))
    TASK_REGISTRY["TemporalBench-captioning"] = BenchmarkTask(
        name="TemporalBench-captioning",
        doc_to_text=temporalbench_doc_to_text,
        process_response=_temporalbench_caption_process,
        aggregate=make_temporalbench_caption_aggregate(embedder_path),
        video_path_keys=("video_name", "video_path"))
    TASK_REGISTRY["MMWorld"] = BenchmarkTask(
        name="MMWorld", doc_to_text=mmworld_doc_to_text,
        process_response=_mmworld_process, aggregate=aggregate_mmworld,
        video_path_keys=("video_id", "video_path"), video_suffix=".mp4")
    if judge is not None:
        TASK_REGISTRY["VideoEvalPro"] = make_videoevalpro_task(judge)


register_extra_tasks()
