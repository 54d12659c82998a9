"""PLM-VideoBench — fgqa / sgqa / rcap / rdcap / rtloc sub-tasks.

Reference sources (lmms-eval/lmms_eval/tasks/plm_videobench/):
  - eval_utils.py — segment IoU (:19-27), detection precision/recall
    (:30-61), ``[start, end] caption`` parsing (:64-86), the SODA dp
    matching from Fujita et al. ECCV'20 (:89-128), SODA_c with an
    LLM-judged caption-similarity score matrix (:131-151), the two judge
    prompts (:154-198), and bbox drawing (:273-290);
  - fgqa/fgqa_utils.py — multiple-choice QA with one-vs-all ("multibinary")
    accuracy grouped by qa_uid;
  - sgqa/sgqa_utils.py — open QA judged yes/no;
  - rcap/rcap_utils.py — region caption judged 0-10, averaged /10;
  - rdcap/rdcap_utils.py — region dense captioning scored SODA_c with a
    pairwise judged score matrix;
  - rtloc/rtloc_utils.py — region temporal localization, mean precision/
    recall over tIoU {0.3,0.5,0.7,0.9} + mIOU.

All prompt templates are the yaml ``lmms_eval_specific_kwargs.default``
strings byte-exact (including the surviving literal ``{answer}`` placeholder:
the reference formats with ``answer="{answer}"`` so downstream model adapters
can splice the answer slot).  The STC tasks' red-rectangle overlay runs as a
``transform_frames`` hook using the doc's masklet bboxes, indexed by the
harness's actual ``frame_idx`` (the reference indexes its uniform
``sample_pos`` the same way, eval_utils.py:283).
"""

from __future__ import annotations

import ast
import json
import os
import re

import numpy as np

from .llm_judge import JudgeConfig, JudgeProvider, create_provider
from .tasks import TASK_REGISTRY, BenchmarkTask

NUM_VIDEO_FRAMES = 32  # _default_template_yaml num_video_frames

# ---------------------------------------------------------------------------
# metric primitives (eval_utils.py) — rewritten, value-parity-tested
# ---------------------------------------------------------------------------


def calculate_iou(range_1, range_2) -> float:
    """eval_utils.py:19-27 — plain 1-D IoU with +1e-8 denominator."""
    s1, e1 = float(min(*range_1)), float(max(*range_1))
    s2, e2 = float(min(*range_2)), float(max(*range_2))
    inter = max(0.0, min(e1, e2) - max(s1, s2))
    union = min(max(e1, e2) - min(s1, s2), (e1 - s1) + (e2 - s2))
    return inter / (union + 1e-8)


def evaluate_detections(predicted_segments, gt_segments,
                        iou_thresholds=(0.3, 0.5, 0.7, 0.9)):
    """eval_utils.py:30-61 — per-threshold covered-set precision/recall plus
    the (n_gt, max(n_pred, 1)) IoU matrix.  Coverage uses STRICT > threshold
    (reference line 48)."""
    pred = np.asarray(predicted_segments, dtype=float).reshape(-1, 2) \
        if len(predicted_segments) else np.zeros((0, 2))
    gt = np.asarray(gt_segments, dtype=float).reshape(-1, 2)
    n_gt, n_pred = gt.shape[0], pred.shape[0]

    iou_matrix = np.zeros((n_gt, max(n_pred, 1)))
    for g in range(n_gt):
        for p in range(n_pred):
            iou_matrix[g, p] = calculate_iou(pred[p], gt[g])

    metrics = {}
    precision, recall = [], []
    for t in iou_thresholds:
        covered = iou_matrix > t
        pred_covered = {p for p in range(n_pred) if covered[:, p].any()}
        gt_covered = {g for g in range(n_gt) if covered[g, :n_pred].any()}
        m = {"pred_covered": pred_covered, "gt_covered": gt_covered,
             "precision": float(len(pred_covered)) / max(float(n_pred), 1.0),
             "recall": float(len(gt_covered)) / float(n_gt)}
        metrics[str(t)] = m
        precision.append(m["precision"])
        recall.append(m["recall"])
    return precision, recall, iou_matrix, metrics


_DELTA_SEG_RE = re.compile(r"\[(\d+,\s*\d+)\]([^[]*)")


def extract_delta_segments(caption: str):
    """eval_utils.py:64-86 — parse "[start, end] caption" runs."""
    segments, captions = [], []
    for span, text in _DELTA_SEG_RE.findall(caption):
        segments.append([int(x) for x in span.replace(" ", "").split(",")])
        t = text.replace(":", " ").replace("\nFrame ", "").strip()
        if t.endswith(","):
            t = t[:-1]
        captions.append(t.strip().replace("\n", " ").strip())
    if not segments:
        return segments, captions
    return np.array(segments), captions


def monotone_assignment_score(scores: np.ndarray) -> float:
    """Max-score monotone (order-preserving) one-to-one matching — the SODA
    dp of eval_utils.py:89-128 (``chased_dp_assignment``), iterative instead
    of recursive.  dp[i,j] = best of skip-row, skip-col, or match (i,j) on
    top of dp[i-1,j-1]; identical values for the non-negative score matrices
    SODA produces."""
    m, n = scores.shape
    dp = np.zeros((m, n))
    for i in range(m):
        for j in range(n):
            best = scores[i, j] + (dp[i - 1, j - 1] if i and j else 0.0)
            if i:
                best = max(best, dp[i - 1, j])
            if j:
                best = max(best, dp[i, j - 1])
            dp[i, j] = best
    return float(dp[m - 1, n - 1])


def sodac_llm_score(iou_matrix, score_matrix, predicted_captions,
                    gt_captions, iou_thresholds=(0.0,)) -> float:
    """eval_utils.py:131-151 — SODA_c: F1 of the dp-matched (IoU-masked x
    judge-scored) assignment, averaged over thresholds."""
    if not predicted_captions:
        return 0
    fs = []
    for t in iou_thresholds:
        iou_cur = np.copy(iou_matrix)
        iou_cur[iou_cur < t] = 0.0
        max_score = monotone_assignment_score(iou_cur * score_matrix)
        n_g, n_p = iou_cur.shape
        p, r = max_score / n_p, max_score / n_g
        fs.append(2 * p * r / (p + r) if p + r > 0 else 0)
    return float(np.mean(fs))


# ---------------------------------------------------------------------------
# judge prompts (eval_utils.py:154-198, byte-exact)
# ---------------------------------------------------------------------------

CAPTION_JUDGE_SYS_PROMPT = (
    "Your task is to score a predicted caption from a model for how similar it is to the ground truth caption, "
    "providing a single integer score between 0-10 indicating the similarity and an explanation. "
    "Focus on whether the information in the ground truth caption is present and accurately represented in the predicted caption. "
    "A score of 10 indicates that the predicted caption accurately represents all the information present in the ground truth caption. "
    "Subtract points for missing and inaccurate information, with lower scores for more significant errors. "
    "Do not penalize extra information in the predicted caption unless it contradicts the ground truth caption. "
    "Do not penalize minor differences in phrasing or word choice. "
    'Respond in the following JSON format: {"score": <int>, "explanation": "<str>"} '
    "where score is between 0-10 and explanation is a short sentence.")

SGQA_JUDGE_SYS_PROMPT = (
    "You are an intelligent chatbot designed for evaluating the correctness of generative outputs for question-answer pairs. "
    "Your task is to compare the predicted answer with the correct answer and determine if they match meaningfully. Here's how you can accomplish the task:"
    "------"
    "##INSTRUCTIONS: "
    "- Focus on the meaningful match between the predicted answer and the correct answer.\n"
    "- Consider synonyms or paraphrases as valid matches.\n"
    "- Evaluate the correctness of the prediction compared to the answer.")


def caption_judge_user_prompt(gt: str, pred: str) -> str:
    return ("Please score the following predicted caption. Respond with "
            "only the JSON.\nPredicted caption: "
            f"{pred}\nGround truth caption: {gt}\n\n")


def sgqa_judge_user_prompt(question: str, pred: str, target: str) -> str:
    return (
        "Please evaluate the following video-based question-answer pair:\n\n"
        f"Question: {question}\n"
        f"Correct Answer: {target}\n"
        f"Predicted Answer: {pred}\n\n"
        "Provide your evaluation only as a yes/no and score where the score is an integer value between 0 and 5, with 5 indicating the highest meaningful match. "
        "Please generate the response in the form of a Python dictionary string with keys 'pred' and 'score', where value of 'pred' is  a string of 'yes' or 'no' and value of 'score' is in INTEGER, not STRING."
        "DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR EXPLANATION. Only provide the Python dictionary string. "
        'For example, your response should look like this: {"pred": "yes", "score": 4.8}}.')


# ---------------------------------------------------------------------------
# default prompt templates (yaml lmms_eval_specific_kwargs.default)
# ---------------------------------------------------------------------------

FGQA_PROMPT = "{question}{answer}"
SGQA_PROMPT = ("The following question is asked by the camera wearer at the "
               "end of the video.  Provide a detailed answer even if unsure."
               "  Try to answer in around 20-30 words.  Now answer the "
               "following question based on the video content: "
               "{question}{answer}")
RCAP_PROMPT = ("Give a detailed description of the events occurring in the "
               "region marked by the red rectangle within frames "
               "[{start_frame}, {end_frame}] in this {total_frames} frame "
               "video.")
RDCAP_PROMPT = ("Create a dense caption of the subject's actions within the "
                "red rectangles, including action frames ids and brief "
                "descriptions. For each item use the format [start, end]: "
                "[description] separated by a newline, where start and end "
                "are frame numbers between {start_frame} and {end_frame} in "
                "this {total_frames} frame video.")
RTLOC_PROMPT = ("Given the region marked by the red rectangle in the video, "
                "please provide the start and end frame of when '{caption}' "
                "happens. Use the format [start, end] where start and end "
                "are frame numbers between {min_frame_idx} and "
                "{max_frame_idx} in this {num_frames} frame video.")


# ---------------------------------------------------------------------------
# fgqa (rule-based)
# ---------------------------------------------------------------------------


def fgqa_qa_template(entry) -> tuple:
    """fgqa_utils.py::qa_template — letters from the numeric suffix of the
    ``option_<i>`` keys; the gold letter found by option-text match."""
    question = f"Question: {entry['question']}\n" + "Options:\n"
    answer = entry["answer"]
    answer_idx = -1
    for key, text in entry["options"].items():
        idx = int(key.split("_")[-1])
        question += f"({chr(ord('A') + idx)}) {text}\n"
        if text == answer:
            answer_idx = idx
    if answer_idx == -1:
        raise ValueError("Answer not found in options")
    question = question.rstrip() + "\nOnly give the best option."
    return question, f"({chr(ord('A') + answer_idx)}) {answer}"


def check_ans(pred: str, gt: str) -> bool:
    """fgqa_utils.py::check_ans — option-token containment either way.
    Quirks preserved: pred_content spans token 0 onward; gt_content[-1]
    IndexErrors on empty content (never hit: gt is always "(X) text")."""
    if "answer:" in pred.lower():
        pred = pred.lower().replace("answer:", "").strip()
    pred_list = pred.lower().split(" ")
    pred_option = pred_list[0]
    if len(pred_option) == 0:
        return False
    gt_list = gt.lower().split(" ")
    gt_option, gt_content = gt_list[0], " ".join(gt_list[1:])
    if gt_content[-1] == ".":
        gt_content = gt_content[:-1]
    if pred_option.replace(".", "") in gt_option:
        return True
    if gt_option in pred_option:
        return True
    return False


def fgqa_doc_to_text(doc, lmms_eval_specific_kwargs=None) -> str:
    kw = {"prompt": FGQA_PROMPT, **(lmms_eval_specific_kwargs or {})}
    question, _ = fgqa_qa_template(doc)
    return kw["prompt"].format(question=question, answer="{answer}")


def _fgqa_process(doc, response, rng=None) -> dict:
    _, answer = fgqa_qa_template(doc)
    return {"uid": doc.get("uid"), "qa_uid": doc.get("qa_uid"),
            "pred_answer": response, "answer": answer,
            "accuracy": float(check_ans(pred=response, gt=answer))}


def aggregate_fgqa(results: list) -> dict:
    """Multibinary accuracy: a qa_uid group counts only if ALL its binary
    sub-questions are right (fgqa_utils.py:75-81, pandas groupby.all)."""
    if not results:
        return {"overall": 0.0, "multibinary_accuracy": 0.0,
                "num_instances": 0}
    groups: dict = {}
    for r in results:
        groups.setdefault(r["qa_uid"], []).append(bool(r["accuracy"]))
    mb = float(np.mean([all(v) for v in groups.values()]))
    return {"overall": 100.0 * mb, "multibinary_accuracy": mb,
            "num_instances": len(results)}


# ---------------------------------------------------------------------------
# STC bbox overlay (transform_frames hook)
# ---------------------------------------------------------------------------


def load_stc_metadata(path: str) -> dict:
    """metadata_test.jsonl → {(video, masklet_id): entry}
    (eval_utils.py:308-324, minus the hub download: the file is local)."""
    with open(path) as f:
        metadata = [json.loads(line) for line in f if line.strip()]
    return {(e["video"], e["masklet_id"]): e for e in metadata}


def draw_bounding_boxes(frames: np.ndarray, positions, bbox_map: dict):
    """Red rectangles (width 4) at each frame's bbox, like
    eval_utils.py:273-290 but on the harness's uint8 array."""
    from PIL import Image, ImageDraw
    out = []
    for frame, pos in zip(frames, positions):
        bbox = bbox_map.get(int(pos))
        if bbox:
            img = Image.fromarray(np.asarray(frame))
            x1, y1, x2, y2 = bbox
            ImageDraw.Draw(img).rectangle([(x1, y1), (x2, y2)],
                                          outline=(255, 0, 0), width=4)
            frame = np.asarray(img)
        out.append(np.asarray(frame))
    return np.stack(out)


def make_stc_transform(metadata: dict | None):
    """Frames hook: look up the doc's masklet bboxes and draw them at the
    positions actually gathered (frame_idx)."""
    def transform(doc, frames, frame_idx):
        if metadata is None:
            return frames
        entry = metadata.get((doc.get("video"), doc.get("masklet_id")))
        if entry is None:
            return frames
        bbox_map = {int(k): v for k, v in entry["bbox"].items()}
        return draw_bounding_boxes(frames, frame_idx, bbox_map)
    return transform


# ---------------------------------------------------------------------------
# sgqa / rcap / rdcap (judged) + rtloc (rule-based)
# ---------------------------------------------------------------------------


def _default_judge() -> JudgeProvider:
    return create_provider(config=JudgeConfig(
        model_name=os.environ.get("MODEL_VERSION",
                                  "Llama-3.3-70B-Instruct"),
        max_tokens=256))


def _judge_caption_score(judge: JudgeProvider, gt: str, pred: str):
    """One rcap/rdcap judgement: JSON {"score": int, "explanation": str};
    parse failure scores 0 (rcap_utils.py:62-70)."""
    res = judge._complete_with_retry(caption_judge_user_prompt(gt, pred),
                                     system_prompt=CAPTION_JUDGE_SYS_PROMPT)
    try:
        judgement = json.loads(res.content)
        judgement["score"]
        return 1, judgement
    except Exception:  # noqa: BLE001 — reference bare-excepts too
        return 0, {"score": 0, "explanation": "N/A"}


def _rescaled_gt_window(doc, num_frames: int):
    rf = doc["total_frames"] / num_frames
    return [int(doc["start_frame"] / rf), int(doc["end_frame"] / rf)]


def make_plm_tasks(judge: JudgeProvider | None = None,
                   stc_metadata: dict | str | None = None,
                   num_video_frames: int = NUM_VIDEO_FRAMES) -> dict:
    """Build all five PLM-VideoBench tasks.  ``stc_metadata`` is the masklet
    bbox map (or a metadata_test.jsonl path); without it the STC tasks run
    but skip the rectangle overlay (and say so once)."""
    if judge is None:
        judge = _default_judge()
    if isinstance(stc_metadata, str):
        stc_metadata = load_stc_metadata(stc_metadata)
    stc_transform = make_stc_transform(stc_metadata)

    # ---- sgqa ----
    def sgqa_doc_to_text(doc, lmms_eval_specific_kwargs=None):
        kw = {"prompt": SGQA_PROMPT, **(lmms_eval_specific_kwargs or {})}
        return kw["prompt"].format(question=doc["question"],
                                   answer="{answer}")

    def sgqa_process(doc, response, rng=None):
        res = judge._complete_with_retry(
            sgqa_judge_user_prompt(question=doc["question"], pred=response,
                                   target=doc["answer"]),
            system_prompt=SGQA_JUDGE_SYS_PROMPT)
        try:
            judgement = json.loads(res.content)
        except Exception:  # noqa: BLE001 — sgqa_utils.py:55-60
            judgement = {"pred": "yes" if "yes" in res.content
                         or "Yes" in res.content else "no",
                         "reason": "parse_error"}
        return {"uid": doc.get("uid"), "pred_answer": response,
                "answer": doc.get("answer"),
                "success": judgement.get("pred") == "yes",
                "judge_success": bool(res.success)}

    def sgqa_aggregate(results):
        if not results:
            return {"overall": 0.0, "success": 0.0, "num_instances": 0}
        s = float(np.mean([r["success"] for r in results]))
        return {"overall": 100.0 * s, "success": s,
                "num_instances": len(results),
                "judge_failures": sum(not r["judge_success"]
                                      for r in results)}

    # ---- rcap ----
    def rcap_doc_to_text(doc, lmms_eval_specific_kwargs=None):
        kw = {"prompt": RCAP_PROMPT, **(lmms_eval_specific_kwargs or {})}
        start, end = _rescaled_gt_window(doc, num_video_frames)
        return kw["prompt"].format(start_frame=start, end_frame=end,
                                   total_frames=doc["total_frames"])

    def rcap_process(doc, response, rng=None):
        success, judgement = _judge_caption_score(judge, doc["caption"],
                                                  response)
        return {"uid": doc.get("uid"), "success": success,
                "pred_answer": response, "answer": doc.get("caption"),
                "llm_judge_score": judgement["score"] / 10,
                "llm_judge_explanation": judgement.get("explanation", "")}

    def rcap_aggregate(results):
        if not results:
            return {"overall": 0.0, "llm_judge_score": 0.0,
                    "num_instances": 0}
        score = round(float(np.mean([r["llm_judge_score"]
                                     for r in results])), 4)
        return {"overall": 100.0 * score, "llm_judge_score": score,
                "success_rate": round(float(np.mean([r["success"]
                                                     for r in results])), 4),
                "num_instances": len(results)}

    # ---- rdcap ----
    def rdcap_doc_to_text(doc, lmms_eval_specific_kwargs=None):
        kw = {"prompt": RDCAP_PROMPT, **(lmms_eval_specific_kwargs or {})}
        return kw["prompt"].format(start_frame=0,
                                   end_frame=num_video_frames - 1,
                                   total_frames=num_video_frames)

    def rdcap_process(doc, response, rng=None):
        pred_segments, pred_captions = extract_delta_segments(response)
        if len(pred_segments) == 0:
            return {"uid": doc.get("uid"), "SODA_c": 0.0,
                    "pred_answer": response}
        rf = doc["total_frames"] / num_video_frames
        gt = doc["dense_captions"]
        gt_segments = np.array([[int(e["start_frame"] / rf),
                                 int(e["end_frame"] / rf)] for e in gt])
        gt_captions = [e["caption"] for e in gt]
        scores = []
        for gt_caption in gt_captions:
            for pred_caption in pred_captions:
                _, judgement = _judge_caption_score(judge, gt_caption,
                                                    pred_caption)
                try:
                    scores.append(judgement["score"] / 10)
                except Exception:  # noqa: BLE001
                    scores.append(0.0)
        score_matrix = np.array(scores).reshape(len(gt_captions),
                                                len(pred_captions))
        _, _, iou_matrix, _ = evaluate_detections(
            pred_segments, gt_segments, iou_thresholds=(0.3, 0.5, 0.7, 0.9))
        soda_c = sodac_llm_score(iou_matrix, score_matrix, pred_captions,
                                 gt_captions, (0.0,))
        return {"uid": doc.get("uid"), "SODA_c": soda_c,
                "pred_answer": response}

    def rdcap_aggregate(results):
        if not results:
            return {"overall": 0.0, "SODA_c": 0.0, "num_instances": 0}
        s = round(float(np.mean([r["SODA_c"] for r in results])), 4)
        return {"overall": 100.0 * s, "SODA_c": s,
                "num_instances": len(results)}

    # ---- rtloc ----
    def rtloc_doc_to_text(doc, lmms_eval_specific_kwargs=None):
        kw = {"prompt": RTLOC_PROMPT, **(lmms_eval_specific_kwargs or {})}
        return kw["prompt"].format(caption=doc["caption"], min_frame_idx=0,
                                   max_frame_idx=num_video_frames - 1,
                                   num_frames=num_video_frames)

    def rtloc_process(doc, response, rng=None):
        try:
            window = re.findall(
                r"(\[[0-9]+(?:\.[0-9]+)?,\s*[0-9]+(?:\.[0-9]+)?\])",
                response)[0]
            pred_segment = np.array([ast.literal_eval(window)])
            parse_error = 0
        except Exception:  # noqa: BLE001 — rtloc_utils.py:62-66
            pred_segment = np.array([[doc["end_frame"] + 10,
                                      doc["end_frame"] + 20]])
            parse_error = 1
        gt_segment = np.array([_rescaled_gt_window(doc, num_video_frames)])
        precision, recall, iou_matrix, _ = evaluate_detections(
            pred_segment, gt_segment, iou_thresholds=(0.3, 0.5, 0.7, 0.9))
        return {"uid": doc.get("uid"), "parse_error": parse_error,
                "pred_answer": response,
                "mean_precision": sum(precision) / len(precision),
                "mean_recall": sum(recall) / len(recall),
                "mIOU": iou_matrix[0, 0]}

    def rtloc_aggregate(results):
        if not results:
            return {"overall": 0.0, "mIOU": 0.0, "num_instances": 0}
        out = {k: round(float(np.mean([r[k] for r in results])), 4)
               for k in ("mean_precision", "mean_recall", "mIOU")}
        out["overall"] = 100.0 * out["mIOU"]
        out["num_instances"] = len(results)
        return out

    stc_keys = ("video", "video_path")
    return {
        "PLM-fgqa": BenchmarkTask(
            name="PLM-fgqa", doc_to_text=fgqa_doc_to_text,
            process_response=_fgqa_process, aggregate=aggregate_fgqa,
            video_path_keys=("video", "video_path")),
        "PLM-sgqa": BenchmarkTask(
            name="PLM-sgqa", doc_to_text=sgqa_doc_to_text,
            process_response=sgqa_process, aggregate=sgqa_aggregate,
            video_path_keys=("video", "video_path")),
        "PLM-rcap": BenchmarkTask(
            name="PLM-rcap", doc_to_text=rcap_doc_to_text,
            process_response=rcap_process, aggregate=rcap_aggregate,
            video_path_keys=stc_keys, transform_frames=stc_transform),
        "PLM-rdcap": BenchmarkTask(
            name="PLM-rdcap", doc_to_text=rdcap_doc_to_text,
            process_response=rdcap_process, aggregate=rdcap_aggregate,
            video_path_keys=stc_keys, transform_frames=stc_transform),
        "PLM-rtloc": BenchmarkTask(
            name="PLM-rtloc", doc_to_text=rtloc_doc_to_text,
            process_response=rtloc_process, aggregate=rtloc_aggregate,
            video_path_keys=stc_keys, transform_frames=stc_transform),
    }


def register_plm_videobench(judge: JudgeProvider | None = None,
                            **kw) -> None:
    TASK_REGISTRY.update(make_plm_tasks(judge, **kw))


register_plm_videobench()
