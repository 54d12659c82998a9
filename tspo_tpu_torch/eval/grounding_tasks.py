"""Charades-STA temporal grounding + LSDBench — rule-scored video tasks.

Reference sources:
  - lmms-eval/lmms_eval/tasks/charades_sta/utils.py — prompt build
    (:59-70, yaml defaults charades.yaml:27-30 — including the reference's
    "seonds" typo, preserved byte-exact because the model sees it) and the
    ``video>>>caption>>>timestamp`` submission records (:78-80);
    charades_sta/eval_tvg.py — the offline scorer: ``extract_time`` (:26-95),
    segment ``iou`` (:98-103), and R@{0.3,0.5,0.7} + mIoU aggregation
    (:115-135).  Unlike the reference (submission file + separate script),
    the harness scores inline AND still emits the submission dict.
  - lmms-eval/lmms_eval/tasks/lsdbench/utils.py — prompt from the options
    dict (:37-44), last-letter answer parse (:47-56), accuracy (:80-95).

Temporal grounding is the benchmark closest to TSPO's own objective (the
selector is a temporal-relevance model), which is why it gets first-class
registry entries here.
"""

from __future__ import annotations

import ast
import re

from .tasks import TASK_REGISTRY, BenchmarkTask

# ---------------------------------------------------------------------------
# Charades-STA
# ---------------------------------------------------------------------------

# charades.yaml lmms_eval_specific_kwargs.default (typo "seonds" is in the
# reference yaml and therefore in every reference eval run's prompt)
CHARADES_PRE_PROMPT = (
    "Please find the visual event described by a sentence in the video, "
    "determining its starting and ending times. The format should be: 'The "
    "event happens in the start time - end time'. For example, The event "
    "'person turn a light on' happens in the 24.3 - 30.4 seonds. Now I will "
    "give you the textual sentence: ")
CHARADES_POST_PROMPT = "Please return its start time and end time."

_TG_KEYWORDS = ("starts", "ends", "happens in", "start time", "end time",
                "start", "end", "happen")
_RANGE_RE = re.compile(r"(\d+\.*\d*)\s*-\s*(\d+\.*\d*)")
_NUMBER_RE = re.compile(r"\b(\d+\.\d+\b|\b\d+)\b")
_HMS_RE = re.compile(r"\b((\d{1,2}:\d{2}:\d{2}))\b")
# the lowercased in-prompt example that eval_tvg strips before parsing
_EXAMPLE_SNIPPET = "a specific example is : 20.8 - 30.0 seconds"


def extract_time(paragraph: str) -> list:
    """Timestamp-pair extraction, semantics-identical to
    eval_tvg.py::extract_time (parity-tested against the reference function):

    1. lowercase, drop the example snippet, then ``"to" -> "-"`` globally
       (this also mutates words containing "to" — reference behavior);
    2. collect range matches ``m - n`` over the WHOLE paragraph;
    3. else pair up the first bare number of each keyword sentence;
    4. else the same with hh:mm:ss times (the mm:ss branch in the reference
       is dead code: the regex only matches two-colon forms);
    5. order each pair, keep only the first.
    """
    text = paragraph.lower().replace(_EXAMPLE_SNIPPET, "").replace("to", "-")
    sentences = re.split(r"[!?\n]", text)
    candidates = [s for s in sentences
                  if any(k in s for k in _TG_KEYWORDS)]

    timestamps = [[float(a), float(b)] for a, b in _RANGE_RE.findall(text)]
    if not sentences:  # unreachable (re.split never returns []) — kept to
        return []      # mirror eval_tvg.py:50-51
    if not timestamps:
        times = []
        for sentence in candidates:
            hit = _NUMBER_RE.findall(sentence)
            if hit:
                times.append(float(hit[0]))
        times = times[: len(times) // 2 * 2]
        timestamps = [(times[i], times[i + 1])
                      for i in range(0, len(times), 2)]
    if not timestamps:
        times = []
        for sentence in candidates:
            hit = _HMS_RE.findall(sentence)
            if not hit:
                continue
            h, m, s = map(int, hit[0][0].split(":"))
            times.append(h * 3600 + m * 60 + s)
        times = times[: len(times) // 2 * 2]
        timestamps = [(times[i], times[i + 1])
                      for i in range(0, len(times), 2)]

    ordered = [[a, b] if b > a else [b, a] for a, b in timestamps]
    return ordered[:1] if len(ordered) > 1 else ordered


def segment_iou(a, b) -> float:
    """eval_tvg.py::iou — intersection over the convex hull of the two
    segments (NOT the union; reference semantics preserved)."""
    lo, hi = max(a[0], b[0]), min(a[1], b[1])
    hull = max(a[1], b[1]) - min(a[0], b[0])
    return max(hi - lo, 0) / hull


def charades_doc_to_text(doc, lmms_eval_specific_kwargs=None) -> str:
    """charades_sta/utils.py:59-70 — note the ". " joiner after the caption."""
    kw = {"pre_prompt": CHARADES_PRE_PROMPT,
          "post_prompt": CHARADES_POST_PROMPT,
          **(lmms_eval_specific_kwargs or {})}
    return f"{kw['pre_prompt']}{doc['caption']}. {kw['post_prompt']}"


def _gt_window(doc) -> list:
    gt = doc["timestamp"]
    if isinstance(gt, str):  # the reference stores str(timestamp) in the
        gt = ast.literal_eval(gt)  # submission key and eval()s it back
    return [float(gt[0]), float(gt[1])]


def _charades_process(doc, response, rng=None) -> dict:
    gt = _gt_window(doc)
    windows = extract_time(response)
    parse_error = len(windows) != 1
    if parse_error:
        # miss penalty: a window guaranteed not to overlap gt
        # (eval_tvg.py:122-124)
        windows = [[gt[1] + 10, gt[1] + 20]]
    return {"video": doc.get("video"), "caption": doc.get("caption"),
            "pred_answer": response, "pred_window": windows[0],
            "answer": gt, "iou": segment_iou(gt, windows[0]),
            "parse_error": int(parse_error),
            "submission_key": f"{doc.get('video')}>>>{doc.get('caption')}"
                              f">>>{doc.get('timestamp')}"}


def aggregate_charades(results: list) -> dict:
    """R@tIoU thresholds + mIoU, all x100 (eval_tvg.py:129-135); overall is
    mIoU.  ``submission`` carries the reference's combined submission dict."""
    if not results:
        return {"overall": 0.0, "mIoU": 0.0,
                "R@0.3": 0.0, "R@0.5": 0.0, "R@0.7": 0.0}
    n = len(results)
    ious = [r["iou"] for r in results]
    out = {f"R@{t}": 100.0 * sum(i >= t for i in ious) / n
           for t in (0.3, 0.5, 0.7)}
    out["mIoU"] = 100.0 * sum(ious) / n
    out["overall"] = out["mIoU"]
    out["parse_errors"] = sum(r["parse_error"] for r in results)
    out["submission"] = {r["submission_key"]: r["pred_answer"]
                         for r in results}
    return out


# ---------------------------------------------------------------------------
# LSDBench
# ---------------------------------------------------------------------------

_LAST_LETTER_RE = re.compile(r"(?<![a-zA-Z])[ABCD](?![a-zA-Z])")


def lsdbench_extract_characters(s: str) -> str:
    """lsdbench/utils.py:47-56 — LAST standalone A-D letter wins."""
    matches = _LAST_LETTER_RE.findall(s.strip())
    return matches[-1] if matches else ""


def lsdbench_doc_to_text(doc, lmms_eval_specific_kwargs=None) -> str:
    """lsdbench/utils.py:37-44 — options dict rendered in iteration order,
    trailing newline kept."""
    options_str = "".join(f"{k}. {v}\n" for k, v in doc["options"].items())
    return doc["question"] + "\n" + options_str


def _lsdbench_process(doc, response, rng=None) -> dict:
    return {"video_id": doc.get("video_id"),
            "pred_answer": lsdbench_extract_characters(response),
            "answer": doc.get("correct_answer")}


def aggregate_lsdbench(results: list) -> dict:
    if not results:
        return {"overall": 0.0}
    return {"overall": 100.0 * sum(r["pred_answer"] == r["answer"]
                                   for r in results) / len(results)}


def register_grounding_tasks() -> None:
    TASK_REGISTRY["Charades-STA"] = BenchmarkTask(
        name="Charades-STA", doc_to_text=charades_doc_to_text,
        process_response=_charades_process, aggregate=aggregate_charades,
        # doc["video"] is the bare file name; the dataset root keeps the
        # Charades_v1_480 folder (charades_sta/utils.py:46-49)
        video_path_keys=("video", "video_path"),
        video_subdir="Charades_v1_480")
    TASK_REGISTRY["LSDBench"] = BenchmarkTask(
        name="LSDBench", doc_to_text=lsdbench_doc_to_text,
        process_response=_lsdbench_process, aggregate=aggregate_lsdbench,
        # lsdbench/utils.py:24 appends ".mp4" to video_id (with .MP4/.mkv
        # fallbacks probed on disk — resolve_video keeps the primary)
        video_path_keys=("video_id", "video_path"), video_suffix=".mp4")


register_grounding_tasks()
