"""Subtitle task variants: VideoMME with-subtitles + LongVideoBench interleave.

Rebuilds the subtitle plumbing of the reference task utils (VERDICT r1
Missing #3):
  - SRT parsing + frame-window subtitle selection:
    lmms-eval/lmms_eval/tasks/videomme/utils.py:94-132,173-228
  - LVB interleaved subtitles:
    lmms-eval/lmms_eval/tasks/longvideobench/utils.py:41-112

The TSPO eval scripts use the non-subtitle variants, so these are
parity-surface: prompts match the reference byte-for-byte given the same
subtitle inputs (tests/test_subtitles.py checks the interleave against the
dynamically-imported reference function).
"""

from __future__ import annotations

import json
import os
import re

import numpy as np

SUBTITLE_FONT_PATTERN = r'<font color="white" size=".72c">(.*?)</font>'


# ---------------------------------------------------------------------------
# SRT (VideoMME)
# ---------------------------------------------------------------------------

def parse_subtitle_time(time_str: str) -> float:
    """"HH:MM:SS,mmm" -> seconds (videomme/utils.py:94-97)."""
    h, m, s_ms = time_str.split(":")
    s, ms = s_ms.split(",")
    return int(h) * 3600 + int(m) * 60 + int(s) + int(ms) / 1000


def load_srt(subtitle_path: str) -> dict:
    """{(start_s, end_s): raw text} (videomme/utils.py:100-113)."""
    subtitles = {}
    with open(subtitle_path, "r", encoding="utf-8") as f:
        for section in f.read().split("\n\n"):
            if not section.strip():
                continue
            lines = section.split("\n")
            if len(lines) >= 3:
                start, end = lines[1].split(" --> ")
                subtitles[(parse_subtitle_time(start),
                           parse_subtitle_time(end))] = " ".join(lines[2:])
    return subtitles


def extract_subtitles(video_path: str, subtitle_path: str):
    """[(start_frame, end_frame, text)], total_frames
    (videomme/utils.py:120-132); frame conversion truncates like the
    reference's int()."""
    from ..video.reader import video_info
    total, fps, _, _ = video_info(video_path)
    out = []
    for (start, end), text in load_srt(subtitle_path).items():
        out.append((int(start * fps), int(end * fps), text))
    return out, total


def videomme_subtitles_for_frames(video_path: str, subtitle_path: str,
                                  frame_num: int) -> str:
    """Subtitle text covering `frame_num` uniformly-sampled frames
    (videomme/utils.py:196-220): dedup by subtitle index (set semantics),
    keep the first <font ...> match of each."""
    subtitle_by_frame, total_frame = extract_subtitles(video_path,
                                                       subtitle_path)
    if frame_num == -1:
        frame_num = total_frame
    uniform = np.linspace(0, total_frame - 1, frame_num, dtype=int).tolist()
    picked = []
    for frame_idx in uniform:
        for idx, (s, e, _) in enumerate(subtitle_by_frame):
            if s <= frame_idx < e:
                picked.append(idx)
    textlist = []
    # the reference iterates `list(set(...))` with NO sort
    # (videomme/utils.py:209); CPython's int-set iteration order is
    # deterministic for given values, so replicating the exact construct —
    # not sorting — is what keeps prompts byte-identical
    for idx in list(set(picked)):
        matches = re.findall(SUBTITLE_FONT_PATTERN, subtitle_by_frame[idx][2])
        if matches:
            textlist.append(matches[0])
    return "\n".join(textlist)


def videomme_doc_to_text_subtitle(doc, lmms_eval_specific_kwargs=None,
                                  video_path: str | None = None,
                                  subtitle_path: str | None = None) -> str:
    """videomme_doc_to_text_subtitle (videomme/utils.py:173-228), non-gemini
    branch.  Resolution of video/subtitle paths is the caller's job (the
    reference resolves from $HF_HOME; the harness passes them via
    lmms_eval_specific_kwargs "video_path"/"subtitle_path"/"frame_num")."""
    kw = lmms_eval_specific_kwargs or {}
    video_path = video_path or kw.get("video_path")
    subtitle_path = subtitle_path or kw.get("subtitle_path")
    # per-doc resolution from roots (the reference resolves from $HF_HOME
    # cache dirs, videomme/utils.py:174-177)
    if subtitle_path is None and kw.get("subtitle_root") and doc.get("videoID"):
        subtitle_path = os.path.join(kw["subtitle_root"],
                                     str(doc["videoID"]) + ".srt")
    if video_path is None and kw.get("video_root") and doc.get("videoID"):
        video_path = os.path.join(kw["video_root"], str(doc["videoID"]))
        if not os.path.exists(video_path):
            video_path += ".mp4"
    subtitle = ""
    if subtitle_path and os.path.exists(subtitle_path):
        if "frame_num" in kw:
            subtitle = videomme_subtitles_for_frames(video_path,
                                                     subtitle_path,
                                                     int(kw["frame_num"]))
        else:
            subtitle = open(subtitle_path).read()
    subtitles_prompt = "This video's subtitles are listed below: \n"
    if subtitle == "":
        subtitle = "No subtitles available"
    option_prompt = ("Select the best answer to the following multiple-choice "
                     "question based on the video and the subtitles. Respond "
                     "with only the letter (A, B, C, or D) of the correct option.")
    question = doc["question"] + "\n" + "\n".join(doc.get("options", []))
    return (subtitles_prompt + subtitle + "\n" + option_prompt + "\n"
            + question + "\n" + "The best answer is:")


# ---------------------------------------------------------------------------
# LongVideoBench interleave
# ---------------------------------------------------------------------------

def timestamp_to_seconds(timestamp: str) -> float:
    """"H:MM:SS.fff" -> seconds (longvideobench/utils.py:21-26)."""
    h, m, s = timestamp.split(":")
    return int(h) * 3600 + int(m) * 60 + float(s)


def compute_frame_timestamps(duration: float, max_num_frames: int = 16) -> list:
    """longvideobench/utils.py:49-53."""
    if duration > max_num_frames:
        return [duration / max_num_frames * i for i in range(max_num_frames)]
    return [i for i in range(int(duration))]


def insert_subtitles_into_frames(frame_timestamps, subtitles,
                                 starting_timestamp_for_subtitles,
                                 duration) -> str:
    """Interleave "<image>" placeholders with subtitle lines
    (longvideobench/utils.py:56-112) — behavioral port, byte-exact output
    (verified against the reference function in tests)."""
    interleaved = []
    cur_i = 0
    for subtitle in subtitles:
        if "timestamp" in subtitle:
            start, end = subtitle["timestamp"]
            if not isinstance(end, float):
                end = duration
            start -= starting_timestamp_for_subtitles
            end -= starting_timestamp_for_subtitles
            mid = (start + end) / 2
            text = subtitle["text"]
        else:
            start = timestamp_to_seconds(subtitle["start"]) - \
                starting_timestamp_for_subtitles
            end = timestamp_to_seconds(subtitle["end"]) - \
                starting_timestamp_for_subtitles
            mid = (start + end) / 2
            text = subtitle["line"]

        for frame_timestamp in frame_timestamps[cur_i:]:
            if frame_timestamp <= mid:
                interleaved.append("<image>")
                cur_i += 1
            else:
                break

        if end - start < 1:
            end = mid + 0.5
            start = mid - 0.5
        if any(start < ts < end for ts in frame_timestamps):
            interleaved.append(text)
    for _ in frame_timestamps[cur_i:]:
        interleaved.append("<image>")
    return "\n".join(interleaved)


def lvb_doc_to_text_interleaved(doc, lmms_eval_specific_kwargs=None,
                                subtitles: list | None = None) -> str:
    """longvideobench_doc_to_text with insert_interleave_subtitles=True
    (longvideobench/utils.py:114-142).  ``subtitles`` may be passed directly
    or resolved from kwargs "subtitle_path" (a json file) +
    "max_num_frames"."""
    from .tasks import LVB_DEFAULT_KWARGS
    kw = {**LVB_DEFAULT_KWARGS, **(lmms_eval_specific_kwargs or {})}
    if subtitles is None:
        path = kw.get("subtitle_path")
        if path is None and kw.get("subtitle_root") and \
                doc.get("subtitle_path"):
            # LVB docs carry a per-doc subtitle_path relative to the cache
            # subtitles dir (longvideobench/utils.py:130-135)
            path = os.path.join(kw["subtitle_root"], doc["subtitle_path"])
        with open(path) as f:
            subtitles = json.load(f)
    cands = doc.get("candidates") or []
    question = doc["question"] + "\n" + "\n".join(
        f"{chr(ord('A') + i)}. {c}" for i, c in enumerate(cands))
    frame_ts = compute_frame_timestamps(doc["duration"],
                                        int(kw.get("max_num_frames", 16)))
    prefix = insert_subtitles_into_frames(
        frame_ts, subtitles, doc["starting_timestamp_for_subtitles"],
        doc["duration"])
    return f"{kw['pre_prompt']}{prefix}\n{question}\n{kw['post_prompt']}"
