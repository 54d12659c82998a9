"""AV-Odyssey: interleaved audio/video/image MC benchmark, rebuilt task layer.

Reference: lmms-eval/lmms_eval/tasks/av_odyssey/utils.py + av_odyssey.yaml.
Questions interleave [audioN]/[videoN]/[imgN] media tags; the reference's
doc_to_visual resolves them to an ordered media list and doc_to_text replaces
each tag with a ``<media_i>`` placeholder.  The letter parse / subfield
aggregation is identical machinery to WorldSense (the reference files carry
the same function verbatim) — reused from eval.worldsense.

Video/image media are consumable by this framework's backbones; audio media
resolve through :func:`doc_to_media` and :func:`av_odyssey_resolve_audio`
(the STANDALONE audio clips of doc['audio_path'], not the video's track) —
the registered task is ``wants_audio``, so audio-capable backbones
(supports_audio) receive the first referenced clip via generate(audio=...),
and video-only backbones run as before.
"""

from __future__ import annotations

import os
import re

from .tasks import TASK_REGISTRY, BenchmarkTask
# module (not symbol) import: when eval.worldsense is the entry module it is
# still mid-initialization while tasks.py's bottom import chain runs this
# file; the parser is resolved at call time
from . import worldsense as _worldsense

SUBFIELDS = ["Timbre", "Tone", "Melody", "Space", "Time", "Hallucination",
             "Intricacy"]

QUESTION_PROMPT = ("Answer with the option's letter from the given choices "
                   "directly.")

_MEDIA_TAG = r"\[(audio|video|img)(\d+)\]"


def split_media_tags(content: str) -> list:
    """Text split on [audio1]/[video2]/[img3] tags; tags become
    (media_type, number) tuples (av_odyssey/utils.py:44-76)."""
    matches = list(re.finditer(_MEDIA_TAG, content))
    if not matches:
        return [content]
    result, last_end = [], 0
    for m in matches:
        if m.start() > last_end:
            result.append(content[last_end:m.start()])
        result.append((m.group(1), int(m.group(2))))
        last_end = m.end()
    if last_end < len(content):
        result.append(content[last_end:])
    return result


def get_text(doc) -> list:
    """question + 4 options + letter instruction, media-tag split
    (av_odyssey/utils.py:119-124)."""
    options = doc["options"]
    option_text = (options[0] + "\n" + options[1] + "\n" + options[2] + "\n"
                   + options[3] + "\n")
    return split_media_tags(doc["question"] + "\n" + option_text
                            + QUESTION_PROMPT)


def av_odyssey_doc_to_text(doc, lmms_eval_specific_kwargs=None) -> str:
    """av_odyssey_doc_to_text (utils.py:128-138): tags -> <media_i>."""
    out, i = [], 0
    for t in get_text(doc):
        if isinstance(t, str):
            out.append(t)
        else:
            out.append(f"<media_{i}>")
            i += 1
    return "".join(out)


def doc_to_media(doc, root: str = "") -> list:
    """Ordered (path, media_type) list mirroring av_odyssey_doc_to_visual
    (utils.py:79-117): image XOR video lists by data_type, audio always;
    ordered by the question's media tags (1-based numbers)."""
    # if/ELIF like the reference (utils.py:74-93): an "image" data_type never
    # fills the video pool, even if the string also contains "video"
    image, video = [], []
    if "image" in doc.get("data_type", ""):
        image = [os.path.join(root, p) for p in doc.get("image_path") or []]
    elif "video" in doc.get("data_type", ""):
        video = [os.path.join(root, p) for p in doc.get("video_path") or []]
    audio = [os.path.join(root, p) for p in doc.get("audio_path") or []]
    pools = {"img": image, "video": video, "audio": audio}
    out = []
    for t in get_text(doc):
        if isinstance(t, tuple):
            mtype, num = t
            out.append((pools[mtype][num - 1], mtype))
    return out


def av_odyssey_process(doc, response, rng=None) -> dict:
    """av_odyssey_process_results (utils.py:199-217)."""
    options = doc["options"]
    option_list = {"A": options[0][3:], "B": options[1][3:],
                   "C": options[2][3:], "D": options[3][3:]}
    answer = _worldsense.parse_multi_choice_response(
        response, ["A", "B", "C", "D"], option_list)
    gt = doc["answer"]
    assert answer in ["A", "B", "C", "D"] and gt in ["A", "B", "C", "D"]
    return {"question_id": doc.get("question_id"), "pred_answer": answer,
            "answer": gt, "score": 1.0 if answer == gt else 0.0,
            "category": doc.get("subfield")}


def aggregate_av_odyssey(results: list) -> dict:
    """av_odyssey_aggregate_results (utils.py:220-264): per-subfield mean of
    each question's first score x100 + question-count-weighted overall."""
    if not results:
        return {"overall": 0.0}
    group: dict = {}
    for r in results:
        group.setdefault(r["category"], {}).setdefault(r["question_id"],
                                                       []).append(r["score"])
    out = {"subfields": {g: 100.0 * sum(v[0] for v in qs.values()) / len(qs)
                         for g, qs in group.items()}}
    total = sum(v[0] for qs in group.values() for v in qs.values())
    n = sum(len(qs) for qs in group.values())
    out["overall"] = 100.0 * total / n
    return out


def av_odyssey_resolve_audio(doc, root: str = "") -> str | None:
    """AV-Odyssey's audio stimuli are STANDALONE clips (doc['audio_path']),
    not the video's soundtrack — the harness feeds the first referenced
    audio clip (single-waveform surface; multi-clip questions get their
    primary stimulus)."""
    for path, mtype in doc_to_media(doc, root):
        if mtype == "audio":
            return path
    return None


def register_av_odyssey() -> None:
    TASK_REGISTRY["AV-Odyssey"] = BenchmarkTask(
        name="AV-Odyssey", doc_to_text=av_odyssey_doc_to_text,
        process_response=av_odyssey_process, aggregate=aggregate_av_odyssey,
        video_path_keys=("video_path",), wants_audio=True,
        resolve_audio=av_odyssey_resolve_audio)


register_av_odyssey()
