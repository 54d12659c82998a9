"""CameraBench VQA — camera-motion yes/no probes with NaturalBench-style
quadruple (question x video) group scoring.

Reference: lmms-eval/lmms_eval/tasks/camerabench_vqa/utils.py — prompt is
``Question + " Please answer Yes or No."`` (:6, :172-176); the answer is
the EARLIER of the standalone words yes/no in the reply (1/0, -1 when
neither appears, :106-145); docs come in consecutive quadruples
(q0_i0, q0_i1, q1_i0, q1_i1 by Index) where q0 is true of video 0 and q1
of video 1, and four metrics roll up (:9-103):
  Acc   — mean over all four binary probes (expected pattern 1,0,0,1)
  Q_Acc — question right on BOTH videos
  I_Acc — video answered right for BOTH questions
  G_Acc — all four right
The reference hardcodes its 1900x4 dataset in asserts; here quadruples
form by Index//4 membership, so --limit/sharded subsets aggregate only
complete groups (incomplete ones are dropped and counted).  Videos resolve
from the doc's ``Video`` field like the reference (utils.py:161).
"""

from __future__ import annotations

import re

from .tasks import TASK_REGISTRY, BenchmarkTask

SUFFIX_FOR_VQA = {"yes_no": "Please answer Yes or No.",
                  "multiple_choice": "Please output the letter "
                                     "corresponding to the correct option."}


def cambench_doc_to_text(doc, lmms_eval_specific_kwargs=None) -> str:
    return doc["Question"] + " " + SUFFIX_FOR_VQA["yes_no"]


def extract_answer(output_string: str) -> int:
    """utils.py:106-145: earlier standalone yes/no wins; -1 when absent."""
    def pos(word):
        m = re.search(r"\b" + re.escape(word) + r"\b", output_string,
                      re.IGNORECASE)
        return m.start() if m else -1

    p_yes, p_no = pos("yes"), pos("no")
    if p_yes == -1 and p_no == -1:
        return -1
    if p_yes != -1 and p_no != -1:
        return 1 if p_yes < p_no else 0
    return 0 if p_yes == -1 else 1


def _process(doc, response, rng=None) -> dict:
    return {"id": int(doc["Index"]), "pred_answer": response,
            "score": extract_answer(response)}


def aggregate_camerabench(results: list) -> dict:
    """get_scores (utils.py:9-103) over Index//4 quadruples.  Groups are
    formed by id//4 MEMBERSHIP (id%4 gives the probe slot), not by sorted
    position, so strided shards / --limit subsets never mix groups —
    incomplete groups are dropped and counted."""
    groups: dict = {}
    for r in results:
        groups.setdefault(r["id"] // 4, {})[r["id"] % 4] = r
    quads = [[g[0], g[1], g[2], g[3]]
             for _, g in sorted(groups.items()) if len(g) == 4]
    dropped = sum(len(g) for g in groups.values() if len(g) != 4)
    n = len(quads)
    if not n:
        return {"Acc": 0.0, "Q_Acc": 0.0, "I_Acc": 0.0, "G_Acc": 0.0,
                "incomplete_quadruples_dropped": dropped}
    q_acc = i_acc = acc = g_acc = 0
    for quad in quads:
        q0i0, q0i1, q1i0, q1i1 = (q["score"] for q in quad)
        text = int(q0i0 == 1 and q0i1 == 0) + int(q1i1 == 1 and q1i0 == 0)
        image = int(q0i0 == 1 and q1i0 == 0) + int(q1i1 == 1 and q0i1 == 0)
        q_acc += text
        i_acc += image
        acc += (int(q0i0 == 1) + int(q0i1 == 0) + int(q1i0 == 0)
                + int(q1i1 == 1))
        g_acc += int(text == 2 and image == 2)
    return {"Acc": acc / (n * 4), "Q_Acc": q_acc / (n * 2),
            "I_Acc": i_acc / (n * 2), "G_Acc": g_acc / n,
            "incomplete_quadruples_dropped": dropped}


def register_camerabench() -> None:
    TASK_REGISTRY["CameraBench"] = BenchmarkTask(
        name="CameraBench", doc_to_text=cambench_doc_to_text,
        process_response=_process, aggregate=aggregate_camerabench,
        video_path_keys=("Video", "video_path", "video"))


register_camerabench()
