"""Benchmark dataset loaders.

Phase-1 input: TSV tables of (index, task_name, video_name, question_id,
question, answer_number, candidates, answer), one row per question
(mp_tools/vlmeval/dataset/video_dataset.py; evaluation/data/*.tsv).
Phase-2 input: question-record json (evaluation/jsons/*.json), augmented with
``frame_idx`` by the precompute merge (change_score_tch.py:20-44).
"""

from __future__ import annotations

import ast
import csv
import json
import os
from dataclasses import dataclass

# question-record id key per benchmark (change_score_tch.py:34-38)
DOC_ID_KEY = {"VideoMME": "question_id", "MLVU": "question_id",
              "LongVideoBench": "id", "LVBench": "question_id",
              "VideoMME-subtitles": "question_id",
              "LongVideoBench-interleaved": "id"}


def load_tsv(path: str) -> list:
    with open(path, newline="", encoding="utf-8") as f:
        return list(csv.DictReader(f, delimiter="\t"))


def load_json(path: str):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def dump_json(obj, path: str):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f)


@dataclass
class VideoQuestionDataset:
    """Phase-1 dataset: one struct per question with a resolvable video path.

    ``build_prompt`` matches the reference multi-choice format
    (video_dataset.py:115-170): "Question: ...\nOptions:\n(A):... (B):... " +
    trailer — phase 1 only uses the text before "\nOptions" as the CLIP query
    (gen_id_tspo.py:62-65), but exact formatting keeps artifacts comparable.
    """

    name: str
    rows: list
    video_root: str = ""

    @classmethod
    def from_tsv(cls, name: str, tsv_path: str, video_root: str = ""):
        return cls(name=name, rows=load_tsv(tsv_path), video_root=video_root)

    def __len__(self):
        return len(self.rows)

    def video_path(self, row) -> str:
        return os.path.join(self.video_root, str(row["video_name"]))

    def build_prompt(self, row) -> str:
        question = row["question"]
        cands = row.get("candidates")
        if isinstance(cands, str):
            try:
                cands = ast.literal_eval(cands)
            except (ValueError, SyntaxError):
                cands = []
        options = "Options:\n"
        for i, cand in enumerate(cands or []):
            options += f"({chr(ord('A') + i)}):{cand} "
        prompt = f"Question: {question}\n"
        if cands:
            prompt += options + "Please select the correct answer from the options above. \n"
        return prompt

    def problem_text(self, row) -> str:
        """CLIP query text: question before options (gen_id_tspo.py:62-65)."""
        prompt = self.build_prompt(row)
        return (prompt.replace("<image>\n", "").replace("Question: ", "")
                .split("\nOptions")[0])

    def iter_structs(self):
        for row in self.rows:
            yield {
                "index": row["index"],
                "question_id": row.get("question_id", row["index"]),
                "video_path": self.video_path(row),
                "prompt": self.build_prompt(row),
                "problem": self.problem_text(row),
                "answer": row.get("answer"),
                "row": row,
            }


def merge_frame_indices(anno: list, scores: dict, dataset: str) -> list:
    """Join per-question frame indices into the question records — produces
    the ``*_frameIdx.json`` artifact (change_score_tch.py:31-44).  Records
    missing from ``scores`` pass through unchanged, as in the reference."""
    id_key = DOC_ID_KEY.get(dataset, "question_id")
    out = []
    for rec in anno:
        rec = dict(rec)
        index = rec[id_key]
        if index in scores:
            rec["frame_idx"] = scores[index]
        out.append(rec)
    return out
