"""Per-rank response cache for phase-2 evaluation.

Equivalent of lmms-eval's dill cache (C34, lmms_eval/caching/cache.py:25-62):
backbone responses keyed by (task, doc id, rank, world) so interrupted runs
resume without regenerating — with a frozen backbone and greedy decoding the
responses are deterministic.
"""

from __future__ import annotations

import json
import os


class ResponseCache:
    def __init__(self, root: str, task: str, rank: int = 0, world: int = 1):
        self.path = os.path.join(root, f"{task}_rank{rank}_world{world}.jsonl")
        self._store = {}
        if os.path.exists(self.path):
            with open(self.path, encoding="utf-8") as f:
                for line in f:
                    if line.strip():
                        rec = json.loads(line)
                        self._store[rec["doc_id"]] = rec["response"]
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._fh = open(self.path, "a", encoding="utf-8")

    def get(self, doc_id):
        return self._store.get(doc_id)

    def put(self, doc_id, response: str):
        if doc_id in self._store:
            return
        self._store[doc_id] = response
        self._fh.write(json.dumps({"doc_id": doc_id, "response": response}) + "\n")
        self._fh.flush()

    def __len__(self):
        return len(self._store)

    def close(self):
        self._fh.close()

    def delete(self):
        self.close()
        if os.path.exists(self.path):
            os.remove(self.path)
