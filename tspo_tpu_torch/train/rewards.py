"""Reward functions for GRPO training.

The port's own copy of ``tspo_tpu/train/rewards.py`` (jax-free there too; the
port imports nothing of the JAX package), with the same functions and
registry.  Reference: ``src/open_tspo/tspo.py:86-172``.  Rewards are
host-side python on decoded completions — cheap relative to the rollouts;
arrays only at the end.

Registry mirrors the reference: accuracy (answer-letter match with optional
symbolic verification), temporal (fraction of selected frames inside the
true-video mask), format (<think>/<answer> tags).
"""

from __future__ import annotations

import re

import numpy as np


def map_prediction_to_option(pred: str):
    """First standalone letter a-e, lowercased (tspo.py:86-99); False if none."""
    model_response = pred.strip().lower()
    matches = re.findall(r"(?<![a-z])[a-e](?![a-z])", model_response)
    if len(matches) < 1:
        return False
    return matches[0]


def _symbolic_match(content: str, sol: str) -> bool:
    """Optional math_verify symbolic check (tspo.py:108-114); unavailable or
    failing parsers fall through to letter matching."""
    try:
        from math_verify import parse, verify
        return float(verify(parse(content), parse(sol))) > 0
    except Exception:
        return False


def accuracy_reward(completions: list, solution: list, sel_idxs=None,
                    total_mask=None, **kwargs) -> list:
    """1.0 if the completion's option letter matches the solution's
    (tspo.py:101-143); solution may carry <answer>x</answer> tags."""
    rewards = []
    for content, sol in zip(completions, solution):
        reward = 0.0
        if _symbolic_match(content, sol):
            reward = 1.0
        if reward == 0.0:
            try:
                m = re.search(r"<answer>(.*?)</answer>", sol, re.DOTALL)
                ground_truth = m.group(1).strip() if m else sol.strip()
                student = map_prediction_to_option(content)
                truth = map_prediction_to_option(ground_truth)
                if student is not False and student == truth:
                    reward = 1.0
            except Exception:
                pass
        rewards.append(reward)
    return rewards


def temporal_localization_reward(completions: list, solution: list,
                                 sel_idxs: list = None, total_mask=None,
                                 **kwargs) -> list:
    """Fraction of selected frame indices falling inside the true-video mask
    (tspo.py:146-159)."""
    mask = np.asarray(total_mask, bool)
    rewards = []
    for sel in sel_idxs:
        sel = np.asarray(sel, np.int64)
        rewards.append(float(mask[sel].sum()) / max(len(sel), 1))
    return rewards


def format_reward(completions: list, **kwargs) -> list:
    """<think>...</think><answer>...</answer> pattern (tspo.py:161-166)."""
    pattern = r"<think>.*?</think>\s*<answer>.*?</answer>"
    return [1.0 if re.match(pattern, c, re.DOTALL) else 0.0 for c in completions]


REWARD_REGISTRY = {
    "accuracy": accuracy_reward,
    "temporal": temporal_localization_reward,
    "format": format_reward,
}


def compose_rewards(rewards_per_func: np.ndarray, sample_type: str) -> np.ndarray:
    """[G, n_funcs] -> [G]: specific sums all funcs; general uses accuracy + 1
    (tspo_trainer.py:570-573)."""
    if sample_type == "specific":
        return rewards_per_func.sum(axis=1)
    return rewards_per_func[:, 0] + 1.0


def extract_problem(original_question: str) -> str:
    """Strip boilerplate and options from the raw question
    (tspo_trainer.py:438-443)."""
    str1 = "Please provide your answer by stating the letter followed by the full option."
    str2 = "Please respond with only the letter of the correct answer."
    q = (original_question.replace("<image>\n", "").replace(str1, "")
         .replace(str2, ""))
    if "\nA" in q:
        return q.split("\nA")[0]
    if "\n(A)" in q:
        return q.split("\n(A)")[0]
    return q


def clean_question(original_question: str) -> str:
    """Question with options kept, boilerplate stripped (tspo_trainer.py:487)."""
    str1 = "Please provide your answer by stating the letter followed by the full option."
    str2 = "Please respond with only the letter of the correct answer."
    return (original_question.replace("<image>\n", "").replace(str1, "")
            .replace(str2, ""))
