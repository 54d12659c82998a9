"""LLM-judge subsystem — model-graded evaluation for open-ended answers.

Rebuilds the reference's `lmms-eval/lmms_eval/llm_judge/` package (protocol
`protocol.py:1-69`, prompt templates `prompt.py:1-68`, builders/parsers
`utils.py:1-115`, provider ABC `base.py:1-245`, factory `factory.py:15-54`)
for this framework.  None of the four TSPO benchmarks use a judge (SURVEY.md
C35), but the task registry is designed for adding more benchmarks, and many
lmms-eval tasks grade with one — so the capability ships.

Differences from the reference, by design:
  - Providers are synchronous callables with bounded-thread fan-out
    (``judge_many``) instead of a parallel asyncio class hierarchy — the
    judge is IO-bound HTTP, not device work, so threads are the simple
    correct tool here.
  - A ``LocalBackboneProvider`` grades with one of THIS framework's
    backbones (any object with ``generate(frames, prompt) -> str``), so
    judging can run on the same card with zero egress — the reference can
    only call external OpenAI/Azure endpoints.
  - The HTTP provider speaks the OpenAI chat-completions wire format via
    urllib (no sdk dependency), with the reference's retry/backoff
    semantics (protocol.py DEFAULT_NUM_RETRIES/RETRY_DELAY).

The prompt templates and output parsing must match the reference
byte-for-byte where grading behavior depends on them (same rationale as the
answer-prefix lists in eval/tasks.py): a judge prompted differently is a
different metric.  Templates are from `prompt.py`, parsing from
`utils.py::ResponseParser`.
"""

from __future__ import annotations

import json
import logging
import os
import re
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# Protocol (reference protocol.py)
# ---------------------------------------------------------------------------

DEFAULT_NUM_RETRIES = 5
DEFAULT_RETRY_DELAY = 10.0


@dataclass
class JudgeConfig:
    """Reference ServerConfig (protocol.py:10-31)."""

    model_name: str = "gpt-4"
    temperature: float = 0.0
    max_tokens: int = 1024
    timeout: float = 60.0
    num_retries: int = DEFAULT_NUM_RETRIES
    retry_delay: float = DEFAULT_RETRY_DELAY
    max_concurrent: int = 10
    system_prompt: Optional[str] = None
    output_format: str = "0/1"          # binary judges: "0/1" or "yes/no"
    # int bounds: they are formatted into the comparative prompt and the
    # reference renders "scale of 1 to 10", not "1.0 to 10.0"
    # (llm_judge/base.py:64, utils.py:26)
    score_range: Tuple[float, float] = (1, 10)


@dataclass
class JudgeResult:
    """Reference Response (protocol.py:58-69), flattened to what callers use."""

    content: str
    model_used: str
    parsed: Any = None
    success: bool = True
    error: Optional[str] = None


# ---------------------------------------------------------------------------
# Prompt templates (reference prompt.py — byte-equivalent, see module doc)
# ---------------------------------------------------------------------------

BINARY_JUDGE_PROMPT = """You are a strict evaluator assessing answer correctness. You must output {positive} for fully correct answers and {negative} for any other case.

# Input
Question:
```
{question}
```
Ground Truth Answer:
```
{answer}
```
Model Prediction:
```
{prediction}
```

# Evaluation Rules
- The model prediction may contain the reasoning process, you should spot the final answer from it.
- For multiple-choice questions: Score {positive} if the predicted answer matches the ground truth answer, it can be directly in option letters or the content of the options.
- For open-ended questions:
  * Score {positive} if the prediction matches the answer semantically, it can be in different format.
  * Score {negative} for partially correct answers or answers with extra incorrect information, even if the reasoning process is correct.
- Ignore minor differences in formatting, capitalization, or spacing since the model may explain in a different way.
- Treat numerical answers as correct if they match within reasonable precision
- For questions requiring units, both value and unit must be correct

# Strict Output format
{positive} or {negative}"""

COMPARATIVE_JUDGE_PROMPT = """We would like to request your feedback on the performance of two AI assistants in response to the user question displayed above.
Please rate the helpfulness, relevance, accuracy, level of details of their responses. Each assistant receives an overall score on a scale of {min_score} to {max_score}, where a higher score indicates better overall performance.
Please first output a single line containing only two values indicating the scores for Assistant 1 and 2, respectively. The two scores are separated by a space.
In the subsequent line, please provide a comprehensive explanation of your evaluation, avoiding any potential bias and ensuring that the order in which the responses were presented does not affect your judgment.

[Question]
{question}

{context_section}

[Assistant 1]
{response1}
[End of Assistant 1]

[Assistant 2]
{response2}
[End of Assistant 2]

[System]
{evaluation_instruction}"""

CORRECTNESS_JUDGE_PROMPT = """You are given a question, the solution and the correct answer. Please determine if the solution matches the correct answer.
Focus only on the mathematical or semantic correctness of the content. Ignore any differences in formatting, such as LaTeX syntax, symbols, styles, or additional wrappers (e.g., \\boxed, $...$, or similar). Compare only the core mathematical or textual meaning of the solution and the correct answer.
The process or reasoning leading to the Solution is irrelevant, ONLY the correctness of the result matters.
Return only "{positive}" if the solution is correct or "{negative}" if it is incorrect.
Only return "{positive}" or "{negative}" with no additional text or formatting.

Question:
{question}
--------------------------------
Correct Answer:
{answer}
--------------------------------
Solution:
{prediction}
--------------------------------"""


def _positive_negative(output_format: str) -> Tuple[str, str]:
    return ("1", "0") if output_format in ("0/1", "1/0") else ("Yes", "No")


def build_binary_prompt(question: str, answer: str, prediction: str,
                        output_format: str = "0/1",
                        custom_prompt: Optional[str] = None, **kw) -> str:
    """utils.py::build_binary_prompt."""
    if custom_prompt:
        return custom_prompt.format(question=question, answer=answer,
                                    pred=prediction, prediction=prediction,
                                    **kw)
    pos, neg = _positive_negative(output_format)
    return BINARY_JUDGE_PROMPT.format(question=question, answer=answer,
                                      prediction=prediction, positive=pos,
                                      negative=neg)


def build_correctness_prompt(question: str, answer: str, prediction: str,
                             output_format: str = "yes/no") -> str:
    """utils.py::build_correctness_prompt."""
    pos, neg = (("Yes", "No") if output_format == "yes/no" else ("1", "0"))
    return CORRECTNESS_JUDGE_PROMPT.format(question=question, answer=answer,
                                           prediction=prediction,
                                           positive=pos, negative=neg)


def build_comparative_prompt(question: str, response1: str, response2: str,
                             context: Optional[str] = None,
                             score_range: Tuple[float, float] = (1, 10),
                             evaluation_instruction: Optional[str] = None,
                             custom_prompt: Optional[str] = None, **kw) -> str:
    """utils.py::build_comparative_prompt."""
    if custom_prompt:
        return custom_prompt.format(question=question, response1=response1,
                                    response2=response2,
                                    context=context or "", **kw)
    section = f"[Context]\n{context}\n\n" if context else ""
    instr = (evaluation_instruction or
             f"Please provide scores from {score_range[0]} to {score_range[1]}.")
    return COMPARATIVE_JUDGE_PROMPT.format(
        question=question, response1=response1, response2=response2,
        context_section=section, min_score=score_range[0],
        max_score=score_range[1], evaluation_instruction=instr)


# ---------------------------------------------------------------------------
# Response parsing (reference utils.py::ResponseParser — same decisions)
# ---------------------------------------------------------------------------

_NUM_RE = re.compile(r"-?\d+(?:\.\d+)?")


def parse_binary(response: str, output_format: str = "0/1") -> int:
    r = response.strip().lower()
    if output_format in ("0/1", "1/0"):
        return 1 if any(p in r for p in ("1", "[1]", "score: 1", "answer: 1")) else 0
    return 1 if (r == "yes" or r.startswith("yes")) else 0


def parse_score(response: str,
                score_range: Optional[Tuple[float, float]] = None) -> float:
    nums = _NUM_RE.findall(response)
    if nums:
        score = float(nums[0])
        if score_range:
            score = max(score_range[0], min(score, score_range[1]))
        return score
    return score_range[0] if score_range else 0.0


def parse_comparative(response: str) -> Tuple[float, float]:
    lines = response.strip().split("\n")
    if lines:
        nums = _NUM_RE.findall(lines[0].replace(",", " ").replace(";", " "))
        if len(nums) >= 2:
            return float(nums[0]), float(nums[1])
    return -1.0, -1.0


def parse_json_blob(response: str) -> Dict[str, Any]:
    m = re.search(r"\{.*\}", response, re.DOTALL)
    if m:
        try:
            return json.loads(m.group())
        except json.JSONDecodeError:
            pass
    return {}


# ---------------------------------------------------------------------------
# Providers
# ---------------------------------------------------------------------------

class JudgeProvider:
    """A provider turns chat messages into completion text.  Subclasses set
    ``complete``; everything else (prompt building, parsing, retries,
    fan-out) is shared.  Mirrors reference base.py::ServerInterface with the
    evaluate_* conveniences."""

    def __init__(self, config: Optional[JudgeConfig] = None):
        self.config = config or JudgeConfig()

    # -- transport ---------------------------------------------------------
    def complete(self, messages: List[dict]) -> str:
        raise NotImplementedError

    def is_available(self) -> bool:
        return True

    # -- shared machinery ---------------------------------------------------
    def _messages(self, prompt: str,
                  system_prompt: Optional[str] = None) -> List[dict]:
        sys_prompt = (system_prompt if system_prompt is not None
                      else self.config.system_prompt)
        msgs = [{"role": "user", "content": prompt}]
        if sys_prompt:
            msgs.insert(0, {"role": "system", "content": sys_prompt})
        return msgs

    def _complete_with_retry(self, prompt: str,
                             system_prompt: Optional[str] = None) -> JudgeResult:
        """``system_prompt`` overrides config.system_prompt for THIS call only
        — callers juggling several judge dimensions (videochatgpt.py) must not
        mutate the shared config (cross-task contamination + races under
        judge_many thread fan-out)."""
        last = None
        for attempt in range(self.config.num_retries):
            try:
                text = self.complete(self._messages(prompt, system_prompt))
                return JudgeResult(content=text,
                                   model_used=self.config.model_name)
            except Exception as e:  # noqa: BLE001 — transport errors retry
                last = e
                if attempt + 1 < self.config.num_retries:
                    time.sleep(0.0 if _in_test() else self.config.retry_delay)
        return JudgeResult(content="", model_used=self.config.model_name,
                           success=False, error=str(last))

    # -- evaluate_* conveniences (reference base.py:46-104) -----------------
    def evaluate_binary(self, question: str, answer: str, prediction: str,
                        output_format: Optional[str] = None,
                        custom_prompt: Optional[str] = None, **kw) -> JudgeResult:
        fmt = output_format or self.config.output_format
        prompt = build_binary_prompt(question, answer, prediction, fmt,
                                     custom_prompt, **kw)
        res = self._complete_with_retry(prompt)
        res.parsed = parse_binary(res.content, fmt) if res.success else 0
        return res

    def evaluate_correctness(self, question: str, answer: str,
                             prediction: str,
                             output_format: str = "yes/no") -> JudgeResult:
        prompt = build_correctness_prompt(question, answer, prediction,
                                          output_format)
        res = self._complete_with_retry(prompt)
        res.parsed = parse_binary(res.content, output_format) if res.success else 0
        return res

    def evaluate_comparative(self, question: str, response1: str,
                             response2: str, context: Optional[str] = None,
                             **kw) -> JudgeResult:
        prompt = build_comparative_prompt(
            question, response1, response2, context,
            score_range=self.config.score_range, **kw)
        res = self._complete_with_retry(prompt)
        res.parsed = (parse_comparative(res.content) if res.success
                      else (-1.0, -1.0))
        return res

    def evaluate_with_rubric(self, question: str, prediction: str,
                             rubric: Dict[str, Any]) -> JudgeResult:
        rubric_text = "\n".join(f"- {k}: {v}" for k, v in rubric.items())
        prompt = (f"Evaluate the following response according to the given "
                  f"rubric.\n\nQuestion: {question}\n\nResponse: "
                  f"{prediction}\n\nRubric:\n{rubric_text}\n\nProvide a JSON "
                  f"response with scores for each rubric item.")
        res = self._complete_with_retry(prompt)
        res.parsed = parse_json_blob(res.content) if res.success else {}
        return res

    def judge_many(self, jobs: Sequence[Callable[["JudgeProvider"], JudgeResult]],
                   ) -> List[JudgeResult]:
        """Bounded-concurrency fan-out (reference async providers'
        max_concurrent semaphore, base.py:110-117)."""
        with ThreadPoolExecutor(max_workers=self.config.max_concurrent) as ex:
            return list(ex.map(lambda job: job(self), jobs))


def _in_test() -> bool:
    return "PYTEST_CURRENT_TEST" in os.environ


class DummyJudgeProvider(JudgeProvider):
    """Always answers positively (reference providers/dummy.py) — for
    pipeline wiring tests and dry runs."""

    def complete(self, messages: List[dict]) -> str:
        return "1" if self.config.output_format in ("0/1", "1/0") else "Yes"


class OpenAICompatProvider(JudgeProvider):
    """OpenAI chat-completions wire format over urllib — covers the
    reference's openai/azure/async_* providers (they differ only in auth
    header and URL shape).  ``base_url`` may be any compatible server
    (vLLM, llama.cpp, a local stub).  This container has zero egress, so
    tests exercise it against a loopback HTTP stub."""

    def __init__(self, config: Optional[JudgeConfig] = None,
                 base_url: Optional[str] = None,
                 api_key: Optional[str] = None,
                 azure: bool = False):
        super().__init__(config)
        self.base_url = (base_url or os.environ.get("OPENAI_API_BASE")
                         or "https://api.openai.com/v1")
        self.api_key = api_key or os.environ.get(
            "AZURE_API_KEY" if azure else "OPENAI_API_KEY", "")
        self.azure = azure

    def is_available(self) -> bool:
        return bool(self.api_key) or "localhost" in self.base_url or \
            "127.0.0.1" in self.base_url

    def complete(self, messages: List[dict]) -> str:
        url = self.base_url.rstrip("/") + "/chat/completions"
        body = json.dumps({
            "model": self.config.model_name,
            "messages": messages,
            "temperature": self.config.temperature,
            "max_tokens": self.config.max_tokens,
        }).encode()
        headers = {"Content-Type": "application/json"}
        if self.azure:
            headers["api-key"] = self.api_key
        else:
            headers["Authorization"] = f"Bearer {self.api_key}"
        req = urllib.request.Request(url, data=body, headers=headers)
        with urllib.request.urlopen(req, timeout=self.config.timeout) as resp:
            payload = json.loads(resp.read().decode())
        return payload["choices"][0]["message"]["content"]


class LocalBackboneProvider(JudgeProvider):
    """Grade with a local backbone (anything exposing
    ``generate(frames, prompt) -> str`` — eval/harness.py::BackboneAdapter).
    An addition to the reference: the judge runs on the device with zero
    egress."""

    def __init__(self, backbone, config: Optional[JudgeConfig] = None):
        super().__init__(config or JudgeConfig(model_name="local"))
        self.backbone = backbone

    def complete(self, messages: List[dict]) -> str:
        import numpy as np
        text = "\n\n".join(m["content"] for m in messages)
        frames = np.zeros((0, 1, 1, 3), dtype=np.uint8)
        return self.backbone.generate(frames, text)


# ---------------------------------------------------------------------------
# Factory (reference factory.py::ProviderFactory)
# ---------------------------------------------------------------------------

_PROVIDERS: Dict[str, type] = {
    "openai": OpenAICompatProvider,
    "azure": OpenAICompatProvider,
    "dummy": DummyJudgeProvider,
    "local": LocalBackboneProvider,
}


def register_provider(api_type: str, cls: type) -> None:
    if not issubclass(cls, JudgeProvider):
        raise ValueError(f"{cls} must subclass JudgeProvider")
    _PROVIDERS[api_type] = cls


def create_provider(api_type: Optional[str] = None,
                    config: Optional[JudgeConfig] = None,
                    **kw) -> JudgeProvider:
    """api_type defaults to $API_TYPE then 'openai' (factory.py:41-47)."""
    api_type = (api_type or os.environ.get("API_TYPE", "openai")).lower()
    if api_type not in _PROVIDERS:
        raise ValueError(f"Unknown API type: {api_type}. "
                         f"Supported: {sorted(_PROVIDERS)}")
    if api_type == "azure":
        kw.setdefault("azure", True)
    return _PROVIDERS[api_type](config=config, **kw)
