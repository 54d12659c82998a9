"""Conversation prompt templates for the LLaVA backbone family.

The port's own copy of ``tspo_tpu/models/conversation.py`` (jax-free there
too; the port imports nothing of the JAX package): the templates,
``build_prompt``, the multi-round ``build_prompt_multi``, ``stop_str`` and
``vicuna_rope_overrides``, rendering the same prompts and rope scaling as
the JAX package.

Rebuilds the *active* slice of the reference's ``llava/conversation.py``
(the Conversation dataclass + get_prompt separator styles, :25-160, and the
template table :555-581) as plain prompt-rendering functions: the reference
keeps mutable message state on a dataclass and renders with a style enum;
here a template is immutable and rendering is one pure function, which is
all the TSPO adapters ever use (append user turn, append empty assistant
turn, get_prompt — llava_vid_tspo.py:413-417, 520-527).

Templates carried: the ones reachable from the reference's TSPO paths —
``qwen_1_5``/``qwen_2`` (LLaVA-Video-7B-Qwen2, the TSPO default),
``vicuna_v1`` (the lmms-eval adapter default, llava_vid_tspo.py:94),
``chatml_direct``, ``llama_2``/``llava_llama_2``, ``mistral_instruct``, and
``llava_llama_3`` (rendered with the Meta-Llama-3 chat layout the reference
obtains via tokenizer.apply_chat_template, conversation.py:97-109 — pinned
here as an explicit format string since a zero-egress build cannot fetch the
tokenizer).
"""

from __future__ import annotations

from dataclasses import dataclass

DEFAULT_IMAGE_TOKEN = "<image>"


@dataclass(frozen=True)
class ConvTemplate:
    name: str
    system: str
    roles: tuple          # (user, assistant) — MPT-style roles embed markup
    sep_style: str        # "two" | "chatml" | "mpt" | "llama_2" | "llama_3"
    sep: str = ""
    sep2: str = ""

    @property
    def stop_str(self) -> str:
        """Generation stop keyword, the reference adapter's rule
        (llava_vid_tspo.py:536): sep2 for the TWO style, sep otherwise, so
        mistral_instruct gets "" and llama_2 "<s>" (they stop on EOS only)."""
        return self.sep2 if self.sep_style == "two" else self.sep

    def render(self, user_message: str, assistant_message: str | None = None
               ) -> str:
        """system + user turn + assistant turn (empty => generation stub) —
        the two-append + get_prompt sequence of the reference adapters.
        Byte-parity with Conversation.get_prompt is pinned by
        tests/test_conversation.py against the actual reference templates."""
        return self.render_turns([(user_message, assistant_message)])

    def render_turns(self, turns) -> str:
        """Render ``[(user, assistant|None), ...]`` — the general
        Conversation.get_prompt message loop (conversation.py:60-163),
        which the single-turn adapters only ever drive with two messages.
        A ``None`` assistant message becomes the generation stub (the
        reference's append_message(role, None))."""
        msgs = []
        for u, a in turns:
            msgs.append((self.roles[0], u))
            msgs.append((self.roles[1], a))
        if self.sep_style == "two":            # conversation.py:74-83
            seps = (self.sep, self.sep2)
            out = self.system + seps[0]
            for i, (role, m) in enumerate(msgs):
                out += f"{role}: {m}{seps[i % 2]}" if m else f"{role}:"
            return out
        if self.sep_style == "chatml":         # conversation.py:85-95
            out = "" if self.system == "" else self.system + self.sep + "\n"
            for role, m in msgs:
                out += f"{role}\n{m}{self.sep}\n" if m else f"{role}\n"
            return out
        if self.sep_style == "mpt":            # conversation.py:121-129
            out = self.system + self.sep
            for role, m in msgs:
                out += role + m + self.sep if m else role
            return out
        if self.sep_style == "llama_2":        # conversation.py:142-163
            sys_block = (f"<<SYS>>\n{self.system}\n<</SYS>>\n\n"
                         if self.system else "")
            out = ""
            for i, (role, m) in enumerate(msgs):
                if not m:
                    continue
                if i == 0:
                    m = sys_block + m
                if i % 2 == 0:
                    out += self.sep + f"[INST] {m} [/INST]"
                else:
                    out += f" {m} {self.sep2}"
            # the reference char-set-lstrips the leading sep ("<s>"),
            # conversation.py:163 — single-turn prompts lose the BOS marker
            # entirely (the tokenizer re-adds BOS)
            return out.lstrip(self.sep) if self.sep else out
        if self.sep_style == "llama_3":        # conversation.py:97-109 via
            out = ("<|begin_of_text|><|start_header_id|>system"  # chat tmpl
                   f"<|end_header_id|>\n\n{self.system}<|eot_id|>")
            for role, m in msgs:
                if m:
                    out += (f"<|start_header_id|>{role}<|end_header_id|>"
                            f"\n\n{m}<|eot_id|>")
            out += "<|start_header_id|>assistant<|end_header_id|>\n\n"
            return out
        raise ValueError(f"unknown sep_style {self.sep_style}")


_QWEN = ConvTemplate(
    name="qwen_1_5",
    system="<|im_start|>system\nYou are a helpful assistant.",
    roles=("<|im_start|>user", "<|im_start|>assistant"),
    sep_style="chatml", sep="<|im_end|>")

_VICUNA_V1 = ConvTemplate(
    name="vicuna_v1",
    system="A chat between a curious user and an artificial intelligence "
           "assistant. The assistant gives helpful, detailed, and polite "
           "answers to the user's questions.",
    roles=("USER", "ASSISTANT"), sep_style="two", sep=" ", sep2="</s>")

_CHATML_DIRECT = ConvTemplate(
    name="chatml_direct",
    system="<|im_start|>system\nAnswer the questions.",
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    sep_style="mpt", sep="<|im_end|>")

_LLAMA_2 = ConvTemplate(
    name="llama_2",
    system="""You are a helpful, respectful and honest assistant. Always answer as helpfully as possible, while being safe.  Your answers should not include any harmful, unethical, racist, sexist, toxic, dangerous, or illegal content. Please ensure that your responses are socially unbiased and positive in nature.

If a question does not make any sense, or is not factually coherent, explain why instead of answering something not correct. If you don't know the answer to a question, please don't share false information.""",
    roles=("USER", "ASSISTANT"), sep_style="llama_2", sep="<s>", sep2="</s>")

_LLAVA_LLAMA_2 = ConvTemplate(
    name="llava_llama_2",
    system="You are a helpful language and vision assistant. You are able "
           "to understand the visual content that the user provides, and "
           "assist the user with a variety of tasks using natural language.",
    roles=("USER", "ASSISTANT"), sep_style="llama_2", sep="<s>", sep2="</s>")

_MISTRAL_INSTRUCT = ConvTemplate(
    name="mistral_instruct", system="",
    roles=("USER", "ASSISTANT"), sep_style="llama_2", sep="", sep2="</s>")

_LLAVA_LLAMA_3 = ConvTemplate(
    name="llava_llama_3",
    system="You are a helpful language and vision assistant. You are able "
           "to understand the visual content that the user provides, and "
           "assist the user with a variety of tasks using natural language.",
    roles=("user", "assistant"), sep_style="llama_3", sep="<|eot_id|>")

CONV_TEMPLATES = {
    "qwen_1_5": _QWEN,
    "qwen_2": _QWEN,
    "vicuna_v1": _VICUNA_V1,
    "v1": _VICUNA_V1,
    "chatml_direct": _CHATML_DIRECT,
    "llama_2": _LLAMA_2,
    "llava_llama_2": _LLAVA_LLAMA_2,
    "mistral_instruct": _MISTRAL_INSTRUCT,
    "llava_mistral_instruct": _MISTRAL_INSTRUCT,
    "llava_llama_3": _LLAVA_LLAMA_3,
}


def get_template(name: str) -> ConvTemplate:
    try:
        return CONV_TEMPLATES[name]
    except KeyError:
        raise KeyError(
            f"unknown conv template {name!r}; available: "
            f"{sorted(CONV_TEMPLATES)}") from None


def build_prompt(question: str, template: str = "qwen_1_5",
                 assistant: str | None = None,
                 add_image_token: bool = True) -> str:
    """The adapter prompt build (llava_vid_tspo.py:520-527): prepend
    ``<image>\\n`` to the task text, wrap in the conv template, end with the
    assistant generation stub.  No trailer is appended — eval task prompts
    carry their own instructions (the trainer's letter-answer trailer is the
    TRAINER's addition, tspo_trainer.py:487)."""
    q = (DEFAULT_IMAGE_TOKEN + "\n" + question) if add_image_token \
        else question
    return get_template(template).render(q, assistant)


def build_prompt_multi(turns, template: str = "qwen_1_5",
                       add_image_token: bool = True) -> str:
    """Multi-round prompt: ``turns`` is [(question, answer|None), ...] with
    the last answer None (the generation stub).  The <image> token rides the
    FIRST user turn only: the video is encoded and spliced once, as in the
    single-turn adapters."""
    rendered = []
    for i, (q, a) in enumerate(turns):
        if i == 0 and add_image_token:
            q = DEFAULT_IMAGE_TOKEN + "\n" + q
        rendered.append((q, a))
    return get_template(template).render_turns(rendered)


def stop_str(template: str = "qwen_1_5") -> str:
    return get_template(template).stop_str


def vicuna_rope_overrides(max_frames_num: int,
                          mm_spatial_pool_stride: int = 2,
                          vision_224: bool = False) -> dict:
    """Long-context linear rope scaling for vicuna/yi LLaVA checkpoints
    (llava_vid_tspo.py:159-174): estimate the token budget (frames x pooled
    grid tokens + ~1000 text), scale the 4096 context up to cover it.
    Returns {} when no scaling is needed (factor < 2, like the reference)."""
    import math
    grid = 16 if vision_224 else 24
    least = max_frames_num * (grid // mm_spatial_pool_stride) ** 2 + 1000
    factor = math.ceil(least / 4096)
    if factor < 2:
        return {}
    return {"rope_scaling": {"factor": float(factor), "type": "linear"},
            "max_sequence_length": 4096 * factor,
            "tokenizer_model_max_length": 4096 * factor}
