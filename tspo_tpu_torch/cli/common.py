"""Shared CLI plumbing: scorer and backbone loading, tokenizers."""

from __future__ import annotations

import dataclasses
import glob
import json
import os

import numpy as np
import torch


def load_scorer(model_path: str | None, *, tiny: bool = False, device="cuda",
                dtype=None):
    """TSPOScorer from a merged checkpoint directory (the npz format or a
    reference merged TSPO-0.4B directory), in ``dtype`` (default bf16) with
    256-frame chunks, or random weights from seed 0 when ``model_path`` is
    None (smoke and bench runs).  ``tiny`` selects the small test config, in
    fp32."""
    from ..configs import CLIPConfig, SelectorConfig
    from ..models.tspo_model import TSPOScorer, build_random_scorer
    from ..utils.device import resolve_device

    device = resolve_device(device)
    dtype, batch_frames = dtype or torch.bfloat16, 256
    gen = torch.Generator().manual_seed(0)
    if model_path:
        tokenize = make_clip_tokenizer(model_path)
        if os.path.exists(os.path.join(model_path, "tspo_params.npz")):
            return TSPOScorer.load(model_path, dtype=dtype, tokenize=tokenize,
                                   batch_frames=batch_frames, device=device)
        return _scorer_from_torch_dir(model_path, dtype, tokenize, batch_frames,
                                      device)
    if tiny:
        clip_cfg = CLIPConfig.tiny()
        return build_random_scorer(
            gen, clip_cfg=clip_cfg,
            selector_cfg=SelectorConfig(dim=clip_cfg.text.projection_dim,
                                        num_heads=4),
            dtype=torch.float32, batch_frames=32, device=device,
            tokenize=_stub_tokenizer(eos=clip_cfg.text.eos_token_id, length=8))
    return build_random_scorer(gen, dtype=dtype, batch_frames=batch_frames,
                               device=device, tokenize=_stub_tokenizer())


def _scorer_from_torch_dir(path: str, dtype, tokenize, batch_frames, device):
    """Load a reference-format merged TSPO-0.4B HF directory (safetensors or
    pytorch_model.bin).  The CLIP geometry is inferred from tensor shapes."""
    from ..configs import SelectorConfig
    from ..models.clip import clip_config_from_state_dict
    from ..models.tspo_model import TSPOScorer
    sd = {}
    st_files = [f for f in os.listdir(path) if f.endswith(".safetensors")]
    if st_files:
        from safetensors import safe_open
        for fname in st_files:
            with safe_open(os.path.join(path, fname), framework="np") as f:
                for k in f.keys():
                    sd[k] = f.get_tensor(k)
    else:
        sd = torch.load(os.path.join(path, "pytorch_model.bin"),
                        map_location="cpu", weights_only=True)
    clip_cfg = clip_config_from_state_dict(
        {k: v for k, v in sd.items() if not k.startswith("selector.")})
    return TSPOScorer.from_torch_merged(
        sd, clip_cfg=clip_cfg,
        selector_cfg=SelectorConfig(dim=clip_cfg.text.projection_dim),
        dtype=dtype, tokenize=tokenize, batch_frames=batch_frames,
        device=device)


def make_clip_tokenizer(model_path: str):
    """CLIP tokenizer from a local checkpoint dir; returns
    problem -> (input_ids, attention_mask) with CLIP padding/truncation.

    Raises instead of degrading: a checkpoint dir with missing or corrupt
    tokenizer files must fail loudly, never score benchmarks with garbage
    text features.  The char-hash stub is reserved for ``model_path=None``
    smoke and bench runs."""
    errors = []
    try:
        from transformers import CLIPTokenizerFast
        tok = CLIPTokenizerFast.from_pretrained(model_path)
    except Exception as e:
        errors.append(f"CLIPTokenizerFast: {e}")
        try:
            from transformers import AutoTokenizer
            tok = AutoTokenizer.from_pretrained(model_path)
        except Exception as e2:
            errors.append(f"AutoTokenizer: {e2}")
            detail = "\n  ".join(errors)
            raise RuntimeError(
                f"no usable tokenizer in checkpoint dir {model_path!r}.\n"
                "Phase-1 scoring conditions on CLIP text features; a fallback "
                "tokenizer would silently select garbage frames, so this is "
                "fatal.  The merged TSPO-0.4B export must contain the CLIP "
                "tokenizer files (vocab.json + merges.txt, or tokenizer.json, "
                "plus tokenizer_config.json); copy them from the "
                "openai/clip-vit-large-patch14 checkpoint.\n"
                f"  {detail}") from e2

    def tokenize(problem: str):
        out = tok(problem, return_tensors="np", padding=True, truncation=True)
        return out["input_ids"], out["attention_mask"]

    return tokenize


def _stub_tokenizer(eos: int = 49407, length: int = 16, vocab: int | None = None):
    vocab = vocab if vocab is not None else eos + 1

    def tokenize(problem: str):
        ids = np.full((1, length), 3, np.int32)
        for i, ch in enumerate(problem[: length - 2]):
            ids[0, i + 1] = 1 + (ord(ch) % max(vocab - 2, 1))
        ids[0, -1] = eos
        return ids, np.ones((1, length), np.int32)
    return tokenize


def stub_qwen_tokenizer(vocab: int = 151643):
    """(encode, decode) for runs without a tokenizer directory: characters to
    ids below ``vocab`` (151643, the first of Qwen2's special ids, so no
    character maps to EOS 151645), and ids back to a space-joined string."""
    def encode(text: str) -> list:
        return [ord(c) % vocab for c in text]

    def decode(toks) -> str:
        return " ".join(str(int(t)) for t in toks)
    return encode, decode


def load_backbone(kind: str, model_path: str | None = None, *, device="cuda",
                  dtype=None, conv_template: str | None = None,
                  max_frames_num: int = 64):
    """Backbone for answering: ``"stub"`` (answers "A", for tests) or
    ``"llava_video"`` from a LLaVA-Video-Qwen2 checkpoint directory
    (safetensors or pytorch_model*.bin in the llava_qwen layout, config.json,
    and an HF tokenizer), on ``device`` in ``dtype`` (default bf16).

    A path naming "vicuna" or "yi" is an old vicuna/yi checkpoint, as in the
    reference adapter (llava_vid_tspo.py:94, 159-174): template ``vicuna_v1``
    unless given, and, when its config has no rope scaling, the linear
    factor that covers ``max_frames_num`` frames of pooled grid tokens."""
    if kind == "stub":
        class Stub:
            def generate(self, frames, prompt):
                return "A"
        return Stub()
    if kind != "llava_video":
        raise ValueError(f"unknown backbone: {kind} (the port has 'stub' and "
                         "'llava_video')")
    from transformers import AutoTokenizer

    from ..models.conversation import vicuna_rope_overrides
    from ..models.llava_video import LLaVAVideoConfig
    tok = AutoTokenizer.from_pretrained(model_path)
    cfg_path = os.path.join(model_path, "config.json")
    hf, cfg = {}, LLaVAVideoConfig()
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            hf = json.load(f)
        cfg = LLaVAVideoConfig.from_hf_config(hf)
    if "vicuna" in str(model_path).lower() or "yi" in str(model_path).lower():
        conv_template = conv_template or "vicuna_v1"
        if cfg.lm.rope_scaling_factor == 1.0:
            over = vicuna_rope_overrides(
                max_frames_num, cfg.pool_stride,
                vision_224="224" in str(hf.get("mm_vision_tower", "")))
            if over:
                cfg = dataclasses.replace(cfg, lm=dataclasses.replace(
                    cfg.lm, rope_scaling_factor=over["rope_scaling"]["factor"]))
    model = _load_llava_dir(model_path, cfg, device=device,
                            dtype=dtype or torch.bfloat16)
    model.encode = lambda s: tok(s).input_ids
    model.decode = lambda toks: tok.decode(toks, skip_special_tokens=True)
    model.conv_template = conv_template or "qwen_1_5"
    model.bos_token_id = tok.bos_token_id
    return model


def _load_llava_dir(path: str, cfg, *, device, dtype):
    from ..models.llava_video import LLaVAVideoModel
    sd = {}
    st_files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if st_files:
        from safetensors import safe_open
        for fname in st_files:
            with safe_open(fname, framework="pt") as f:
                for k in f.keys():
                    sd[k] = f.get_tensor(k)
    else:
        for fname in sorted(glob.glob(os.path.join(path, "pytorch_model*.bin"))):
            sd.update(torch.load(fname, map_location="cpu", weights_only=True))
    return LLaVAVideoModel.from_torch_checkpoint(sd, cfg, dtype=dtype,
                                                 device=device)


def load_jsonl(path: str) -> list:
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]
