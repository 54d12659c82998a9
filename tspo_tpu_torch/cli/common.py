"""Shared CLI plumbing: scorer loading and tokenizers."""

from __future__ import annotations

import os

import numpy as np
import torch


def load_scorer(model_path: str | None, *, tiny: bool = False, device="cuda"):
    """TSPOScorer from a merged checkpoint directory (the npz format or a
    reference merged TSPO-0.4B directory), in bf16 with 256-frame chunks, or
    random weights from seed 0 when ``model_path`` is None (smoke and bench
    runs).  ``tiny`` selects the small test config, in fp32."""
    from ..configs import CLIPConfig, SelectorConfig
    from ..models.tspo_model import TSPOScorer, build_random_scorer
    from ..utils.device import resolve_device

    device = resolve_device(device)
    dtype, batch_frames = torch.bfloat16, 256
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
