"""Port parity: the demo CLI (``python -m tspo_tpu_torch.cli.demo``) against
the JAX package's ``tspo_tpu.cli.demo`` on one synthetic video.

Both demos read the same synthetic assets (``scripts/make_synthetic_assets``:
a merged TSPO checkpoint at tiny CLIP geometry and a tiny LLaVA-Video
checkpoint directory with its mini Qwen2 tokenizer), score, select 8 of the
24 candidate frames and answer.  Both run in fp32 (the JAX demo's loaders
and the port's are bf16, so the test hands both packages' loaders fp32):
the selected indices and the answer must be equal."""

import ast
import os
from functools import partial

import jax.numpy as jnp
import pytest
import torch

from tspo_tpu.cli import common as jcommon
from tspo_tpu.cli import demo as jdemo
from tspo_tpu_torch.cli import common as tcommon
from tspo_tpu_torch.cli import demo as tdemo

pytest.importorskip("cv2")
pytest.importorskip("safetensors")
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    from scripts.make_synthetic_assets import (build_backbone, build_ckpt,
                                               build_videos)
    root = tmp_path_factory.mktemp("demo_assets")
    ckpt = build_ckpt(str(root / "ckpt"), tiny=True)
    backbone = build_backbone(str(root / "backbone"))
    names = build_videos(str(root / "videos"), n=1, candidate_frames=24)
    return ckpt, backbone, str(root / "videos" / names[0])


def _lines(out: str) -> dict:
    got = {}
    for line in out.splitlines():
        if line.startswith("selected "):
            got["selected"] = line.split(":", 1)[1].strip()
        elif line.startswith("answer: "):
            got["answer"] = line[len("answer: "):]
    return got


def test_port_demo_matches_jax_demo(assets, tmp_path, monkeypatch, capsys):
    ckpt, backbone, video = assets
    args = ["--video", video, "--question", "What moves in the video?",
            "--model-path", ckpt, "--backbone", "llava_video",
            "--backbone-path", backbone, "--sample-num", "8",
            "--window-size", "4"]
    monkeypatch.setattr(jcommon, "enable_compilation_cache", lambda: None)
    monkeypatch.setattr(jcommon, "load_scorer",
                        partial(jcommon.load_scorer, dtype=jnp.float32))
    load_dir = jcommon._load_llava_dir
    monkeypatch.setattr(jcommon, "_load_llava_dir",
                        lambda path, cfg, **kw: load_dir(path, cfg,
                                                         dtype=jnp.float32, **kw))
    jdemo.main(args + ["--contact-sheet", str(tmp_path / "jax.jpg")])
    want = _lines(capsys.readouterr().out)

    monkeypatch.setattr(tcommon, "load_scorer",
                        partial(tcommon.load_scorer, dtype=torch.float32))
    tload_dir = tcommon._load_llava_dir
    monkeypatch.setattr(tcommon, "_load_llava_dir",
                        lambda path, cfg, **kw: tload_dir(
                            path, cfg, **{**kw, "dtype": torch.float32}))
    tdemo.main(args + ["--contact-sheet", str(tmp_path / "port.jpg"),
                       "--device", "cpu"])
    got = _lines(capsys.readouterr().out)
    assert set(want) == {"selected", "answer"} and want["answer"]
    assert got == want
    assert os.path.getsize(tmp_path / "port.jpg") > 0


def test_port_demo_raises_without_card(assets, monkeypatch):
    _, _, video = assets
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdemo.main(["--video", video, "--question", "q", "--tiny"])


def test_stub_backbone_answers(assets, tmp_path, capsys):
    _, _, video = assets
    tdemo.main(["--video", video, "--question", "q", "--tiny", "--device",
                "cpu", "--backbone", "stub", "--sample-num", "4",
                "--contact-sheet", str(tmp_path / "s.jpg")])
    out = _lines(capsys.readouterr().out)
    assert out["answer"] == "A" and len(ast.literal_eval(out["selected"])) == 4


@pytest.mark.parametrize("sample_num,factor", [(16, 1.0), (64, 3.0)])
def test_demo_passes_sample_num_to_the_vicuna_rope_factor(
        assets, tmp_path, monkeypatch, capsys, sample_num, factor):
    """A vicuna checkpoint answered by the demo gets the rope factor that
    covers ``--sample-num`` frames, as the JAX demo gives it: at 16 frames
    ceil((16 * 12**2 + 1000) / 4096) = 1 (no scaling), at 64 frames 3.  The
    tokenizer and the weights are stubbed on both sides; the stub model
    answers with its template and factor."""
    import json
    import types

    import transformers

    _, _, video = assets
    path = tmp_path / "llava-vicuna-7b"
    path.mkdir()
    (path / "config.json").write_text(json.dumps({
        "model_type": "llava_llama", "vocab_size": 1000, "hidden_size": 64,
        "intermediate_size": 128, "num_hidden_layers": 2,
        "num_attention_heads": 4,
        "mm_vision_tower": "openai/clip-vit-large-patch14-336"}))

    class Echo:
        def __init__(self, cfg):
            self.cfg = cfg

        def generate(self, frames, prompt):
            return f"{self.conv_template} {self.cfg.lm.rope_scaling_factor}"

    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        lambda *a, **k: types.SimpleNamespace(bos_token_id=1))
    monkeypatch.setattr(jcommon, "_load_llava_dir", lambda p, cfg, **kw: Echo(cfg))
    monkeypatch.setattr(tcommon, "_load_llava_dir", lambda p, cfg, **kw: Echo(cfg))
    monkeypatch.setattr(jcommon, "enable_compilation_cache", lambda: None)
    args = ["--video", video, "--question", "q", "--tiny", "--backbone",
            "llava_video", "--backbone-path", str(path), "--sample-num",
            str(sample_num), "--window-size", "4"]
    jdemo.main(args + ["--contact-sheet", str(tmp_path / "jax.jpg")])
    want = _lines(capsys.readouterr().out)["answer"]
    tdemo.main(args + ["--contact-sheet", str(tmp_path / "port.jpg"),
                       "--device", "cpu"])
    got = _lines(capsys.readouterr().out)["answer"]
    assert got == want == f"vicuna_v1 {factor}"
