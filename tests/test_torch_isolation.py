"""The port stands alone: importing every tspo_tpu_torch module pulls in
neither JAX nor the JAX package, and its entry points refuse to run without
a card unless told ``device="cpu"``."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tspo_tpu_torch.configs import CLIPConfig, PrecomputeConfig, SelectorConfig

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
import tspo_tpu_torch
names = ["tspo_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    tspo_tpu_torch.__path__, "tspo_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "flax", "optax"))
             or m == "tspo_tpu" or m.startswith("tspo_tpu."))
assert {"tspo_tpu_torch.train.trainer", "tspo_tpu_torch.train.grpo",
        "tspo_tpu_torch.train.checkpoint", "tspo_tpu_torch.train.rewards",
        "tspo_tpu_torch.video.augment", "tspo_tpu_torch.cli.train"} <= set(names)
print(len(names), bad)
"""


def test_importing_every_module_leaves_jax_and_tspo_tpu_out():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 20, out.stdout            # every module was imported
    assert bad == "[]", f"port imported {bad}"


def test_sources_never_name_jax_or_tspo_tpu_imports():
    for path in (ROOT / "tspo_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                assert "jax" not in s, f"{path}: {s}"
                assert not s.startswith(("import tspo_tpu ", "from tspo_tpu ",
                                         "from tspo_tpu.", "import tspo_tpu.")), \
                    f"{path}: {s}"


def test_checkpoint_libraries_load_only_inside_loaders():
    """``transformers`` and ``safetensors`` (optional: running the port on a
    card needs neither) are imported only inside the functions that read
    checkpoint directories, never when a port module is imported."""
    probe = _PROBE.replace(
        'm == "jax" or m.startswith(("jax.", "jaxlib", "flax", "optax"))\n'
        '             or m == "tspo_tpu" or m.startswith("tspo_tpu.")',
        'm.split(".")[0] in ("transformers", "safetensors")')
    assert probe != _PROBE
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().split(" ", 1)[1] == "[]", out.stdout


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_scorer_defaults_to_cuda_and_raises_without_card(monkeypatch):
    from tspo_tpu_torch.models.tspo_model import build_random_scorer
    _no_card(monkeypatch)
    tiny = dict(clip_cfg=CLIPConfig.tiny(),
                selector_cfg=SelectorConfig(dim=48, num_heads=4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_random_scorer(torch.Generator().manual_seed(0), **tiny)
    s = build_random_scorer(torch.Generator().manual_seed(0), device="cpu", **tiny)
    assert s.device.type == "cpu"


def test_load_scorer_and_cli_raise_without_card(monkeypatch, tmp_path):
    from tspo_tpu_torch.cli import precompute as precompute_cli
    from tspo_tpu_torch.cli.common import load_scorer
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError):
        load_scorer(None, tiny=True)
    assert load_scorer(None, tiny=True, device="cpu").device.type == "cpu"
    tsv = tmp_path / "B.tsv"
    tsv.write_text("index\ttask_name\tvideo_name\tquestion_id\tquestion\n")
    with pytest.raises(RuntimeError):
        precompute_cli.main(["--data", "B", "--tsv", str(tsv), "--video-root",
                             str(tmp_path), "--tiny"])


def test_llava_entry_points_default_to_cuda_and_raise_without_card(monkeypatch):
    from tspo_tpu_torch.cli.common import load_backbone
    from tspo_tpu_torch.models.llava_video import LLaVAVideoConfig, LLaVAVideoModel
    _no_card(monkeypatch)
    cfg = LLaVAVideoConfig.tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLaVAVideoModel.random_init(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLaVAVideoModel.from_torch_checkpoint({}, cfg)
    m = LLaVAVideoModel.random_init(torch.Generator().manual_seed(0), cfg,
                                    dtype=torch.float32, device="cpu")
    assert m.device.type == "cpu"
    with pytest.raises(ValueError, match="unknown backbone"):
        load_backbone("qwen2_5_vl", None)


def test_precompute_takes_the_scorers_device(tmp_path):
    from tspo_tpu_torch.eval.precompute import FrameIndexPrecompute
    from tspo_tpu_torch.models.tspo_model import build_random_scorer
    from tspo_tpu_torch.video.cache import FeatureCache
    s = build_random_scorer(torch.Generator().manual_seed(0), device="cpu",
                            clip_cfg=CLIPConfig.tiny(),
                            selector_cfg=SelectorConfig(dim=48, num_heads=4))
    pre = FrameIndexPrecompute(s, FeatureCache(str(tmp_path)), PrecomputeConfig())
    assert pre.scorer.device.type == "cpu"


def test_kernel_wrapper_raises_for_cuda_without_card():
    """A CUDA tensor cannot even be made here; the wrapper's device check is
    what decides, so a non-CPU, non-CUDA device raises rather than falling
    back."""
    from tspo_tpu_torch.ops.flash_attention import flash_attention
    from tspo_tpu_torch.ops.vit_attention import vit_attention
    q = torch.zeros(1, 4, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        vit_attention(q, q, q, 2)
    q4 = torch.zeros(1, 4, 2, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q4, q4, q4)
    from tspo_tpu_torch.ops import vit_attention_variants as vv
    m = torch.zeros(2, 4, 128, dtype=torch.bfloat16, device="meta")
    calls = {
        "lane_attention": lambda: vv.lane_attention(m, m, m, 2),
        "lane_packed_attention": lambda: vv.lane_packed_attention(
            torch.zeros(2, 4, 384, dtype=torch.bfloat16, device="meta"), 2),
        "bdp2_attention": lambda: vv.bdp2_attention(m, m, m, 2),
        "pipelined_attention": lambda: vv.pipelined_attention(m, m, m, 2),
        "dma_add": lambda: vv.dma_add(m, m),
        "gemm": lambda: vv.gemm(m, m, trans_b=True),
        "row_softmax": lambda: vv.row_softmax(m.float(), 1.0),
    }
    assert set(calls) == {fn.__name__ for fn in vv.WRAPPERS}
    for name, call in calls.items():
        with pytest.raises(ValueError, match="unsupported device"):
            call()


def test_variant_bench_raises_without_card_unless_told_cpu(monkeypatch, capsys):
    from tspo_tpu_torch.tools import bench_vit_attention_variants as bench
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main(["lane"])
    assert bench.main(["lane", "--device", "cpu", "--tiny"]) == 0
    assert '"variant": "lane"' in capsys.readouterr().out


def test_flash_form_comparison_needs_a_card(monkeypatch, tmp_path):
    from tspo_tpu_torch.tools import compare_flash_forms as cmp
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        cmp.main([str(tmp_path / "old.cu")])
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        cmp.main(["--kernel", "vit_attention", str(tmp_path / "old.cu")])
    with pytest.raises(ValueError, match="kernel must be one of"):
        cmp.compare([tmp_path / "old.cu"], kernel="lane_attention")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for kernel in cmp.KERNELS:
        with pytest.raises(ValueError, match="distinct file name"):
            cmp.compare([tmp_path / "a" / "f.cu", tmp_path / "b" / "f.cu"],
                        kernel=kernel)


def _tiny_trainer(tmp_path, device, **kw):
    from tspo_tpu_torch.configs import TrainConfig
    from tspo_tpu_torch.models.tspo_model import build_random_scorer
    from tspo_tpu_torch.train.trainer import TSPOTrainer
    scorer = build_random_scorer(torch.Generator().manual_seed(0), device=device,
                                 clip_cfg=CLIPConfig.tiny(),
                                 selector_cfg=SelectorConfig(dim=48, num_heads=4))
    return TSPOTrainer(scorer=scorer, backbone=None, dataset=[],
                       output_dir=str(tmp_path), **kw)


def test_trainer_and_train_cli_default_to_cuda_and_raise_without_card(
        monkeypatch, tmp_path):
    from tspo_tpu_torch.cli import train as train_cli
    from tspo_tpu_torch.cli.common import load_scorer
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _tiny_trainer(tmp_path, "cuda")
    trainer = _tiny_trainer(tmp_path, "cpu")
    assert trainer.device.type == "cpu" and trainer._generator.device.type == "cpu"
    assert all(not p.requires_grad for p in trainer.scorer.clip.parameters())
    assert all(p.requires_grad and p.dtype == torch.float32
               for p in trainer.scorer.selector.parameters())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_scorer(None, tiny=True)
    jsonl = tmp_path / "rows.jsonl"
    jsonl.write_text('{"video": "v.mp4", "original_question": "q"}\n')
    assert train_cli.build_parser().parse_args(
        ["--video-folder", "."]).device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--jsonl-path", str(jsonl), "--video-folder",
                        str(tmp_path), "--tiny", "--max-steps", "1"])


@pytest.mark.parametrize("flags", [
    ["--mesh-data", "2"], ["--coordinator", "localhost:1234"],
    ["--num-processes", "2"], ["--process-id", "0"],
    ["--ckpt-backend", "orbax"], ["--tensorboard"], ["--quantize-backbone"],
    ["--cross-batch-rollouts"],
])
def test_train_cli_unported_options_raise(tmp_path, flags):
    from tspo_tpu_torch.cli import train as train_cli
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item"):
        train_cli.main(["--jsonl-path", str(tmp_path / "none.jsonl"),
                        "--video-folder", str(tmp_path), "--tiny", "--device",
                        "cpu", *flags])
    with pytest.raises(SystemExit):       # the port has no qwen2_5_vl backbone
        train_cli.build_parser().parse_args(["--video-folder", ".", "--backbone",
                                             "qwen2_5_vl"])


def test_trainer_mesh_orbax_and_multihost_raise(tmp_path):
    from tspo_tpu_torch.configs import TrainConfig
    from tspo_tpu_torch.train.checkpoint import OrbaxCheckpointer
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        _tiny_trainer(tmp_path, "cpu", mesh=object())
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        _tiny_trainer(tmp_path, "cpu", cfg=TrainConfig(ckpt_backend="orbax"))
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        OrbaxCheckpointer(str(tmp_path))
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        _tiny_trainer(tmp_path, "cpu").train_step_batch_global([], None)
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        _tiny_trainer(tmp_path, "cpu", cfg=TrainConfig(cross_batch_rollouts=True))
