"""Port parity: the ``tspo-torch-evaluate`` CLI (``tspo_tpu_torch.cli.evaluate``)
against ``tspo_tpu.cli.evaluate`` on toy VideoMME docs over the toy videos
of ``tests/test_eval.py``.

With ``--backbone stub --device cpu`` the port writes the JAX CLI's output
files, ``<task>_rank<r>_<stamp>.json`` and its ``_samples.jsonl``, with the
same task, metrics, count and sample records (the timestamp and
``elapsed_s`` aside; the port's config also has ``--device``), prints the
same table, and runs a ``--config`` sweep alike.  ``--speculative`` on the
synthetic tiny LLaVA-Video checkpoint (fp32 in both packages) gives the JAX
CLI's samples and the port's own non-speculative ones.  Each option the port
does not have yet raises ``NotImplementedError`` naming its ROADMAP.md item;
the rule-only defaults of the judged families run without ``--judge``."""

import json

import pytest
import torch
import yaml

from test_eval import _vmme_docs, bench_dir  # noqa: F401
from tspo_tpu.cli import common as jcommon
from tspo_tpu.cli import evaluate as jcli
from tspo_tpu_torch.cli import evaluate as tcli

torch.set_num_threads(1)


@pytest.fixture
def docs_json(bench_dir, tmp_path):  # noqa: F811
    path = tmp_path / "VideoMME_frameIdx.json"
    path.write_text(json.dumps(_vmme_docs(5)))
    return str(path), str(bench_dir / "videos")


def _outputs(out_dir):
    """{'json': the aggregate minus its run-specific keys, 'samples': the
    JSONL records} of the one run written to ``out_dir``."""
    (agg,) = sorted(p for p in out_dir.iterdir() if p.suffix == ".json")
    body = json.loads(agg.read_text())
    samples = [json.loads(x) for x in
               agg.with_name(agg.stem + "_samples.jsonl").read_text().splitlines()]
    config = {k: v for k, v in body.pop("config").items() if k not in ("output", "device")}
    body.pop("elapsed_s")
    return {"name": agg.name.rsplit("_", 2)[0], "json": body, "config": config,
            "samples": samples}


@pytest.mark.parametrize("extra", [[], ["--batch", "2", "--limit", "4"]],
                         ids=["batch_1", "batch_2"])
def test_stub_run_writes_the_jax_cli_outputs(docs_json, tmp_path, monkeypatch, capsys,
                                             extra):
    path, videos = docs_json
    monkeypatch.setattr(jcommon, "enable_compilation_cache", lambda: None)
    argv = ["--task", "VideoMME", "--frame-idx-json", path, "--video-root", videos,
            "--backbone", "stub", "--max-frames-num", "8", *extra]
    jcli.main(argv + ["--output", str(tmp_path / "jax")])
    jax_out = capsys.readouterr().out
    tcli.main(argv + ["--output", str(tmp_path / "port"), "--device", "cpu"])
    port_out = capsys.readouterr().out
    want, got = _outputs(tmp_path / "jax"), _outputs(tmp_path / "port")
    assert got == want
    assert got["name"] == "VideoMME_rank0" and got["json"]["n"] == (4 if extra else 5)
    table = lambda out: out.split("saved ->")[0].strip().splitlines()[-8:]  # noqa: E731
    assert table(port_out) == table(jax_out)


def test_make_table_matches_jax():
    metrics = {"overall": 51.25, "short": 50, "categories": {"d": 12.5, "e": 0.0},
               "note": "bleurt: gated"}
    assert tcli.make_table("VideoMME", metrics, 8) == jcli.make_table("VideoMME", metrics, 8)


def test_config_sweep_matches_jax(docs_json, tmp_path, monkeypatch, capsys):
    path, videos = docs_json
    monkeypatch.setattr(jcommon, "enable_compilation_cache", lambda: None)
    outs = {}
    for name, cli, extra in (("jax", jcli, {}), ("port", tcli, {"device": "cpu"})):
        runs = [dict(task="VideoMME", frame_idx_json=path, video_root=videos,
                     max_frames_num=8, output=str(tmp_path / name / f"r{i}"), **extra)
                for i in range(2)]
        runs[1]["limit"] = 2
        runs.append(dict(runs[0], task=None))            # a failing run: the sweep goes on
        cfg = tmp_path / f"{name}.yaml"
        cfg.write_text(yaml.safe_dump(runs))
        cli.main(["--config", str(cfg), "--backbone", "stub"])
        outs[name] = [_outputs(tmp_path / name / f"r{i}") for i in range(2)]
    assert outs["port"] == outs["jax"]
    assert [o["json"]["n"] for o in outs["port"]] == [5, 2]
    assert capsys.readouterr().out.count("run 3 failed") == 2


@pytest.mark.parametrize("flags,item", [
    (["--coordinator", "localhost:1234"], 6), (["--num-processes", "2"], 6),
    (["--process-id", "0"], 6), (["--speculative", "--quantize-backbone"], 5),
    (["--quantize-backbone"], 5),
    (["--wandb-args", "project=tspo"], 7), (["--judge", "dummy"], 8),
    (["--megabench-submission", "sub.json"], 8),
    (["--task", "ActivityNet-QA"], 8), (["--task", "MEGABench-core"], 8),
    (["--task", "TempCompass-multi-choice", "--judge", "dummy"], 8),
])
def test_unported_options_raise_naming_their_item(docs_json, tmp_path, flags, item):
    path, videos = docs_json
    argv = ["--task", "VideoMME", "--frame-idx-json", path, "--video-root", videos,
            "--device", "cpu", "--output", str(tmp_path / "out"), *flags]
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md Queue 1 item {item}\\b"):
        tcli.main(argv)
    assert not (tmp_path / "out").exists()
    with pytest.raises(SystemExit):              # the port has no qwen2_5_vl backbone
        tcli.build_parser().parse_args(["--backbone", "qwen2_5_vl"])


def test_speculative_llava_run_matches_jax_and_plain(docs_json, tmp_path, monkeypatch,
                                                    capsys):
    """``--backbone llava_video --speculative`` on the synthetic tiny
    checkpoint: the port's samples equal the JAX CLI's and the port's own
    without ``--speculative`` (speculation is greedy-exact)."""
    pytest.importorskip("safetensors")
    import jax.numpy as jnp
    from scripts.make_synthetic_assets import build_backbone
    from tspo_tpu_torch.cli import common as tcommon
    path, videos = docs_json
    backbone = build_backbone(str(tmp_path / "backbone"))
    monkeypatch.setattr(jcommon, "enable_compilation_cache", lambda: None)
    jload, tload = jcommon._load_llava_dir, tcommon._load_llava_dir
    monkeypatch.setattr(jcommon, "_load_llava_dir",
                        lambda p, cfg, **kw: jload(p, cfg, **{**kw, "dtype": jnp.float32}))
    monkeypatch.setattr(tcommon, "_load_llava_dir",
                        lambda p, cfg, **kw: tload(p, cfg, **{**kw, "dtype": torch.float32}))
    argv = ["--task", "VideoMME", "--frame-idx-json", path, "--video-root", videos,
            "--backbone", "llava_video", "--backbone-path", backbone,
            "--max-frames-num", "8", "--limit", "2"]
    jcli.main(argv + ["--speculative", "--output", str(tmp_path / "jax")])
    tcli.main(argv + ["--speculative", "--output", str(tmp_path / "spec"),
                      "--device", "cpu"])
    tcli.main(argv + ["--output", str(tmp_path / "plain"), "--device", "cpu"])
    capsys.readouterr()
    want, spec, plain = (_outputs(tmp_path / n) for n in ("jax", "spec", "plain"))
    assert spec["samples"] == want["samples"] == plain["samples"]
    assert spec["config"]["speculative"] and not plain["config"]["speculative"]
    assert all(s["response"] for s in spec["samples"]) and len(spec["samples"]) == 2


def test_rule_only_judged_families_run_without_judge(docs_json, tmp_path):
    """TempCompass's import-time rule-based registration runs without
    ``--judge``, as in the JAX CLI (which re-registers it the same way)."""
    from tspo_tpu_torch.eval.tasks import get_task
    path, videos = docs_json
    tcli.main(["--task", "TempCompass-multi-choice", "--frame-idx-json", path,
               "--video-root", videos, "--device", "cpu", "--limit", "1",
               "--output", str(tmp_path / "out")])
    assert get_task("TempCompass-multi-choice").output_type == "generate_until"
    assert len(list((tmp_path / "out").iterdir())) == 2
