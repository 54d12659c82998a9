"""Port parity: phase-1 precompute (tspo_tpu_torch.eval.precompute and its
CLI) against the JAX FrameIndexPrecompute on a toy video set written with cv2.

Both packages score with the same weights; the emitted ``*_frameIdx.json``
must be byte-identical."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tspo_tpu.configs import CLIPConfig as JCLIPConfig
from tspo_tpu.configs import PrecomputeConfig as JPrecomputeConfig
from tspo_tpu.configs import SelectorConfig as JSelectorConfig
from tspo_tpu.eval.datasets import VideoQuestionDataset as JDataset
from tspo_tpu.eval.precompute import FrameIndexPrecompute as JPrecompute
from tspo_tpu.models.tspo_model import build_random_scorer as jax_random_scorer
from tspo_tpu.video.cache import FeatureCache as JCache
from tspo_tpu_torch.cli import precompute as precompute_cli
from tspo_tpu_torch.configs import CLIPConfig, PrecomputeConfig, SelectorConfig
from tspo_tpu_torch.eval.datasets import VideoQuestionDataset, load_json
from tspo_tpu_torch.eval.precompute import FrameIndexPrecompute
from tspo_tpu_torch.interop import scorer_from_numpy
from tspo_tpu_torch.video.cache import FeatureCache

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(1)

CLIP_CFG = CLIPConfig.tiny()
SEL_CFG = SelectorConfig(dim=CLIP_CFG.text.projection_dim, num_heads=4)
JCLIP_CFG = JCLIPConfig.tiny()
JSEL_CFG = JSelectorConfig(dim=JCLIP_CFG.text.projection_dim, num_heads=4)


def _tokenize(problem: str):
    ids = np.full((1, 8), 3, np.int32)
    for i, ch in enumerate(problem[:6]):
        ids[0, i + 1] = 1 + ord(ch) % 500
    ids[0, -1] = CLIP_CFG.text.eos_token_id
    return ids, np.ones((1, 8), np.int32)


KW = dict(tokenize=_tokenize, batch_frames=32, frame_buckets=(64, 128, 256))


def _write_video(path, n_frames, seed, fps=5.0, wh=(64, 48)):
    """Blocky random colour fields, different in every frame."""
    rng = np.random.default_rng(seed)
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, wh)
    for _ in range(n_frames):
        low = rng.integers(0, 256, (wh[1] // 8, wh[0] // 8, 3), np.uint8)
        w.write(np.kron(low, np.ones((8, 8, 1), np.uint8)))
    w.release()


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """Three videos, four questions (two share v1), TSV + anno json."""
    root = tmp_path_factory.mktemp("torch_bench")
    (root / "videos").mkdir()
    # seeds picked so that no question's top-8 boundary is a near tie (the
    # 8th and 9th logits differ by >= 1e-2, three orders above the two
    # packages' fp32 logit difference); exact-index parity needs a margin
    for i, n in enumerate((150, 200, 260)):
        _write_video(root / "videos" / f"v{i}.mp4", n, seed=20 + i)
    rows = [("0", "v0.mp4", "q0", "What is shown first?"),
            ("1", "v1.mp4", "q1", "Where is the red block?"),
            ("2", "v1.mp4", "q2", "When does it change?"),
            ("3", "v2.mp4", "q3", "How many colours?")]
    with open(root / "TinyBench.tsv", "w") as f:
        f.write("index\ttask_name\tvideo_name\tquestion_id\tquestion\t"
                "answer_number\tcandidates\tanswer\n")
        for idx, vid, qid, q in rows:
            f.write(f"{idx}\tTinyBench\t{vid}\t{qid}\t{q}\t0\t['a', 'b']\tA\n")
    with open(root / "anno.json", "w") as f:
        json.dump([{"question_id": qid, "question": q, "videoID": vid}
                   for _, vid, qid, q in rows] +
                  [{"question_id": "unscored", "question": "x"}], f)
    return root


@pytest.fixture(scope="module")
def scorers():
    js = jax_random_scorer(seed=0, clip_cfg=JCLIP_CFG, selector_cfg=JSEL_CFG,
                           dtype=jnp.float32, **KW)
    ps = scorer_from_numpy(jax.tree_util.tree_map(np.asarray, js.clip_params),
                           jax.tree_util.tree_map(np.asarray, js.selector_params),
                           CLIP_CFG, SEL_CFG, dtype=torch.float32, device="cpu",
                           **KW)
    return js, ps


def _run_port(bench, ps, out, dataset="TinyBench", **cfg):
    ds = VideoQuestionDataset.from_tsv(dataset, str(bench / "TinyBench.tsv"),
                                       str(bench / "videos"))
    pre = FrameIndexPrecompute(ps, FeatureCache(str(out / "cache")),
                               PrecomputeConfig(sample_num=8, max_frames=512, **cfg),
                               work_dir=str(out / "work"), name="T")
    res = pre.run(ds)
    pre.emit_frame_idx_json(dataset, load_json(str(bench / "anno.json")),
                            str(out / f"{dataset}_frameIdx.json"))
    return pre, res


def _run_jax(bench, js, out, dataset="TinyBench"):
    ds = JDataset.from_tsv(dataset, str(bench / "TinyBench.tsv"),
                           str(bench / "videos"))
    pre = JPrecompute(js, JCache(str(out / "cache")),
                      JPrecomputeConfig(sample_num=8, max_frames=512),
                      work_dir=str(out / "work"), name="T")
    res = pre.run(ds)
    pre.emit_frame_idx_json(dataset, load_json(str(bench / "anno.json")),
                            str(out / f"{dataset}_frameIdx.json"))
    return res


@pytest.mark.parametrize("dataset", ["TinyBench", "VideoMME"])
def test_frame_idx_json_byte_identical(bench, scorers, tmp_path, dataset):
    """topk (TinyBench) and bin-max (VideoMME's method) selections."""
    js, ps = scorers
    jres = _run_jax(bench, js, tmp_path / "jax", dataset)
    _, pres = _run_port(bench, ps, tmp_path / "port", dataset)
    assert pres == jres and len(pres) == 4
    name = f"{dataset}_frameIdx.json"
    jbytes = (tmp_path / "jax" / name).read_bytes()
    assert (tmp_path / "port" / name).read_bytes() == jbytes
    docs = json.loads(jbytes)
    assert sum("frame_idx" in d for d in docs) == 4


def test_resume_skips_scoring(bench, scorers, tmp_path):
    js, ps = scorers
    pre, first = _run_port(bench, ps, tmp_path)
    # a second run loads supp.pkl and never touches the scorer
    calls = []
    orig = ps.encode_frame_features
    ps.encode_frame_features = lambda frames: calls.append(1) or orig(frames)
    try:
        again = pre.run(VideoQuestionDataset.from_tsv(
            "TinyBench", str(bench / "TinyBench.tsv"), str(bench / "videos")))
        assert again == first and calls == []
        # without supp.pkl the per-question feature blobs are reused: no encode
        os.remove(pre._supp_path("TinyBench"))
        third = pre.run(VideoQuestionDataset.from_tsv(
            "TinyBench", str(bench / "TinyBench.tsv"), str(bench / "videos")))
        assert third == first and calls == []
    finally:
        ps.encode_frame_features = orig


def test_video_sharing_encodes_each_video_once(bench, scorers, tmp_path):
    js, ps = scorers
    calls = []
    orig = ps.encode_frame_features
    ps.encode_frame_features = lambda frames: calls.append(len(frames)) or orig(frames)
    try:
        _, shared = _run_port(bench, ps, tmp_path / "shared")
        n_shared = len(calls)
        _, unshared = _run_port(bench, ps, tmp_path / "unshared",
                                share_video_features=False)
    finally:
        ps.encode_frame_features = orig
    assert n_shared == 3 and len(calls) == 3 + 4
    assert shared == unshared


def test_sharded_ranks_cover_all_questions(bench, scorers, tmp_path):
    js, ps = scorers
    ds = VideoQuestionDataset.from_tsv("TinyBench", str(bench / "TinyBench.tsv"),
                                       str(bench / "videos"))
    pre = FrameIndexPrecompute(ps, FeatureCache(str(tmp_path / "cache")),
                               PrecomputeConfig(sample_num=8, max_frames=512),
                               work_dir=str(tmp_path / "work"), name="T")
    parts = [pre.run(ds, shard=(r, 2)) for r in range(2)]
    assert sorted(k for p in parts for k in p) == ["q0", "q1", "q2", "q3"]
    assert os.path.exists(pre._supp_path("TinyBench", (1, 2)))
    assert pre.load_results("TinyBench") == {**parts[0], **parts[1]}


def test_cli_smoke_tiny_cpu(bench, tmp_path, capsys):
    out_json = tmp_path / "TinyBench_frameIdx.json"
    precompute_cli.main([
        "--data", "TinyBench", "--tsv", str(bench / "TinyBench.tsv"),
        "--video-root", str(bench / "videos"),
        "--work-dir", str(tmp_path / "work"),
        "--cache-root", str(tmp_path / "cache"),
        "--sample-num", "8", "--max-frames", "512", "--tiny", "--device", "cpu",
        "--anno-json", str(bench / "anno.json"), "--out-json", str(out_json),
    ])
    txt = capsys.readouterr().out
    assert "4 questions scored" in txt
    docs = json.loads(out_json.read_text())
    assert sum("frame_idx" in d for d in docs) == 4
    for d in docs:
        if "frame_idx" in d:
            assert len(d["frame_idx"]) == 8
            assert d["frame_idx"] == sorted(d["frame_idx"])


def test_load_scorer_from_torch_merged_dir(tmp_path):
    """A reference-format merged checkpoint directory (safetensors + CLIP
    tokenizer files, no config.json) loads into the port: geometry inferred
    from tensor shapes, weights equal to the checkpoint, tokenizer the
    checkpoint's own."""
    safetensors = pytest.importorskip("safetensors.torch")
    transformers = pytest.importorskip("transformers")
    from tspo_tpu.utils.mini_tokenizer import write_mini_clip_tokenizer
    from tspo_tpu_torch.cli.common import load_scorer, make_clip_tokenizer

    hf_cfg = transformers.CLIPConfig(
        text_config=dict(vocab_size=512, hidden_size=128, intermediate_size=512,
                         num_hidden_layers=2, num_attention_heads=2,
                         max_position_embeddings=16, projection_dim=96,
                         eos_token_id=511, hidden_act="quick_gelu"),
        vision_config=dict(hidden_size=128, intermediate_size=512,
                           num_hidden_layers=2, num_attention_heads=2,
                           patch_size=8, image_size=32, projection_dim=96,
                           hidden_act="quick_gelu"),
        projection_dim=96)
    torch.manual_seed(0)
    sd = dict(transformers.CLIPModel(hf_cfg).state_dict())
    gen = torch.Generator().manual_seed(1)
    for name in ("temporal.Self_q", "temporal.Self_k", "temporal.Self_v",
                 "temporal.ffn_o", "mlp.0", "mlp.2"):
        sd[f"selector.{name}.weight"] = torch.randn(96, 96, generator=gen) * 0.02
        sd[f"selector.{name}.bias"] = torch.zeros(96)
    ckpt = tmp_path / "TSPO-mini"
    ckpt.mkdir()
    safetensors.save_file({k: v.contiguous() for k, v in sd.items()},
                          str(ckpt / "model.safetensors"))
    write_mini_clip_tokenizer(str(ckpt))

    scorer = load_scorer(str(ckpt), device="cpu")
    assert scorer.clip_cfg.vision.width == 128 and scorer.clip_cfg.text.layers == 2
    got = scorer.clip.state_dict()
    for k, v in sd.items():
        if k.startswith("selector."):
            torch.testing.assert_close(scorer.selector.state_dict()[k[9:]], v)
        elif not k.endswith("position_ids"):
            torch.testing.assert_close(got[k].float(), v.bfloat16().float())
    ids, mask = scorer.tokenize("what is shown?")
    hf_tok = transformers.CLIPTokenizerFast.from_pretrained(str(ckpt))
    np.testing.assert_array_equal(ids, hf_tok("what is shown?",
                                              return_tensors="np")["input_ids"])
    frames = np.random.default_rng(0).integers(0, 256, (20, 32, 32, 3), np.uint8)
    idx, logits = scorer(frames, "what?", sample_num=8)
    assert len(idx) == 8 and np.all(np.isfinite(logits))

    bad = tmp_path / "ckpt-no-tok"
    bad.mkdir()
    (bad / "model.safetensors").write_bytes(b"")
    with pytest.raises(RuntimeError, match="no usable tokenizer"):
        make_clip_tokenizer(str(bad))
