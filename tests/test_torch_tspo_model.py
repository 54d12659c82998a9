"""Port parity: tspo_tpu_torch TSPOScorer end to end against the JAX scorer.

Both scorers hold the same weights (the JAX ``build_random_scorer`` converted
through ``tspo_tpu_torch.interop.scorer_from_numpy``) and get the same uint8
frames.  Tolerances: image features rtol = atol = 1e-4, selector logits
rtol 1e-5 / atol 1e-3; top-k, bin-max and AKS indices exactly equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tspo_tpu.configs import CLIPConfig as JCLIPConfig
from tspo_tpu.configs import SelectorConfig as JSelectorConfig
from tspo_tpu.models.tspo_model import TSPOScorer as JScorer
from tspo_tpu.models.tspo_model import build_random_scorer as jax_random_scorer
from tspo_tpu_torch.configs import CLIPConfig, SelectorConfig
from tspo_tpu_torch.interop import scorer_from_numpy
from tspo_tpu_torch.models.tspo_model import TSPOScorer, build_random_scorer

torch.set_num_threads(1)

CLIP_CFG = CLIPConfig.tiny()
SEL_CFG = SelectorConfig(dim=CLIP_CFG.text.projection_dim, num_heads=4)
JCLIP_CFG = JCLIPConfig.tiny()
JSEL_CFG = JSelectorConfig(dim=JCLIP_CFG.text.projection_dim, num_heads=4)
KW = dict(tokenize=None, batch_frames=32, frame_buckets=(64, 128, 256))


def _tokenize(problem: str):
    ids = np.full((1, 8), 3, np.int32)
    for i, ch in enumerate(problem[:6]):
        ids[0, i + 1] = 1 + ord(ch) % 500
    ids[0, -1] = CLIP_CFG.text.eos_token_id
    return ids, np.ones((1, 8), np.int32)


KW["tokenize"] = _tokenize


@pytest.fixture(scope="module")
def pair():
    js = jax_random_scorer(seed=0, clip_cfg=JCLIP_CFG, selector_cfg=JSEL_CFG,
                           dtype=jnp.float32, **KW)
    ps = scorer_from_numpy(jax.tree_util.tree_map(np.asarray, js.clip_params),
                           jax.tree_util.tree_map(np.asarray, js.selector_params),
                           CLIP_CFG, SEL_CFG, dtype=torch.float32, device="cpu",
                           **KW)
    return js, ps


def _frames(T, seed=0, hw=(48, 60)):
    return np.random.default_rng(seed).integers(0, 256, (T, *hw, 3), np.uint8)


def test_end_to_end_topk_matches_jax(pair):
    js, ps = pair
    frames = _frames(70)
    jf = np.asarray(js.encode_frame_features(frames))
    pf = ps.encode_frame_features(frames).numpy()
    np.testing.assert_allclose(pf, jf, rtol=1e-4, atol=1e-4)
    jidx, jlog = js(frames, "what happens?", sample_num=16)
    pidx, plog = ps(frames, "what happens?", sample_num=16)
    np.testing.assert_allclose(plog, jlog, rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(pidx, jidx)


@pytest.mark.parametrize("method,kw", [("bin-max", {}), ("aks", {}),
                                       ("aks", dict(t1=0.8, all_depth=5))])
def test_binmax_and_aks_match_jax(pair, method, kw):
    js, ps = pair
    frames = _frames(90, seed=1)
    jfeat = js.extract_features(frames, "q")
    pfeat = ps.extract_features(frames, "q")
    jidx, jlog = js.temporal_sampling(*jfeat, method=method, sample_num=16, **kw)
    pidx, plog = ps.temporal_sampling(*pfeat, method=method, sample_num=16, **kw)
    np.testing.assert_allclose(plog, jlog, rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(np.asarray(pidx), np.asarray(jidx))


@pytest.mark.parametrize("T", [31, 32, 33, 64, 70])
def test_chunk_boundary(pair, T):
    """Frame counts around the 32-frame chunk: chunked features equal one
    whole batch, and the fused path matches JAX's."""
    js, ps = pair
    frames = _frames(T, seed=T)
    chunked = ps.encode_frame_features(frames)
    whole = TSPOScorer(ps.clip, ps.selector, CLIP_CFG, SEL_CFG, _tokenize,
                       batch_frames=128, dtype=torch.float32, device="cpu")
    torch.testing.assert_close(chunked, whole.encode_frame_features(frames),
                               rtol=1e-4, atol=1e-4)
    jidx, jlog = js.score_video_fused(frames, "q", sample_num=8)
    pidx, plog = ps.score_video_fused(frames, "q", sample_num=8)
    np.testing.assert_allclose(plog, jlog, rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(pidx, jidx)


def test_fused_question_path_matches_jax(pair):
    js, ps = pair
    frames = _frames(100, seed=4)
    feats = ps.encode_frame_features(frames)
    jfeats = js.encode_frame_features(frames)
    for q in ("first question", "second one?"):
        jidx, jlog = js.score_features_fused(jfeats, q, sample_num=16)
        pidx, plog = ps.score_features_fused(feats, q, sample_num=16)
        np.testing.assert_allclose(plog, jlog, rtol=1e-5, atol=1e-3)
        np.testing.assert_array_equal(pidx, jidx)
        # same question, full fused path: identical selection
        vidx, _ = ps.score_video_fused(frames, q, sample_num=16)
        np.testing.assert_array_equal(vidx, pidx)
    bidx, _ = ps.score_features_fused(feats, "q", sample_num=16, method="bin-max")
    jb, _ = js.score_features_fused(jfeats, "q", sample_num=16, method="bin-max")
    np.testing.assert_array_equal(bidx, np.asarray(jb))


def test_small_video_and_large_sample_num(pair):
    js, ps = pair
    frames = _frames(10, seed=5)
    idx, logits = ps(frames, "q", sample_num=16)
    np.testing.assert_array_equal(idx, np.arange(10))
    pidx, _ = ps.score_video_fused(frames, "q", sample_num=100)   # k > bucket
    jidx, _ = js.score_video_fused(frames, "q", sample_num=100)
    np.testing.assert_array_equal(pidx, jidx)
    assert len(pidx) == 10


def test_save_port_load_jax_selects_same(tmp_path, pair):
    js, ps = pair
    ps.save(str(tmp_path))
    loaded = JScorer.load(str(tmp_path), clip_cfg=JCLIP_CFG,
                          selector_cfg=JSelectorConfig(), dtype=jnp.float32, **KW)
    assert loaded.selector_cfg.num_heads == SEL_CFG.num_heads
    frames = _frames(80, seed=6)
    jidx, _ = loaded(frames, "q", sample_num=16)
    pidx, _ = ps(frames, "q", sample_num=16)
    np.testing.assert_array_equal(pidx, jidx)


def test_save_jax_load_port_selects_same(tmp_path, pair):
    js, ps = pair
    js.save(str(tmp_path))
    loaded = TSPOScorer.load(str(tmp_path), clip_cfg=CLIP_CFG,
                             selector_cfg=SelectorConfig(), dtype=torch.float32,
                             device="cpu", **KW)
    assert loaded.selector_cfg == SEL_CFG     # config.json overrides geometry
    assert all(p.dtype == torch.float32 for p in loaded.selector.parameters())
    frames = _frames(80, seed=7)
    jidx, _ = js(frames, "q", sample_num=16)
    pidx, _ = loaded(frames, "q", sample_num=16)
    np.testing.assert_array_equal(pidx, jidx)
    # and the port's own round trip keeps every parameter
    loaded.save(str(tmp_path / "again"))
    a = np.load(tmp_path / "tspo_params.npz")
    b = np.load(tmp_path / "again" / "tspo_params.npz")
    assert sorted(a.files) == sorted(b.files)
    for key in a.files:
        np.testing.assert_array_equal(a[key], b[key])


def test_bf16_scorer_keeps_selector_fp32():
    s = build_random_scorer(torch.Generator().manual_seed(0), clip_cfg=CLIP_CFG,
                            selector_cfg=SEL_CFG, dtype=torch.bfloat16,
                            device="cpu", **KW)
    assert all(p.dtype == torch.bfloat16 for p in s.clip.parameters())
    assert all(p.dtype == torch.float32 for p in s.selector.parameters())
    idx, logits = s.score_video_fused(_frames(40, seed=8), "q", sample_num=8)
    assert logits.dtype == np.float32 and np.all(np.isfinite(logits))
    assert len(idx) == 8 and list(idx) == sorted(idx)


def test_from_torch_merged(pair):
    """Reference merged layout (HF CLIP state dict + selector.* keys)."""
    transformers = pytest.importorskip("transformers")
    t, v = CLIP_CFG.text, CLIP_CFG.vision
    hf_cfg = transformers.CLIPConfig(
        text_config=dict(vocab_size=t.vocab_size, hidden_size=t.width,
                         intermediate_size=4 * t.width, num_hidden_layers=t.layers,
                         num_attention_heads=t.heads,
                         max_position_embeddings=t.max_positions,
                         projection_dim=t.projection_dim,
                         eos_token_id=t.eos_token_id, hidden_act="quick_gelu"),
        vision_config=dict(hidden_size=v.width, intermediate_size=4 * v.width,
                           num_hidden_layers=v.layers, num_attention_heads=v.heads,
                           patch_size=v.patch_size, image_size=v.image_size,
                           projection_dim=v.projection_dim, hidden_act="quick_gelu"),
        projection_dim=t.projection_dim)
    torch.manual_seed(1)
    sd = dict(transformers.CLIPModel(hf_cfg).state_dict())
    gen = torch.Generator().manual_seed(2)
    for name in ("temporal.Self_q", "temporal.Self_k", "temporal.Self_v",
                 "temporal.ffn_o", "mlp.0", "mlp.2"):
        sd[f"selector.{name}.weight"] = torch.randn(SEL_CFG.dim, SEL_CFG.dim,
                                                    generator=gen) * 0.02
        sd[f"selector.{name}.bias"] = torch.zeros(SEL_CFG.dim)
    ps = TSPOScorer.from_torch_merged(sd, clip_cfg=CLIP_CFG, selector_cfg=SEL_CFG,
                                      dtype=torch.float32, device="cpu", **KW)
    js = JScorer.from_torch_merged(sd, clip_cfg=JCLIP_CFG, selector_cfg=JSEL_CFG,
                                   dtype=jnp.float32, **KW)
    frames = _frames(40, seed=9)
    pidx, plog = ps(frames, "q", sample_num=8)
    jidx, jlog = js(frames, "q", sample_num=8)
    np.testing.assert_allclose(plog, jlog, rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(pidx, jidx)
