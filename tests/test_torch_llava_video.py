"""Port parity: tspo_tpu_torch.models.llava_video against
tspo_tpu.models.llava_video.

One llava_qwen-layout state dict made with numpy from a seed (a tiny Qwen2
and a tiny SigLIP at image_size 64, so 8x8 patches pool to 4x4 and a frame
gives 4 * (4 + 1) = 20 tokens; biases non-zero) loads into both packages'
``from_torch_checkpoint`` in fp32.  Tolerances: pooling, newline and splice
exact up to fp32 rounding (1e-6); video tokens rtol = atol = 2e-4 (the
SigLIP tower tolerance); generated strings exactly equal, on a prompt of 26
frames (>= 512 tokens, so both packages prefill through their flash path)."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from test_torch_qwen2 import hf_qwen2_state_dict
from test_torch_siglip import hf_siglip_state_dict
from tspo_tpu.models import conversation as jconv
from tspo_tpu.models import llava_video as jl
from tspo_tpu.models.qwen2 import Qwen2Config as JQwen2Config
from tspo_tpu.models.siglip import SigLIPConfig as JSigLIPConfig
from tspo_tpu_torch import interop
from tspo_tpu_torch.models import conversation as tconv
from tspo_tpu_torch.models import llava_video as tl
from tspo_tpu_torch.models.qwen2 import Qwen2Config
from tspo_tpu_torch.models.siglip import SigLIPConfig

torch.set_num_threads(1)

CFG = tl.LLaVAVideoConfig(
    lm=Qwen2Config.tiny(),
    vision=dataclasses.replace(SigLIPConfig.tiny(), image_size=64),
    max_context=1024)
JCFG = jl.LLaVAVideoConfig(
    lm=JQwen2Config(**dataclasses.asdict(CFG.lm)),
    vision=JSigLIPConfig(**dataclasses.asdict(CFG.vision)),
    max_context=CFG.max_context)


def _encode(s):
    return [ord(c) % CFG.lm.vocab_size for c in s]


def _decode(toks):
    return " ".join(str(t) for t in toks)


def llava_state_dict(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed + 100)
    W, D = CFG.vision.width, CFG.lm.hidden_size
    sd = hf_qwen2_state_dict(CFG.lm, seed)
    for k, v in hf_siglip_state_dict(CFG.vision, seed + 1).items():
        sd["model.vision_tower.vision_tower." + k] = v
    sd["model.mm_projector.0.weight"] = (rng.normal(size=(D, W)) * 0.1).astype(np.float32)
    sd["model.mm_projector.0.bias"] = (rng.normal(size=D) * 0.1).astype(np.float32)
    sd["model.mm_projector.2.weight"] = (rng.normal(size=(D, D)) * 0.1).astype(np.float32)
    sd["model.mm_projector.2.bias"] = (rng.normal(size=D) * 0.1).astype(np.float32)
    sd["model.image_newline"] = (rng.normal(size=D) * 0.5).astype(np.float32)
    sd["multiModal_align.mlp.0.weight"] = np.zeros((2, 2), np.float32)  # ignored
    return sd


@pytest.fixture(scope="module")
def models():
    sd = llava_state_dict()
    jax_model = jl.LLaVAVideoModel.from_torch_checkpoint(
        sd, JCFG, dtype=jnp.float32, encode=_encode, decode=_decode,
        max_new_tokens=6)
    port = tl.LLaVAVideoModel.from_torch_checkpoint(
        sd, CFG, dtype=torch.float32, device="cpu", encode=_encode,
        decode=_decode, batch_frames=4, max_new_tokens=6)
    return jax_model, port


def _frames(n, seed, h=48, w=40):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8)


def test_pool_and_newline_tokens_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 81, 5)).astype(np.float32)     # odd grid 9 -> 4
    np.testing.assert_allclose(
        tl.pool_2d_average(torch.from_numpy(x), 9, 2).numpy(),
        np.asarray(jl.pool_2d_average(jnp.asarray(x), 9, 2)), rtol=1e-6, atol=1e-6)
    f = rng.normal(size=(3, 16, 7)).astype(np.float32)
    nl = rng.normal(size=7).astype(np.float32)
    np.testing.assert_array_equal(
        tl.add_token_per_grid(torch.from_numpy(f), torch.from_numpy(nl), 4).numpy(),
        np.asarray(jl.add_token_per_grid(jnp.asarray(f), jnp.asarray(nl), 4)))
    np.testing.assert_array_equal(
        tl.add_token_per_frame(torch.from_numpy(f), torch.from_numpy(nl)).numpy(),
        np.asarray(jl.add_token_per_frame(jnp.asarray(f), jnp.asarray(nl))))


def test_prompt_and_tokenize_match_jax(models):
    jax_model, port = models
    q = "What happens <audio> next?"
    assert port._prompt(q) == jax_model._prompt(q)
    assert tl.build_qwen15_prompt(q) == jl.build_qwen15_prompt(q)
    for bos in (None, 7):
        def enc(s):
            return ([7] if bos else []) + _encode(s)
        p = "ab<image>\ncd<audio>e"
        assert tl.tokenize_with_image(p, enc, bos) == jl.tokenize_with_image(p, enc, bos)


@pytest.mark.parametrize("template", sorted(jconv.CONV_TEMPLATES))
def test_conversation_templates_match_jax(template):
    for q, a in (("What is shown?", None), ("Pick one.\nA. x\nB. y", "A")):
        assert tconv.build_prompt(q, template, a) == jconv.build_prompt(q, template, a)
        assert tconv.build_prompt(q, template, a, add_image_token=False) == \
            jconv.build_prompt(q, template, a, add_image_token=False)


def test_splice_matches_jax(models):
    jax_model, port = models
    ids = tl.tokenize_with_image(port._prompt("Why?"), _encode)
    vid = np.random.default_rng(2).normal(size=(40, CFG.lm.hidden_size)).astype(np.float32)
    want = np.asarray(jax_model.splice_embeddings(ids, jnp.asarray(vid)))
    got = port.splice_embeddings(ids, torch.from_numpy(vid)).numpy()
    assert got.shape == (1, len(ids) - 1 + 40, CFG.lm.hidden_size)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        port.splice_embeddings(_encode("no image"), torch.from_numpy(vid))


def test_encode_video_matches_jax_and_chunking(models):
    jax_model, port = models
    frames = _frames(6, seed=3)
    got = port.encode_video(frames)
    assert got.shape == (6 * CFG.tokens_per_frame, CFG.lm.hidden_size)
    assert CFG.tokens_per_frame == 20
    want = np.asarray(jax_model.encode_video(frames))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    one_chunk = dataclasses.replace(port, batch_frames=16)
    torch.testing.assert_close(one_chunk.encode_video(frames), got,
                               rtol=1e-5, atol=1e-5)


def test_generate_matches_jax_through_flash(models):
    jax_model, port = models
    frames = _frames(26, seed=4)
    q = "Describe the video."
    embeds, _, _ = port._prepare_generate(frames, q, None, None)
    assert embeds.shape[1] >= 512                 # the flash path at prefill
    want = jax_model.generate(frames, q, max_new_tokens=6)
    got = port.generate(frames, q, max_new_tokens=6)
    assert got == want and len(got.split()) >= 1


def test_text_only_generate_matches_jax(models):
    jax_model, port = models
    assert port.generate(None, "Hi?", max_new_tokens=5) == \
        jax_model.generate(None, "Hi?", max_new_tokens=5)


def test_jax_tree_crosses_through_interop():
    """The JAX package's own random_init params (numpy leaves) become a port
    model through llava_state_dict_from_tree; both answer alike."""
    import jax
    jcfg = dataclasses.replace(JCFG, max_context=512)
    jm = jl.LLaVAVideoModel.random_init(0, jcfg, dtype=jnp.float32,
                                        encode=_encode, decode=_decode)
    tree = jax.tree_util.tree_map(np.asarray, jm.params)
    port = interop.llava_from_numpy(tree, dataclasses.replace(CFG, max_context=512),
                                    device="cpu", encode=_encode, decode=_decode)
    frames = _frames(2, seed=5)
    np.testing.assert_allclose(port.encode_video(frames).numpy(),
                               np.asarray(jm.encode_video(frames)),
                               rtol=2e-4, atol=2e-4)
    assert port.generate(frames, "Why?", max_new_tokens=4) == \
        jm.generate(frames, "Why?", max_new_tokens=4)


def test_queued_features_raise_not_implemented(models):
    """The audio track is still queued (ROADMAP Queue 1 item 5), on generate
    and on its stream; sampling and speculative decode run (their parity is
    test_torch_llava_decode.py's)."""
    _, port = models
    frames = _frames(1, seed=6)
    with pytest.raises(NotImplementedError, match="ROADMAP.md \\(Queue 1 item 5\\)"):
        port.generate(frames, "q", audio=np.zeros(16000, np.float32))
    with pytest.raises(NotImplementedError, match="ROADMAP.md \\(Queue 1 item 5\\)"):
        next(port.generate_stream(frames, "q", audio=np.zeros(16000, np.float32)))
    assert port.generate(frames, "q", temperature=0.7, seed=1, max_new_tokens=2)
    assert dataclasses.replace(port, speculative=True).generate(frames, "q") == \
        port.generate(frames, "q")


def test_config_from_hf_matches_jax():
    hf = {"model_type": "llava_qwen", "vocab_size": 1000, "hidden_size": 64,
          "intermediate_size": 128, "num_hidden_layers": 2,
          "num_attention_heads": 4, "num_key_value_heads": 2,
          "mm_vision_config": {"width": 32, "layers": 1, "heads": 2,
                               "intermediate": 64, "patch_size": 8,
                               "image_size": 32, "layer_norm_eps": 1e-6}}
    got = tl.LLaVAVideoConfig.from_hf_config(hf)
    want = jl.LLaVAVideoConfig.from_hf_config(hf)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    llama = {"model_type": "llava_llama", "vocab_size": 1000, "hidden_size": 64,
             "intermediate_size": 128, "num_hidden_layers": 2,
             "num_attention_heads": 4, "rope_scaling": {"type": "linear",
                                                         "factor": 2.0}}
    assert dataclasses.asdict(tl.LLaVAVideoConfig.from_hf_config(llama)) == \
        dataclasses.asdict(jl.LLaVAVideoConfig.from_hf_config(llama))


def test_random_init_is_seeded_and_finite():
    cfg = tl.LLaVAVideoConfig.tiny()
    a = tl.LLaVAVideoModel.random_init(torch.Generator().manual_seed(3), cfg,
                                       dtype=torch.float32, device="cpu")
    b = tl.LLaVAVideoModel.random_init(torch.Generator().manual_seed(3), cfg,
                                       dtype=torch.float32, device="cpu")
    for (na, pa), (_, pb) in zip(a.net.named_parameters(), b.net.named_parameters()):
        assert torch.equal(pa, pb), na
        assert torch.isfinite(pa).all()
    assert a.net.lm.model.layers[0].input_layernorm.weight.eq(1).all()


@pytest.mark.parametrize("name,tower,rope,frames", [
    ("llava-vicuna-7b", "openai/clip-vit-large-patch14-336", None, 64),
    ("LLaVA-Yi-34B", "openai/clip-vit-large-patch14-224", None, 64),
    ("llava-v1.5-vicuna-13b", "google/siglip-so400m-patch14-384", None, 32),
    ("llava-vicuna-7b-long", "openai/clip-vit-large-patch14-336",
     {"type": "linear", "factor": 4.0}, 64),
    ("LLaVA-Video-7B-Qwen2", "google/siglip-so400m-patch14-384", None, 64),
])
def test_load_backbone_picks_the_references_template_and_rope(
        tmp_path, monkeypatch, name, tower, rope, frames):
    """``load_backbone("llava_video", path)``: a path naming vicuna or yi
    gets template vicuna_v1 and, without rope scaling in its config, the
    linear factor covering the frames' tokens (ceil((64 * 12**2 + 1000) /
    4096) = 3 for a non-224 tower), as in the JAX package; other paths get
    qwen_1_5 and their config's factor.  The tokenizer and the weights are
    stubbed on both sides."""
    import types
    from pathlib import Path

    import transformers

    from tspo_tpu.cli import common as jcommon
    from tspo_tpu_torch.cli import common as tcommon
    # a relative path: only the checkpoint's own name is matched, wherever
    # the test's temporary directory lies
    monkeypatch.chdir(tmp_path)
    path = Path(name)
    path.mkdir()
    family = "qwen2" if "Qwen" in name else "llama"
    hf = {"model_type": f"llava_{family}", "vocab_size": 1000, "hidden_size": 64,
          "intermediate_size": 128, "num_hidden_layers": 2,
          "num_attention_heads": 4, "mm_vision_tower": tower}
    if rope:
        hf["rope_scaling"] = rope
    (path / "config.json").write_text(__import__("json").dumps(hf))
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        lambda *a, **k: types.SimpleNamespace(bos_token_id=1))
    monkeypatch.setattr(jcommon, "_load_llava_dir",
                        lambda p, cfg, **kw: types.SimpleNamespace(cfg=cfg))
    monkeypatch.setattr(tcommon, "_load_llava_dir",
                        lambda p, cfg, **kw: types.SimpleNamespace(cfg=cfg))
    want = jcommon.load_backbone("llava_video", str(path), max_frames_num=frames)
    got = tcommon.load_backbone("llava_video", str(path), max_frames_num=frames,
                                device="cpu")
    assert got.conv_template == want.conv_template
    assert got.cfg.lm.rope_scaling_factor == want.cfg.lm.rope_scaling_factor
    expect = {"llava-vicuna-7b": ("vicuna_v1", 3.0), "LLaVA-Yi-34B": ("vicuna_v1", 2.0),
              "llava-v1.5-vicuna-13b": ("vicuna_v1", 2.0),
              "llava-vicuna-7b-long": ("vicuna_v1", 4.0),
              "LLaVA-Video-7B-Qwen2": ("qwen_1_5", 1.0)}[name]
    assert (got.conv_template, got.cfg.lm.rope_scaling_factor) == expect
    assert tconv.vicuna_rope_overrides(frames, 2, "224" in tower) == \
        jconv.vicuna_rope_overrides(frames, 2, "224" in tower)
