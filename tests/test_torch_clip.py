"""Port parity: tspo_tpu_torch.models.clip against tspo_tpu.models.clip.

Same weights on both sides (the JAX package's init, converted to numpy and
loaded through tspo_tpu_torch.interop), same numpy inputs, fp32 on the CPU.
Tolerances: preprocessing atol 1e-4; image and text features rtol = atol =
1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tspo_tpu.configs import CLIPConfig as JCLIPConfig
from tspo_tpu.models import clip as jclip
from tspo_tpu_torch.configs import CLIPConfig
from tspo_tpu_torch.interop import (clip_tree_from_hf_state_dict,
                                    hf_state_dict_from_clip_tree)
from tspo_tpu_torch.models import clip as tclip

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CFG = CLIPConfig.tiny()
JCFG = JCLIPConfig.tiny()


@pytest.fixture(scope="module")
def jax_params():
    return jclip.init_clip_params(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def port_model(jax_params):
    tree = jax.tree_util.tree_map(np.asarray, jax_params)
    model = tclip.empty_clip_model(CFG)
    return tclip.load_hf_state_dict(model, hf_state_dict_from_clip_tree(tree, CFG))


@pytest.mark.parametrize("H,W,size", [(48, 64, 32), (64, 40, 32),
                                      (120, 160, 224), (90, 60, 224),
                                      (32, 50, 32)])
def test_preprocess_parity_non_square(H, W, size):
    """Landscape and portrait frames, down- (antialiased) and up-sampling,
    and an axis already at the target size."""
    frames = np.random.default_rng(H * W).integers(0, 256, (2, H, W, 3), np.uint8)
    want = np.asarray(jclip.preprocess_frames(jnp.asarray(frames), size,
                                              jnp.float32))
    got = tclip.preprocess_frames(torch.from_numpy(frames), size,
                                  torch.float32).numpy()
    assert got.shape == want.shape == (2, 3, size, size)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_normalize_and_host_resize_parity():
    rng = np.random.default_rng(5)
    sq = rng.integers(0, 256, (3, 32, 32, 3), np.uint8)
    np.testing.assert_allclose(
        tclip.normalize_frames(torch.from_numpy(sq), 32, torch.float32).numpy(),
        np.asarray(jclip.normalize_frames(jnp.asarray(sq), 32, jnp.float32)),
        atol=1e-6)
    pytest.importorskip("cv2")
    frames = rng.integers(0, 256, (2, 48, 70, 3), np.uint8)
    np.testing.assert_array_equal(tclip.host_resize_crop(frames, 32),
                                  jclip.host_resize_crop(frames, 32))


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Route the JAX tower's attention through its Pallas kernel in
    interpret mode, as the JAX suite runs the kernel on the CPU."""
    from tspo_tpu.ops import vit_attention as jva
    orig = jva.vit_attention

    def interpret(q, k, v, heads, impl="auto", interpret=False):
        return orig(q, k, v, heads, impl="pallas", interpret=True)

    monkeypatch.setattr(jva, "vit_attention", interpret)


@pytest.mark.parametrize("cls_fast", [True, False])
def test_image_features_parity(jax_params, port_model, pallas_interpret,
                               cls_fast):
    rng = np.random.default_rng(1)
    pixels = rng.normal(size=(5, 3, 32, 32)).astype(np.float32)
    want = np.asarray(jclip.encode_images(jax_params, jnp.asarray(pixels),
                                          JCFG.vision, cls_fast=cls_fast))
    with torch.no_grad():
        got = port_model.encode_images(torch.from_numpy(pixels),
                                       cls_fast=cls_fast).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_cls_fast_matches_full_encoder(port_model):
    """The class-token-only last layer is an algebraic identity of the full
    encoder (only the pooled class token is consumed)."""
    pixels = torch.from_numpy(np.random.default_rng(2).normal(
        size=(4, 3, 32, 32)).astype(np.float32))
    with torch.no_grad():
        fast = port_model.encode_images(pixels, cls_fast=True)
        full = port_model.encode_images(pixels, cls_fast=False)
    torch.testing.assert_close(fast, full, rtol=1e-4, atol=1e-4)


def _ids(B, L, eos, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, eos - 1, (B, L)).astype(np.int32)
    ends = rng.integers(3, L, B)
    mask = np.zeros((B, L), np.int32)
    for b, e in enumerate(ends):
        ids[b, e] = eos
        mask[b, :e + 1] = 1
    return ids, mask


@pytest.mark.parametrize("with_mask", [False, True])
def test_text_features_parity(jax_params, port_model, with_mask):
    ids, mask = _ids(4, CFG.text.max_positions, CFG.text.eos_token_id, seed=3)
    m = mask if with_mask else None
    want = np.asarray(jclip.encode_text(jax_params, jnp.asarray(ids),
                                        None if m is None else jnp.asarray(m),
                                        JCFG.text))
    with torch.no_grad():
        got = port_model.encode_text(
            torch.from_numpy(ids.astype(np.int64)),
            None if m is None else torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_cosine_scores_parity():
    rng = np.random.default_rng(4)
    img = rng.normal(size=(10, 48)).astype(np.float32)
    img[3] = 0.0                               # exercises the eps clamp
    txt = rng.normal(size=(1, 48)).astype(np.float32)
    want = np.asarray(jclip.cosine_scores(jnp.asarray(img), jnp.asarray(txt)))
    got = tclip.cosine_scores(torch.from_numpy(img), torch.from_numpy(txt[0])).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def hf_clip():
    transformers = pytest.importorskip("transformers")
    t, v = CFG.text, CFG.vision
    hf_cfg = transformers.CLIPConfig(
        text_config=dict(
            vocab_size=t.vocab_size, hidden_size=t.width,
            intermediate_size=4 * t.width, num_hidden_layers=t.layers,
            num_attention_heads=t.heads, max_position_embeddings=t.max_positions,
            projection_dim=t.projection_dim, eos_token_id=t.eos_token_id,
            hidden_act="quick_gelu"),
        vision_config=dict(
            hidden_size=v.width, intermediate_size=4 * v.width,
            num_hidden_layers=v.layers, num_attention_heads=v.heads,
            patch_size=v.patch_size, image_size=v.image_size,
            projection_dim=v.projection_dim, hidden_act="quick_gelu"),
        projection_dim=t.projection_dim)
    torch.manual_seed(0)
    return transformers.CLIPModel(hf_cfg).eval()


def test_hf_state_dict_load_matches_clip_params_from_torch(hf_clip):
    """An HF CLIPModel state dict loads into the port with load_state_dict;
    the port's tree view of it equals the JAX package's
    clip_params_from_torch, and both towers agree with each other and HF."""
    jparams = jclip.clip_params_from_torch(hf_clip, JCFG)
    port = tclip.load_hf_state_dict(tclip.empty_clip_model(CFG),
                                    hf_clip.state_dict())
    tree = clip_tree_from_hf_state_dict(port.state_dict(), CFG)
    jl = jax.tree_util.tree_leaves_with_path(jparams)
    tl = dict(jax.tree_util.tree_leaves_with_path(tree))
    assert len(jl) == len(tl)
    for path, leaf in jl:
        np.testing.assert_array_equal(np.asarray(tl[path]), np.asarray(leaf))

    rng = np.random.default_rng(6)
    pixels = rng.normal(size=(3, 3, 32, 32)).astype(np.float32)
    ids, _ = _ids(2, CFG.text.max_positions, CFG.text.eos_token_id, seed=7)
    with torch.no_grad():
        got_img = port.encode_images(torch.from_numpy(pixels)).numpy()
        got_txt = port.encode_text(torch.from_numpy(ids.astype(np.int64))).numpy()
        hf_img = hf_clip.get_image_features(
            pixel_values=torch.from_numpy(pixels)).numpy()
    want_img = np.asarray(jclip.encode_images(jparams, jnp.asarray(pixels),
                                              JCFG.vision))
    want_txt = np.asarray(jclip.encode_text(jparams, jnp.asarray(ids),
                                            cfg=JCFG.text))
    np.testing.assert_allclose(got_img, want_img, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_txt, want_txt, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_img, hf_img, rtol=2e-4, atol=2e-4)


def test_config_inference_parity(hf_clip):
    sd = {k: v.numpy() for k, v in hf_clip.state_dict().items()}
    got = tclip.clip_config_from_state_dict(sd)
    want = jclip.clip_config_from_state_dict(sd)
    assert got.text.__dict__ == want.text.__dict__
    assert got.vision.__dict__ == want.vision.__dict__
