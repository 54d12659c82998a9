"""Port parity: tspo_tpu_torch.models.selector against tspo_tpu.models.selector.

Same weights (the JAX init converted to the reference MultiModal_Align state
dict), same numpy inputs, fp32.  Tolerances: logits rtol 1e-5, atol 1e-3
(the logits are divided by score_tau = 0.025, which scales fp32 rounding of
the cosines by 40); banded against dense 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tspo_tpu.configs import SelectorConfig as JSelectorConfig
from tspo_tpu.models import selector as jsel
from tspo_tpu_torch.configs import SelectorConfig
from tspo_tpu_torch.interop import (selector_state_dict_from_tree,
                                    selector_tree_from_state_dict)
from tspo_tpu_torch.models import selector as tsel

torch.set_num_threads(1)

DIM, HEADS = 48, 4
CFG = SelectorConfig(dim=DIM, num_heads=HEADS)
JCFG = JSelectorConfig(dim=DIM, num_heads=HEADS)


@pytest.fixture(scope="module")
def jax_params():
    return jsel.init_selector_params(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def port_sel(jax_params):
    sel = tsel.MultiModalAlign(CFG)
    tree = jax.tree_util.tree_map(np.asarray, jax_params)
    return tsel.load_reference_state_dict(sel, selector_state_dict_from_tree(tree)).eval()


def _inputs(T, M=1, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(T, DIM)).astype(np.float32),
            rng.normal(size=(M, DIM)).astype(np.float32),
            rng.normal(scale=0.1, size=T).astype(np.float32))


def _port(sel, frame, text, cs, **kw):
    with torch.no_grad():
        logits, ctx = tsel.score_frames(sel, torch.from_numpy(frame),
                                        torch.from_numpy(text),
                                        torch.from_numpy(cs), **kw)
    return logits.numpy(), ctx.numpy()


@pytest.mark.parametrize("T,w", [(40, 12), (128, 12), (100, 8), (13, 12), (64, 5)])
def test_banded_and_dense_match_jax(jax_params, port_sel, T, w):
    frame, text, cs = _inputs(T, seed=T + w)
    want, _ = jsel.score_frames(jax_params, jnp.asarray(frame), jnp.asarray(text),
                                jnp.asarray(cs), cfg=JCFG, window_size=w)
    want = np.asarray(want)
    band, band_ctx = _port(port_sel, frame, text, cs, window_size=w)
    dense, dense_ctx = _port(port_sel, frame, text, cs, window_size=w,
                             dense_mask=True)
    np.testing.assert_allclose(band, dense, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(band_ctx, dense_ctx, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(band, want, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(dense, want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("T,bucket", [(50, 64), (100, 128), (200, 512)])
def test_padded_bucket_matches_jax(jax_params, port_sel, T, bucket):
    """A valid prefix in a zero-padded bucket, with tau and M=2 text rows;
    padded query rows stay finite."""
    frame, text, cs = _inputs(T, M=2, seed=bucket)
    fpad = np.zeros((bucket, DIM), np.float32)
    fpad[:T] = frame
    cpad = np.zeros(bucket, np.float32)
    cpad[:T] = cs
    valid = np.arange(bucket) < T
    want, _ = jsel.score_frames(jax_params, jnp.asarray(fpad), jnp.asarray(text),
                                jnp.asarray(cpad), cfg=JCFG, valid=jnp.asarray(valid),
                                score_tau=0.05)
    got, _ = _port(port_sel, fpad, text, cpad, valid=torch.from_numpy(valid),
                   score_tau=0.05)
    np.testing.assert_allclose(got[:T], np.asarray(want)[:T], rtol=1e-5, atol=1e-3)
    assert np.all(np.isfinite(got))
    # prefix of the bucket equals the unpadded run
    ref, _ = _port(port_sel, frame, text, cs, score_tau=0.05)
    np.testing.assert_allclose(got[:T], ref, rtol=1e-4, atol=1e-4)


def test_state_dict_round_trip_reference_keys(jax_params, port_sel):
    sd = port_sel.state_dict()
    assert set(sd) == {f"{k}.{s}" for k in
                       ["temporal.Self_q", "temporal.Self_k", "temporal.Self_v",
                        "temporal.ffn_o", "mlp.0", "mlp.2"]
                       for s in ["weight", "bias"]}
    # reference state dict -> port -> JAX tree equals the JAX package's own
    # conversion of the same state dict
    ref_sd = jsel.selector_params_to_torch(jax_params)
    for k, v in ref_sd.items():
        np.testing.assert_array_equal(sd[k].numpy(), v)
    back = selector_tree_from_state_dict(sd)
    want = jsel.selector_params_from_torch(ref_sd)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                jax.tree_util.tree_leaves_with_path(want)):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # a prefixed reference checkpoint loads too
    fresh = tsel.MultiModalAlign(CFG)
    tsel.load_reference_state_dict(
        fresh, {f"multiModal_align.{k}": torch.from_numpy(v) for k, v in ref_sd.items()})
    for k, v in fresh.state_dict().items():
        torch.testing.assert_close(v, sd[k])


def test_init_selector_is_seeded_fp32():
    a = tsel.init_selector(CFG, torch.Generator().manual_seed(3))
    b = tsel.init_selector(CFG, torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and va.dtype == torch.float32
        torch.testing.assert_close(va, vb, atol=0, rtol=0)
    bound = 1.0 / np.sqrt(DIM)
    assert all(p.abs().max().item() <= bound for p in a.parameters())
