"""Port parity: tspo_tpu_torch.ops (positional encoding, masks, bucketing,
selection) against tspo_tpu.ops on the same numpy inputs.

Tolerances: float outputs 1e-6 (fp32, same formula); indices exactly equal."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tspo_tpu.ops import masking as jmask
from tspo_tpu.ops import positional as jpos
from tspo_tpu.ops import selection as jsel
from tspo_tpu_torch.ops import masking as tmask
from tspo_tpu_torch.ops import positional as tpos
from tspo_tpu_torch.ops import selection as tsel

torch.set_num_threads(1)

BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096, 8192)


@pytest.mark.parametrize("T,C,true_len", [(64, 48, 64), (128, 768, 97),
                                          (33, 7, 20), (256, 64, 1)])
def test_positional_encoding_parity(T, C, true_len):
    want = np.asarray(jpos.sinusoidal_positional_encoding(T, C, true_len))
    got = tpos.sinusoidal_positional_encoding(T, C, true_len).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    # traced/tensor true_len path
    got_t = tpos.sinusoidal_positional_encoding(T, C, torch.tensor(true_len)).numpy()
    np.testing.assert_allclose(got_t, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("T,w", [(16, 4), (20, 12), (64, 7), (9, 1)])
def test_window_mask_and_offsets_parity(T, w):
    rng = np.random.default_rng(T * 100 + w)
    valid = rng.random(T) < 0.7
    np.testing.assert_array_equal(tmask.window_mask(T, w).numpy(),
                                  np.asarray(jmask.window_mask(T, w)))
    np.testing.assert_array_equal(
        tmask.window_mask(T, w, torch.as_tensor(valid)).numpy(),
        np.asarray(jmask.window_mask(T, w, jnp.asarray(valid))))
    np.testing.assert_array_equal(tmask.band_offsets(w), jmask.band_offsets(w))


def test_bucketing_parity():
    for n in (1, 63, 64, 65, 300, 8192, 8193, 20000):
        assert tmask.bucket_for(n) == jmask.bucket_for(n)
        assert tmask.bucket_for(n, (32, 96)) == jmask.bucket_for(n, (32, 96))
    x = np.random.default_rng(0).normal(size=(37, 5)).astype(np.float32)
    for axis, bucket in ((0, 64), (1, 8)):
        got, gv = tmask.pad_to_bucket(x, bucket, axis=axis)
        want, wv = jmask.pad_to_bucket(x, bucket, axis=axis)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(gv, wv)
    with pytest.raises(ValueError):
        tmask.pad_to_bucket(x, 16)


@pytest.mark.parametrize("bucket", BUCKETS)
def test_topk_parity_every_bucket_padded_valid(bucket):
    rng = np.random.default_rng(bucket)
    n = int(rng.integers(bucket // 2 + 1, bucket + 1))
    valid = np.arange(bucket) < n
    scores = rng.normal(size=bucket).astype(np.float32)
    for k in (16, 64):
        gi, gc = tsel.topk_select(torch.as_tensor(scores), k, torch.as_tensor(valid))
        wi, wc = jsel.topk_select(jnp.asarray(scores), k, jnp.asarray(valid))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        assert int(gc) == int(wc)
    # fewer valid frames than k: sentinel tail and count both match
    few = np.arange(bucket) < 5
    gi, gc = tsel.topk_select(torch.as_tensor(scores), 16, torch.as_tensor(few))
    wi, wc = jsel.topk_select(jnp.asarray(scores), 16, jnp.asarray(few))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    assert int(gc) == int(wc) == 5


@pytest.mark.parametrize("bucket", BUCKETS)
def test_bin_max_parity_every_bucket_padded_valid(bucket):
    rng = np.random.default_rng(bucket + 1)
    n = int(rng.integers(bucket // 2 + 1, bucket + 1))
    valid = np.arange(bucket) < n
    scores = rng.normal(size=bucket).astype(np.float32)
    for k in (8, 64):
        gi, gc = tsel.bin_max_select(torch.as_tensor(scores), k,
                                     torch.as_tensor(valid))
        wi, wc = jsel.bin_max_select(jnp.asarray(scores), k, jnp.asarray(valid))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        assert int(gc) == int(wc) == k


def test_equal_scores_pick_lower_index():
    """Ties resolve to the lower frame index, as jax.lax.top_k does."""
    scores = np.zeros(64, np.float32)
    scores[[3, 10, 20, 40, 50]] = 1.0            # five-way tie for 3 slots
    gi, _ = tsel.topk_select(torch.as_tensor(scores), 3)
    wi, _ = jsel.topk_select(jnp.asarray(scores), 3)
    np.testing.assert_array_equal(gi.numpy(), [3, 10, 20])
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    # all equal: the first k indices
    flat = np.full(32, 0.5, np.float32)
    gi, _ = tsel.topk_select(torch.as_tensor(flat), 8)
    np.testing.assert_array_equal(gi.numpy(), np.arange(8))
    # bin-max: equal scores inside a bin pick the lower index
    gi, _ = tsel.bin_max_select(torch.as_tensor(flat), 4)
    wi, _ = jsel.bin_max_select(jnp.asarray(flat), 4)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


@pytest.mark.parametrize("profile", [dict(t1=0.2, all_depth=3),
                                     dict(t1=0.8, all_depth=5)])
@pytest.mark.parametrize("T,k", [(500, 64), (300, 32), (40, 64)])
def test_aks_select_index_exact(profile, T, k):
    rng = np.random.default_rng(T + k)
    scores = np.cumsum(rng.normal(size=T)).astype(np.float32)   # structured
    assert tsel.aks_select(scores, k, **profile) == \
        jsel.aks_select(scores, k, **profile)


def test_uniform_helpers_parity():
    for t, l in ((10, 4), (100, 1), (7, 0), (63, 64)):
        assert tsel.generate_uniform_integers(t, l) == \
            jsel.generate_uniform_integers(t, l)
    for n, s in ((100, 7), (5, 5), (5, 6), (64, 0)):
        assert tsel.uniform_sample_indices(n, s) == \
            jsel.uniform_sample_indices(n, s)
