"""Port parity: ``tspo_tpu_torch.ops.selection.gumbel_topk`` against the JAX
package's ``gumbel_topk``.

The two RNGs differ, so the port gets the JAX draw ``jax.random.gumbel(key,
(T,))`` as ``noise``.  Indices exactly equal; ``st_probs`` and ``log_probs``
within 1e-6 absolute.  Cases: with and without ``valid``, ``k_len < k``, and
logits at the selector's scale (divided by ``score_tau`` = 0.025) where
more than T - k entries of the softmax underflow to exactly 0 and the top k
is decided by the lower-index tie rule."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tspo_tpu.ops.selection import gumbel_topk as jax_gumbel_topk
from tspo_tpu_torch.ops.selection import gumbel_topk

torch.set_num_threads(1)


def _both(logits, k, valid=None, k_len=None, tau=1.0, seed=0):
    key = jax.random.PRNGKey(seed)
    g = np.asarray(jax.random.gumbel(key, (len(logits),), jnp.float32))
    want = jax_gumbel_topk(key, jnp.asarray(logits), k,
                           None if valid is None else jnp.asarray(valid), tau,
                           k_len=None if k_len is None else jnp.int32(k_len))
    got = gumbel_topk(torch.from_numpy(logits), k,
                      None if valid is None else torch.from_numpy(valid), tau,
                      k_len=k_len, noise=np.array(g))
    return [np.asarray(x) for x in want], [x.numpy() for x in got]


def _check(want, got):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)
    # log-probs of masked entries are ~-1e30 on both sides
    live = want[2] > -1e29
    np.testing.assert_allclose(got[2][live], want[2][live], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[2] > -1e29, live)


@pytest.mark.parametrize("T,k,n_valid,k_len,seed", [
    (64, 8, None, None, 0),
    (128, 16, 100, None, 1),
    (128, 16, 90, 8, 2),
    (64, 16, None, 5, 3),
    (256, 8, 201, 8, 4),
])
def test_gumbel_topk_matches_jax(T, k, n_valid, k_len, seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=T).astype(np.float32)
    valid = None if n_valid is None else np.arange(T) < n_valid
    want, got = _both(logits, k, valid, k_len, seed=seed)
    _check(want, got)
    idx = got[0]
    n = k if k_len is None else k_len
    assert np.all(np.diff(idx[:n]) > 0)
    if k_len is not None:
        assert np.all(idx[n:] == 0)
    if valid is not None:
        assert valid[idx[:n]].all()


@pytest.mark.parametrize("k_len", [None, 6])
def test_underflow_ties_go_to_the_lower_index(k_len):
    """Selector logits span ±80 (score_tau 0.025), so softmax((logits + g))
    is exactly 0 for most frames: the top k then picks zeros by index."""
    T, k = 128, 16
    rng = np.random.default_rng(7)
    logits = np.full(T, -80.0, np.float32)
    logits[rng.choice(T, 3, replace=False)] = 80.0   # three frames take all mass
    logits += rng.normal(scale=1.0, size=T).astype(np.float32)
    valid = np.arange(T) < 120
    want, got = _both(logits, k, valid, k_len, seed=11)
    y = torch.softmax(torch.from_numpy(np.where(
        valid, logits + np.asarray(jax.random.gumbel(jax.random.PRNGKey(11), (T,))),
        -1e30).astype(np.float32)), -1).numpy()
    assert (y == 0).sum() > T - k                   # the tie case is exercised
    _check(want, got)


def test_draws_from_generator_without_noise():
    logits = torch.from_numpy(np.random.default_rng(0).normal(size=64).astype(np.float32))
    a = gumbel_topk(logits, 8, generator=torch.Generator().manual_seed(3))[0]
    b = gumbel_topk(logits, 8, generator=torch.Generator().manual_seed(3))[0]
    c = gumbel_topk(logits, 8, generator=torch.Generator().manual_seed(4))[0]
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.dtype == torch.int32 and torch.all(a[1:] > a[:-1])


def test_straight_through_gradient_flows_through_the_softmax():
    logits = torch.from_numpy(np.random.default_rng(1).normal(size=32)
                              .astype(np.float32)).requires_grad_()
    g = np.random.default_rng(2).gumbel(size=32).astype(np.float32)
    idx, st, lp = gumbel_topk(logits, 4, noise=np.array(g))
    np.testing.assert_allclose(st.detach().numpy()[idx.long().numpy()], 1.0, atol=1e-6)
    (st * torch.arange(32.0)).sum().backward()
    assert torch.isfinite(logits.grad).all() and logits.grad.abs().sum() > 0
