"""Port parity: ``tspo_tpu_torch.train.grpo`` against ``tspo_tpu.train.grpo``.

Same selector weights (the JAX init converted through ``interop``), same
numpy batch, fp32, 4 heads, window 8.  Limits: ``anneal_tau`` exactly equal;
``sample_subsets`` indices exactly equal given the Gumbel noise of JAX's key
splits; the surrogate loss within 1e-5 relative and every selector gradient
within 1e-5 of the gradient's largest entry (the key bias's exact gradient
is 0: a softmax ignores a shift common to its row, so its entries are fp32
noise); three ``selector_update_step`` calls at
``grad_accum`` 1 and 2 against optax: parameters within 1e-6 (all but the
key bias: its gradient is rounding noise, which Adam scales up to a step of
~lr in either package, and no output depends on it), loss and grad norm
within 1e-5 relative, the reward metrics (std with ddof=0) within 1e-7;
an optax state mapped into the port's AdamW resumes with the same next
step, and maps back to the same leaves."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tspo_tpu.configs import SelectorConfig as JSelectorConfig
from tspo_tpu.configs import TrainConfig as JTrainConfig
from tspo_tpu.models.selector import init_selector_params
from tspo_tpu.train import grpo as jgrpo
from tspo_tpu_torch.configs import SelectorConfig, TrainConfig
from tspo_tpu_torch.interop import (adamw_state_from_optax,
                                    optax_leaves_from_adamw,
                                    selector_state_dict_from_tree)
from tspo_tpu_torch.models.selector import MultiModalAlign, load_reference_state_dict
from tspo_tpu_torch.train import grpo

torch.set_num_threads(1)

DIM, HEADS, W, G = 48, 4, 8, 4
JCFG = JSelectorConfig(dim=DIM, num_heads=HEADS, window_size=W)
CFG = SelectorConfig(dim=DIM, num_heads=HEADS, window_size=W)
TAU = 0.025
# the key projection's bias shifts every score of a softmax row by the same
# q.b_k, so its exact gradient is 0 and nothing downstream depends on it
NOISE_ONLY = {"temporal.Self_k.bias"}


def _port_selector(params):
    sd = selector_state_dict_from_tree(jax.tree_util.tree_map(np.asarray, params))
    return load_reference_state_dict(MultiModalAlign(CFG), sd)


def _batch(B=2, T=64, lens=(64, 41), seed=0):
    rng = np.random.default_rng(seed)
    feat = rng.normal(size=(B, T, DIM)).astype(np.float32)
    text = rng.normal(size=(B, 1, DIM)).astype(np.float32)
    csc = rng.normal(scale=0.1, size=(B, T)).astype(np.float32)
    valid = np.arange(T)[None, :] < np.asarray(lens)[:, None]
    feat[~valid] = 0.0
    csc[~valid] = 0.0
    return (jgrpo.TrainBatch(*map(jnp.asarray, (feat, text, csc, valid))),
            grpo.TrainBatch(*map(torch.from_numpy, (feat, text, csc, valid))))


def _jax_noise(key, B, T):
    """The Gumbel draws sample_subsets makes from ``key``: split over the
    batch, then over the generations."""
    out = np.zeros((B, G, T), np.float32)
    for b, kb in enumerate(jax.random.split(key, B)):
        for g, kg in enumerate(jax.random.split(kb, G)):
            out[b, g] = np.asarray(jax.random.gumbel(kg, (T,), jnp.float32))
    return out


def _grads(sel):
    return {n: (np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy())
            for n, p in sel.named_parameters()}




@pytest.mark.parametrize("step,horizon", [(0, 10), (3, 10), (9, 10), (10, 10),
                                          (25, 10), (7, 0), (1000, 333)])
def test_anneal_tau_matches_jax_past_the_horizon(step, horizon):
    want = float(jgrpo.anneal_tau(step, horizon, 0.025, 0.01))
    assert grpo.anneal_tau(step, horizon, 0.025, 0.01) == want
    if step >= horizon:
        assert want == pytest.approx(0.01)


@pytest.mark.parametrize("k_len", [None, (8, 5)])
def test_sample_subsets_indices_match_jax(k_len):
    params = init_selector_params(jax.random.PRNGKey(0), JCFG)
    sel = _port_selector(params)
    jb, pb = _batch()
    key = jax.random.PRNGKey(42)
    want = jgrpo.sample_subsets(params, jb, key, jnp.float32(TAU), sel_cfg=JCFG,
                                num_generations=G, sample_len=8, window_size=W,
                                k_len=None if k_len is None else jnp.asarray(k_len))
    got = grpo.sample_subsets(sel, pb, TAU, num_generations=G, sample_len=8,
                              window_size=W, k_len=k_len,
                              noise=_jax_noise(key, 2, 64))
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.k_len.numpy(), np.asarray(want.k_len))


def _subsets_and_rewards(k_len=(8, 5), seed=3):
    rng = np.random.default_rng(seed)
    idx = np.zeros((2, G, 8), np.int64)
    for b, (kl, n) in enumerate(zip(k_len, (64, 41))):
        for g in range(G):
            idx[b, g, :kl] = np.sort(rng.choice(n, kl, replace=False))
    rewards = rng.choice([0.0, 0.5, 1.0, 1.5, 2.0], size=(2, G)).astype(np.float32)
    rewards[:, 0], rewards[:, 1] = 0.0, 2.0            # groups never constant
    return idx, np.asarray(k_len, np.int64), rewards


def test_surrogate_loss_and_gradients_match_jax():
    params = init_selector_params(jax.random.PRNGKey(1), JCFG)
    sel = _port_selector(params)
    jb, pb = _batch(seed=1)
    idx, kl, rewards = _subsets_and_rewards()
    loss_j, grads_j = jax.value_and_grad(jgrpo.grpo_surrogate_loss)(
        params, jb, jgrpo.SampledSubsets(jnp.asarray(idx, jnp.int32),
                                         jnp.asarray(kl, jnp.int32)),
        jnp.asarray(rewards), jnp.float32(TAU), sel_cfg=JCFG, window_size=W)
    loss = grpo.grpo_surrogate_loss(
        sel, pb, grpo.SampledSubsets(torch.from_numpy(idx), torch.from_numpy(kl)),
        torch.from_numpy(rewards), TAU, window_size=W)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(loss_j), rel=1e-5, abs=1e-7)
    want = selector_state_dict_from_tree(jax.tree_util.tree_map(np.asarray, grads_j))
    got = _grads(sel)
    assert set(got) == set(want)
    scale = max(np.abs(g).max() for g in want.values())
    for name in want:
        assert np.abs(got[name] - want[name]).max() <= 1e-5 * scale, name
    for name in NOISE_ONLY:
        assert np.abs(got[name]).max() <= 1e-6 * scale
    assert np.abs(got["mlp.0.weight"]).max() > 0
    assert not np.any(got["temporal.ffn_o.weight"])    # unused, as in JAX


def test_k_len_padding_adds_nothing_to_frame_0():
    """Indices past k_len are 0; with frame 0 never selected inside k_len,
    its log-prob gradient comes only through the softmax normaliser, the
    same as when the padding slots hold another frame."""
    params = init_selector_params(jax.random.PRNGKey(2), JCFG)
    jb, pb = _batch(seed=2)
    idx, kl, rewards = _subsets_and_rewards(k_len=(8, 3), seed=5)
    idx[idx == 0] = 1
    grads = []
    for pad in (0, 7):
        sel = _port_selector(params)
        idx_p = idx.copy()
        idx_p[1, :, 3:] = pad
        grpo.grpo_surrogate_loss(
            sel, pb, grpo.SampledSubsets(torch.from_numpy(idx_p), torch.from_numpy(kl)),
            torch.from_numpy(rewards), TAU, window_size=W).backward()
        grads.append(_grads(sel))
    for name in grads[0]:
        np.testing.assert_array_equal(grads[0][name], grads[1][name])


def _run_both(grad_accum, steps=3, lr=5e-3):
    params = init_selector_params(jax.random.PRNGKey(3), JCFG)
    sel = _port_selector(params)
    jcfg = JTrainConfig(learning_rate=lr, grad_accum=grad_accum, window_size=W)
    cfg = TrainConfig(learning_rate=lr, grad_accum=grad_accum, window_size=W)
    jopt = jgrpo.make_optimizer(jcfg)
    jstate = jopt.init(params)
    opt = grpo.make_optimizer(cfg, sel.parameters())
    for step in range(steps):
        jb, pb = _batch(seed=10 + step)
        idx, kl, rewards = _subsets_and_rewards(seed=20 + step)
        params, jstate, jm = jgrpo.selector_update_step(
            params, jstate, jb,
            jgrpo.SampledSubsets(jnp.asarray(idx, jnp.int32), jnp.asarray(kl, jnp.int32)),
            jnp.asarray(rewards), jnp.float32(TAU), sel_cfg=JCFG, train_cfg=jcfg,
            optimizer=jopt, window_size=W)
        m = grpo.selector_update_step(
            sel, opt, pb, grpo.SampledSubsets(torch.from_numpy(idx), torch.from_numpy(kl)),
            torch.from_numpy(rewards), TAU, train_cfg=cfg, window_size=W)
        yield step, params, jstate, jm, sel, opt, m


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_selector_update_step_matches_optax(grad_accum):
    before = {n: p.detach().numpy().copy() for n, p in _port_selector(
        init_selector_params(jax.random.PRNGKey(3), JCFG)).named_parameters()}
    for step, params, _, jm, sel, _, m in _run_both(grad_accum):
        want = selector_state_dict_from_tree(jax.tree_util.tree_map(np.asarray, params))
        got = {n: p.detach().numpy().copy() for n, p in sel.named_parameters()}
        for name in set(want) - NOISE_ONLY:
            np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-6,
                                       err_msg=name)
        for key in ("loss", "grad_norm"):
            assert float(m[key]) == pytest.approx(float(jm[key]), rel=1e-5, abs=1e-7)
        for key in ("reward_mean", "reward_std"):
            assert float(m[key]) == pytest.approx(float(jm[key]), rel=1e-7, abs=1e-7)
        # MultiSteps: the parameters move only on every grad_accum-th call
        moved = any(not np.array_equal(got[n], before[n]) for n in got)
        assert moved == ((step + 1) % grad_accum == 0)
        before = got


@pytest.mark.parametrize("grad_accum,steps", [(1, 2), (2, 3)])
def test_optax_state_resumes_in_the_port(grad_accum, steps):
    """After ``steps`` JAX updates, the optax state maps into the port's
    AdamW (mid-accumulation at grad_accum 2), the next step agrees, and the
    port's state maps back to optax's leaves."""
    *_, (_, params, jstate, _, _, _, _) = _run_both(grad_accum, steps)
    sel = _port_selector(params)
    cfg = TrainConfig(learning_rate=5e-3, grad_accum=grad_accum, window_size=W)
    opt = grpo.make_optimizer(cfg, sel.parameters())
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate)]
    state = adamw_state_from_optax(leaves, sel)
    assert state["step"] == steps // grad_accum
    grpo.load_optimizer_state(opt, sel, state)
    back = optax_leaves_from_adamw(grpo.optimizer_state(opt, sel), grad_accum)
    assert len(back) == len(leaves)
    for a, b in zip(back, leaves):
        np.testing.assert_array_equal(a, b)

    jcfg = JTrainConfig(learning_rate=5e-3, grad_accum=grad_accum, window_size=W)
    jb, pb = _batch(seed=99)
    idx, kl, rewards = _subsets_and_rewards(seed=98)
    params, _, _ = jgrpo.selector_update_step(
        params, jstate, jb,
        jgrpo.SampledSubsets(jnp.asarray(idx, jnp.int32), jnp.asarray(kl, jnp.int32)),
        jnp.asarray(rewards), jnp.float32(TAU), sel_cfg=JCFG, train_cfg=jcfg,
        optimizer=jgrpo.make_optimizer(jcfg), window_size=W)
    grpo.selector_update_step(
        sel, opt, pb, grpo.SampledSubsets(torch.from_numpy(idx), torch.from_numpy(kl)),
        torch.from_numpy(rewards), TAU, train_cfg=cfg, window_size=W)
    want = selector_state_dict_from_tree(jax.tree_util.tree_map(np.asarray, params))
    for name, p in sel.named_parameters():
        if name not in NOISE_ONLY:
            np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0,
                                       atol=1e-6, err_msg=name)


def test_adamw_defaults_are_optax_adamw_not_torch():
    sel = MultiModalAlign(CFG)
    opt = grpo.make_optimizer(dataclasses.replace(TrainConfig(), grad_accum=1),
                              sel.parameters())
    group = opt.param_groups[0]
    assert group["weight_decay"] == 0.0 and group["eps"] == 1e-8
    assert group["betas"] == (0.9, 0.999) and group["lr"] == 5e-4
    assert isinstance(opt, torch.optim.AdamW)
