"""Port parity: tspo_tpu_torch.models.qwen2 against tspo_tpu.models.qwen2.

One HF-layout Qwen2ForCausalLM state dict made with numpy from a seed (qkv
biases non-zero) loads into both packages at tiny geometry, fp32.
Tolerances: hidden states and cache contents rtol = atol = 1e-4 (fp32 sums
in another order; the flash path's plain version against the JAX package's
pure-JAX flash, which scales q before the dot); greedy tokens exactly equal."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tspo_tpu.models import qwen2 as jq
from tspo_tpu_torch.models import qwen2 as tq

torch.set_num_threads(1)

CFG = tq.Qwen2Config.tiny()


def hf_qwen2_state_dict(cfg, seed: int) -> dict:
    """Random HF ``Qwen2ForCausalLM`` state dict (numpy), biases non-zero."""
    rng = np.random.default_rng(seed)
    D, I, hd = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    qd, kvd = cfg.num_heads * hd, cfg.num_kv_heads * hd

    def nrm(*shape, s=0.08):
        return (rng.normal(size=shape) * s).astype(np.float32)

    sd = {"model.embed_tokens.weight": nrm(cfg.vocab_size, D, s=0.5),
          "model.norm.weight": 1 + nrm(D, s=0.1),
          "lm_head.weight": nrm(cfg.vocab_size, D, s=0.3)}
    for i in range(cfg.num_layers):
        f = f"model.layers.{i}"
        sd[f"{f}.input_layernorm.weight"] = 1 + nrm(D, s=0.1)
        sd[f"{f}.post_attention_layernorm.weight"] = 1 + nrm(D, s=0.1)
        for name, out in (("q_proj", qd), ("k_proj", kvd), ("v_proj", kvd)):
            sd[f"{f}.self_attn.{name}.weight"] = nrm(out, D, s=0.15)
            if cfg.qkv_bias:
                sd[f"{f}.self_attn.{name}.bias"] = nrm(out, s=0.2)
        sd[f"{f}.self_attn.o_proj.weight"] = nrm(D, qd)
        sd[f"{f}.mlp.gate_proj.weight"] = nrm(I, D)
        sd[f"{f}.mlp.up_proj.weight"] = nrm(I, D)
        sd[f"{f}.mlp.down_proj.weight"] = nrm(D, I)
    return sd


def both(cfg, seed=0):
    """(jax params, jax cfg, port model) holding the same weights."""
    sd = hf_qwen2_state_dict(cfg, seed)
    jcfg = jq.Qwen2Config(**dataclasses.asdict(cfg))
    params = jq.qwen2_params_from_torch(sd, jcfg, dtype=jnp.float32)
    model = tq.Qwen2Model(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)
    return params, jcfg, model.eval()


def _ragged(B, S, D, lengths, seed):
    emb = (np.random.default_rng(seed).normal(size=(B, S, D)) * 0.5).astype(np.float32)
    valid = np.arange(S)[None, :] < np.asarray(lengths)[:, None]
    return emb, valid


@pytest.mark.parametrize("flash_threshold,window", [(512, None), (8, None),
                                                     (512, 5)])
def test_forward_matches_jax(flash_threshold, window):
    """Dense path, the flash path (threshold 8 < S), and the dense path with
    a sliding window, on a ragged B=2 prefill into a longer cache."""
    cfg = dataclasses.replace(CFG, sliding_window=window)
    params, jcfg, model = both(cfg)
    B, S, T = 2, 12, 20
    emb, valid = _ragged(B, S, cfg.hidden_size, (12, 7), seed=1)
    av = np.zeros((B, T), bool)
    av[:, :S] = valid
    jcache = jq.KVCache.create(jcfg, B, T, jnp.float32)
    want, jcache = jq.qwen2_forward(params, jnp.asarray(emb), jcache,
                                    jnp.arange(S), jnp.asarray(av), jcfg,
                                    flash_threshold=flash_threshold)
    cache = tq.KVCache.create(cfg, B, T, torch.float32)
    with torch.inference_mode():
        got, cache = tq.qwen2_forward(model, torch.from_numpy(emb), cache,
                                      torch.arange(S), torch.from_numpy(av),
                                      flash_threshold=flash_threshold)
    assert cache.length == S
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(jcache.v),
                               rtol=1e-4, atol=1e-4)


def test_decode_step_after_prefill_matches_jax():
    """One appended token per row, per-row rope positions (ragged)."""
    params, jcfg, model = both(CFG, seed=2)
    B, S, T = 2, 6, 10
    emb, valid = _ragged(B, S, CFG.hidden_size, (6, 4), seed=3)
    av = np.zeros((B, T), bool)
    av[:, :S] = valid
    step = (np.random.default_rng(4).normal(size=(B, 1, CFG.hidden_size)) * 0.5
            ).astype(np.float32)
    pos = np.asarray([[6], [4]])
    av2 = av.copy()
    av2[:, S] = True
    jcache = jq.KVCache.create(jcfg, B, T, jnp.float32)
    _, jcache = jq.qwen2_forward(params, jnp.asarray(emb), jcache,
                                 jnp.arange(S), jnp.asarray(av), jcfg)
    want, _ = jq.qwen2_forward(params, jnp.asarray(step), jcache,
                               jnp.asarray(pos), jnp.asarray(av2), jcfg)
    cache = tq.KVCache.create(CFG, B, T, torch.float32)
    with torch.inference_mode():
        tq.qwen2_forward(model, torch.from_numpy(emb), cache, torch.arange(S),
                         torch.from_numpy(av))
        got, cache = tq.qwen2_forward(model, torch.from_numpy(step), cache,
                                      torch.from_numpy(pos), torch.from_numpy(av2))
    assert cache.length == S + 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_greedy_decode_ragged_batch_matches_jax_through_flash():
    """A ragged B=2 prompt of 520 slots (>= 512: both packages take their
    flash path at prefill), 6 greedy tokens per row, token for token."""
    params, jcfg, model = both(CFG, seed=5)
    B, S = 2, 520
    emb, valid = _ragged(B, S, CFG.hidden_size, (520, 433), seed=6)
    n_new = 6
    jcache = jq.KVCache.create(jcfg, B, S + n_new + 2, jnp.float32)
    want, jn = jq.greedy_decode(params, jnp.asarray(emb), jnp.asarray(valid),
                                jcache, jcfg, n_new)
    cache = tq.KVCache.create(CFG, B, S + n_new + 2, torch.float32)
    got, n = tq.greedy_decode(model, torch.from_numpy(emb),
                              torch.from_numpy(valid), cache, n_new)
    assert n == int(jn)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_greedy_decode_stops_at_eos_and_pads():
    """An EOS id that the model emits first ends the row: the output is
    EOS-padded and n_steps stops early, as in the JAX loop."""
    params, jcfg, model = both(CFG, seed=7)
    emb, valid = _ragged(1, 5, CFG.hidden_size, (5,), seed=8)
    cache = tq.KVCache.create(CFG, 1, 16, torch.float32)
    toks, n = tq.greedy_decode(model, torch.from_numpy(emb),
                               torch.from_numpy(valid), cache, 6)
    first = int(toks[0])
    jcache = jq.KVCache.create(jcfg, 1, 16, jnp.float32)
    want, jn = jq.greedy_decode(params, jnp.asarray(emb), jnp.asarray(valid),
                                jcache, jcfg, 6, eos_token_id=first)
    cache = tq.KVCache.create(CFG, 1, 16, torch.float32)
    got, n = tq.greedy_decode(model, torch.from_numpy(emb),
                              torch.from_numpy(valid), cache, 6,
                              eos_token_id=first)
    assert n == int(jn) == 1
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() == first).all()


def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    w = (1 + 0.1 * rng.normal(size=64)).astype(np.float32)
    np.testing.assert_allclose(
        tq.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6).numpy(),
        np.asarray(jq._rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)),
        rtol=1e-6, atol=1e-6)
    pos = np.arange(3000)
    jc, js = jq._rope(jnp.asarray(pos), 128, 1e6)
    tc, tsn = tq.rope(torch.from_numpy(pos), 128, 1e6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-4, rtol=0)
    np.testing.assert_allclose(tsn.numpy(), np.asarray(js), atol=2e-4, rtol=0)
    assert tc.dtype == torch.float32
