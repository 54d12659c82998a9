"""Port parity: the decode features of tspo_tpu_torch.models.qwen2 — the
chunked streams, nucleus sampling, the suffix prefill (``prefill_extend``,
dense and through the flash path at a ``q_offset``), the in-place
continuation and prompt-lookup speculative decode — against
tspo_tpu.models.qwen2.

The weights are ``test_torch_qwen2.py``'s HF-layout state dict (numpy, from
a seed) in both packages at the tiny geometry, fp32.  Tolerances: tokens
exactly equal, forward-pass counts equal; fp32 logits, hidden states and
cache contents rtol = atol = 1e-5.  Sampled tokens replay the JAX package's
own Gumbel draws (``jax.random.gumbel`` of each key split, in its order) as
the port's ``noise``: the two random generators differ."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_qwen2 import CFG, both
from tspo_tpu.models import qwen2 as jq
from tspo_tpu_torch.models import qwen2 as tq

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def pair():
    return both(CFG, seed=11)


def _prompt(model, seed, S=9):
    """(ids [1, S], port embeds, jax embeds, valid) of a random token prompt."""
    ids = np.random.default_rng(seed).integers(0, CFG.vocab_size - 2, size=(1, S))
    emb = tq.embed_tokens(model, torch.from_numpy(ids)).detach().float()
    return ids, emb, jnp.asarray(emb.numpy()), torch.ones(1, S, dtype=torch.bool)


def _tcache(T, B=1):
    return tq.KVCache.create(CFG, B, T, torch.float32)


def _jcache(jcfg, T, B=1):
    return jq.KVCache.create(jcfg, B, T, jnp.float32)


def jax_gumbel(key, n, B=1):
    """The [B, V] Gumbel draws of n emitted tokens of the JAX sampler: one
    split a token, as ``sample_decode`` threads its key."""
    draws = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.gumbel(sub, (B, CFG.vocab_size))))
    return draws


# ---------------------------------------------------------------------------
# Chunked streaming decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_stream_matches_greedy(pair, chunk):
    """Concatenated blocks equal the JAX fused loop's tokens and the port's
    greedy_decode, for chunks that do and do not divide max_new."""
    params, jcfg, model = pair
    _, emb, jemb, valid = _prompt(model, 3 + chunk)
    max_new = 12
    want, _ = jq.greedy_decode(params, jemb, jnp.asarray(valid.numpy()),
                               _jcache(jcfg, 32), jcfg, max_new, eos_token_id=-7)
    T = 9 + -(-max_new // chunk) * chunk
    got = np.concatenate(list(tq.greedy_decode_stream(
        model, emb, valid, _tcache(T), max_new, eos_token_id=-7, chunk=chunk)), axis=1)
    assert got.shape == (1, max_new) and got.dtype == np.int32
    np.testing.assert_array_equal(got[0], np.asarray(want))
    fused, _ = tq.greedy_decode(model, emb, valid, _tcache(32), max_new, eos_token_id=-7)
    np.testing.assert_array_equal(got[0], fused.numpy())


def test_stream_eos_early_stop(pair):
    """EOS mid-stream: JAX's EOS padding, and no chunk after every row is done."""
    params, jcfg, model = pair
    _, emb, jemb, valid = _prompt(model, 7)
    max_new = 12
    free, _ = tq.greedy_decode(model, emb, valid, _tcache(32), max_new, eos_token_id=-7)
    eos = int(free[3])
    want, n_want = jq.greedy_decode(params, jemb, jnp.asarray(valid.numpy()),
                                    _jcache(jcfg, 32), jcfg, max_new, eos_token_id=eos)
    chunks = list(tq.greedy_decode_stream(model, emb, valid, _tcache(32), max_new,
                                          eos_token_id=eos, chunk=2))
    got = np.concatenate(chunks, axis=1)
    np.testing.assert_array_equal(got[0], np.asarray(want)[: got.shape[1]])
    assert (got[0, int(n_want):] == eos).all()
    assert len(chunks) <= -(-int(n_want) // 2) + 1


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_stream_rejects_small_cache(pair, sampled):
    _, _, model = pair
    _, emb, _, valid = _prompt(model, 8)
    small = _tcache(9 + 12 - 1)
    it = (tq.sample_decode_stream(model, emb, valid, small, 12, 1.0, 1.0, chunk=4)
          if sampled else tq.greedy_decode_stream(model, emb, valid, small, 12, chunk=4))
    with pytest.raises(ValueError, match="stream cache needs >= 21 slots"):
        next(iter(it))


def test_decode_prefill_and_chunk_match_jax(pair):
    """The split halves at a ragged B=2 prompt: first tokens, chunk tokens,
    the carried tok and done, and the cache, against the JAX package."""
    params, jcfg, model = pair
    rng = np.random.default_rng(12)
    emb = (rng.normal(size=(2, 7, CFG.hidden_size)) * 0.5).astype(np.float32)
    valid = np.arange(7)[None] < np.array([[7], [5]])
    T = 7 + 8
    tok, jc, pos0 = jq.decode_prefill(params, jnp.asarray(emb), jnp.asarray(valid),
                                      _jcache(jcfg, T, 2), jcfg)
    jout, jtok, jc, jdone = jq.decode_chunk(params, tok, jc, pos0, jnp.int32(0),
                                            jnp.asarray(valid), jnp.zeros(2, bool),
                                            jcfg, 5, jnp.int32(-7))
    cache = _tcache(T, 2)
    ttok, cache, tpos0 = tq.decode_prefill(model, torch.from_numpy(emb),
                                           torch.from_numpy(valid), cache)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(tok))
    np.testing.assert_array_equal(tpos0.numpy(), np.asarray(pos0))
    out, ttok, cache, done = tq.decode_chunk(model, ttok, cache, tpos0, 0,
                                             torch.from_numpy(valid),
                                             torch.zeros(2, dtype=torch.bool), 5, -7)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    assert cache.length == int(jc.length) == 12
    np.testing.assert_allclose(cache.k[:, :, :12].numpy(), np.asarray(jc.k)[:, :, :12],
                               **TOL)


# ---------------------------------------------------------------------------
# Sampled decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("temperature,top_p", [(2.0, 0.9), (0.7, 1.0), (5.0, 0.3)])
def test_sample_decode_replays_jax_noise(pair, temperature, top_p):
    """The fused sampled loop, given JAX's per-token Gumbel draws, emits the
    JAX package's tokens and step count."""
    params, jcfg, model = pair
    _, emb, jemb, valid = _prompt(model, 21)
    key = jax.random.PRNGKey(5)
    want, n_want = jq.sample_decode(params, jemb, jnp.asarray(valid.numpy()),
                                    _jcache(jcfg, 40), jcfg, 14, key, temperature,
                                    top_p, eos_token_id=-7)
    got, n = tq.sample_decode(model, emb, valid, _tcache(40), 14, temperature, top_p,
                              eos_token_id=-7, noise=iter(jax_gumbel(key, 15)))
    assert n == int(n_want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("chunk", [1, 4, 5])
def test_sample_stream_matches_fused_with_jax_noise(pair, chunk):
    """Sampled stream blocks equal the JAX fused sample_decode at the same
    key (its noise replayed), and the port's fused loop at the same seed."""
    params, jcfg, model = pair
    _, emb, jemb, valid = _prompt(model, 30 + chunk)
    key, max_new = jax.random.PRNGKey(chunk), 12
    want, _ = jq.sample_decode(params, jemb, jnp.asarray(valid.numpy()),
                               _jcache(jcfg, 40), jcfg, max_new, key, 2.0, 0.9,
                               eos_token_id=-7)
    T = 9 + -(-max_new // chunk) * chunk
    got = np.concatenate(list(tq.sample_decode_stream(
        model, emb, valid, _tcache(T), max_new, 2.0, 0.9, eos_token_id=-7,
        chunk=chunk, noise=iter(jax_gumbel(key, max_new + 1)))), axis=1)
    assert got.shape == (1, max_new)
    np.testing.assert_array_equal(got[0], np.asarray(want))
    fused, _ = tq.sample_decode(model, emb, valid, _tcache(40), max_new, 2.0, 0.9,
                                eos_token_id=-7,
                                generator=torch.Generator().manual_seed(9))
    streamed = np.concatenate(list(tq.sample_decode_stream(
        model, emb, valid, _tcache(T), max_new, 2.0, 0.9, eos_token_id=-7,
        chunk=chunk, generator=torch.Generator().manual_seed(9))), axis=1)
    np.testing.assert_array_equal(streamed[0], fused.numpy())


def test_sample_stream_eos_early_stop(pair):
    params, jcfg, model = pair
    _, emb, jemb, valid = _prompt(model, 7)
    key, max_new = jax.random.PRNGKey(11), 12
    free, _ = jq.sample_decode(params, jemb, jnp.asarray(valid.numpy()),
                               _jcache(jcfg, 40), jcfg, max_new, key, 2.0, 1.0,
                               eos_token_id=-7)
    eos = int(np.asarray(free)[3])
    want, n_want = jq.sample_decode(params, jemb, jnp.asarray(valid.numpy()),
                                    _jcache(jcfg, 40), jcfg, max_new, key, 2.0, 1.0,
                                    eos_token_id=eos)
    chunks = list(tq.sample_decode_stream(model, emb, valid, _tcache(40), max_new,
                                          2.0, 1.0, eos_token_id=eos, chunk=2,
                                          noise=iter(jax_gumbel(key, max_new + 1))))
    got = np.concatenate(chunks, axis=1)
    np.testing.assert_array_equal(got[0], np.asarray(want)[: got.shape[1]])
    assert (got[0, int(n_want):] == eos).all()
    assert len(chunks) <= -(-int(n_want) // 2) + 1


def test_sample_top_p_tiny_and_low_temperature_equal_greedy(pair):
    _, _, model = pair
    _, emb, _, valid = _prompt(model, 3, S=7)
    want, n = tq.greedy_decode(model, emb, valid, _tcache(64), 8, eos_token_id=-7)
    gen = torch.Generator().manual_seed(42)
    for temperature, top_p in ((5.0, 1e-9), (1e-5, 1.0)):
        got, m = tq.sample_decode(model, emb, valid, _tcache(64), 8, temperature, top_p,
                                  eos_token_id=-7, generator=gen)
        assert m == n
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_sample_seed_reproducible_and_varies(pair):
    _, _, model = pair
    _, emb, _, valid = _prompt(model, 5, S=6)

    def run(seed):
        toks, n = tq.sample_decode(model, emb, valid, _tcache(64), 12, 3.0, 1.0,
                                   eos_token_id=-7,
                                   generator=torch.Generator().manual_seed(seed))
        return toks.numpy()[:n]

    np.testing.assert_array_equal(run(7), run(7))
    assert any(not np.array_equal(run(s), run(7)) for s in (8, 9, 10))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sample_token_ties_follow_jax_order(seed):
    """Logits with many exact ties (few distinct values): the token is JAX's
    ``sample_token`` draw given the same Gumbel noise, which requires the
    higher index first among equal logits.  A descending stable sort (lower
    index first) would pick another token on these inputs."""
    rng = np.random.default_rng(seed)
    B, V = 3, CFG.vocab_size
    logits = rng.integers(0, 4, size=(B, V)).astype(np.float32)
    logits[:, rng.integers(0, V, size=5)] = 6.0                 # tied top group
    key = jax.random.PRNGKey(seed)
    noise = np.asarray(jax.random.gumbel(key, (B, V)))
    for temperature, top_p in ((1.0, 1.0), (0.5, 0.9), (2.0, 0.5)):
        want = np.asarray(jq.sample_token(jnp.asarray(logits), key, temperature, top_p))
        got = tq.sample_token(torch.from_numpy(logits), temperature, top_p,
                              torch.from_numpy(noise)).numpy()
        np.testing.assert_array_equal(got, want)
    # the order matters on these inputs: lower-index-first tie order differs
    lo_first = torch.sort(torch.from_numpy(logits), descending=True, stable=True).indices
    wrong = torch.gather(lo_first, -1, torch.argmax(
        torch.sort(torch.from_numpy(logits), descending=True).values
        + torch.from_numpy(noise), dim=-1)[:, None])[:, 0].numpy()
    right = tq.sample_token(torch.from_numpy(logits), 1.0, 1.0,
                            torch.from_numpy(noise)).numpy()
    assert (wrong != right).any()


def test_gumbel_noise_is_finite_and_seeded():
    a = tq.gumbel_noise((4, 1000), torch.Generator().manual_seed(1))
    b = tq.gumbel_noise((4, 1000), torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and torch.isfinite(a).all()
    assert abs(a.mean().item() - 0.5772) < 0.05               # Euler-Mascheroni


# ---------------------------------------------------------------------------
# Suffix prefill and continuation
# ---------------------------------------------------------------------------

def _extend_case(params, jcfg, model, seed, P, S, valid_len, T):
    """A P-token prefill, then one suffix block of S rows (valid_len real)
    in both packages.  Returns (jax tok, jax cache, jax logits at the last
    real row, port tok, port cache, port logits)."""
    rng = np.random.default_rng(seed)
    pre = (rng.normal(size=(1, P, CFG.hidden_size)) * 0.5).astype(np.float32)
    sfx = (rng.normal(size=(1, S, CFG.hidden_size)) * 0.5).astype(np.float32)
    pv = np.ones((1, P), bool)
    _, jc, _ = jq.decode_prefill(params, jnp.asarray(pre), jnp.asarray(pv),
                                 _jcache(jcfg, T), jcfg)
    # the JAX package's off-TPU extension: the dense path
    av = jnp.arange(T)[None, :] < P + valid_len
    h, _ = jq.qwen2_forward(params, jnp.asarray(sfx), jc, P + jnp.arange(S), av, jcfg,
                            flash_threshold=10**9)
    jlogits = np.asarray(jq.lm_logits(params, h[:, valid_len - 1], jcfg))
    jtok, jc = jq.prefill_extend(params, jnp.asarray(sfx), jnp.int32(valid_len), jc, jcfg)
    cache = _tcache(T)
    tq.decode_prefill(model, torch.from_numpy(pre), torch.from_numpy(pv), cache)
    assert cache.length == P
    sink = []
    ttok, cache = tq.prefill_extend(model, torch.from_numpy(sfx), valid_len, cache,
                                    step_logits=sink)
    return jtok, jc, jlogits, ttok, cache, sink[0].numpy()


@pytest.mark.parametrize("S,valid_len", [(64, 37), (256, 256), (520, 517), (600, 512)],
                         ids=["dense_64", "dense_256", "flash_520", "flash_600"])
def test_prefill_extend_matches_jax_dense_extension(pair, S, valid_len):
    """A block after a 21-token prefix: below 512 rows both packages run the
    dense path; from 512 the port takes the flash path at q_offset = 21 over
    the cache's keys (the plain version of the kernel on the CPU) and is held
    against the JAX package's dense extension.  Token exact; last-row logits
    and the cache below the real length within 1e-5."""
    params, jcfg, model = pair
    P, T = 21, 21 + S + 40
    jtok, jc, jlogits, ttok, cache, tlogits = _extend_case(params, jcfg, model, S, P, S,
                                                           valid_len, T)
    assert cache.length == int(jc.length) == P + S
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(tlogits, jlogits, **TOL)
    n = P + valid_len
    np.testing.assert_allclose(cache.k[:, :, :n].numpy(), np.asarray(jc.k)[:, :, :n], **TOL)
    np.testing.assert_allclose(cache.v[:, :, :n].numpy(), np.asarray(jc.v)[:, :, :n], **TOL)


def test_prefill_extend_flash_offset_launches_the_flash_wrapper(pair, monkeypatch):
    """The offset branch calls flash_attention once a layer with q_offset =
    the cache length, lengths = length + valid_len and K/V the cache slots up
    to the block's end; a 511-row block stays dense."""
    from tspo_tpu_torch.ops import flash_attention as fa
    _, _, model = pair
    calls = []
    real = tq.flash_attention

    def spy(q, k, v, lengths, causal, window, q_offset):
        calls.append((q.shape[1], k.shape[1], lengths.tolist(), q_offset))
        return real(q, k, v, lengths, causal=causal, window=window, q_offset=q_offset)

    monkeypatch.setattr(tq, "flash_attention", spy)
    cache = _tcache(40 + 600 + 511)
    cache.length = 40
    emb = torch.zeros(1, 600, CFG.hidden_size)
    tq.prefill_extend(model, emb, 550, cache)
    assert calls == [(600, 640, [590], 40)] * CFG.num_layers
    cache.length = 590
    tq.prefill_extend(model, emb[:, :511], 511, cache)
    assert len(calls) == CFG.num_layers
    assert fa.flash_attention.launches == 0            # plain version on the CPU


def test_forward_refuses_a_flash_block_after_a_filled_cache_without_flash_suffix(pair):
    """Only a caller that vouches for a hole-free cache (``flash_suffix``, as
    :func:`prefill_extend` does) gets the offset flash; any other flash block
    after a filled cache raises before a slot is written."""
    _, _, model = pair
    cache = _tcache(40 + 512)
    cache.length = 40
    av = torch.ones(1, 40 + 512, dtype=torch.bool)
    with pytest.raises(ValueError, match="needs flash_suffix"):
        tq.qwen2_forward(model, torch.zeros(1, 512, CFG.hidden_size), cache,
                         40 + torch.arange(512), av)
    assert cache.length == 40
    assert not cache.k[:, :, 40:].any()


def test_prefill_extend_refuses_a_block_past_capacity(pair):
    _, _, model = pair
    cache = _tcache(30)
    cache.length = 20
    with pytest.raises(ValueError, match="cannot take 16 tokens after 20"):
        tq.prefill_extend(model, torch.zeros(1, 16, CFG.hidden_size), 5, cache)
    assert cache.length == 20


def test_prefill_extend_sampled_replays_jax_noise(pair):
    params, jcfg, model = pair
    rng = np.random.default_rng(40)
    pre = (rng.normal(size=(1, 10, CFG.hidden_size)) * 0.5).astype(np.float32)
    sfx = (rng.normal(size=(1, 64, CFG.hidden_size)) * 0.5).astype(np.float32)
    key = jax.random.PRNGKey(3)
    _, jc, _ = jq.decode_prefill(params, jnp.asarray(pre), jnp.ones((1, 10), bool),
                                 _jcache(jcfg, 100), jcfg)
    jtok, _, _ = jq.prefill_extend_sampled(params, jnp.asarray(sfx), jnp.int32(30), jc,
                                           jcfg, key, 2.0, 0.8)
    cache = _tcache(100)
    tq.decode_prefill(model, torch.from_numpy(pre), torch.ones(1, 10, dtype=torch.bool),
                      cache)
    ttok, cache = tq.prefill_extend_sampled(model, torch.from_numpy(sfx), 30, cache,
                                            2.0, 0.8, noise=iter(jax_gumbel(key, 1)))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    assert cache.length == 74


@pytest.mark.parametrize("max_new,chunk", [(12, 32), (12, 5), (9, 3)])
def test_greedy_decode_continue_matches_jax(pair, max_new, chunk):
    """Continuation after a prefix + extension: tokens equal JAX's, and the
    cache below the committed length (prefix + answer) holds the same K/V;
    the port runs no step past max_new (JAX runs whole chunks)."""
    params, jcfg, model = pair
    P, S, vl = 15, 64, 23
    T = P + S + 40
    jtok, jc, _, ttok, cache, _ = _extend_case(params, jcfg, model, 50, P, S, vl, T)
    L = P + vl
    jc = jc._replace(length=jnp.int32(L))
    want, jc = jq.greedy_decode_continue(params, jtok, jc, jcfg, max_new, chunk=chunk,
                                         eos_token_id=-7)
    cache.length = L
    got, cache = tq.greedy_decode_continue(model, ttok, cache, max_new, chunk=chunk,
                                           eos_token_id=-7)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert len(got) == max_new and cache.length == L + max_new
    n = L + len(got)
    np.testing.assert_allclose(cache.k[:, :, :n].numpy(), np.asarray(jc.k)[:, :, :n], **TOL)


def test_greedy_decode_continue_stream_blocks_and_final(pair):
    """The continuation stream: EOS-padded blocks equal to JAX's, and
    ``final`` filled only once the generator is exhausted."""
    params, jcfg, model = pair
    P, S, vl, max_new = 11, 64, 30, 10
    T = P + S + 40
    jtok, jc, _, ttok, cache, _ = _extend_case(params, jcfg, model, 60, P, S, vl, T)
    free, _ = tq.greedy_decode_continue(model, ttok, _copy(cache, P + vl), max_new,
                                        eos_token_id=-7)
    eos = int(free[4])
    jc = jc._replace(length=jnp.int32(P + vl))
    jfinal = {}
    want = list(jq.greedy_decode_continue_stream(params, jtok, jc, jcfg, max_new,
                                                 eos_token_id=eos, chunk=3, final=jfinal))
    cache.length = P + vl
    final = {}
    it = tq.greedy_decode_continue_stream(model, ttok, cache, max_new,
                                          eos_token_id=eos, chunk=3, final=final)
    got = [next(it)]
    assert final == {}
    got += list(it)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(final["tokens"], jfinal["tokens"])
    assert final["cache"] is cache and eos not in final["tokens"]


def _copy(cache, length):
    return tq.KVCache(cache.k.clone(), cache.v.clone(), length)


def test_greedy_decode_continue_rejects_small_cache(pair):
    _, _, model = pair
    cache = _tcache(40)
    cache.length = 20
    with pytest.raises(ValueError, match=r"conversation cache needs >= 52 slots "
                                         r"\(L=20 \+ 1x32\), got 40"):
        tq.greedy_decode_continue(model, 3, cache, 16)


# ---------------------------------------------------------------------------
# Prompt-lookup speculative decode
# ---------------------------------------------------------------------------

def _spec_both(pair, emb, jemb, valid, lookup, lvalid, max_new=12, d=4, eos=-7):
    """(jax tokens, n, n_fwd) and (port tokens, n, n_fwd, step logits)."""
    params, jcfg, model = pair
    S = emb.shape[1]
    T = S + max_new + d + 2
    jt, jn, jf = jq.greedy_decode_speculative(
        params, jemb, jnp.asarray(valid.numpy()), _jcache(jcfg, T), jcfg, max_new,
        jnp.asarray(lookup), jnp.asarray(lvalid), eos_token_id=eos, draft_len=d)
    sink = []
    tt, tn, tf = tq.greedy_decode_speculative(model, emb, valid, _tcache(T), max_new,
                                              lookup, lvalid, eos_token_id=eos,
                                              draft_len=d, step_logits=sink)
    return (np.asarray(jt), int(jn), int(jf)), (tt.numpy(), tn, tf, sink)


def _greedy(model, emb, valid, max_new=12, eos=-7):
    toks, n = tq.greedy_decode(model, emb, valid, _tcache(emb.shape[1] + max_new + 8),
                               max_new, eos_token_id=eos)
    return toks.numpy(), n


def _check_spec(jax_out, port_out, greedy):
    (jt, jn, jf), (tt, tn, tf, sink) = jax_out, port_out
    np.testing.assert_array_equal(tt, jt)
    assert (tn, tf) == (jn, jf)
    np.testing.assert_array_equal(tt, greedy[0])
    assert tn == greedy[1]
    # each emitted token is the argmax of the logits recorded for it
    emitted = [int(t) for t in tt[:tn]]
    assert [int(x.argmax()) for x in sink[:len(emitted)]] == emitted


@pytest.mark.parametrize("case", ["random_lookup", "oracle_lookup", "eos_parity",
                                  "ragged_empty_lookup", "eos_in_corpus",
                                  "match_at_corpus_end"])
def test_speculative_matches_jax_and_greedy(pair, case):
    """The JAX package's six speculative cases: tokens, n_valid and the
    forward-pass count equal JAX's, tokens equal greedy."""
    _, _, model = pair
    ids, emb, jemb, valid = _prompt(model, {"random_lookup": 3, "oracle_lookup": 6,
                                            "eos_parity": 7, "ragged_empty_lookup": 8,
                                            "eos_in_corpus": 9,
                                            "match_at_corpus_end": 10}[case])
    base = ids[0].astype(np.int32)
    eos, d = -7, 4
    if case == "ragged_empty_lookup":
        emb = torch.cat([emb[:, :6], torch.zeros(1, 3, CFG.hidden_size)], dim=1)
        jemb = jnp.asarray(emb.numpy())
        valid = torch.tensor([[True] * 6 + [False] * 3])
        lookup, lvalid, d = np.zeros(5, np.int32), np.zeros(5, bool), 3
    free = _greedy(model, emb, valid)
    if case == "random_lookup":
        lookup = base
    elif case == "oracle_lookup":
        lookup = np.concatenate([base, free[0].astype(np.int32)])
    elif case == "eos_parity":
        lookup = np.concatenate([base, free[0].astype(np.int32)])
        eos = int(free[0][5])
    elif case == "eos_in_corpus":
        lookup = np.empty(base.size * 2, np.int32)
        lookup[0::2], lookup[1::2] = base, 0
    elif case == "match_at_corpus_end":
        lookup = np.concatenate([base, free[0][:2].astype(np.int32)])
    if case != "ragged_empty_lookup":
        lvalid = np.ones(lookup.size, bool)
    jax_out, port_out = _spec_both(pair, emb, jemb, valid, lookup, lvalid, d=d, eos=eos)
    _check_spec(jax_out, port_out, _greedy(model, emb, valid, eos=eos))
    if case == "oracle_lookup":
        assert port_out[2] <= 6, port_out[2]


def test_speculative_rejects_small_cache(pair):
    _, _, model = pair
    _, emb, _, valid = _prompt(model, 11)
    with pytest.raises(ValueError, match="cache too small for speculation"):
        tq.greedy_decode_speculative(model, emb, valid, _tcache(emb.shape[1] + 4), 12,
                                     np.zeros(8, np.int32), np.zeros(8, bool),
                                     draft_len=4)


def test_build_spec_lookup_matches_jax():
    for ids in ([], [5, 6, 7], list(range(300))):
        got = tq.build_spec_lookup(iter(ids))
        want = jq.build_spec_lookup(iter(ids))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("chunk", [1, 2, 4])
def test_stream_detokenize_matches_jax(chunk):
    """The pure-Python state machine: equal deltas for a pair-decoding
    detokenizer (a character split over a chunk edge is held back)."""
    def pair_decode(toks):
        text = "".join(chr(0x4E00 + (a % 100)) for a in toks[0::2][: len(toks) // 2])
        return text + ("�" if len(toks) % 2 else "")

    toks = np.array([[3, 9, 27, 4, 8, 1, 5, -7, -7, -7]], np.int32)
    blocks = [toks[:, i:i + chunk] for i in range(0, toks.shape[1], chunk)]
    got = list(tq.stream_detokenize(iter(blocks), pair_decode, -7))
    want = list(jq.stream_detokenize(iter(blocks), pair_decode, -7))
    assert got == want and "".join(got) == pair_decode([3, 9, 27, 4, 8, 1, 5])
