"""Port parity: multi-round conversations with prefix-K/V reuse, sampling,
the streams and speculative decode of
``tspo_tpu_torch.models.llava_video.LLaVAVideoModel`` against the JAX
package's, on the tiny fp32 LLaVA of ``test_torch_llava_video.py`` (the
same llava_qwen-layout state dict made with numpy from a seed, loaded by
both packages).

Greedy answers (generate, the streams, stateless and stateful rounds,
speculative) are strings compared exactly, with the JAX package's and with
each other; a stateful round's state matches JAX's (token ids and covered
length exactly, the cache below the covered length within rtol = atol =
1e-5).  Sampled answers come from the port's own generator, so they are
held to the port's fused call at the same seed, and to greedy at a vanishing
nucleus; token parity of the sampler with the JAX package is
``test_torch_qwen2_decode.py``'s (JAX's Gumbel draws replayed)."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from test_torch_llava_video import CFG, JCFG, _decode, _encode, _frames, llava_state_dict
from tspo_tpu.models import conversation as jconv
from tspo_tpu.models import llava_video as jl
from tspo_tpu_torch.models import conversation as tconv
from tspo_tpu_torch.models import llava_video as tl
from tspo_tpu_torch.models import qwen2 as tq

torch.set_num_threads(1)

ROUNDS = ("What?", "And then?", "Why is that?")


@pytest.fixture(scope="module")
def models():
    sd = llava_state_dict(seed=3)
    jax_model = jl.LLaVAVideoModel.from_torch_checkpoint(
        sd, JCFG, dtype=jnp.float32, encode=_encode, decode=_decode,
        max_new_tokens=6)
    port = tl.LLaVAVideoModel.from_torch_checkpoint(
        sd, CFG, dtype=torch.float32, device="cpu", encode=_encode,
        decode=_decode, batch_frames=4, max_new_tokens=6)
    return jax_model, port


def _count_encodes(model):
    counts = {"n": 0}
    orig = model.encode_video

    def counted(frames):
        counts["n"] += 1
        return orig(frames)
    return counts, counted


def test_multi_round_prompt_and_stop_str_match_jax(models):
    jax_model, port = models
    turns = [("What?", "1 2"), ("And then?", None)]
    assert port.render_chat_prompt(turns) == jax_model.render_chat_prompt(turns)
    for name in sorted(jconv.CONV_TEMPLATES):
        assert tconv.build_prompt_multi(turns, name) == jconv.build_prompt_multi(turns, name)
        assert tconv.stop_str(name) == jconv.stop_str(name)
        assert tconv.get_template(name).stop_str == jconv.get_template(name).stop_str


def test_multi_round_single_turn_equals_generate(models):
    jax_model, port = models
    frames = _frames(2, seed=7)
    solo = port.generate(frames, "What?", max_new_tokens=3)
    assert port.generate_multi_round(frames, [("What?", None)], max_new_tokens=3) == solo
    assert solo == jax_model.generate(frames, "What?", max_new_tokens=3)


def test_multi_round_stateful_matches_stateless_and_jax(models, monkeypatch):
    """Three rounds through one ConversationState answer exactly as the
    stateless full re-prefill and as the JAX package's stateful rounds; the
    port's state holds JAX's ids, covered length and cache; the video
    encodes once for the stateful conversation."""
    jax_model, port = models
    frames = _frames(2, seed=8)
    state, jstate = port.new_conversation_state(), jax_model.new_conversation_state()
    counts, counted = _count_encodes(port)
    monkeypatch.setattr(port, "encode_video", counted)
    turns = []
    for r, q in enumerate(ROUNDS):
        want = jax_model.generate_multi_round(frames, [*turns, (q, None)],
                                              max_new_tokens=3, state=jstate)
        plain = port.generate_multi_round(frames, [*turns, (q, None)], max_new_tokens=3)
        got = port.generate_multi_round(frames, [*turns, (q, None)], max_new_tokens=3,
                                        state=state)
        assert got == plain == want, f"round {r}"
        assert state.ids == list(jstate.ids) and state.covered == jstate.covered
        n = state.covered
        assert state.cache.length == int(jstate.cache.length) == n
        np.testing.assert_allclose(state.cache.k[:, :, :n].numpy(),
                                   np.asarray(jstate.cache.k)[:, :, :n], rtol=1e-5,
                                   atol=1e-5)
        turns.append((q, want))
    assert counts["n"] == 3 + 1            # each stateless round, the state once


def test_multi_round_step_logits_sink_holds_each_step(models):
    """``step_logits`` through ``generate_multi_round``: each entry is the
    fp32 [1, V] logits a token was chosen from, so their argmax, up to
    max_new and cut at EOS, is the answer, with and without a state; the
    stateful round's logits equal the stateless re-prefill's within
    rtol = atol = 1e-5."""
    _, port = models
    frames = _frames(2, seed=8)
    eos = port.cfg.lm.eos_token_id
    state, turns = port.new_conversation_state(), []
    for q in ROUNDS[:2]:
        sinks = {}
        for name, st in (("stateless", None), ("stateful", state)):
            sinks[name] = []
            text = port.generate_multi_round(frames, [*turns, (q, None)], max_new_tokens=3,
                                             state=st, step_logits=sinks[name])
            assert all(lg.shape == (1, port.cfg.lm.vocab_size) and lg.dtype == torch.float32
                       for lg in sinks[name])
            toks = [int(lg[0].argmax()) for lg in sinks[name]][:3]
            toks = toks[:toks.index(eos)] if eos in toks else toks
            assert port.decode(toks) == text, name
        n = min(len(sinks["stateless"]), len(sinks["stateful"]))
        assert n >= 1
        np.testing.assert_allclose(torch.cat(sinks["stateful"][:n]).numpy(),
                                   torch.cat(sinks["stateless"][:n]).numpy(),
                                   rtol=1e-5, atol=1e-5)
        turns.append((q, text))


def test_multi_round_state_capacity_overflow_reprefills(models):
    """headroom 0 sizes the cache to round 1, so round 2 re-prefills into a
    larger cache and still answers as the stateless path."""
    jax_model, port = models
    frames = _frames(2, seed=9)
    state = port.new_conversation_state(headroom=0)
    a1 = port.generate_multi_round(frames, [("What?", None)], max_new_tokens=3,
                                   state=state)
    cap1 = state.cache.k.shape[2]
    turns = [("What?", a1), ("And then?", None)]
    want = jax_model.generate_multi_round(frames, turns, max_new_tokens=3)
    assert port.generate_multi_round(frames, turns, max_new_tokens=3, state=state) == want
    assert state.cache.k.shape[2] > cap1


@pytest.mark.parametrize("headroom", [0, 40, 72, 120, 200])
def test_multi_round_state_headroom_boundary_sweep(models, headroom):
    """Stateful equals stateless at every cache headroom, capacities just
    past the reuse boundary included (the last extension chunk's padding is
    budgeted; a block past capacity would raise, never land on the prefix)."""
    jax_model, port = models
    frames = _frames(2, seed=11)
    state = port.new_conversation_state(headroom=headroom)
    turns = []
    for q in ("What?", "And then after that happens?"):
        want = jax_model.generate_multi_round(frames, [*turns, (q, None)],
                                              max_new_tokens=3)
        got = port.generate_multi_round(frames, [*turns, (q, None)], max_new_tokens=3,
                                        state=state)
        assert got == want, q
        turns.append((q, want))


def test_multi_round_state_clamps_max_new_like_stateless(models):
    jax_model, port = models
    frames = _frames(2, seed=12)
    state = port.new_conversation_state()
    port.generate_multi_round(frames, [("What?", None)], max_new_tokens=1, state=state)
    prompt_e = state.covered - 1
    cfg = dataclasses.replace(CFG, max_context=prompt_e + 5)
    tight = dataclasses.replace(port, cfg=cfg)
    got = tight.generate_multi_round(frames, [("What?", None)], max_new_tokens=64,
                                     state=tight.new_conversation_state())
    jtight = dataclasses.replace(jax_model, cfg=dataclasses.replace(
        JCFG, max_context=prompt_e + 5))
    prompt = jconv.build_prompt_multi([("What?", None)], "qwen_1_5")
    assert got == tight.generate(frames, "", max_new_tokens=64, prompt=prompt) \
        == jtight.generate(frames, "", max_new_tokens=64, prompt=prompt)
    assert len(got.split()) <= 5


def test_multi_round_exception_leaves_state_clean(models, monkeypatch):
    jax_model, port = models
    frames = _frames(2, seed=10)
    state = port.new_conversation_state(headroom=256)
    a1 = port.generate_multi_round(frames, [("What?", None)], max_new_tokens=3,
                                   state=state)
    turns = [("What?", a1), ("And then?", None)]

    def boom(*a, **k):
        raise RuntimeError("injected")
    with monkeypatch.context() as m:
        m.setattr(tq, "prefill_extend", boom)
        with pytest.raises(RuntimeError, match="injected"):
            port.generate_multi_round(frames, turns, max_new_tokens=3, state=state)
    assert state.cache is None and state.ids == [] and state.covered == 0
    want = jax_model.generate_multi_round(frames, turns, max_new_tokens=3)
    assert port.generate_multi_round(frames, turns, max_new_tokens=3, state=state) == want


def test_multi_round_stream_matches(models):
    """Streamed rounds, stateless and stateful, join to the non-stream
    answer across three rounds at a chunk that does not divide max_new; the
    state commits after each fully consumed stream."""
    jax_model, port = models
    frames = _frames(2, seed=21)
    state = port.new_conversation_state()
    turns, covered = [], 0
    for q in ROUNDS:
        want = jax_model.generate_multi_round(frames, [*turns, (q, None)],
                                              max_new_tokens=5)
        stateless = "".join(port.generate_multi_round_stream(
            frames, [*turns, (q, None)], max_new_tokens=5, chunk=3))
        stateful = "".join(port.generate_multi_round_stream(
            frames, [*turns, (q, None)], max_new_tokens=5, chunk=3, state=state))
        assert stateless == stateful == want, q
        assert state.cache is not None and state.covered > covered
        covered = state.covered
        turns.append((q, want))


def test_multi_round_stream_abandoned_leaves_state_clean(models):
    jax_model, port = models
    frames = _frames(2, seed=22)
    state = port.new_conversation_state()
    a1 = port.generate_multi_round(frames, [("What?", None)], max_new_tokens=4,
                                   state=state)
    turns = [("What?", a1), ("And then?", None)]
    it = port.generate_multi_round_stream(frames, turns, max_new_tokens=4, chunk=1,
                                          state=state)
    assert next(it)
    it.close()
    assert state.cache is None and state.video_tokens is not None
    want = jax_model.generate_multi_round(frames, turns, max_new_tokens=4)
    assert port.generate_multi_round(frames, turns, max_new_tokens=4, state=state) == want
    assert state.cache is not None


def test_sampled_rounds_refuse_state(models):
    _, port = models
    frames = _frames(2, seed=31)
    state = port.new_conversation_state()
    with pytest.raises(ValueError, match="prefix-KV state"):
        port.generate_multi_round(frames, [("Q?", None)], temperature=0.5, state=state)
    with pytest.raises(ValueError, match="prefix-KV state"):
        next(port.generate_multi_round_stream(frames, [("Q?", None)], temperature=0.5,
                                              state=state))
    assert state.cache is None and state.video_tokens is None


def test_multi_round_sampled_is_seeded_and_streams_alike(models):
    _, port = models
    frames = _frames(3, seed=31)
    turns = [("What is shown?", "A scene."), ("And then?", None)]
    a = port.generate_multi_round(frames, turns, max_new_tokens=5, temperature=2.0, seed=6)
    b = port.generate_multi_round(frames, turns, max_new_tokens=5, temperature=2.0, seed=6)
    assert a == b
    assert "".join(port.generate_multi_round_stream(
        frames, turns, max_new_tokens=5, chunk=2, temperature=2.0, seed=6)) == a


@pytest.mark.parametrize("chunk", [1, 3, 8, 16])
def test_generate_stream_matches_generate_and_jax(models, chunk):
    jax_model, port = models
    frames = _frames(2, seed=11)
    q = "Describe the scene."
    want = jax_model.generate(frames, q, max_new_tokens=9)
    deltas = list(port.generate_stream(frames, q, max_new_tokens=9, chunk=chunk))
    assert all(deltas), deltas
    assert "".join(deltas) == want == port.generate(frames, q, max_new_tokens=9)


def test_generate_stream_through_flash_matches_jax(models):
    """A prompt of >= 512 tokens (26 frames): the stream's prefill takes the
    flash path, as generate's does."""
    jax_model, port = models
    frames = _frames(26, seed=4)
    want = jax_model.generate(frames, "Describe the video.", max_new_tokens=6)
    assert "".join(port.generate_stream(frames, "Describe the video.",
                                        max_new_tokens=6, chunk=4)) == want


def test_generate_stream_near_max_context(models):
    jax_model, port = models
    frames = _frames(2, seed=12)
    q = "Pick one: A. up B. down"
    ids = tl.tokenize_with_image(port._prompt(q), _encode)
    S = port.splice_embeddings(ids, port.encode_video(frames)).shape[1]
    tight = dataclasses.replace(port, cfg=dataclasses.replace(CFG, max_context=S + 5))
    want = tight.generate(frames, q, max_new_tokens=5)
    assert "".join(tight.generate_stream(frames, q, max_new_tokens=5, chunk=4)) == want


def test_generate_stream_multibyte_safe(models):
    """A character whose two tokens straddle a block edge is held back: no
    U+FFFD in any delta but the last, and the deltas join to generate's."""
    _, port = models

    def pair_decode(toks):
        text = "".join(chr(0x4E00 + (a % 100)) for a in toks[0::2][: len(toks) // 2])
        return text + ("�" if len(toks) % 2 else "")

    model = dataclasses.replace(port, decode=pair_decode)
    frames = _frames(2, seed=13)
    want = model.generate(frames, "Describe.", max_new_tokens=7)
    for chunk in (1, 3):
        deltas = list(model.generate_stream(frames, "Describe.", max_new_tokens=7,
                                            chunk=chunk))
        assert "".join(deltas) == want
        assert not any("�" in d for d in deltas[:-1]), deltas


def test_generate_sampled_top1_greedy_and_seeded(models):
    _, port = models
    frames = _frames(3, seed=15)
    greedy = port.generate(frames, "Describe.", max_new_tokens=4)
    assert port.generate(frames, "Describe.", max_new_tokens=4, temperature=5.0,
                         top_p=1e-9) == greedy
    a = port.generate(frames, "Describe.", max_new_tokens=4, temperature=2.0, seed=9)
    assert a == port.generate(frames, "Describe.", max_new_tokens=4, temperature=2.0,
                              seed=9)
    assert "".join(port.generate_stream(frames, "Describe.", max_new_tokens=4, chunk=3,
                                        temperature=2.0, seed=9)) == a


def test_unseeded_sampling_draws_a_fresh_seed(models, monkeypatch):
    _, port = models
    seeds = []
    real = tl.LLaVAVideoModel._generator

    def spy(self, seed):
        seeds.append(tl._sampling_seed(seed))
        return real(self, seeds[-1])
    monkeypatch.setattr(tl.LLaVAVideoModel, "_generator", spy)
    frames = _frames(2, seed=16)
    for seed in (None, None, 9, 9):
        port.generate(frames, "Describe.", max_new_tokens=2, temperature=1.0, seed=seed)
    assert seeds[0] != seeds[1] and seeds[2] == seeds[3] == 9


@pytest.mark.parametrize("n_frames", [2, 26], ids=["dense", "flash"])
def test_generate_speculative_matches_plain_and_jax(models, n_frames):
    jax_model, port = models
    frames = _frames(n_frames, seed=9)
    q = "What color is the square? A. red B. blue"
    plain = port.generate(frames, q, max_new_tokens=10)
    spec = dataclasses.replace(port, speculative=True, draft_len=4)
    jspec = dataclasses.replace(jax_model, speculative=True, draft_len=4)
    assert spec.generate(frames, q, max_new_tokens=10) == plain \
        == jspec.generate(frames, q, max_new_tokens=10)


def test_speculative_capacity_clamp_and_fallback(models):
    """Near max_context the draft clamps to the headroom; at none plain greedy
    decode answers (the JAX package's rule), greedy-exact either way."""
    _, port = models
    frames = _frames(2, seed=3)
    q = "Pick one: A. up B. down"
    plain = port.generate(frames, q, max_new_tokens=8)
    ids = tl.tokenize_with_image(port._prompt(q), _encode)
    S = port.splice_embeddings(ids, port.encode_video(frames)).shape[1]
    for ctx in (S + 8, S + 8 + 2):
        tight = dataclasses.replace(port, speculative=True, draft_len=4,
                                    cfg=dataclasses.replace(CFG, max_context=ctx))
        assert tight.generate(frames, q, max_new_tokens=8) == plain
