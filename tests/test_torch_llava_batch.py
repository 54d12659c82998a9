"""Port parity: batched and teacher-forced answering of
``tspo_tpu_torch.models.llava_video.LLaVAVideoModel`` against the JAX
package's, on the tiny fp32 LLaVA of ``test_torch_llava_video.py`` (the same
llava_qwen-layout state dict made with numpy from a seed, loaded by both
packages' ``from_torch_checkpoint``).

``generate_batch_multi`` on ragged rows (their own questions and 2 to 4
frames each) and ``generate_batch`` give exactly the JAX package's strings
and those of the port's own ``generate`` row by row.  ``loglikelihood``
gives a log-probability within 1e-4 absolute of JAX's and the same
``is_greedy``; ``continuation_logprobs(top_k=3)`` the same continuation and
top-k ids and log-probabilities within 1e-4.  The cases marked ``flash``
hold a row of 26 frames (>= 512 tokens), so both packages prefill through
their flash path (the port's plain version on the CPU), ragged in the
batched case."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from test_torch_llava_video import CFG, JCFG, _decode, _encode, _frames, llava_state_dict
from tspo_tpu.models import llava_video as jl
from tspo_tpu_torch.models import llava_video as tl

torch.set_num_threads(1)

QUESTIONS = ["What is shown?", "Which colour dominates the scene?\nA. red\nB. blue",
             "Why?"]


@pytest.fixture(scope="module")
def models():
    sd = llava_state_dict()
    jax_model = jl.LLaVAVideoModel.from_torch_checkpoint(
        sd, JCFG, dtype=jnp.float32, encode=_encode, decode=_decode,
        max_new_tokens=6)
    port = tl.LLaVAVideoModel.from_torch_checkpoint(
        sd, CFG, dtype=torch.float32, device="cpu", encode=_encode,
        decode=_decode, batch_frames=8, max_new_tokens=6)
    return jax_model, port


def _rows(counts, seed):
    return [_frames(n, seed + i) for i, n in enumerate(counts)]


@pytest.mark.parametrize("counts", [(3, 2, 4), (26, 2, 3)], ids=["dense", "flash"])
def test_generate_batch_multi_matches_jax_and_single_rows(models, counts):
    jax_model, port = models
    frames = _rows(counts, seed=10)
    embeds, valid, max_new = port._prepare_batch(frames, QUESTIONS)
    lengths = valid.sum(1).tolist()
    assert len(set(lengths)) == 3 and max_new == 6        # ragged rows
    assert (max(lengths) >= 512) == (counts[0] == 26)
    want = jax_model.generate_batch_multi(frames, QUESTIONS)
    got = port.generate_batch_multi(frames, QUESTIONS)
    singles = [port.generate(f, q) for f, q in zip(frames, QUESTIONS)]
    assert got == want
    assert got == singles
    assert all(len(s.split()) >= 1 for s in got)


def test_generate_batch_matches_jax_and_single_rows(models):
    jax_model, port = models
    # black, white and two seeded subsets: rows that answer differently
    frames = [np.zeros((3, 48, 40, 3), np.uint8), np.full((3, 48, 40, 3), 255, np.uint8),
              *_rows((3, 3), seed=20)]
    q = "Describe the video."
    want = jax_model.generate_batch(frames, q, max_new_tokens=5)
    got = port.generate_batch(frames, q, max_new_tokens=5)
    assert got == want
    assert got == [port.generate(f, q, max_new_tokens=5) for f in frames]
    assert len(set(got)) > 1                  # the subsets answer differently


def test_generate_batch_checks_its_arguments(models):
    _, port = models
    frames = _rows((2, 2), seed=30)
    with pytest.raises(ValueError, match="max_new_tokens must be >= 1"):
        port.generate_batch(frames, "q", max_new_tokens=0)
    with pytest.raises(ValueError, match="no cache slot left"):
        port.generate_batch_multi(_rows((52, 2), seed=31), ["q", "q"])
    with pytest.raises(ValueError, match="encode/decode"):
        dataclasses.replace(port, encode=None).generate_batch(frames, "q")


@pytest.mark.parametrize("n_frames", [3, 26], ids=["dense", "flash"])
def test_loglikelihood_matches_jax(models, n_frames):
    jax_model, port = models
    frames = _frames(n_frames, seed=40)
    q = "Which is it?\nA. a cat\nB. a dog"
    for cont in ("A. a cat", "B", "the dog runs"):
        want_lp, want_greedy = jax_model.loglikelihood(frames, q, cont)
        got_lp, got_greedy = port.loglikelihood(frames, q, cont)
        assert isinstance(got_lp, float) and isinstance(got_greedy, bool)
        assert got_lp == pytest.approx(want_lp, abs=1e-4), cont
        assert got_greedy == want_greedy, cont
    # a continuation the model itself would answer is greedy in both
    answer = port.generate(frames, q, max_new_tokens=3)
    toks = [int(t) for t in answer.split()]
    greedy_text = "".join(chr(t) for t in toks)
    assert _encode(greedy_text) == toks
    assert port.loglikelihood(frames, q, greedy_text)[1] is True
    assert jax_model.loglikelihood(frames, q, greedy_text)[1] is True


@pytest.mark.parametrize("n_frames", [2, 26], ids=["dense", "flash"])
def test_continuation_logprobs_match_jax(models, n_frames):
    jax_model, port = models
    frames = _frames(n_frames, seed=50)
    q, cont = "What happens next?", "it rains"
    want = jax_model.continuation_logprobs(frames, q, cont, top_k=3)
    got = port.continuation_logprobs(frames, q, cont, top_k=3)
    assert got[0] == want[0] == _encode(cont)
    assert got[1].dtype == np.float64 and got[1].shape == (len(cont),)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-4)
    assert got[2].dtype == np.int32 and got[2].shape == (len(cont), 3)
    np.testing.assert_array_equal(got[2], want[2])
    assert got[3].dtype == np.float64
    np.testing.assert_allclose(got[3], want[3], rtol=0, atol=1e-4)
    # the token log-probs sum to loglikelihood's
    assert got[1].sum() == pytest.approx(port.loglikelihood(frames, q, cont)[0],
                                         abs=1e-4)
    ids, lps, top_ids, top_lps = port.continuation_logprobs(frames, q, cont)
    assert ids == got[0] and top_ids.shape == (len(cont), 0) and \
        top_ids.dtype == np.int32 and top_lps.shape == (len(cont), 0)
    np.testing.assert_array_equal(lps, got[1])


def test_text_only_loglikelihood_matches_jax(models):
    jax_model, port = models
    for frames in (None, np.zeros((0, 8, 8, 3), np.uint8)):
        want = jax_model.loglikelihood(frames, "Hi?", "hello")
        got = port.loglikelihood(frames, "Hi?", "hello")
        assert got[0] == pytest.approx(want[0], abs=1e-4) and got[1] == want[1]
