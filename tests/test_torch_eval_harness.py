"""Port parity: ``tspo_tpu_torch.eval.harness`` against ``tspo_tpu.eval.harness``
on the toy videos of ``tests/test_eval.py`` (its ``bench_dir`` fixture).

``evaluate_task`` gives equal ``results``, ``metrics`` and ``samples`` in
both packages with the stub backbone, with a recording batching backbone at
``batch_size`` 1 and 2 (the same batched calls), and with the tiny fp32
LLaVA of ``test_torch_llava_video.py`` at ``batch_size`` 2 (ragged
``generate_batch_multi`` in both); ``EgoSchema-ppl`` through the tiny
LLaVA's ``loglikelihood`` likewise.  So do the degrade-to-single path of a
failing batch, the shard merge, the response-cache resume, live scoring and
a missing video's ``[error: ...]`` record.  The port's frames reach the
backbone as numpy arrays from the producer thread, and an audio task with
an audio-capable backbone raises, naming the ROADMAP item."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_eval import BatchingBackbone, StubBackbone, _vmme_docs, bench_dir  # noqa: F401
from test_torch_llava_video import CFG, JCFG, _decode, _encode, llava_state_dict
from tspo_tpu.eval import caching as jcaching
from tspo_tpu.eval import harness as jharness
from tspo_tpu.models import llava_video as jl
from tspo_tpu_torch.eval import caching as tcaching
from tspo_tpu_torch.eval import harness as tharness
from tspo_tpu_torch.models import llava_video as tl

torch.set_num_threads(1)


def _both(task, docs, make_backbone, **kw):
    """(JAX result, port result, JAX backbone, port backbone)."""
    jb, tb = make_backbone(), make_backbone()
    want = jharness.evaluate_task(task, docs, jb, **kw)
    got = tharness.evaluate_task(task, docs, tb, **kw)
    return want, got, jb, tb


def _assert_equal(got, want):
    assert got.results == want.results
    assert got.metrics == want.metrics
    assert got.samples == want.samples


@pytest.fixture(scope="module")
def videos(bench_dir):  # noqa: F811
    return str(bench_dir / "videos")


def test_stub_backbone_matches_jax(videos):
    want, got, _, tb = _both("VideoMME", _vmme_docs(5), StubBackbone, video_root=videos,
                             max_frames_num=8, on_error="raise")
    _assert_equal(got, want)
    assert len(got.samples) == 5 and "overall" in got.metrics
    assert all(isinstance(shape, tuple) and shape[0] == 8 for shape, _ in tb.calls)


@pytest.mark.parametrize("batch_size", [1, 2])
def test_batching_backbone_matches_jax(videos, batch_size):
    want, got, jb, tb = _both("VideoMME", _vmme_docs(5), BatchingBackbone,
                              video_root=videos, max_frames_num=8, on_error="raise",
                              batch_size=batch_size)
    _assert_equal(got, want)
    assert tb.batch_calls == jb.batch_calls
    assert [n for n, _ in tb.batch_calls] == ([2, 2] if batch_size == 2 else [])


def test_failing_batch_degrades_to_single_like_jax(videos):
    want, got, jb, tb = _both("VideoMME", _vmme_docs(4),
                              lambda: BatchingBackbone(fail_batches=True),
                              video_root=videos, max_frames_num=8, batch_size=4)
    _assert_equal(got, want)
    assert len(tb.calls) == len(jb.calls) == 4          # one generate a doc
    assert not any(str(s["response"]).startswith("[error:") for s in got.samples)
    with pytest.raises(RuntimeError, match="batched decode OOM"):
        tharness.evaluate_task("VideoMME", _vmme_docs(2),
                               BatchingBackbone(fail_batches=True), video_root=videos,
                               max_frames_num=8, batch_size=2, on_error="raise")


def test_shard_merge_matches_jax(videos):
    docs = _vmme_docs(5)
    merged = {}
    for name, h in (("jax", jharness), ("port", tharness)):
        shards = [h.evaluate_task("VideoMME", docs, StubBackbone(), video_root=videos,
                                  max_frames_num=8, shard=(r, 2), on_error="raise")
                  for r in range(2)]
        merged[name] = h.merge_shards("VideoMME", shards)
    _assert_equal(merged["port"], merged["jax"])
    assert len(merged["port"].results) == 5


def test_response_cache_resume_matches_jax(videos, tmp_path):
    class Refuse(StubBackbone):
        def generate(self, frames, prompt):
            raise AssertionError("a cached doc was answered again")

    docs = _vmme_docs(3)
    runs = {}
    for name, h, caching in (("jax", jharness, jcaching), ("port", tharness, tcaching)):
        first = h.evaluate_task("VideoMME", docs, StubBackbone(), video_root=videos,
                                max_frames_num=8, on_error="raise",
                                response_cache=caching.ResponseCache(str(tmp_path / name),
                                                                     "VideoMME"))
        again = h.evaluate_task("VideoMME", docs, Refuse(), video_root=videos,
                                max_frames_num=8, on_error="raise",
                                response_cache=caching.ResponseCache(str(tmp_path / name),
                                                                     "VideoMME"))
        runs[name] = (first, again)
    for got, want in zip(runs["port"], runs["jax"]):
        _assert_equal(got, want)
    assert [s["response"] for s in runs["port"][1].samples] == \
        [s["response"] for s in runs["port"][0].samples]


def test_missing_video_error_record_matches_jax(tmp_path):
    docs = [dict(_vmme_docs(1)[0], videoID="nope.mp4")]
    want, got, _, _ = _both("VideoMME", docs, StubBackbone, video_root=str(tmp_path),
                            max_frames_num=4)
    _assert_equal(got, want)
    assert got.samples[0]["response"].startswith("[error:")


def test_live_scoring_matches_jax(videos):
    """Docs without ``frame_idx`` and a scorer: 1-fps candidates scored by the
    port's ``TSPOScorer.__call__`` (the same tiny weights as JAX's)."""
    import jax

    from test_eval import CLIP_CFG, SEL_CFG, _tokenize
    from tspo_tpu.models.tspo_model import build_random_scorer
    from tspo_tpu_torch.configs import CLIPConfig, SelectorConfig
    from tspo_tpu_torch.interop import scorer_from_numpy
    js = build_random_scorer(seed=0, clip_cfg=CLIP_CFG, selector_cfg=SEL_CFG,
                             dtype=jnp.float32, tokenize=_tokenize, batch_frames=32,
                             frame_buckets=(64, 128, 256))
    ps = scorer_from_numpy(jax.tree_util.tree_map(np.asarray, js.clip_params),
                           jax.tree_util.tree_map(np.asarray, js.selector_params),
                           CLIPConfig.tiny(), SelectorConfig(
                               dim=CLIPConfig.tiny().text.projection_dim, num_heads=4),
                           dtype=torch.float32, device="cpu", tokenize=_tokenize,
                           batch_frames=32, frame_buckets=(64, 128, 256))
    docs = [{k: v for k, v in d.items() if k != "frame_idx"} for d in _vmme_docs(3)]
    kw = dict(video_root=videos, max_frames_num=8, on_error="raise")
    want = jharness.evaluate_task("VideoMME", docs, StubBackbone(), scorer=js, **kw)
    got = tharness.evaluate_task("VideoMME", docs, StubBackbone(), scorer=ps, **kw)
    _assert_equal(got, want)
    assert all(len(s["frame_idx"]) == 8 for s in got.samples)


def test_audio_task_with_an_audio_backbone_raises(videos):
    class Audio(StubBackbone):
        supports_audio = True

    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        tharness.evaluate_task("WorldSense", [], Audio(), video_root=videos)
    # a video-only backbone runs the audio task frames-only, as in JAX
    docs = [{"video_path": "v0.mp4", "question": "What?",
             "candidates": ["A. x", "B. y", "C. z", "D. w"],
             "answer": "A", "domain": "d", "task_type": "t", "frame_idx": [0, 1, 2, 3]}]
    want, got, _, _ = _both("WorldSense", docs, StubBackbone, video_root=videos,
                            max_frames_num=4)
    _assert_equal(got, want)


@pytest.fixture(scope="module")
def llava():
    sd = llava_state_dict()
    jax_model = jl.LLaVAVideoModel.from_torch_checkpoint(
        sd, JCFG, dtype=jnp.float32, encode=_encode, decode=_decode, max_new_tokens=4)
    port = tl.LLaVAVideoModel.from_torch_checkpoint(
        sd, CFG, dtype=torch.float32, device="cpu", encode=_encode, decode=_decode,
        batch_frames=8, max_new_tokens=4)
    return jax_model, port


def test_tiny_llava_batched_matches_jax(videos, llava):
    jax_model, port = llava
    docs = [dict(d, question=d["question"] + " x" * i) for i, d in enumerate(_vmme_docs(3))]
    kw = dict(video_root=videos, max_frames_num=6, on_error="raise")
    want = jharness.evaluate_task("VideoMME", docs, jax_model, batch_size=2, **kw)
    got = tharness.evaluate_task("VideoMME", docs, port, batch_size=2, **kw)
    _assert_equal(got, want)
    single = tharness.evaluate_task("VideoMME", docs, port, **kw)
    _assert_equal(single, got)
    assert all(len(s["response"].split()) >= 1 for s in got.samples)


def test_tiny_llava_loglikelihood_task_matches_jax(bench_dir, llava):  # noqa: F811
    jax_model, port = llava
    docs = [{"video_idx": f"v{i}", "question": f"What happens in clip {i}?",
             "option": ["A. a red car", "B. a dog", "C. rain", "D. two people talk",
                        "E. nothing"], "answer": i, "frame_idx": [0, 5, 10, 15]}
            for i in range(2)]
    kw = dict(video_root=str(bench_dir / "videos"), max_frames_num=4, on_error="raise")
    want = jharness.evaluate_task("EgoSchema-ppl", docs, jax_model, **kw)
    got = tharness.evaluate_task("EgoSchema-ppl", docs, port, **kw)
    _assert_equal(got, want)
    assert [s["response"] for s in got.samples][0] in "ABCDE"


def test_producer_hands_numpy_frames_to_the_backbone(videos):
    seen = []

    class Record(StubBackbone):
        def generate(self, frames, prompt):
            seen.append(type(frames))
            return super().generate(frames, prompt)

    tharness.evaluate_task("VideoMME", _vmme_docs(2), Record(), video_root=videos,
                           max_frames_num=8, on_error="raise")
    assert seen == [np.ndarray, np.ndarray]
    assert dataclasses.is_dataclass(tharness.EvalResult)
