"""Port parity: the port's own copies of ``train/rewards.py`` and
``video/augment.py`` against the JAX package's.

Rewards on fixed tables and the needle composites on a seeded
``np.random.Generator``: outputs exactly equal, and each side leaves its
generator in the same state.  ``sample_real_frames`` at the frames' own size
equals the JAX package's ``cv2.resize`` result without importing cv2 (the
card's machine has none)."""

import sys

import numpy as np
import pytest
import torch

from tspo_tpu.train import rewards as jrewards
from tspo_tpu.video import augment as jaug
from tspo_tpu_torch.train import rewards
from tspo_tpu_torch.video import augment

cv2 = pytest.importorskip("cv2")

torch.set_num_threads(1)

COMPLETIONS = ["A", "b.", "The answer is (C).", "nothing here", "<answer>d</answer>",
               "<think>x</think> <answer>a</answer>", "e) last", ""]
SOLUTIONS = ["<answer>a</answer>", "B", "c", "<answer>a</answer>", "D",
             "<answer>A</answer>", "<answer>e</answer>", "a"]


def test_reward_registry_matches_jax():
    assert list(rewards.REWARD_REGISTRY) == list(jrewards.REWARD_REGISTRY)
    rng = np.random.default_rng(0)
    mask = rng.random(40) < 0.3
    sel = [np.sort(rng.choice(40, 8, replace=False)) for _ in COMPLETIONS]
    for name, fn in rewards.REWARD_REGISTRY.items():
        kw = dict(completions=COMPLETIONS, solution=SOLUTIONS, sel_idxs=sel,
                  total_mask=mask)
        assert fn(**kw) == jrewards.REWARD_REGISTRY[name](**kw), name
    for text in COMPLETIONS + SOLUTIONS:
        assert (rewards.map_prediction_to_option(text)
                == jrewards.map_prediction_to_option(text))


@pytest.mark.parametrize("stype", ["specific", "general"])
def test_compose_rewards_matches_jax(stype):
    rpf = np.random.default_rng(1).random((8, 3)).astype(np.float32)
    np.testing.assert_array_equal(rewards.compose_rewards(rpf, stype),
                                  jrewards.compose_rewards(rpf, stype))


@pytest.mark.parametrize("q", [
    "<image>\nWhat color?\nA. red\nB. blue Please respond with only the letter "
    "of the correct answer.",
    "<image>\nWhich one?\n(A) x\n(B) y Please provide your answer by stating the "
    "letter followed by the full option.",
    "no options here",
])
def test_question_cleaning_matches_jax(q):
    assert rewards.extract_problem(q) == jrewards.extract_problem(q)
    assert rewards.clean_question(q) == jrewards.clean_question(q)


def _video(n, seed, hw=(12, 16)):
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 3), np.uint8)


def _same_rng_state(a, b):
    assert a.bit_generator.state == b.bit_generator.state


@pytest.mark.parametrize("n,repeat,clip", [(128, 3, 50), (30, 2, 50), (64, 4, 10)])
def test_needle_composites_match_jax(n, repeat, clip):
    video = _video(n, n)
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    got = augment.repeat_videos(video, repeat, clip, rng=r1)
    want = jaug.repeat_videos(video, repeat, clip, rng=r2)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    wrong = [_video(len(got[0]), 100 + i) for i in range(5)]
    for fn in ("shuffle_clips", "shuffle_clips_1fps"):
        (gv, gm), (wv, wm) = (getattr(augment, fn)(got, wrong, rng=r1),
                              getattr(jaug, fn)(want, wrong, rng=r2))
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(gm, wm)
        assert gm.sum() == sum(len(c) for c in got)
    gv, gm = augment.shuffle_fixed_clips(got, wrong)
    wv, wm = jaug.shuffle_fixed_clips(want, wrong)
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gm, wm)
    _same_rng_state(r1, r2)


def test_resizes_match_jax():
    video = _video(3, 9, hw=(30, 40))
    np.testing.assert_array_equal(augment.resize_video(video, 24, 20),
                                  jaug.resize_video(video, 24, 20))
    np.testing.assert_array_equal(augment.resize_short(video, 21),
                                  jaug.resize_short(video, 21))


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    root = tmp_path_factory.mktemp("aug")
    for i, n in enumerate((60, 20)):
        w = cv2.VideoWriter(str(root / f"v{i}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"),
                            1.0, (32, 24))
        for t in range(n):
            w.write(np.full((24, 32, 3), (7 * t + 50 * i) % 256, np.uint8))
        w.release()
    return str(root), [{"video": "v0.mp4"}, {"video": "v1.mp4"}]


@pytest.mark.parametrize("target", [(24, 32), (20, 28)])
def test_sample_real_frames_matches_jax(videos, target):
    root, pool = videos
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(4):
        got = augment.sample_real_frames(pool, root, 50, *target, rng=r1)
        want = jaug.sample_real_frames(pool, root, 50, *target, rng=r2)
        assert got.shape == (50, *target, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    _same_rng_state(r1, r2)


def test_sample_real_frames_at_its_own_size_needs_no_cv2(videos, monkeypatch):
    root, pool = videos
    want = jaug.sample_real_frames(pool, root, 50, 24, 32,
                                   rng=np.random.default_rng(8))
    from tspo_tpu_torch.video import reader
    decoded = {p: reader.load_video(p, max_frames_num=50, fps=1, force_sample=False)
               for p in (f"{root}/{row['video']}" for row in pool)}
    # the decode is replaced by its result: with cv2 gone, only a resize
    # could need it
    monkeypatch.setattr(reader, "load_video", lambda path, **kw: decoded[path])
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = augment.sample_real_frames(pool, root, 50, 24, 32,
                                     rng=np.random.default_rng(8))
    np.testing.assert_array_equal(got, want)
    assert not any(got is d[0] for d in decoded.values())
    with pytest.raises(ImportError):
        augment.sample_real_frames(pool, root, 50, 20, 28,
                                   rng=np.random.default_rng(8))
