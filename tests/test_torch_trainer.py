"""Port parity: ``tspo_tpu_torch.train.trainer.TSPOTrainer`` against the JAX
package's ``TSPOTrainer`` on tiny mp4 videos written with cv2.

Both trainers hold the same tiny CLIP + selector weights (the JAX init
converted through ``interop``), decode the same videos, draw the same needle
composites from ``np.random.default_rng(seed)``, and get the same Gumbel
noise: the port's ``noise_fn`` replays the JAX trainer's key splits.  The
backbone is a stub whose answer depends on the frames it is given.  Over
four steps (specific, general, specific, general; ``grad_accum`` 2): sampled
indices and rewards exactly equal, loss and grad norm within 1e-5 relative,
each step's selector gradient against JAX's (``_assert_grads_close``: the
query/key projections are held there), and selector parameters within 1e-5
wherever Adam's second-moment estimate sqrt(v_hat) was at least 1e-6 (100x
its eps) after every update so far.  Below that Adam's step
m_hat / (sqrt(v_hat) + eps) turns the rounding noise of the gradient into up
to ±lr in either package: the tiny selector's query/key gradients are 1e-5
to 2e-4 of the MLP's, and the key bias's exact gradient is 0 (see
tests/test_torch_grpo.py); the share of each leaf compared is printed.
Also: ``train_step_batch`` over mixed types, the batched ``train`` loop
against the JAX CLI's, the checkpoint round trip with ``prune_checkpoints``
and ``resume_from``, a JAX ``checkpoint-N.npz`` resumed in the port (its
next step equal to JAX's), ``export_merged`` read back by the JAX
``TSPOScorer.load``, and the ``tspo-torch-train`` CLI on the CPU."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tspo_tpu.configs import CLIPConfig as JCLIPConfig
from tspo_tpu.configs import SelectorConfig as JSelectorConfig
from tspo_tpu.configs import TrainConfig as JTrainConfig
from tspo_tpu.models.tspo_model import TSPOScorer as JScorer
from tspo_tpu.models.tspo_model import build_random_scorer as jax_random_scorer
from tspo_tpu.train import grpo as jgrpo
from tspo_tpu.train import trainer as jtrainer_mod
from tspo_tpu_torch.configs import CLIPConfig, SelectorConfig, TrainConfig
from tspo_tpu_torch.interop import scorer_from_numpy, selector_state_dict_from_tree
from tspo_tpu_torch.train import grpo
from tspo_tpu_torch.train import trainer as trainer_mod
from tspo_tpu_torch.train.checkpoint import list_checkpoints, load_train_state
from tspo_tpu_torch.train.grpo import optimizer_state

cv2 = pytest.importorskip("cv2")

torch.set_num_threads(1)

CLIP_CFG = CLIPConfig.tiny()
SEL_CFG = SelectorConfig(dim=CLIP_CFG.text.projection_dim, num_heads=4, window_size=8)
JCLIP_CFG = JCLIPConfig.tiny()
JSEL_CFG = JSelectorConfig(dim=JCLIP_CFG.text.projection_dim, num_heads=4,
                           window_size=8)
BUCKETS = (64, 128, 256, 512, 1024)
CFG_KW = dict(num_generations=4, training_sample_len=8, learning_rate=5e-3,
              max_steps=60, window_size=8, save_every=1000, seed=0, grad_accum=2,
              needle_wrong_clips=3, needle_clip_len=10)
RESOLVED = 1e-6        # sqrt(v_hat) from which Adam's step is determined
QUESTION = ("<image>\nWhen is it bright?\nA. mid\nB. never Please respond with "
            "only the letter of the correct answer.")


def _tokenize(problem: str):
    ids = np.full((1, 8), 3, np.int32)
    for i, ch in enumerate(problem[:6]):
        ids[0, i + 1] = 1 + ord(ch) % 500
    ids[0, -1] = CLIP_CFG.text.eos_token_id
    return ids, np.ones((1, 8), np.int32)


class OracleBackbone:
    """'A' iff most of the given frames are bright: the answer, and so the
    reward, depends on which frames were selected."""

    def generate(self, frames, question):
        frac = float((frames.astype(np.float32).mean(axis=(1, 2, 3)) > 100).mean())
        return "A" if frac > 0.5 else "B"


class JaxNoise:
    """The Gumbel noise the JAX trainer draws at each step: its key chain
    (``_next_rng``), split over the batch, then over the generations."""

    def __init__(self, seed: int, skip: int = 0):
        self.key = jax.random.PRNGKey(seed)
        for _ in range(skip):
            self.key, _ = jax.random.split(self.key)

    def __call__(self, shape):
        B, G, T = shape
        self.key, sub = jax.random.split(self.key)
        out = np.zeros(shape, np.float32)
        for b, kb in enumerate(jax.random.split(sub, B)):
            for g, kg in enumerate(jax.random.split(kb, G)):
                out[b, g] = np.asarray(jax.random.gumbel(kg, (T,), jnp.float32))
        return out


def _write(path, n, value_fn, seed=0):
    """n frames of 48x48: a seeded texture of its own around each frame's
    brightness, so that no two frames are alike (constant frames make the
    selector's query/key gradients ~1e-5 of the others: rounding noise that
    Adam scales up to steps of ~lr in either package)."""
    rng = np.random.default_rng(seed)
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 1.0, (48, 48))
    for i in range(n):
        tex = rng.integers(-25, 26, (6, 6, 3)).repeat(8, 0).repeat(8, 1)
        w.write(np.clip(value_fn(i) + tex, 0, 255).astype(np.uint8))
    w.release()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_train")
    _write(root / "train.mp4", 64, lambda i: 200 if 20 <= i < 40 else 40, seed=1)
    _write(root / "dark.mp4", 60, lambda i: 40, seed=2)
    _write(root / "bright.mp4", 60, lambda i: 190, seed=3)
    general = {"video": "train.mp4", "original_question": QUESTION,
               "problem": "When is it bright?", "solution": "<answer>a</answer>",
               "type": "general"}
    pool = [{"video": "dark.mp4"}, {"video": "bright.mp4"}, {"video": "train.mp4"}]
    return root, general, dict(general, type="specific"), pool


def _pair(root, pool, out, cfg_kw=None, noise_skip=0):
    """A JAX trainer and a port trainer with the same weights and settings."""
    kw = dict(CFG_KW, **(cfg_kw or {}))
    js = jax_random_scorer(seed=0, clip_cfg=JCLIP_CFG, selector_cfg=JSEL_CFG,
                           dtype=jnp.float32, tokenize=_tokenize, batch_frames=32,
                           frame_buckets=BUCKETS)
    ps = scorer_from_numpy(jax.tree_util.tree_map(np.asarray, js.clip_params),
                           jax.tree_util.tree_map(np.asarray, js.selector_params),
                           CLIP_CFG, SEL_CFG, dtype=torch.float32, device="cpu",
                           tokenize=_tokenize, batch_frames=32, frame_buckets=BUCKETS)
    common = dict(backbone=OracleBackbone(), dataset=[], video_folder=str(root),
                  irrelevant_pool=pool)
    jt = jtrainer_mod.TSPOTrainer(scorer=js, cfg=JTrainConfig(**kw), sel_cfg=JSEL_CFG,
                                  output_dir=str(out / "jax"), **common)
    pt = trainer_mod.TSPOTrainer(scorer=ps, cfg=TrainConfig(**kw),
                                 output_dir=str(out / "port"),
                                 noise_fn=JaxNoise(kw["seed"], noise_skip), **common)
    return jt, pt


def _jax_grads(params, batch, subsets, rewards, tau, **kw):
    _, grads = jax.value_and_grad(jgrpo.grpo_surrogate_loss)(
        params, batch, subsets, rewards, tau, sel_cfg=kw["sel_cfg"],
        window_size=kw["window_size"], adv_eps=kw["train_cfg"].adv_eps)
    return selector_state_dict_from_tree(jax.tree_util.tree_map(np.asarray, grads))


def _port_grads(selector, batch, subsets, rewards, tau, **kw):
    names, params = zip(*selector.named_parameters())
    loss = grpo.grpo_surrogate_loss(selector, batch, subsets, rewards, tau,
                                    window_size=kw["window_size"],
                                    adv_eps=kw["train_cfg"].adv_eps)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return {n: (np.zeros(p.shape, np.float32) if g is None else g.numpy())
            for n, p, g in zip(names, params, grads)}


@pytest.fixture
def record(monkeypatch):
    """Each trainer's sampled indices, rewards and this call's selector
    gradient, per step."""
    seen = {"jax": [], "port": [], "applied": []}

    def wrap(mod, side, arg):
        sample, update = mod.sample_subsets, mod.selector_update_step

        def sample_rec(*a, **k):
            out = sample(*a, **k)
            seen[side].append({"indices": np.asarray(out.indices)})
            return out

        def update_rec(*a, **k):
            seen[side][-1]["rewards"] = np.asarray(a[arg])
            grads_of = _port_grads if side == "port" else _jax_grads
            seen[side][-1]["grads"] = grads_of(a[0], *a[2:6], **k)
            out = update(*a, **k)
            if side == "port" and a[1].mini_step == 0:   # AdamW stepped
                st = a[1].state
                seen["applied"].append({
                    n: np.sqrt(st[p]["exp_avg_sq"].numpy()
                               / (1 - 0.999 ** float(st[p]["step"])))
                    for n, p in a[0].named_parameters()})
            return out

        monkeypatch.setattr(mod, "sample_subsets", sample_rec)
        monkeypatch.setattr(mod, "selector_update_step", update_rec)

    wrap(jtrainer_mod, "jax", 4)
    wrap(trainer_mod, "port", 4)
    return seen


def _params(jt, pt):
    want = selector_state_dict_from_tree(
        jax.tree_util.tree_map(np.asarray, jt.scorer.selector_params))
    got = {n: p.detach().numpy().copy()
           for n, p in pt.scorer.selector.named_parameters()}
    return want, got


def _assert_params_close(jt, pt, applied, atol=1e-5):
    """Parameters within ``atol`` where sqrt(v_hat) was resolved after each
    update so far (the port's, as recorded); most of the MLP and value
    projection must be (the tiny selector's query/key mostly are not, and
    ``_assert_grads_close`` holds their gradients instead).  Prints the
    share of each leaf compared."""
    want, got = _params(jt, pt)
    shares = {}
    for name in want:
        ok = np.ones(want[name].shape, bool)
        for rms in applied:
            ok &= rms[name] >= RESOLVED
        shares[name] = round(float(ok.mean()), 3)
        if name.startswith(("mlp.", "temporal.Self_v.")):
            assert ok.mean() > 0.5, (name, ok.mean())
        np.testing.assert_allclose(got[name][ok], want[name][ok], rtol=0,
                                   atol=atol, err_msg=name)
    print("parameter share compared:", shares)


def _assert_grads_close(js, ps):
    """One step's gradient: the whole gradient within 1e-4 of JAX's in
    relative norm (the batched steps differ by ~1e-5: group advantages over
    close rewards scale up fp32 rounding of the log-probs), and every leaf
    with a gradient (all but the key bias, whose exact gradient is 0 and
    both sides hold rounding noise) at cosine >= 0.9999 to JAX's and within
    1e-2 of its norm.  The query/key gradients are 1e-5 to 2e-4 of the
    largest and differ by up to ~3e-3 of their own norm: fp32 rounding
    through the attention softmax, which the cosine bounds without letting
    a wrong direction or scale through."""
    want, got = js["grads"], ps["grads"]
    assert set(got) == set(want)
    flat = {k: np.concatenate([d[n].ravel() for n in sorted(want)]).astype(np.float64)
            for k, d in (("want", want), ("got", got))}
    assert np.linalg.norm(flat["got"] - flat["want"]) <= \
        1e-4 * np.linalg.norm(flat["want"])
    for name in want:
        a, b = got[name].ravel().astype(np.float64), want[name].ravel().astype(np.float64)
        if name == "temporal.Self_k.bias" or not b.any():
            continue
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
        assert cos >= 0.9999, (name, cos)
        assert np.linalg.norm(a) == pytest.approx(np.linalg.norm(b), rel=1e-2), name


def _assert_metrics_close(m, jm):
    for key in ("loss", "grad_norm"):
        assert m[key] == pytest.approx(jm[key], rel=1e-5, abs=1e-7), key
    for key in ("reward", "reward_std", "score_tau"):
        assert m[key] == jm[key], key


def test_train_step_matches_jax_over_four_steps(data, tmp_path, record):
    root, general, specific, pool = data
    jt, pt = _pair(root, pool, tmp_path)
    for i, row in enumerate([specific, general, specific, general]):
        jm, m = jt.train_step(row), pt.train_step(row)
        jt.step += 1
        pt.step += 1
        js, ps = record["jax"][i], record["port"][i]
        np.testing.assert_array_equal(ps["indices"], js["indices"])
        np.testing.assert_array_equal(ps["rewards"], js["rewards"])
        _assert_grads_close(js, ps)
        _assert_metrics_close(m, jm)
        assert set(m) == set(jm)
        for key in m:
            if key.startswith("rewards/") or key in ("ts_length", "type",
                                                     "completion_length"):
                assert m[key] == jm[key], key
        _assert_params_close(jt, pt, record["applied"])
    kinds = [r["rewards"].std() > 0 for r in record["port"]]
    assert kinds[0] and kinds[2]                # the specific steps learn


def test_train_step_batch_matches_jax_over_mixed_types(data, tmp_path, record):
    root, general, specific, pool = data
    jt, pt = _pair(root, pool, tmp_path, {"grad_accum": 1})
    rows = [general, specific]
    jm, m = jt.train_step_batch(rows), pt.train_step_batch(rows)
    js, ps = record["jax"][0], record["port"][0]
    np.testing.assert_array_equal(ps["indices"], js["indices"])
    assert (ps["indices"][0, :, 4:] == 0).all()  # general: K/2, 0-padded
    np.testing.assert_array_equal(ps["rewards"], js["rewards"])
    _assert_grads_close(js, ps)
    _assert_metrics_close(m, jm)
    assert m["batch"] == 2
    _assert_params_close(jt, pt, record["applied"])


def test_checkpoint_round_trip_prune_and_resume(data, tmp_path):
    root, general, specific, pool = data
    _, pt = _pair(root, pool, tmp_path, {"save_every": 1, "save_total_limit": 2})
    pt.dataset = [general, specific]
    history = pt.train(max_steps=3)
    assert len(history) == 3
    out = pt.output_dir
    assert list_checkpoints(out) == [2, 3]                 # pruned to 2
    with open(pt.metrics_path) as f:
        assert [json.loads(line)["step"] for line in f] == [0, 1, 2]
    step, sel_sd, opt = load_train_state(out, pt.scorer.selector)
    assert step == 3 and opt["mini_step"] == 1 and opt["step"] == 1
    for name, p in pt.scorer.selector.named_parameters():
        np.testing.assert_array_equal(sel_sd[name], p.detach().numpy())

    _, fresh = _pair(root, pool, tmp_path / "fresh")
    assert fresh.resume_from(out) == 3 and fresh.step == 3
    want, got = optimizer_state(pt.optimizer, pt.scorer.selector), \
        optimizer_state(fresh.optimizer, fresh.scorer.selector)
    assert (got["step"], got["mini_step"]) == (want["step"], want["mini_step"])
    for group in ("exp_avg", "exp_avg_sq", "acc_grads"):
        for name in want[group]:
            np.testing.assert_array_equal(got[group][name], want[group][name])
    for (_, a), (_, b) in zip(pt.scorer.selector.named_parameters(),
                              fresh.scorer.selector.named_parameters()):
        assert torch.equal(a, b)


def test_jax_checkpoint_resumes_in_the_port(data, tmp_path, record):
    """Three JAX steps at grad_accum 2 (mid-accumulation), a JAX
    ``checkpoint-3.npz``; the port resumes from it and its fourth step
    equals JAX's.  Neither package checkpoints the host RNG, so the test
    hands the JAX trainer's over for the fourth step's needle composite."""
    root, general, specific, pool = data
    jt, _ = _pair(root, pool, tmp_path)
    for row in (specific, general, specific):
        jt.train_step(row)
        jt.step += 1
    jt.save_checkpoint()
    _, pt = _pair(root, pool, tmp_path / "p", noise_skip=3)
    assert pt.resume_from(jt.output_dir) == 3
    assert pt.optimizer.mini_step == 1
    _assert_params_close(jt, pt, [], atol=0)
    pt._np_rng.bit_generator.state = jt._np_rng.bit_generator.state
    before = _params(jt, pt)[1]
    jm, m = jt.train_step(specific), pt.train_step(specific)
    np.testing.assert_array_equal(record["port"][-1]["indices"],
                                  record["jax"][-1]["indices"])
    _assert_metrics_close(m, jm)
    assert pt.optimizer.mini_step == 0         # the 4th call applied the mean
    _assert_params_close(jt, pt, record["applied"])
    assert any(not np.array_equal(before[n], p) for n, p in _params(jt, pt)[1].items())


def test_export_merged_loads_in_the_jax_package(data, tmp_path):
    root, general, specific, pool = data
    _, pt = _pair(root, pool, tmp_path)
    pt.train_step(specific)
    pt.train_step(general)                 # grad_accum 2: the selector moved
    path = pt.export_merged(str(tmp_path / "merged"))
    js = JScorer.load(path, clip_cfg=JCLIP_CFG, selector_cfg=JSEL_CFG,
                      dtype=jnp.float32, tokenize=_tokenize, batch_frames=32,
                      frame_buckets=BUCKETS)
    frames = np.random.default_rng(0).integers(0, 256, (40, 48, 48, 3), np.uint8)
    want = js(frames, "when?", sample_num=8)
    got = pt.scorer(frames, "when?", sample_num=8)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(got[0], want[0])


def test_cli_trains_two_steps_on_the_cpu(data, tmp_path):
    from tspo_tpu_torch.cli import train as train_cli
    root, general, specific, pool = data
    jsonl = tmp_path / "rows.jsonl"
    jsonl.write_text("\n".join(json.dumps(r) for r in (general, specific)) + "\n")
    out = tmp_path / "out"
    train_cli.main(["--jsonl-path", str(jsonl), "--video-folder", str(root),
                    "--tiny", "--backbone", "stub", "--device", "cpu",
                    "--max-steps", "2", "--num-generations", "2",
                    "--training-sample-len", "4", "--window-size", "4",
                    "--output-dir", str(out), "--export-merged",
                    str(tmp_path / "merged")])
    lines = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
    assert [m["step"] for m in lines] == [0, 1]
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for m in lines)
    assert list_checkpoints(str(out)) == [2]
    assert os.path.exists(tmp_path / "merged" / "tspo_params.npz")


def test_batched_train_matches_the_jax_cli_loop(data, tmp_path, record):
    """``train(batch_size=2)`` against the JAX CLI's batched loop at one
    epoch over three rows: ceil(3 / 2) = 2 steps over the same rows in the
    same order, the same indices, rewards and metrics, one metrics line a
    step and the final checkpoint."""
    from argparse import Namespace

    from tspo_tpu.cli import train as jcli
    root, general, specific, pool = data
    jt, pt = _pair(root, pool, tmp_path, {"grad_accum": 1, "num_train_epochs": 1})
    jt.dataset = pt.dataset = [general, specific, specific]
    jh = jcli._train_batched(jt, Namespace(batch_size=2, max_steps=CFG_KW["max_steps"],
                                           mesh_data=0))
    h = pt.train(batch_size=2)
    assert len(h) == len(jh) == 2 and pt.step == jt.step == 2
    for i, (m, jm) in enumerate(zip(h, jh)):
        np.testing.assert_array_equal(record["port"][i]["indices"],
                                      record["jax"][i]["indices"])
        np.testing.assert_array_equal(record["port"][i]["rewards"],
                                      record["jax"][i]["rewards"])
        _assert_grads_close(record["jax"][i], record["port"][i])
        _assert_metrics_close(m, jm)
        assert set(m) - {"time"} == set(jm) and m["batch"] == jm["batch"] == 2
        assert m["step"] == jm["step"] == i
    _assert_params_close(jt, pt, record["applied"])
    for out in (pt.output_dir, jt.output_dir):
        with open(os.path.join(out, "metrics.jsonl")) as f:
            assert [json.loads(line)["step"] for line in f] == [0, 1]
        assert list_checkpoints(out) == [2]


def test_cli_batched_epoch_matches_the_jax_cli(data, tmp_path, monkeypatch):
    """``tspo-torch-train --batch-size 2 --num-train-epochs 1`` plans and
    takes the JAX CLI's steps over three rows, with its tau schedule and
    metric keys (the packages' random tiny weights differ, so the losses
    do)."""
    from tspo_tpu.cli import common as jcommon
    from tspo_tpu.cli import train as jcli
    from tspo_tpu_torch.cli import train as train_cli
    root, general, specific, _ = data
    jsonl = tmp_path / "rows.jsonl"
    jsonl.write_text("\n".join(json.dumps(r) for r in (general, specific, general))
                     + "\n")
    monkeypatch.setattr(jcommon, "enable_compilation_cache", lambda: None)
    args = ["--jsonl-path", str(jsonl), "--video-folder", str(root), "--tiny",
            "--backbone", "stub", "--batch-size", "2", "--num-train-epochs", "1",
            "--num-generations", "2", "--training-sample-len", "4",
            "--window-size", "4"]
    jcli.main(args + ["--output-dir", str(tmp_path / "jax")])
    train_cli.main(args + ["--output-dir", str(tmp_path / "port"), "--device", "cpu"])
    lines = {}
    for side in ("jax", "port"):
        text = (tmp_path / side / "metrics.jsonl").read_text()
        lines[side] = [json.loads(x) for x in text.splitlines()]
        assert list_checkpoints(str(tmp_path / side)) == [2]
    assert [m["step"] for m in lines["port"]] == [m["step"] for m in lines["jax"]] == [0, 1]
    for m, jm in zip(lines["port"], lines["jax"]):
        assert set(m) - {"time"} == set(jm)
        assert (m["score_tau"], m["batch"]) == (jm["score_tau"], jm["batch"])
        assert np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])


# -- batched rollouts through a tiny LLaVA backbone --------------------------

def _letter_decode(toks):
    """The tiny LLaVA's tokens as an option letter, so that rewards depend on
    what the backbone answers for each subset."""
    return "A" if toks and toks[0] % 2 == 0 else "B"


class Spy:
    """A backbone's calls, by method and rows, passed through to it."""

    def __init__(self, model):
        self.model, self.calls = model, []

    def generate(self, frames, question):
        self.calls.append(("generate", 1))
        return self.model.generate(frames, question)

    def generate_batch(self, frames_list, question):
        self.calls.append(("generate_batch", len(frames_list)))
        return self.model.generate_batch(frames_list, question)

    def generate_batch_multi(self, frames_list, questions):
        self.calls.append(("generate_batch_multi", len(frames_list)))
        return self.model.generate_batch_multi(frames_list, questions)


@pytest.fixture(scope="module")
def llava_pair():
    """The tiny fp32 LLaVA of test_torch_llava_video.py in both packages,
    answering in 2 tokens read as a letter."""
    from test_torch_llava_video import CFG as LCFG
    from test_torch_llava_video import JCFG as JLCFG
    from test_torch_llava_video import _encode, llava_state_dict
    from tspo_tpu.models import llava_video as jl
    from tspo_tpu_torch.models import llava_video as tl
    sd = llava_state_dict()
    jm = jl.LLaVAVideoModel.from_torch_checkpoint(
        sd, JLCFG, dtype=jnp.float32, encode=_encode, decode=_letter_decode,
        max_new_tokens=2)
    pm = tl.LLaVAVideoModel.from_torch_checkpoint(
        sd, LCFG, dtype=torch.float32, device="cpu", encode=_encode,
        decode=_letter_decode, batch_frames=16, max_new_tokens=2)
    return jm, pm


def _llava_pair(root, pool, out, llava_pair, cfg_kw):
    jt, pt = _pair(root, pool, out, cfg_kw)
    jt.backbone, pt.backbone = Spy(llava_pair[0]), Spy(llava_pair[1])
    return jt, pt


def test_train_step_takes_generate_batch_like_jax(data, tmp_path, record, llava_pair):
    """Both trainers answer a step's G subsets in one ``generate_batch`` call
    of the tiny LLaVA: the same indices, completions' rewards and gradients."""
    root, general, specific, pool = data
    jt, pt = _llava_pair(root, pool, tmp_path, llava_pair, {"grad_accum": 1})
    G = CFG_KW["num_generations"]
    for i, row in enumerate([specific, general]):
        jm, m = jt.train_step(row), pt.train_step(row)
        jt.step += 1
        pt.step += 1
        js, ps = record["jax"][i], record["port"][i]
        np.testing.assert_array_equal(ps["indices"], js["indices"])
        np.testing.assert_array_equal(ps["rewards"], js["rewards"])
        _assert_grads_close(js, ps)
        _assert_metrics_close(m, jm)
        assert m["completion_length"] == jm["completion_length"]
    assert pt.backbone.calls == jt.backbone.calls == [("generate_batch", G)] * 2
    assert any(r["rewards"].std() > 0 for r in record["port"])   # answers differ
    _assert_params_close(jt, pt, record["applied"])


def test_cross_batch_rollouts_match_jax(data, tmp_path, record, llava_pair):
    """``cross_batch_rollouts=True`` at batch size 2: one ragged
    ``generate_batch_multi`` call over the 2 x G rollouts (K=8 and 4 frames)
    in both trainers, with JAX's indices, rewards and gradients."""
    root, general, specific, pool = data
    jt, pt = _llava_pair(root, pool, tmp_path, llava_pair,
                         {"grad_accum": 1, "cross_batch_rollouts": True})
    rows = [specific, general]
    jm, m = jt.train_step_batch(rows), pt.train_step_batch(rows)
    js, ps = record["jax"][0], record["port"][0]
    np.testing.assert_array_equal(ps["indices"], js["indices"])
    np.testing.assert_array_equal(ps["rewards"], js["rewards"])
    _assert_grads_close(js, ps)
    _assert_metrics_close(m, jm)
    G = CFG_KW["num_generations"]
    assert pt.backbone.calls == jt.backbone.calls == [("generate_batch_multi", 2 * G)]
    # without the flag each sample takes its own generate_batch call
    jt2, pt2 = _llava_pair(root, pool, tmp_path / "b", llava_pair, {"grad_accum": 1})
    jt2.train_step_batch(rows), pt2.train_step_batch(rows)
    assert pt2.backbone.calls == jt2.backbone.calls == [("generate_batch", G)] * 2
