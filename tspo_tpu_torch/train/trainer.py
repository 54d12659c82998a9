"""GRPO trainer: the host loop of rollouts, rewards and selector updates.

Counterpart of ``tspo_tpu/train/trainer.py`` (reference
``LLaVAVideoTSPOTrainer.compute_loss``, tspo_trainer.py:434-640).  Per
sample:

  1. host: 1-fps decode (<= 128 frames); "specific" samples become
     needle-in-a-haystack composites with a ground-truth mask
  2. device: CLIP features once per sample (``vit_attention`` on the card)
  3. device: G Gumbel-top-k frame subsets from the selector logits
  4. host + device: the frozen backbone answers once per subset
     (``generate``: SigLIP, Qwen2 prefill through ``flash_attention``,
     greedy decode)
  5. host: rewards (accuracy / temporal / format) -> group advantages
  6. device: REINFORCE surrogate update of the selector only

Everything runs on the scorer's device: ``cuda`` unless the scorer was
built for the CPU.  The Gumbel draws come from a ``torch.Generator`` seeded
by ``cfg.seed`` on that device, or from ``noise_fn`` when given; the host
augmentation from ``np.random.default_rng(cfg.seed)``, as in the JAX
package.  The JAX package's mesh and multi-host steps are not ported.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..configs import TrainConfig
from ..models.tspo_model import TSPOScorer
from ..ops.masking import bucket_for
from ..video.augment import (repeat_videos, sample_real_frames, shuffle_clips,
                             shuffle_fixed_clips)
from ..video.reader import load_video
from .checkpoint import (ORBAX_UNPORTED, export_merged, load_train_state,
                         prune_checkpoints, save_train_state)
from .grpo import (TrainBatch, anneal_tau, load_optimizer_state, make_optimizer,
                   sample_subsets, selector_update_step)
from .rewards import (REWARD_REGISTRY, clean_question, compose_rewards,
                      extract_problem)

# the TRAINER appends the letter-answer instruction to the rollout question
# (tspo_trainer.py:487); backbone.generate wraps prompts without trailers
ANSWER_TRAILER = ("\nPlease answer with the option's letter from the given "
                  "choices directly.")

_MULTIHOST = ("mesh and multi-host training are not ported yet (ROADMAP.md "
              "Queue 1 item 6)")
CROSS_BATCH_UNPORTED = ("cross_batch_rollouts needs the backbone's "
                        "generate_batch_multi, not ported yet (ROADMAP.md "
                        "Queue 1 item 3)")


def _pad(x: torch.Tensor, bucket: int) -> torch.Tensor:
    """Zero-pad the leading axis to ``bucket``, in fp32."""
    x = x.float()
    return F.pad(x, (0, 0) * (x.dim() - 1) + (0, bucket - x.shape[0]))


@dataclass
class TSPOTrainer:
    scorer: TSPOScorer                      # CLIP (frozen) + selector (trains)
    backbone: object                        # generate(frames, question) -> str
    dataset: Sequence                       # jsonl rows (C15 schema)
    cfg: TrainConfig = field(default_factory=TrainConfig)
    video_folder: str = ""
    irrelevant_pool: Sequence | None = None  # distractor source rows
    reward_funcs: Sequence[str] = ("accuracy", "temporal")
    output_dir: str = "output"
    toy_example: bool = False
    metric_hook: Callable | None = None
    # (B, G, T) -> Gumbel noise of a step's draws; None draws from the
    # trainer's generator (tests pass the JAX package's draws)
    noise_fn: Callable | None = None
    mesh: object | None = None              # not ported: must stay None

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(_MULTIHOST)
        if self.cfg.ckpt_backend != "npz":
            raise NotImplementedError(ORBAX_UNPORTED)
        if self.cfg.cross_batch_rollouts:
            raise NotImplementedError(CROSS_BATCH_UNPORTED)
        self.device = self.scorer.device
        self.optimizer = make_optimizer(self.cfg, self.scorer.selector.parameters())
        self.step = 0
        self._generator = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        self._np_rng = np.random.default_rng(self.cfg.seed)
        self.metrics_path = os.path.join(self.output_dir, "metrics.jsonl")

    # ------------------------------------------------------------------
    # sample preparation (host)
    # ------------------------------------------------------------------

    def planned_steps(self, max_steps: int | None = None,
                      batch_size: int = 1) -> int:
        """Total steps the run is planned for, the anneal horizon: epochs x
        steps per epoch (ceil(len(dataset) / batch_size)) when epochs are
        configured (capped by max_steps), else min(max_steps, len(dataset))
        (HF Trainer's ``state.max_steps``, tspo_trainer.py:496)."""
        if max_steps is not None:
            return max_steps
        cfg = self.cfg
        if cfg.num_train_epochs:
            per_epoch = -(-len(self.dataset) // batch_size)
            n = int(np.ceil(cfg.num_train_epochs * per_epoch))
            return min(n, cfg.max_steps) if cfg.max_steps else n
        return min(cfg.max_steps, len(self.dataset))

    def _tau(self) -> float:
        """Anneal over the planned run length: ``total_steps`` is pinned by
        train(); a caller that steps the trainer itself may set it, else it
        derives from the dataset and config."""
        total = getattr(self, "total_steps", None) or self.planned_steps()
        return anneal_tau(self.step, total, self.cfg.score_tau,
                          self.cfg.score_tau_final)

    def prepare_sample(self, row: dict):
        """Decode + augment one sample; returns (video, mask, problem,
        question, sample_len, sample_type)."""
        sample_type = row.get("type", "general")
        problem = extract_problem(row["original_question"])
        question = clean_question(row["original_question"])
        path = os.path.join(self.video_folder, row["video"])
        video, _, _ = load_video(path, max_frames_num=self.cfg.max_candidate_frames,
                                 fps=1, force_sample=False)
        if sample_type == "specific":
            # needle-in-a-haystack composite (tspo_trainer.py:462-480)
            if self.toy_example:
                # fixed layout + cached distractors (tspo_trainer.py:463-467)
                true_clips = repeat_videos(video, repeat_times=1,
                                           sample_len=self.cfg.needle_clip_len,
                                           rng=self._np_rng)
                if not hasattr(self, "_fixed_wrong_clips"):
                    self._fixed_wrong_clips = [sample_real_frames(
                        self.irrelevant_pool, root=self.video_folder,
                        sample_num=len(true_clips[0]), target_h=video.shape[1],
                        target_w=video.shape[2], rng=self._np_rng)
                        for _ in range(self.cfg.needle_wrong_clips)]
                video, mask = shuffle_fixed_clips(true_clips,
                                                  self._fixed_wrong_clips)
                return (video, mask, problem, question,
                        self.cfg.training_sample_len, sample_type)
            true_clips = repeat_videos(
                video, repeat_times=int(self._np_rng.integers(1, 5)),
                sample_len=self.cfg.needle_clip_len, rng=self._np_rng)
            wrong_clips = [sample_real_frames(
                self.irrelevant_pool, root=self.video_folder,
                sample_num=len(true_clips[0]), target_h=video.shape[1],
                target_w=video.shape[2], rng=self._np_rng)
                for _ in range(self.cfg.needle_wrong_clips)]
            video, mask = shuffle_clips(true_clips, wrong_clips, rng=self._np_rng)
            sample_len = self.cfg.training_sample_len
        else:
            mask = np.ones(len(video), bool)
            sample_len = self.cfg.training_sample_len // 2
        return video, mask, problem, question, sample_len, sample_type

    def features(self, video, problem):
        """CLIP features of one sample as ordinary tensors: the scorer
        computes them under ``torch.inference_mode``, whose tensors cannot
        be saved for backward; the clones can."""
        return tuple(x.clone() for x in self.scorer.extract_features(video, problem))

    def _batch(self, feats) -> TrainBatch:
        """Stack per-sample (img, txt, csc) features into one padded fp32
        batch at the bucket of the longest."""
        bucket = bucket_for(max(int(f[0].shape[0]) for f in feats),
                            self.scorer.frame_buckets)
        rows = torch.arange(bucket, device=self.device)
        return TrainBatch(
            frame_feat=torch.stack([_pad(img, bucket) for img, _, _ in feats]),
            text_feat=torch.stack([txt.float().reshape(1, -1) for _, txt, _ in feats]),
            clip_scores=torch.stack([_pad(csc, bucket) for _, _, csc in feats]),
            valid=torch.stack([rows < img.shape[0] for img, _, _ in feats]))

    def _sample(self, batch: TrainBatch, tau: float, sample_len: int, k_len=None):
        B, T = batch.valid.shape
        noise = (None if self.noise_fn is None else
                 self.noise_fn((B, self.cfg.num_generations, T)))
        return sample_subsets(self.scorer.selector, batch, tau,
                              num_generations=self.cfg.num_generations,
                              sample_len=sample_len,
                              window_size=self.cfg.window_size, k_len=k_len,
                              generator=self._generator, noise=noise)

    def _update(self, batch, subsets, rewards: np.ndarray, tau: float) -> dict:
        return selector_update_step(
            self.scorer.selector, self.optimizer, batch, subsets,
            torch.as_tensor(rewards, device=self.device), tau,
            train_cfg=self.cfg, window_size=self.cfg.window_size)

    def _completions(self, video, idx_g, question: str) -> list:
        """One answer per subset, one ``generate`` after another (the JAX
        trainer's fallback when the backbone has no ``generate_batch``)."""
        gen_q = question + ANSWER_TRAILER
        return [self.backbone.generate(video[idx], gen_q) for idx in idx_g]

    def _rewards(self, row, completions, idx_g, mask) -> np.ndarray:
        """[G, n_funcs] rewards of one sample (tspo_trainer.py:557-573)."""
        G = self.cfg.num_generations
        per_func = np.zeros((G, len(self.reward_funcs)), np.float32)
        for j, name in enumerate(self.reward_funcs):
            per_func[:, j] = REWARD_REGISTRY[name](
                completions=completions, solution=[row.get("solution", "")] * G,
                sel_idxs=list(idx_g), total_mask=mask)
        return per_func

    # ------------------------------------------------------------------
    # one training step
    # ------------------------------------------------------------------

    def train_step(self, row: dict) -> dict:
        cfg = self.cfg
        video, mask, problem, question, sample_len, sample_type = \
            self.prepare_sample(row)
        tau = self._tau()

        # CLIP features once per sample (tspo_trainer.py:497-498)
        img, txt, csc = self.features(video, problem)
        batch = self._batch([(img, txt, csc)])

        # G stochastic subsets (device), then frozen rollouts
        subsets = self._sample(batch, tau, sample_len)
        idx_g = subsets.indices[0].cpu().numpy()                 # [G, K]
        completions = self._completions(video, idx_g, question)
        rewards_per_func = self._rewards(row, completions, idx_g, mask)
        rewards = compose_rewards(rewards_per_func, sample_type)  # [G]

        # device update (REINFORCE surrogate, group baseline)
        dev_metrics = self._update(batch, subsets, rewards[None], tau)
        metrics = {
            "step": self.step,
            "loss": float(dev_metrics["loss"]),
            "grad_norm": float(dev_metrics["grad_norm"]),
            "reward": float(rewards.mean()),
            "reward_std": float(rewards.std()),
            "ts_length": float(idx_g.shape[1]),
            "completion_length": float(np.mean([len(c) for c in completions])),
            "score_tau": tau,
            "type": sample_type,
        }
        for j, name in enumerate(self.reward_funcs):
            metrics[f"rewards/{name}_reward"] = float(rewards_per_func[:, j].mean())

        if self.toy_example:
            pred = self.scorer.score(img, txt, csc, window_size=cfg.window_size,
                                     score_tau=tau)
            self._toy_artifacts(video, idx_g, rewards_per_func,
                                csc.float().cpu().numpy(), pred * tau,
                                sample_type)
        return metrics

    # ------------------------------------------------------------------
    # batched step (B samples, types may mix)
    # ------------------------------------------------------------------

    def _rollout_rewards(self, rows, prepared, idx_bg, k_lens) -> np.ndarray:
        """Frozen-backbone rollouts + reward fan-out.  idx_bg [B, G, K]
        (0-padded past k_lens[b]); returns rewards [B, G]."""
        rewards = np.zeros((len(rows), self.cfg.num_generations), np.float32)
        for b, (row, (video, mask, _, question, _, stype)) in enumerate(
                zip(rows, prepared)):
            idx_g = [idx[:k_lens[b]] for idx in idx_bg[b]]
            completions = self._completions(video, idx_g, question)
            rewards[b] = compose_rewards(
                self._rewards(row, completions, idx_g, mask), stype)
        return rewards

    def train_step_batch(self, rows: Sequence[dict]) -> dict:
        """One update over B samples (types may mix): the reference's one
        sample per DeepSpeed rank, gathered on one card."""
        prepared = [self.prepare_sample(r) for r in rows]
        tau = self._tau()
        k_lens = np.asarray([p[4] for p in prepared], np.int64)
        batch = self._batch([self.features(video, problem)
                             for video, _, problem, _, _, _ in prepared])
        subsets = self._sample(batch, tau, int(k_lens.max()), k_len=k_lens)
        idx_bg = subsets.indices.cpu().numpy()                  # [B, G, K]
        rewards = self._rollout_rewards(rows, prepared, idx_bg, k_lens)
        dev_metrics = self._update(batch, subsets, rewards, tau)
        return {"step": self.step, "loss": float(dev_metrics["loss"]),
                "grad_norm": float(dev_metrics["grad_norm"]),
                "reward": float(rewards.mean()),
                "reward_std": float(rewards.std()),
                "batch": len(rows), "score_tau": tau}

    def train_step_batch_global(self, rows_local, global_mesh) -> dict:
        raise NotImplementedError(_MULTIHOST)

    # ------------------------------------------------------------------
    # loop, checkpoints, export
    # ------------------------------------------------------------------

    def train(self, max_steps: int | None = None, shuffle: bool = True,
              batch_size: int = 0) -> list:
        """The training loop.  ``batch_size`` 0 takes one sample a step
        (``train_step``, the reference's per-rank bs=1); ``batch_size`` B > 0
        takes B samples a step (``train_step_batch``), as the JAX CLI's
        batched loop does, and draws its order from a fresh
        ``default_rng(cfg.seed)``, so the augmentation stream is not
        consumed by it."""
        B = max(batch_size, 1)
        max_steps = self.planned_steps(max_steps, B)
        # pin the anneal horizon to this run's end, resumed or not
        self.total_steps = self.step + max_steps
        rng = np.random.default_rng(self.cfg.seed) if batch_size else self._np_rng
        n = len(self.dataset)
        order = rng.permutation(n) if shuffle else np.arange(n)
        os.makedirs(self.output_dir, exist_ok=True)
        history = []
        t0 = time.time()
        for i in range(max_steps):
            rows = [self.dataset[int(order[(i * B + j) % n])] for j in range(B)]
            metrics = (self.train_step_batch(rows) if batch_size
                       else self.train_step(rows[0]))
            metrics["time"] = round(time.time() - t0, 2)
            history.append(metrics)
            with open(self.metrics_path, "a") as f:
                f.write(json.dumps(metrics) + "\n")
            if self.metric_hook:
                self.metric_hook(metrics)
            self.step += 1
            if self.step % self.cfg.save_every == 0:
                self.save_checkpoint()
        self.save_checkpoint()
        return history

    def save_checkpoint(self):
        save_train_state(self.output_dir, self.step, self.scorer.selector,
                         self.optimizer)
        prune_checkpoints(self.output_dir, self.cfg.save_total_limit)

    def resume_from(self, directory: str | None = None,
                    step: int | None = None) -> int:
        """Restore selector parameters, optimizer state and step from the
        latest (or given) checkpoint of either package; returns the step."""
        sel = self.scorer.selector
        step, sel_sd, opt = load_train_state(directory or self.output_dir, sel,
                                             step)
        with torch.no_grad():
            for name, p in sel.named_parameters():
                p.copy_(torch.as_tensor(sel_sd[name]))
        if opt is not None:
            load_optimizer_state(self.optimizer, sel, opt)
        self.step = step
        return step

    def export_merged(self, directory: str):
        """Standalone TSPO-0.4B export (merge_weights.py equivalent)."""
        return export_merged(directory, self.scorer)

    # ------------------------------------------------------------------

    def _toy_artifacts(self, video, idx_g, rewards_per_func, clip_scores,
                       pred_scores, sample_type):
        """Contact sheet of the last sampled subset + smoothed pred score
        curve (tspo_trainer.py:575-585, trainer/utils.py:265-329); nothing
        without matplotlib and scipy."""
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            from scipy.ndimage import gaussian_filter1d
        except ImportError:
            return
        out = os.path.join(self.output_dir, f"save_image_{sample_type}")
        os.makedirs(out, exist_ok=True)
        idx = idx_g[-1]
        sel = video[idx]
        n = len(sel)
        ncols = int(np.ceil(np.sqrt(n)))
        nrows = int(np.ceil(n / ncols))
        fig, axes = plt.subplots(nrows, ncols, figsize=(ncols * 2, nrows * 1.5))
        axes = np.atleast_2d(axes)
        for j in range(nrows * ncols):
            ax = axes.flat[j]
            ax.axis("off")
            if j < n:
                ax.imshow(sel[j])
                ax.set_title(str(int(idx[j])), fontsize=10, color="red")
        fig.savefig(os.path.join(out, f"sampled_frames_{self.step}.jpg"),
                    dpi=120, bbox_inches="tight")
        plt.close(fig)

        fig = plt.figure(figsize=(5, 2.5))
        plt.plot(gaussian_filter1d(np.asarray(pred_scores, np.float32), 1.5),
                 label=f"Pred Score (Step {self.step})", color="#ff7f0e")
        title = f"Mean R_A: {rewards_per_func[:, 0].mean():.4f}"
        if sample_type == "specific" and rewards_per_func.shape[1] > 1:
            title += f"  Mean R_T: {rewards_per_func[:, 1].mean():.4f}"
        plt.title(title)
        plt.xlabel("Video Frame Index")
        plt.legend(loc="upper right")
        plt.grid(True, linestyle="--", alpha=0.5)
        fig.savefig(os.path.join(out, f"scores_{self.step}.jpg"), dpi=120,
                    bbox_inches="tight")
        plt.close(fig)
