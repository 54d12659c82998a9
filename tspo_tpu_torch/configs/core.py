"""Typed configs of the phase-1 scoring slice, as frozen dataclasses.

Copies of ``tspo_tpu/configs/core.py``'s ``SelectorConfig``, ``CLIPTextConfig``,
``CLIPVisionConfig``, ``CLIPConfig``, ``TrainConfig`` and ``PrecomputeConfig``,
with the same fields and defaults, so a checkpoint's geometry and a training
run's settings read the same on both sides.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class SelectorConfig:
    """MultiModalAlign selector head (reference model/temporal_agent.py:81-143)."""

    dim: int = 768
    num_heads: int = 8
    window_size: int = 12          # train/eval default (train_deepspeed.sh --window_size 12)
    score_tau: float = 0.025       # divided into the fused score (temporal_agent.py:141)
    mask_fill: float = -1e6        # additive mask value (temporal_agent.py:45)
    cosine_eps: float = 1e-6       # pair_cosine eps (temporal_agent.py:113)

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads


@dataclass(frozen=True)
class CLIPTextConfig:
    """openai/clip-vit-large-patch14 text tower."""

    vocab_size: int = 49408
    width: int = 768
    layers: int = 12
    heads: int = 12
    max_positions: int = 77
    projection_dim: int = 768
    eos_token_id: int = 49407
    layer_norm_eps: float = 1e-5


@dataclass(frozen=True)
class CLIPVisionConfig:
    """openai/clip-vit-large-patch14 vision tower."""

    width: int = 1024
    layers: int = 24
    heads: int = 16
    patch_size: int = 14
    image_size: int = 224
    projection_dim: int = 768
    layer_norm_eps: float = 1e-5

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def seq_len(self) -> int:
        return self.grid * self.grid + 1  # +1 class token


@dataclass(frozen=True)
class CLIPConfig:
    text: CLIPTextConfig = field(default_factory=CLIPTextConfig)
    vision: CLIPVisionConfig = field(default_factory=CLIPVisionConfig)
    logit_scale_init: float = 2.6592

    @classmethod
    def tiny(cls) -> "CLIPConfig":
        """Small config for parity tests and CPU smoke runs."""
        return cls(
            text=CLIPTextConfig(vocab_size=512, width=64, layers=2, heads=4,
                                max_positions=32, projection_dim=48, eos_token_id=511),
            vision=CLIPVisionConfig(width=96, layers=2, heads=4, patch_size=8,
                                    image_size=32, projection_dim=48),
        )


@dataclass(frozen=True)
class TrainConfig:
    """GRPO training loop (reference train_deepspeed.sh:14-39, tspo_trainer.py)."""

    num_generations: int = 8           # G (train_deepspeed.sh --num_generations 8)
    training_sample_len: int = 16      # frames selected per generation ("specific")
    window_size: int = 12
    score_tau: float = 0.025           # annealed linearly to tau_final
    score_tau_final: float = 0.01      # (tspo_trainer.py:496)
    learning_rate: float = 5e-4
    max_candidate_frames: int = 128    # 1-fps decode cap in training (tspo_trainer.py:457)
    needle_wrong_clips: int = 12       # distractor clips (tspo_trainer.py:471)
    needle_clip_len: int = 50          # frames per clip (tspo_trainer.py:465)
    max_completion_length: int = 256   # backbone generate cap (tspo_trainer.py:533)
    adv_eps: float = 1e-4              # advantage std eps (tspo_trainer.py:592)
    max_steps: int = 1000
    # when set, the planned run length is ceil(epochs * len(dataset)) like
    # the reference HF Trainer (--num_train_epochs 1, train_deepspeed.sh:38)
    # and tau anneals over exactly that span; max_steps then only caps it
    num_train_epochs: float | None = None
    # batch ALL B x G rollouts of a train_step_batch into ONE ragged-prompt
    # decode (backbone.generate_batch_multi; a backbone without it answers
    # each sample with its own generate_batch or generate calls)
    cross_batch_rollouts: bool = False
    seed: int = 0
    frame_bucket: int = 128            # padded candidate-frame bucket
    grad_accum: int = 2                # per-rank accumulation (train_deepspeed.sh)
    log_every: int = 1
    save_every: int = 100
    save_total_limit: int = 8
    ckpt_backend: str = "npz"          # "npz"; "orbax" is the JAX package's only


@dataclass(frozen=True)
class PrecomputeConfig:
    """Phase-1 frame-index precompute (reference mp_tools/vlmeval/vlm/gen_id_tspo.py)."""

    sample_num: int = 64
    window_size: int = 12
    max_frames: int = 50000            # 1-fps decode cap (gen_id_tspo.py:69)
    method: str = "topk"               # "bin-max" for VideoMME (gen_id_tspo.py:83)
    checkpoint_every: int = 100        # incremental result checkpointing (run_hzf.py:165)
    frame_buckets: tuple = (128, 256, 512, 1024, 2048, 4096, 8192)
    batch_frames: int = 256            # device batch for CLIP image encode
    # reuse a video's image features across its questions; outputs are
    # identical, only text encode + cosine + selector run per question
    share_video_features: bool = True
