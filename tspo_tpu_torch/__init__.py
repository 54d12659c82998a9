"""tspo_tpu_torch — the PyTorch/CUDA port of tspo_tpu for NVIDIA Hopper.

A second package beside ``tspo_tpu`` (the JAX reference), mirroring its
layout.  It imports torch and numpy, never JAX and nothing of ``tspo_tpu``.
Plain tensor code is PyTorch; each Pallas kernel of the JAX package on a
ported path becomes a hand-written Hopper kernel under ``csrc/``, built with
nvcc at first use.

Layer map of the ported slices (phase-1 scoring, the LLaVA-Video answer,
GRPO training of the selector):
  ops/       selection (top-k / bin-max / AKS / Gumbel top-k), masks,
             positional encoding, ``vit_attention`` and ``flash_attention``
             (each Hopper kernel's wrapper + plain version)
  models/    CLIP-L/14 towers, MultiModalAlign selector, TSPOScorer;
             SigLIP tower, Qwen2 decoder, conversation templates,
             LLaVAVideoModel
  video/     host-side decode (native C++ ffmpeg + cv2), feature cache,
             needle-in-a-haystack composites
  eval/      phase-1 frame-index precompute, dataset loaders
  train/     GRPO: subsets, surrogate loss, AdamW, rewards, checkpoints,
             ``TSPOTrainer``
  cli/       ``python -m tspo_tpu_torch.cli.precompute``, ``.cli.demo`` and
             ``.cli.train``
  tools/     where the time goes on the card (``profile_scoring``,
             ``profile_answer``)
  utils/     device choice, checkpoint helpers, the nvcc kernel build
  interop.py weights and optimizer state between the JAX package's trees
             and this package
"""

__version__ = "0.1.0"
