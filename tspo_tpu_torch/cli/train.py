"""Training CLI on the port, ``tspo-torch-train``: GRPO training of the
selector (counterpart of ``tspo_tpu/cli/train.py``).

  python -m tspo_tpu_torch.cli.train --jsonl-path data.jsonl \\
      --video-folder /videos --clip-path /ckpt/clip --backbone llava_video \\
      --backbone-path /ckpt/llava --num-generations 8 \\
      --training-sample-len 16 --window-size 12

Runs on the card (``--device cuda``, the default) and raises without one
unless given ``--device cpu``.  The JAX CLI's mesh and multi-host options,
orbax checkpoints, TensorBoard export and the int8 backbone are accepted by
the parser and raise: they are not ported yet (ROADMAP.md).  ``--batch-size
B`` takes B samples a step (``TSPOTrainer.train(batch_size=B)``), and with
``--cross-batch-rollouts`` answers all B x G rollouts of a step in one
ragged batched decode.
"""

from __future__ import annotations

import argparse

_QUEUE_6 = "not ported yet (ROADMAP.md Queue 1 item 6)"


def build_parser():
    p = argparse.ArgumentParser(description="TSPO GRPO training (PyTorch)")
    p.add_argument("--jsonl-path", default=None)
    p.add_argument("--toy-jsonl-path", default=None)
    p.add_argument("--video-folder", required=True)
    p.add_argument("--clip-path", default=None,
                   help="merged TSPO/CLIP checkpoint dir (random init if absent)")
    p.add_argument("--backbone", default="stub", choices=["stub", "llava_video"])
    p.add_argument("--backbone-path", default=None)
    p.add_argument("--quantize-backbone", action="store_true",
                   help="weight-only int8 decoder (not ported)")
    p.add_argument("--output-dir", default="output")
    p.add_argument("--reward-funcs", nargs="+", default=["accuracy", "temporal"])
    p.add_argument("--num-generations", type=int, default=8)
    p.add_argument("--training-sample-len", type=int, default=16)
    p.add_argument("--window-size", type=int, default=12)
    p.add_argument("--score-tau", type=float, default=0.025)
    p.add_argument("--learning-rate", type=float, default=5e-4)
    p.add_argument("--max-steps", type=int, default=1000)
    p.add_argument("--num-train-epochs", type=float, default=None,
                   help="plan the run (and the tau anneal horizon) as "
                        "epochs x dataset length like the reference "
                        "--num_train_epochs; --max-steps then only caps it")
    p.add_argument("--cross-batch-rollouts", action="store_true",
                   help="one ragged-prompt decode for all B x G rollouts of "
                        "a batched step")
    p.add_argument("--save-steps", type=int, default=100)
    p.add_argument("--save-total-limit", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiny", action="store_true",
                   help="tiny test config (CPU smoke runs)")
    p.add_argument("--batch-size", type=int, default=0,
                   help="samples per step; 0 = single-sample loop "
                        "(reference per-rank bs=1)")
    p.add_argument("--mesh-data", type=int, default=0,
                   help="data-parallel mesh size (not ported)")
    p.add_argument("--coordinator", default=None,
                   help="multi-host coordinator host:port (not ported)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--export-merged", default=None,
                   help="directory for the merged TSPO-0.4B export after training")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in --output-dir")
    p.add_argument("--ckpt-backend", default="npz", choices=("npz", "orbax"),
                   help="orbax is the JAX package's only")
    p.add_argument("--tensorboard", action="store_true",
                   help="TensorBoard event files (not ported)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a card)")
    return p


def _refuse_unported(args):
    if args.mesh_data or args.coordinator or args.num_processes is not None \
            or args.process_id is not None:
        raise NotImplementedError(f"mesh and multi-host training are {_QUEUE_6}")
    if args.ckpt_backend == "orbax":
        raise NotImplementedError(f"orbax checkpoints are {_QUEUE_6}")
    if args.tensorboard:
        raise NotImplementedError("TensorBoard export is not ported yet "
                                  "(ROADMAP.md Queue 1 item 7)")
    if args.quantize_backbone:
        raise NotImplementedError("the int8 backbone is not ported yet "
                                  "(ROADMAP.md Queue 1 item 5)")


def main(argv=None):
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    from ..configs import TrainConfig
    from ..train.trainer import TSPOTrainer
    from .common import load_backbone, load_jsonl, load_scorer

    jsonl = args.toy_jsonl_path or args.jsonl_path
    if not jsonl:
        raise SystemExit("need --jsonl-path or --toy-jsonl-path")
    dataset = load_jsonl(jsonl)

    cfg = TrainConfig(
        num_generations=args.num_generations,
        training_sample_len=args.training_sample_len,
        window_size=args.window_size, score_tau=args.score_tau,
        learning_rate=args.learning_rate, max_steps=args.max_steps,
        save_every=args.save_steps, save_total_limit=args.save_total_limit,
        ckpt_backend=args.ckpt_backend, seed=args.seed,
        num_train_epochs=args.num_train_epochs,
        cross_batch_rollouts=args.cross_batch_rollouts)

    scorer = load_scorer(args.clip_path, tiny=args.tiny, device=args.device)
    backbone = load_backbone(args.backbone, args.backbone_path, device=args.device)
    trainer = TSPOTrainer(
        scorer=scorer, backbone=backbone, dataset=dataset, cfg=cfg,
        video_folder=args.video_folder, irrelevant_pool=dataset,
        reward_funcs=tuple(args.reward_funcs), output_dir=args.output_dir,
        toy_example=bool(args.toy_jsonl_path))
    if args.resume:
        step = trainer.resume_from()
        print(f"resumed from step {step}")
    history = trainer.train(
        max_steps=None if args.num_train_epochs else args.max_steps,
        batch_size=args.batch_size)
    if args.export_merged:
        trainer.export_merged(args.export_merged)
    print(f"trained {len(history)} steps; "
          f"final reward {history[-1]['reward']:.3f}" if history else "no steps")


if __name__ == "__main__":
    main()
