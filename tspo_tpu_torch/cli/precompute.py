"""Phase-1 CLI on the port: frame-index precompute in one command.

  python -m tspo_tpu_torch.cli.precompute --data LongVideoBench \\
      --tsv evaluation/data/LongVideoBench.tsv --video-root /videos \\
      --model-path /ckpt/TSPO-0.4B --anno-json evaluation/jsons/lvb_val.json \\
      --out-json evaluation/jsons_idx/TSPO_LongVideoBench_frameIdx.json

Runs on the card (``--device cuda``, the default) and raises without one
unless given ``--device cpu``.  ``--rank/--world`` shard the question list,
one checkpoint file per rank.
"""

from __future__ import annotations

import argparse


def build_parser():
    p = argparse.ArgumentParser(description="TSPO frame-index precompute (PyTorch)")
    p.add_argument("--data", required=True,
                   help="LongVideoBench | MLVU | VideoMME | LVBench")
    p.add_argument("--tsv", required=True)
    p.add_argument("--video-root", required=True)
    p.add_argument("--model-path", default=None)
    p.add_argument("--name", default="TSPO")
    p.add_argument("--work-dir", default="work_dir")
    p.add_argument("--cache-root", default="feature_cache")
    p.add_argument("--sample-num", type=int, default=64)
    p.add_argument("--method", default="topk",
                   choices=["topk", "bin-max", "aks"],
                   help="selection method (VideoMME auto-switches to bin-max)")
    p.add_argument("--window-size", type=int, default=12)
    p.add_argument("--max-frames", type=int, default=50000)
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--world", type=int, default=1)
    p.add_argument("--rerun", action="store_true")
    p.add_argument("--no-share-video-features", action="store_true",
                   help="disable the video-level image-feature reuse across "
                        "a video's questions (outputs are identical either way)")
    p.add_argument("--decode-workers", type=int, default=1,
                   help=">1 decodes videos concurrently through the native "
                        "C++ pool (see video/native.py)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny test config (CPU smoke runs)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a card)")
    p.add_argument("--anno-json", default=None)
    p.add_argument("--out-json", default=None)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ..configs import PrecomputeConfig
    from ..eval.datasets import VideoQuestionDataset, load_json
    from ..eval.precompute import FrameIndexPrecompute
    from ..video.cache import FeatureCache
    from .common import load_scorer

    scorer = load_scorer(args.model_path, tiny=args.tiny, device=args.device)
    ds = VideoQuestionDataset.from_tsv(args.data, args.tsv, args.video_root)
    shard = (args.rank, args.world)
    pre = FrameIndexPrecompute(
        scorer, FeatureCache(args.cache_root),
        PrecomputeConfig(sample_num=args.sample_num,
                         window_size=args.window_size,
                         max_frames=args.max_frames, method=args.method,
                         share_video_features=not args.no_share_video_features),
        work_dir=args.work_dir, name=args.name,
        decode_workers=args.decode_workers)
    done = []
    results = pre.run(ds, shard=shard, rerun=args.rerun,
                      progress=lambda qid: done.append(qid) or (
                          len(done) % 25 == 0 and print(f"{len(done)} done")))
    print(f"{len(results)} questions scored -> "
          f"{pre._supp_path(args.data, shard)}")
    errs = pre.load_errors(args.data, shard)
    if errs:
        print(f"{len(errs)} questions FAILED (see "
              f"{pre._errors_path(args.data, shard)}): "
              + ", ".join(list(errs)[:5]) + ("..." if len(errs) > 5 else ""))
    if args.anno_json and args.out_json:
        merged = pre.emit_frame_idx_json(args.data, load_json(args.anno_json),
                                         args.out_json)
        with_idx = sum("frame_idx" in r for r in merged)
        print(f"wrote {args.out_json} ({with_idx}/{len(merged)} with frame_idx)")


if __name__ == "__main__":
    main()
