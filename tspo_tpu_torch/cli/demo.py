"""Demo CLI on the port: score a long video with TSPO, select keyframes,
optionally answer with a backbone, and save the sampled-frame contact sheet.

  python -m tspo_tpu_torch.cli.demo --video path.mp4 --question "What happens?" \\
      --model-path /ckpt/TSPO-0.4B [--backbone llava_video --backbone-path ..]

Runs on the card (``--device cuda``, the default) and raises without one
unless given ``--device cpu``.  Checkpoint directories load in bf16.
"""

from __future__ import annotations

import argparse

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description="TSPO demo (PyTorch)")
    p.add_argument("--video", required=True)
    p.add_argument("--question", required=True)
    p.add_argument("--model-path", default=None)
    p.add_argument("--backbone", default=None, choices=[None, "stub", "llava_video"])
    p.add_argument("--backbone-path", default=None)
    p.add_argument("--conv-template", default=None,
                   help="conversation template (qwen_1_5, vicuna_v1, "
                        "chatml_direct, ... — models/conversation.py)")
    p.add_argument("--sample-num", type=int, default=64)
    p.add_argument("--window-size", type=int, default=12)
    p.add_argument("--method", default="topk",
                   choices=["topk", "bin-max", "aks"])
    p.add_argument("--max-candidates", type=int, default=50000)
    p.add_argument("--tiny", action="store_true",
                   help="tiny test config (CPU smoke runs)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a card)")
    p.add_argument("--contact-sheet", default="sampled_frames_TSPO.jpg")
    return p


def write_contact_sheet(path: str, frames: np.ndarray, idx) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    n = len(frames)
    ncols = int(np.ceil(np.sqrt(n)))
    nrows = int(np.ceil(n / ncols))
    fig, axes = plt.subplots(nrows, ncols, figsize=(ncols * 2, nrows * 1.5))
    for j, ax in enumerate(np.atleast_2d(axes).flat):
        ax.axis("off")
        if j < n:
            ax.imshow(frames[j])
            ax.set_title(str(int(idx[j])), fontsize=9, color="red")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ..video.reader import load_video
    from .common import load_backbone, load_scorer

    scorer = load_scorer(args.model_path, tiny=args.tiny, device=args.device)
    frames, _, video_time = load_video(args.video,
                                       max_frames_num=args.max_candidates,
                                       fps=1, min_frames_num=0)
    print(f"{len(frames)} candidate frames ({video_time:.0f}s video)")
    # demo cap: more than 600 candidates select at most 64
    sample_num = args.sample_num if len(frames) <= 600 else min(args.sample_num, 64)
    idx, _ = scorer(frames, args.question, sample_num=sample_num,
                    window_size=args.window_size, method=args.method)
    print(f"selected {len(idx)} frames: {list(map(int, idx))}")
    selected = frames[np.asarray(idx)]

    try:
        write_contact_sheet(args.contact_sheet, selected, idx)
        print(f"contact sheet -> {args.contact_sheet}")
    except ImportError as e:
        print(f"(no contact sheet: {e})")

    if args.backbone:
        backbone = load_backbone(args.backbone, args.backbone_path,
                                 device=args.device,
                                 conv_template=args.conv_template,
                                 max_frames_num=args.sample_num)
        answer = backbone.generate(selected, args.question)
        print(f"answer: {answer}")


if __name__ == "__main__":
    main()
