"""Phase-2 CLI on the port, ``tspo-torch-evaluate`` (counterpart of
``tspo_tpu/cli/evaluate.py``): a backbone over precomputed frame indices.

  python -m tspo_tpu_torch.cli.evaluate --task LongVideoBench \\
      --frame-idx-json evaluation/jsons_idx/TSPO_LongVideoBench_frameIdx.json \\
      --video-root /videos --backbone llava_video --backbone-path /ckpt \\
      --max-frames-num 64 --output results/

Baseline (uniform sampling, no TSPO): add --uniform.  ``--batch B`` answers
B consecutive questions in one ragged batched decode.

Runs on the card (``--device cuda``, the default) and raises without one
unless given ``--device cpu``.  The JAX CLI's multi-host options, speculative
decoding, the int8 backbone, W&B logging, ``--judge`` and the LLM-judged task
families are accepted by the parser and raise: they are not ported yet
(ROADMAP.md).  The judge-free defaults those families register at import
time (TempCompass, TOMATO, VITATECS, PLM-fgqa, PLM-rtloc) run.  The output
JSON and JSONL files have the JAX CLI's names and keys.
"""

from __future__ import annotations

import argparse
import json
import os
import time

_QUEUE = "not ported yet (ROADMAP.md Queue 1 item {})"


def build_parser():
    p = argparse.ArgumentParser(description="TSPO benchmark evaluation (PyTorch)")
    p.add_argument("--task", default=None,
                   help="LongVideoBench | MLVU | VideoMME | LVBench | ... "
                        "(eval/tasks.py TASK_REGISTRY; required unless "
                        "--config is given)")
    p.add_argument("--frame-idx-json", default=None)
    p.add_argument("--config", default=None,
                   help="yaml of one run dict or a list of run dicts, each "
                        "mapping CLI flag names to values (reference "
                        "lmms-eval --config, __main__.py:86-108); entries "
                        "override the flags on the command line and runs "
                        "execute sequentially")
    p.add_argument("--video-root", default="")
    p.add_argument("--backbone", default="stub", choices=["stub", "llava_video"])
    p.add_argument("--backbone-path", default=None)
    p.add_argument("--speculative", action="store_true",
                   help="prompt-lookup speculative decoding (not ported)")
    p.add_argument("--quantize-backbone", action="store_true",
                   help="weight-only int8 decoder (not ported)")
    p.add_argument("--max-frames-num", type=int, default=64)
    p.add_argument("--batch", type=int, default=1,
                   help="co-decode B consecutive questions through the "
                        "backbone's ragged generate_batch_multi (single-row "
                        "decode reads every weight once a token; B rows "
                        "share that read)")
    p.add_argument("--uniform", action="store_true",
                   help="uniform-sampling baseline (is_uniform=True)")
    p.add_argument("--live-model-path", default=None,
                   help="TSPO scorer for single-phase live frame selection "
                        "(docs without frame_idx)")
    p.add_argument("--live-method", default="topk",
                   choices=["topk", "bin-max", "aks"])
    p.add_argument("--subtitle-root", default=None,
                   help="directory of .srt (VideoMME-subtitles) or per-doc "
                        "subtitle jsons (LongVideoBench-interleaved)")
    p.add_argument("--pre-prompt", default=None,
                   help="override the task's lmms_eval_specific_kwargs "
                        "pre_prompt (yaml default otherwise)")
    p.add_argument("--post-prompt", default=None,
                   help="override the task's lmms_eval_specific_kwargs "
                        "post_prompt (yaml default otherwise)")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--coordinator", default=None,
                   help="multi-host coordinator address host:port (not ported)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--world", type=int, default=1)
    p.add_argument("--output", default="eval_results")
    p.add_argument("--log-samples", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="--no-log-samples writes metrics only")
    p.add_argument("--judge", default=None,
                   help="LLM-judge provider for judged tasks (not ported)")
    p.add_argument("--conv-template", default=None,
                   help="conversation template for the llava_video backbone "
                        "(qwen_1_5 default; vicuna_v1/chatml_direct/... — "
                        "models/conversation.py)")
    p.add_argument("--plm-stc-metadata", default=None,
                   help="PLM-VideoBench STC masklet metadata_test.jsonl "
                        "(bbox overlays for PLM-rtloc)")
    p.add_argument("--megabench-submission", default=None,
                   help="MEGABench-*: reference-submission-format json "
                        "(not ported)")
    p.add_argument("--wandb-args", default=None,
                   help="comma-separated wandb.init kwargs (not ported)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a card)")
    return p


# judged-task families: task-name prefixes -> (eval module, registrar), as in
# the JAX CLI.  The port has the modules of the families whose judge-free
# defaults it runs; a judged run of any family is not ported.
JUDGED_TASK_REGISTRARS = (
    (("ActivityNet-QA",), "tasks_activitynet", "register_activitynetqa"),
    (("VideoChatGPT",), "videochatgpt", "register_videochatgpt"),
    (("MovieChat", "VideoDetailDescription"), "more_judged_tasks",
     "register_more_judged"),
    (("VideoEvalPro",), "extra_tasks", "register_extra_tasks"),
    (("TempCompass",), "tempcompass", "register_tempcompass"),
    (("TOMATO",), "tomato_vinoground", "register_tomato_vinoground"),
    (("WorldQA", "CVRR"), "worldqa_cvrr", "register_worldqa_cvrr"),
    (("VDC",), "vdc", "register_vdc"),
    (("EgoThink",), "egothink", "register_egothink"),
    (("VITATECS",), "vitatecs", "register_vitatecs"),
    (("MixEvals",), "mix_evals", "register_mix_evals"),
    (("MMVU",), "mmvu", "register_mmvu"),
    (("PLM-",), "plm_videobench", "register_plm_videobench"),
    (("FunQA",), "funqa", "register_funqa"),
    (("CAPability",), "capability", "register_capability"),
    (("MEGABench",), "megabench", "register_megabench"),
)
# the judge-free rule-based registrations the port runs without --judge
# (reference defaults: tomato USE_GPT_PARSER=False, tempcompass rule-first;
# PLM-fgqa/PLM-rtloc are rule-scored).  MEGABench-core waits with its family
_RULE_ONLY_WITHOUT_JUDGE = ("TempCompass", "TOMATO", "VITATECS",
                            "PLM-fgqa", "PLM-rtloc")
JUDGED_UNPORTED = ("LLM-judged task families and --judge are "
                   + _QUEUE.format(8))


def _register_judged_task(args) -> None:
    import importlib
    for prefixes, mod_name, fn_name in JUDGED_TASK_REGISTRARS:
        if not args.task.startswith(prefixes):
            continue
        if args.judge is not None or not args.task.startswith(
                _RULE_ONLY_WITHOUT_JUDGE):
            raise NotImplementedError(f"{args.task}: {JUDGED_UNPORTED}")
        extra = {}
        if fn_name == "register_plm_videobench" and \
                getattr(args, "plm_stc_metadata", None):
            extra["stc_metadata"] = args.plm_stc_metadata
        # re-register the rule-only defaults explicitly: a prior --config
        # run may have installed another variant in the shared registry
        mod = importlib.import_module(f"tspo_tpu_torch.eval.{mod_name}")
        getattr(mod, fn_name)(None, **extra)
        return
    if args.judge is not None:
        raise NotImplementedError(JUDGED_UNPORTED)


def _refuse_unported(args):
    if args.coordinator or args.num_processes is not None \
            or args.process_id is not None:
        raise NotImplementedError(f"multi-host evaluation is {_QUEUE.format(6)}")
    if args.speculative:
        raise NotImplementedError(f"speculative decoding is {_QUEUE.format(3)}")
    if args.quantize_backbone:
        raise NotImplementedError(f"the int8 backbone is {_QUEUE.format(5)}")
    if args.wandb_args is not None:
        raise NotImplementedError(f"W&B logging is {_QUEUE.format(7)}")
    if args.megabench_submission:
        raise NotImplementedError(f"MEGABench submissions: {JUDGED_UNPORTED}")


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.config:
        # namespace-copy override like the reference (__main__.py:322-371):
        # one failing run logs and continues instead of killing the sweep
        import copy
        import yaml
        with open(args.config) as f:
            runs = yaml.safe_load(f)
        runs = runs if isinstance(runs, list) else [runs]
        for i, run in enumerate(runs):
            run_args = copy.copy(args)
            run_args.config = None
            for key, value in (run or {}).items():
                setattr(run_args, str(key).replace("-", "_"), value)
            print(f"[config] run {i + 1}/{len(runs)}: task={run_args.task}")
            try:
                _run(run_args)
            # SystemExit too: a misconfigured run reaches parser.error()
            except (Exception, SystemExit) as e:  # noqa: BLE001 — sweep keeps going
                import traceback
                traceback.print_exc()
                print(f"[config] run {i + 1} failed: {e}")
        return
    _run(args)


def _run(args):
    if not args.task or not args.frame_idx_json:
        build_parser().error(
            "--task and --frame-idx-json are required (or pass --config)")
    _refuse_unported(args)
    from ..eval.datasets import load_json
    from ..eval.harness import evaluate_task
    from ..utils.device import resolve_device
    from .common import load_backbone

    resolve_device(args.device)
    _register_judged_task(args)
    docs = load_json(args.frame_idx_json)
    # max_frames_num feeds the vicuna/yi rope-scaling override (factor is
    # derived from the frame budget — llava_vid_tspo.py:159-174)
    backbone = load_backbone(args.backbone, args.backbone_path,
                             device=args.device, conv_template=args.conv_template,
                             max_frames_num=args.max_frames_num)
    scorer = None
    if args.live_model_path:
        from .common import load_scorer
        scorer = load_scorer(args.live_model_path, device=args.device)
    t0 = time.time()
    done = []
    res = evaluate_task(
        args.task, docs, backbone, video_root=args.video_root,
        max_frames_num=args.max_frames_num, is_uniform=args.uniform,
        limit=args.limit, shard=(args.rank, args.world),
        log_samples=args.log_samples, scorer=scorer,
        live_method=args.live_method, batch_size=args.batch,
        specific_kwargs={k: v for k, v in
                         (("pre_prompt", args.pre_prompt),
                          ("post_prompt", args.post_prompt),
                          ("subtitle_root", args.subtitle_root),
                          ("video_root",
                           args.video_root if args.subtitle_root else None),
                          ("frame_num",
                           args.max_frames_num if args.subtitle_root else None))
                         if v is not None}
        or None,
        progress=lambda qid: done.append(qid) or (
            len(done) % 25 == 0 and print(f"{len(done)} done")))

    # one process: its shard is the whole result (the JAX CLI gathers the
    # shards of a multi-host run here; --rank/--world shards merge offline
    # through eval.harness.merge_shards)
    os.makedirs(args.output, exist_ok=True)
    stamp = time.strftime("%Y%m%d_%H%M%S")
    agg_path = os.path.join(args.output,
                            f"{args.task}_rank{args.rank}_{stamp}.json")
    with open(agg_path, "w") as f:
        json.dump({"task": args.task, "metrics": res.metrics,
                   "n": len(res.results),
                   "elapsed_s": round(time.time() - t0, 1),
                   "config": vars(args)}, f, indent=2)
    if args.log_samples:
        with open(agg_path.replace(".json", "_samples.jsonl"), "w") as f:
            for s in res.samples:
                f.write(json.dumps(s) + "\n")
    print(make_table(args.task, res.metrics, len(res.results)))
    print(f"saved -> {agg_path}")


def make_table(task: str, metrics: dict, n: int) -> str:
    """Results table (lmms_eval.utils.make_table equivalent)."""
    def fmt(v):
        # non-numeric values are informational: printed verbatim
        return f"{v:.2f}" if isinstance(v, (int, float)) else str(v)

    lines = [f"| {task} (n={n}) | acc % |", "|---|---|"]
    for key, val in metrics.items():
        if isinstance(val, dict):
            for sub, v in val.items():
                lines.append(f"| {key}/{sub} | {fmt(v)} |")
        else:
            lines.append(f"| {key} | {fmt(val)} |")
    return "\n".join(lines)


if __name__ == "__main__":
    main()
