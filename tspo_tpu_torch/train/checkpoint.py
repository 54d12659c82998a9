"""Selector checkpointing and merged-model export.

Counterpart of ``tspo_tpu/train/checkpoint.py``: only the selector trains,
so a checkpoint is one small npz (selector parameters, optimizer state,
step) plus a json of metadata.  The selector is stored under the JAX
package's ``params/<tree path>`` keys (kernels [in, out]), so either package
reads the other's parameters.  The optimizer state is stored under the
port's own ``adamw/...`` keys; a JAX checkpoint's optax leaves (``opt/NNNN``)
are mapped through ``interop.adamw_state_from_optax`` on load.

``export_merged`` writes the standalone TSPO-0.4B directory
(scripts/merge_weights.py:31-58) through ``TSPOScorer.save``, and
``export_torch_selector`` the reference ``MultiModal_Align`` state dict.
The JAX package's ``OrbaxCheckpointer`` is not ported.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

from ..interop import (adamw_state_from_optax, selector_state_dict_from_tree,
                       selector_tree_from_state_dict)
from ..models.tspo_model import flatten_tree, unflatten_tree

ORBAX_UNPORTED = ("orbax checkpoints are the JAX package's only; the port "
                  "writes npz (ROADMAP.md Queue 1 item 6, with multi-host "
                  "training)")


def save_train_state(directory: str, step: int, selector, optimizer=None,
                     extra: dict | None = None) -> str:
    """Write ``checkpoint-<step>.npz`` (+ ``.json``) into ``directory``."""
    from .grpo import optimizer_state
    os.makedirs(directory, exist_ok=True)
    payload: dict = {}
    flatten_tree(selector_tree_from_state_dict(selector.state_dict()), "params",
                 payload)
    if optimizer is not None:
        st = optimizer_state(optimizer, selector)
        payload["adamw/step"] = np.int64(st["step"])
        payload["adamw/mini_step"] = np.int64(st["mini_step"])
        for group in ("exp_avg", "exp_avg_sq", "acc_grads"):
            for name, val in st[group].items():
                payload[f"adamw/{group}/{name}"] = val
    path = os.path.join(directory, f"checkpoint-{step}.npz")
    np.savez(path + ".tmp.npz", **payload)
    os.replace(path + ".tmp.npz", path)
    with open(os.path.join(directory, f"checkpoint-{step}.json"), "w") as f:
        json.dump({"step": step, **(extra or {})}, f)
    return path


def list_checkpoints(directory: str) -> list:
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"checkpoint-(\d+)\.npz", name)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def prune_checkpoints(directory: str, keep: int):
    """save_total_limit behaviour (train_deepspeed.sh:38)."""
    steps = list_checkpoints(directory)
    for step in steps[:-keep] if keep > 0 else []:
        for suffix in (".npz", ".json"):
            path = os.path.join(directory, f"checkpoint-{step}{suffix}")
            if os.path.exists(path):
                os.remove(path)


def load_train_state(directory: str, selector, step: int | None = None):
    """Returns (step, selector state dict (numpy, reference keys), optimizer
    state or None) of the latest (or given) checkpoint, written by either
    package.  ``selector`` names and shapes the optimizer state."""
    steps = list_checkpoints(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    step = steps[-1] if step is None else step
    with np.load(os.path.join(directory, f"checkpoint-{step}.npz")) as z:
        sel_sd = selector_state_dict_from_tree(unflatten_tree(z, "params"))
        if "adamw/step" in z.files:
            opt = {"step": int(z["adamw/step"]),
                   "mini_step": int(z["adamw/mini_step"])}
            for group in ("exp_avg", "exp_avg_sq", "acc_grads"):
                opt[group] = {k.split("/", 2)[2]: z[k] for k in z.files
                              if k.startswith(f"adamw/{group}/")}
        else:
            leaves = [z[k] for k in sorted(k for k in z.files
                                           if k.startswith("opt/"))]
            opt = adamw_state_from_optax(leaves, selector) if leaves else None
    return step, sel_sd, opt


class OrbaxCheckpointer:
    """The JAX package's orbax backend; not in the port."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(ORBAX_UNPORTED)


def export_merged(directory: str, scorer) -> str:
    """Standalone TSPO-0.4B export (merge_weights.py equivalent): the
    scorer's CLIP towers and selector in the merged-v1 npz layout."""
    scorer.save(directory)
    return directory


def export_torch_selector(path: str, selector) -> str:
    """torch-layout MultiModal_Align state dict (keys Self_q/.../mlp.0/mlp.2),
    loadable by the reference merge_weights flow."""
    torch.save({k: v.detach().cpu() for k, v in selector.state_dict().items()},
               path)
    return path
