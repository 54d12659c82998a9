"""Weights across the two packages' layouts.

The JAX package keeps its parameters as nested dicts ("trees"): transformer
layers stacked on a leading [L, ...] axis and linear kernels as [in, out].
This port keeps HF-named ``nn.Module`` parameters: one module per layer and
linear weights as [out, in].  The functions here convert between the two as
numpy, with no JAX import, so a JAX tree converted to numpy loads here and
the port's ``save`` writes the JAX package's ``tspo_params.npz`` layout.
The LLaVA-Video backbone crosses as a llava_qwen-layout state dict, the
format both packages' ``from_torch_checkpoint`` read.  The trainer's AdamW
state crosses as optax's flat leaf list (``adamw_state_from_optax`` and its
inverse), so a run checkpointed by either package resumes in the other.
"""

from __future__ import annotations

import numpy as np
import torch

from .configs import CLIPConfig, SelectorConfig
from .utils.hf_port import stack_layers, t2n

_LN = (("ln1", "layer_norm1"), ("ln2", "layer_norm2"))
_LIN = (("attn", "q", "self_attn.q_proj"), ("attn", "k", "self_attn.k_proj"),
        ("attn", "v", "self_attn.v_proj"), ("attn", "o", "self_attn.out_proj"),
        ("mlp", "fc1", "mlp.fc1"), ("mlp", "fc2", "mlp.fc2"))

# selector tree (group, name) <-> reference MultiModal_Align key
SELECTOR_KEYS = {
    "temporal.Self_q": ("temporal", "q"),
    "temporal.Self_k": ("temporal", "k"),
    "temporal.Self_v": ("temporal", "v"),
    "temporal.ffn_o": ("temporal", "ffn_o"),
    "mlp.0": ("mlp", "fc1"),
    "mlp.2": ("mlp", "fc2"),
}


def _encoder_to_hf(layers: dict, prefix: str, n: int, sd: dict):
    for i in range(n):
        f = f"{prefix}.encoder.layers.{i}"
        for tree_name, hf_name in _LN:
            sd[f"{f}.{hf_name}.weight"] = t2n(layers[tree_name]["scale"][i])
            sd[f"{f}.{hf_name}.bias"] = t2n(layers[tree_name]["bias"][i])
        for grp, name, hf_name in _LIN:
            p = layers[grp][name]
            sd[f"{f}.{hf_name}.weight"] = t2n(p["kernel"][i]).T.copy()
            sd[f"{f}.{hf_name}.bias"] = t2n(p["bias"][i])


def _encoder_from_hf(sd: dict, prefix: str, n: int) -> dict:
    f = prefix + ".encoder.layers.{i}"
    out = {"attn": {}, "mlp": {}}
    for tree_name, hf_name in _LN:
        out[tree_name] = {"scale": stack_layers(sd, n, f"{f}.{hf_name}.weight"),
                          "bias": stack_layers(sd, n, f"{f}.{hf_name}.bias")}
    for grp, name, hf_name in _LIN:
        out[grp][name] = {
            "kernel": stack_layers(sd, n, f"{f}.{hf_name}.weight").transpose(0, 2, 1),
            "bias": stack_layers(sd, n, f"{f}.{hf_name}.bias")}
    return out


def hf_state_dict_from_clip_tree(tree: dict, cfg: CLIPConfig) -> dict:
    """JAX CLIP tree (numpy leaves) -> HF ``CLIPModel`` state dict (numpy)."""
    t, v = tree["text"], tree["vision"]
    sd = {
        "text_model.embeddings.token_embedding.weight": t2n(t["token_embedding"]),
        "text_model.embeddings.position_embedding.weight": t2n(t["position_embedding"]),
        "text_model.final_layer_norm.weight": t2n(t["final_ln"]["scale"]),
        "text_model.final_layer_norm.bias": t2n(t["final_ln"]["bias"]),
        "text_projection.weight": t2n(t["projection"]).T.copy(),
        "vision_model.embeddings.class_embedding": t2n(v["class_embedding"]),
        "vision_model.embeddings.position_embedding.weight": t2n(v["position_embedding"]),
        # [3*P*P, W] GEMM kernel -> the HF conv weight [W, 3, P, P]
        "vision_model.embeddings.patch_embedding.weight": t2n(v["patch_kernel"]).T.reshape(
            cfg.vision.width, 3, cfg.vision.patch_size, cfg.vision.patch_size).copy(),
        "vision_model.pre_layrnorm.weight": t2n(v["pre_ln"]["scale"]),
        "vision_model.pre_layrnorm.bias": t2n(v["pre_ln"]["bias"]),
        "vision_model.post_layernorm.weight": t2n(v["post_ln"]["scale"]),
        "vision_model.post_layernorm.bias": t2n(v["post_ln"]["bias"]),
        "visual_projection.weight": t2n(v["projection"]).T.copy(),
        "logit_scale": t2n(tree["logit_scale"]),
    }
    _encoder_to_hf(t["layers"], "text_model", cfg.text.layers, sd)
    _encoder_to_hf(v["layers"], "vision_model", cfg.vision.layers, sd)
    return sd


def clip_tree_from_hf_state_dict(sd: dict, cfg: CLIPConfig) -> dict:
    """HF ``CLIPModel`` state dict -> JAX CLIP tree (numpy leaves): what
    ``tspo_tpu/models/clip.py::clip_params_from_torch`` computes."""
    sd = {k: t2n(v) for k, v in sd.items()}
    t, v = cfg.text, cfg.vision
    patch = sd["vision_model.embeddings.patch_embedding.weight"]
    return {
        "text": {
            "token_embedding": sd["text_model.embeddings.token_embedding.weight"],
            "position_embedding": sd["text_model.embeddings.position_embedding.weight"],
            "layers": _encoder_from_hf(sd, "text_model", t.layers),
            "final_ln": {"scale": sd["text_model.final_layer_norm.weight"],
                         "bias": sd["text_model.final_layer_norm.bias"]},
            "projection": sd["text_projection.weight"].T,
        },
        "vision": {
            "class_embedding": sd["vision_model.embeddings.class_embedding"],
            "position_embedding": sd["vision_model.embeddings.position_embedding.weight"],
            "patch_kernel": patch.reshape(v.width, -1).T,
            "pre_ln": {"scale": sd["vision_model.pre_layrnorm.weight"],
                       "bias": sd["vision_model.pre_layrnorm.bias"]},
            "layers": _encoder_from_hf(sd, "vision_model", v.layers),
            "post_ln": {"scale": sd["vision_model.post_layernorm.weight"],
                        "bias": sd["vision_model.post_layernorm.bias"]},
            "projection": sd["visual_projection.weight"].T,
        },
        "logit_scale": sd["logit_scale"],
    }


def selector_state_dict_from_tree(tree: dict) -> dict:
    """JAX selector tree -> reference ``MultiModal_Align`` state dict (numpy)."""
    out = {}
    for key, (grp, name) in SELECTOR_KEYS.items():
        p = tree[grp][name]
        out[f"{key}.weight"] = t2n(p["kernel"]).T.copy()
        out[f"{key}.bias"] = t2n(p["bias"])
    return out


def selector_tree_from_state_dict(sd: dict) -> dict:
    """Reference ``MultiModal_Align`` state dict -> JAX selector tree (numpy)."""
    out = {"temporal": {}, "mlp": {}}
    for key, (grp, name) in SELECTOR_KEYS.items():
        out[grp][name] = {"kernel": t2n(sd[f"{key}.weight"]).T,
                          "bias": t2n(sd[f"{key}.bias"])}
    return out


def _selector_leaf_names() -> list:
    """(torch parameter name, is a kernel) of each selector tree leaf, in
    the order ``jax.tree_util`` flattens the tree: sorted keys."""
    by_tree = {tree_key: key for key, tree_key in SELECTOR_KEYS.items()}
    return [(f"{by_tree[(grp, name)]}.{'weight' if leaf == 'kernel' else 'bias'}",
             leaf == "kernel")
            for grp, name in sorted(by_tree) for leaf in ("bias", "kernel")]


def adamw_state_from_optax(opt_leaves, selector) -> dict:
    """The JAX trainer's optax state (``load_train_state``'s flat leaves) ->
    the port optimizer's state (``train.grpo.optimizer_state`` layout).

    ``optax.adamw`` flattens to [count, mu..., nu...] (25 leaves for the
    selector); inside ``optax.MultiSteps`` (``grad_accum > 1``) to
    [mini_step, gradient_step, count, mu..., nu..., acc_grads...] (39).
    count -> ``step``, mu -> ``exp_avg``, nu -> ``exp_avg_sq``; kernels
    [in, out] become weights [out, in]."""
    names = _selector_leaf_names()
    n = len(names)
    shapes = dict((k, tuple(p.shape)) for k, p in selector.named_parameters())
    leaves = [np.asarray(x) for x in opt_leaves]
    if len(leaves) == 1 + 2 * n:
        mini_step, adam, acc = 0, leaves, None
    elif len(leaves) == 3 + 3 * n:
        mini_step, adam, acc = int(leaves[0]), leaves[2:3 + 2 * n], leaves[3 + 2 * n:]
    else:
        raise ValueError(f"{len(leaves)} optimizer leaves: not optax.adamw "
                         f"({1 + 2 * n}) or MultiSteps of it ({3 + 3 * n})")

    def by_name(xs):
        out = {}
        for (name, kernel), x in zip(names, xs):
            x = np.asarray(x, np.float32)
            out[name] = np.ascontiguousarray(x.T if kernel else x)
            if out[name].shape != shapes[name]:
                raise ValueError(f"{name}: optimizer leaf {x.shape} for a "
                                 f"parameter of {shapes[name]}")
        return out

    zeros = [np.zeros(shapes[name][::-1] if kernel else shapes[name], np.float32)
             for name, kernel in names]
    return {"step": int(adam[0]), "mini_step": mini_step,
            "exp_avg": by_name(adam[1:1 + n]),
            "exp_avg_sq": by_name(adam[1 + n:1 + 2 * n]),
            "acc_grads": by_name(zeros if acc is None else acc)}


def optax_leaves_from_adamw(state: dict, grad_accum: int) -> list:
    """Inverse of :func:`adamw_state_from_optax`: the flat leaves the JAX
    package's ``restore_opt_state`` rebuilds its optax state from, for an
    optimizer made with ``grad_accum``."""
    names = _selector_leaf_names()

    def leaves(group):
        return [np.ascontiguousarray(state[group][name].T if kernel
                                     else state[group][name]).astype(np.float32)
                for name, kernel in names]

    count = np.int32(state["step"])
    adam = [count] + leaves("exp_avg") + leaves("exp_avg_sq")
    if grad_accum <= 1:
        return adam
    return [np.int32(state["mini_step"]), count] + adam + leaves("acc_grads")


def scorer_from_numpy(clip_tree: dict, selector_tree: dict,
                      clip_cfg: CLIPConfig, selector_cfg: SelectorConfig,
                      dtype=torch.float32, device="cuda", **kw):
    """A port ``TSPOScorer`` holding the weights of a JAX scorer, given its
    CLIP and selector trees as nested dicts of numpy arrays.  The selector
    stays fp32 whatever ``dtype``."""
    from .models.tspo_model import TSPOScorer
    return TSPOScorer.from_state_dicts(
        hf_state_dict_from_clip_tree(clip_tree, clip_cfg),
        selector_state_dict_from_tree(selector_tree),
        clip_cfg=clip_cfg, selector_cfg=selector_cfg, dtype=dtype,
        device=device, **kw)


_QWEN_LIN = (("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"),
             ("v", "self_attn.v_proj"), ("o", "self_attn.o_proj"),
             ("gate", "mlp.gate_proj"), ("up", "mlp.up_proj"),
             ("down", "mlp.down_proj"))


def llava_state_dict_from_tree(tree: dict, cfg) -> dict:
    """JAX ``LLaVAVideoModel.params`` (numpy leaves) -> llava_qwen state dict
    (numpy), the layout ``LLaVAVideoModel.from_torch_checkpoint`` of either
    package reads.  ``cfg`` is the port's ``LLaVAVideoConfig``."""
    lm, vis, proj = tree["lm"], tree["vision"], tree["projector"]
    sd = {"model.embed_tokens.weight": t2n(lm["embedding"]),
          "model.norm.weight": t2n(lm["final_ln"]),
          "model.image_newline": t2n(tree["image_newline"]),
          "model.mm_projector.0.weight": t2n(proj["fc1"]["kernel"]).T.copy(),
          "model.mm_projector.0.bias": t2n(proj["fc1"]["bias"]),
          "model.mm_projector.2.weight": t2n(proj["fc2"]["kernel"]).T.copy(),
          "model.mm_projector.2.bias": t2n(proj["fc2"]["bias"])}
    if "lm_head" in lm:
        sd["lm_head.weight"] = t2n(lm["lm_head"])
    layers = lm["layers"]
    for i in range(cfg.lm.num_layers):
        f = f"model.layers.{i}"
        sd[f"{f}.input_layernorm.weight"] = t2n(layers["ln1"][i])
        sd[f"{f}.post_attention_layernorm.weight"] = t2n(layers["ln2"][i])
        for name, hf_name in _QWEN_LIN:
            p = layers[name]
            sd[f"{f}.{hf_name}.weight"] = t2n(p["kernel"][i]).T.copy()
            if "bias" in p:
                sd[f"{f}.{hf_name}.bias"] = t2n(p["bias"][i])
    v = cfg.vision
    tower = {
        # [3*P*P, W] GEMM kernel -> the HF conv weight [W, 3, P, P]
        "vision_model.embeddings.patch_embedding.weight": t2n(vis["patch_kernel"]).T.reshape(
            v.width, 3, v.patch_size, v.patch_size).copy(),
        "vision_model.embeddings.patch_embedding.bias": t2n(vis["patch_bias"]),
        "vision_model.embeddings.position_embedding.weight": t2n(vis["position_embedding"]),
    }
    _encoder_to_hf(vis["layers"], "vision_model", v.layers, tower)
    sd.update({"model.vision_tower.vision_tower." + k: w for k, w in tower.items()})
    return sd


def llava_from_numpy(tree: dict, cfg, dtype=torch.float32, device="cuda", **kw):
    """A port ``LLaVAVideoModel`` holding the weights of a JAX
    ``LLaVAVideoModel``, given its params as nested dicts of numpy arrays."""
    from .models.llava_video import LLaVAVideoModel
    return LLaVAVideoModel.from_torch_checkpoint(
        llava_state_dict_from_tree(tree, cfg), cfg, dtype=dtype, device=device,
        **kw)
