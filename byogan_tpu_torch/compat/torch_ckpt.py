"""Reference ``.pth`` checkpoints and the JAX package's weights.

The port's modules already use the reference state-dict names and layouts,
so a reference checkpoint loads as it is, after the ``module.`` prefix that
``nn.DataParallel`` adds is stripped.  ``generator_state_from_jax`` and
``critic_state_from_jax`` carry a byogan_tpu param tree (as numpy) across,
with the port's own copy of the key maps (byogan_tpu/compat/torch_ckpt.py:
79-186):

    linear  (in, out)        -> (out, in)        transpose
    conv    (kH, kW, I, O)   -> (O, I, kH, kW)   HWIO -> OIHW
    noise   (C,)             -> (1, C, 1, 1)
    const   (1, 4, 4, C)     -> (1, C, 4, 4)     NHWC -> NCHW
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch


def generator_key_map(
    num_stages: int = 8, mapping_depth: int = 8
) -> List[Tuple[str, Tuple[str, ...], str]]:
    """[(torch_key, jax_param_path, kind)], kind in {linear, conv, noise,
    const, bias}."""
    entries = []
    for i in range(mapping_depth):
        base = f"to_w_noise.0.layers.{i}.0"
        entries.append((f"{base}.weight", ("mapping", f"dense{i}", "weight"), "linear"))
        entries.append((f"{base}.bias", ("mapping", f"dense{i}", "bias"), "bias"))
    for k in range(num_stages):
        stage = f"stages_{k}"
        for torch_conv, ours in (("conv_1", "conv1"), ("conv_2", "conv2")):
            base = f"gen_blocks.{k}.{torch_conv}"
            if torch_conv == "conv_1" and k == 0:
                entries.append((f"{base}.conv", (stage, ours, "const"), "const"))
            else:
                entries.append(
                    (f"{base}.conv.weight", (stage, ours, "conv", "weight"), "conv")
                )
                entries.append(
                    (f"{base}.conv.bias", (stage, ours, "conv", "bias"), "bias")
                )
            entries.append(
                (f"{base}.inject_noise.weights", (stage, ours, "noise", "weight"), "noise")
            )
            entries.append(
                (f"{base}.adain.style.weight", (stage, ours, "adain", "style", "weight"), "linear")
            )
            entries.append(
                (f"{base}.adain.style.bias", (stage, ours, "adain", "style", "bias"), "bias")
            )
        entries.append((f"to_rgbs.{k}.weight", (f"to_rgbs_{k}", "weight"), "conv"))
        entries.append((f"to_rgbs.{k}.bias", (f"to_rgbs_{k}", "bias"), "bias"))
    return entries


def critic_key_map(num_stages: int = 8) -> List[Tuple[str, Tuple[str, ...], str]]:
    """[(torch_key, jax_param_path, kind)] of the critic.  The final block
    is conv_1 = Seq(stddev, conv, lrelu), conv_2 = Seq(conv4, lrelu,
    flatten, linear, lrelu, linear); the others conv_1 = Seq(conv, lrelu),
    conv_2 = Seq(conv, pool, lrelu)."""
    entries = []
    for k in range(num_stages):
        entries.append((f"from_rgbs.{k}.0.weight", (f"from_rgbs_{k}", "conv", "weight"), "conv"))
        entries.append((f"from_rgbs.{k}.0.bias", (f"from_rgbs_{k}", "conv", "bias"), "bias"))
        block, base = f"blocks_{k}", f"conv_blocks.{k}"
        if k == num_stages - 1:
            layers = (("conv_1.1", "conv1", "conv"), ("conv_2.0", "conv2", "conv"),
                      ("conv_2.3", "dense1", "linear"), ("conv_2.5", "dense2", "linear"))
        else:
            layers = (("conv_1.0", "conv1", "conv"), ("conv_2.0", "conv2", "conv"))
        for torch_name, ours, kind in layers:
            entries.append((f"{base}.{torch_name}.weight", (block, ours, "weight"), kind))
            entries.append((f"{base}.{torch_name}.bias", (block, ours, "bias"), "bias"))
    return entries


def _to_torch_layout(v: np.ndarray, kind: str) -> np.ndarray:
    if kind == "linear":
        return v.T
    if kind == "conv":
        return v.transpose(3, 2, 0, 1)
    if kind == "noise":
        return v.reshape(1, -1, 1, 1)
    if kind == "const":
        return v.transpose(0, 3, 1, 2)
    return v


def _state_from_jax(params: Mapping[str, Any], key_map) -> Dict[str, torch.Tensor]:
    state = {}
    for key, path, kind in key_map:
        node = params
        for p in path:
            node = node[p]
        v = _to_torch_layout(np.asarray(node, dtype=np.float32), kind)
        state[key] = torch.from_numpy(np.array(v, order="C"))  # a writable copy
    return state


def generator_state_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """byogan_tpu generator params (nested dicts of arrays) -> the port's
    float32 state dict.  Stage count and mapping depth come from the tree."""
    num_stages = sum(1 for k in params if k.startswith("stages_"))
    return _state_from_jax(params, generator_key_map(num_stages, len(params["mapping"])))


def critic_state_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """byogan_tpu critic params -> the port's float32 state dict."""
    num_stages = sum(1 for k in params if k.startswith("blocks_"))
    return _state_from_jax(params, critic_key_map(num_stages))


def strip_module_prefix(state: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Drop ``module.`` (reference checkpoints wrap nets in DataParallel)."""
    return {
        (k[len("module."):] if k.startswith("module.") else k): torch.as_tensor(v)
        for k, v in state.items()
    }


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    """Load a reference-format ``.pth``: gen and critic (state dicts, when
    present), iter, im_count, step, epoch, alpha, and model (a ModelSpec
    dict, or None for the reference architecture).  A checkpoint the port's
    trainer wrote also carries gen_opt, critic_opt and rng, passed on as
    they are, and may carry gen_ema (the EMA generator's state dict),
    aug_p, rt_ema and pl_ema (the regularizers' scalars) and train_config
    (the trajectory knobs it was trained with)."""
    save = torch.load(path, map_location="cpu", weights_only=False)
    out: Dict[str, Any] = {
        "iter": int(save.get("iter", 0)),
        "im_count": int(save.get("im_count", 0)),
        "step": int(save.get("step", 1)),
        "epoch": int(save.get("epoch", 0)),
        "alpha": save.get("alpha", None),
        "model": save.get("model"),
    }
    for net in ("gen", "critic", "gen_ema"):
        if net in save:
            out[net] = strip_module_prefix(save[net])
    for extra in ("gen_opt", "critic_opt", "rng", "train_config", "aug_p", "rt_ema", "pl_ema"):
        if extra in save:
            out[extra] = save[extra]
    return out
