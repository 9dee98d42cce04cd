"""Checkpoints as reference-format ``.pth`` files
(byogan_tpu/train/checkpoint.py:42-229, 261-276, 387-455).

A checkpoint holds the reference's logical fields {gen, critic, iter,
im_count, step, epoch, alpha} under the reference's state-dict names, so
the reference and ``byogan_tpu.train.checkpoint.load_checkpoint`` read it,
plus what an exact resume needs: ``model`` (the ModelSpec), both optimizer
states, the generator RNG's state, ``gen_ema`` (the EMA generator, when the
run has one), the regularizers' scalars ``aug_p``, ``rt_ema`` and
``pl_ema`` (floats, when the run has them) and ``train_config`` (the knobs
that steer the trajectory, checked on resume).  Files are ``chk-{iters}.pth`` and ``FINAL.pth``,
written atomically; ``latest_checkpoint`` picks the one to resume from.
Under the model axis every rank gathers the nets, the EMA and both
optimizer states from their blocks and global rank 0 writes them, so the
file is the one a single process writes; a restore loads it into the full
state, which ``parallel.shard_train_state`` then cuts.

The JAX package's own checkpoints are orbax directories, which need JAX to
read; convert one with ``byogan-export`` to a ``.pth`` first.
"""

from __future__ import annotations

import os
import pickle
import re
from typing import Any, Dict, Optional

import torch

from byogan_tpu_torch.compat.torch_ckpt import load_torch_checkpoint
from byogan_tpu_torch.parallel.tensor import gather_optimizer_state, gather_state_dict

#: Config knobs that determine the training trajectory: the batch-exact
#: resume rebuilds the epoch and batch position and the RNG stream from
#: them, so a resume under other values would silently land elsewhere
#: (byogan_tpu/train/checkpoint.py:42-58).
TRAJECTORY_KEYS = (
    "batch_progression",
    "epoch_progression",
    "critic_repeats",
    "fade_percentage",
    "seed",
    "noise_trunc",
    "use_r1",
    "r1_interval",
    "style_mix_prob",
    "aug_p",
    "ada_target",
    "ada_speed",
    "plr_weight",
    "plr_interval",
    "compute_dtype",
)


#: The regularizers' scalars a checkpoint carries when the state has them
#: (byogan_tpu/train/checkpoint.py:156-161).
REGULARIZER_KEYS = ("aug_p", "rt_ema", "pl_ema")


def trajectory_snapshot(config) -> Dict[str, Any]:
    """The trajectory knobs of ``config`` as plain values (tuples as lists)."""
    snap = {}
    for k in TRAJECTORY_KEYS:
        v = getattr(config, k)
        snap[k] = list(v) if isinstance(v, tuple) else v
    return snap


def check_resume_config(saved: Optional[Dict[str, Any]], config, allow_mismatch: bool = False) -> None:
    """Raise (or, with ``allow_mismatch``, warn) when ``config``'s trajectory
    knobs differ from ``saved``, the snapshot a checkpoint was written with
    (byogan_tpu/train/checkpoint.py:70-102).  A checkpoint without one
    loads unchecked."""
    if saved is None or config is None:
        return
    current = trajectory_snapshot(config)
    mismatched = [
        f"  {k}: checkpoint={saved[k]!r} vs config={current[k]!r}"
        for k in TRAJECTORY_KEYS
        if k in saved and saved[k] != current[k]
    ]
    if not mismatched:
        return
    detail = (
        "resume config mismatch: these knobs steer the batch-exact resume "
        "position and RNG stream, so the resumed trajectory would silently "
        "diverge:\n" + "\n".join(mismatched)
    )
    if allow_mismatch:
        print(f"WARNING: {detail}\n(continuing: mismatch explicitly allowed)")
        return
    raise ValueError(
        detail + "\n(resume with the original config, or pass --force-resume / "
        "allow_config_mismatch=True to accept a divergent trajectory)"
    )

def checkpoint_name(iters: int) -> str:
    """Reference naming: ``chk-{iters}`` (train.py:258)."""
    return f"chk-{iters}"


def save_checkpoint(
    directory: str,
    state,
    alpha: Optional[float],
    name: Optional[str] = None,
    model_spec=None,
    train_config=None,
    mesh=None,
) -> str:
    """Write ``state`` (a ``TrainState``) to ``{directory}/{name}.pth``;
    ``alpha`` is the saved fade value, None once past the fade.  With
    ``train_config`` the file records its trajectory knobs.  With a
    ``mesh`` (a ``parallel.mesh.Mesh``) every rank must call it: the model
    axis's blocks are gathered on every rank and global rank 0 alone
    writes.  Returns the path on every rank."""
    path = os.path.abspath(os.path.join(directory, (name or checkpoint_name(state.iters)) + ".pth"))
    save = {
        "gen": gather_state_dict(state.gen, mesh),
        "critic": gather_state_dict(state.critic, mesh),
        "iter": int(state.iters),
        "im_count": int(state.im_count),
        "step": int(state.stage),
        "epoch": int(state.epoch),
        "alpha": None if alpha is None else float(alpha),
        "model": None if model_spec is None else model_spec.to_dict(),
        "gen_opt": gather_optimizer_state(state.gen_opt, state.gen, mesh),
        "critic_opt": gather_optimizer_state(state.critic_opt, state.critic, mesh),
        "rng": state.rng.get_state(),
        "train_config": None if train_config is None else trajectory_snapshot(train_config),
    }
    if state.gen_ema is not None:
        save["gen_ema"] = gather_state_dict(state.gen_ema, mesh)
    for key in REGULARIZER_KEYS:
        if getattr(state, key) is not None:
            save[key] = float(getattr(state, key))
    if mesh is None or mesh.global_rank == 0:
        os.makedirs(directory, exist_ok=True)
        tmp = path + ".tmp"
        torch.save(save, tmp)
        os.replace(tmp, path)
    return path


def prune_checkpoints(directory: str, keep: int) -> list:
    """Remove the oldest ``chk-{iters}.pth`` beyond the newest ``keep``;
    ``FINAL.pth`` stays.  Returns the removed paths."""
    if keep <= 0 or not os.path.isdir(directory):
        return []
    found = sorted(
        (int(m.group(1)), os.path.join(directory, e))
        for e in os.listdir(directory)
        if (m := re.fullmatch(r"chk-(\d+)\.pth", e))
    )
    removed = [p for _, p in found[: max(0, len(found) - keep)]]
    for p in removed:
        os.remove(p)
    return removed


def latest_checkpoint(directory: str) -> Optional[str]:
    """The checkpoint to resume from (byogan_tpu/train/checkpoint.py:196-229):
    the newest ``chk-{N}.pth``, or ``FINAL.pth`` when its saved ``iter`` is
    at least N (ties go to FINAL, written after the periodic save at the
    same iteration); None if there is neither.  A leftover ``*.pth.tmp``
    (a save cut short) is never picked, and a FINAL that cannot be read
    falls back to the periodic checkpoint.  FINAL is memory-mapped, so only
    its ``iter`` is read."""
    if not os.path.isdir(directory):
        return None
    best, best_iter = None, -1
    for entry in os.listdir(directory):
        m = re.fullmatch(r"chk-(\d+)\.pth", entry)
        if m and int(m.group(1)) > best_iter:
            best, best_iter = os.path.join(directory, entry), int(m.group(1))
    final = os.path.join(directory, "FINAL.pth")
    if os.path.isfile(final):
        try:
            if torch.load(final, map_location="cpu", mmap=True, weights_only=True)["iter"] >= best_iter:
                return final
        except (OSError, RuntimeError, EOFError, KeyError, TypeError, ValueError, pickle.UnpicklingError):
            pass  # a partial or foreign FINAL: resume from the periodic checkpoint
    return best


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Load a reference-format ``.pth`` file (see ``load_torch_checkpoint``)."""
    if os.path.isfile(path):
        return load_torch_checkpoint(path)
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a directory (an orbax checkpoint); the port reads "
            "only .pth files -- export it with byogan-export first"
        )
    raise FileNotFoundError(f"checkpoint not found: {path}")


def restore_train_state(
    path: str, state, config=None, allow_mismatch: bool = False
) -> Optional[float]:
    """Load a checkpoint into ``state`` in place; returns its alpha.  A
    reference ``.pth`` restores the weights and counters; one the port
    wrote also restores both optimizers and the RNG, for an exact resume.
    With ``config``, its trajectory knobs are checked against the
    checkpoint's (``check_resume_config``).  A run with EMA takes the
    checkpoint's EMA generator, or a copy of its generator where it has
    none (byogan_tpu/train/checkpoint.py:409-417).  A run with
    augmentation, ADA or path-length regularization continues from the
    checkpoint's ``aug_p``, ``rt_ema`` and ``pl_ema``; a checkpoint written
    without them leaves the state's (``aug_p`` from the config, the others
    0), as JAX does (checkpoint.py:419-436)."""
    loaded = load_checkpoint(path)
    check_resume_config(loaded.get("train_config"), config, allow_mismatch)
    state.gen.load_state_dict(loaded["gen"], strict=True)
    state.critic.load_state_dict(loaded["critic"], strict=True)
    if state.gen_ema is not None:
        state.gen_ema.load_state_dict(loaded.get("gen_ema", loaded["gen"]), strict=True)
    for key in REGULARIZER_KEYS:
        if getattr(state, key) is not None and loaded.get(key) is not None:
            setattr(state, key, torch.tensor(loaded[key], dtype=torch.float32, device=getattr(state, key).device))
    if "gen_opt" in loaded:
        state.gen_opt.load_state_dict(loaded["gen_opt"])
        state.critic_opt.load_state_dict(loaded["critic_opt"])
        state.rng.set_state(loaded["rng"])
    state.iters, state.im_count = loaded["iter"], loaded["im_count"]
    state.stage, state.epoch = loaded["step"], loaded["epoch"]
    return loaded["alpha"]
