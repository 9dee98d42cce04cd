"""Typed training config and reference-compatible INI loading
(byogan_tpu/train/config.py:30-275, the port's own copy).

Same file format and keys as the reference's ``config.txt`` (configparser,
``[DEFAULT]`` inheritance, one section per dataset) and the same parse
quirks: ``use_r1`` is true only for the exact string ``"True"``,
``gradient_lambda`` goes through ``int()``, ``lr`` defaults to 0.001 in
code.  ``final_image_size`` is read by nobody.

``data_axis`` and ``model_axis`` lay the processes of a parallel run, one
per card, out as a ``data x model`` mesh (``parallel/mesh.py``): their
product must equal the world size, and ``data_axis`` must divide every
``batch_progression`` entry (checked by the loop).  The model axis shards
the widest weights over its ranks (``parallel/tensor.py``).
The opt-in regularizers are ported: augmentation at a fixed ``aug_p`` or
steered by the ADA controller (``ada_target``, which needs R1), and
path-length regularization (``plr_weight``), with JAX's checks; so is
rematerialization, for every stage (``remat``) or per stage
(``remat_progression``, ``stage_remat``).
"""

from __future__ import annotations

import configparser
import dataclasses
import os
from typing import Mapping, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    # reference knobs (train.py:18-41)
    data: Optional[str] = None
    device: str = "tpu"  # reference key; "cpu" selects the CPU, anything else the GPU
    c_lambda: float = 10.0
    noise_size: int = 512
    beta_1: float = 0.0
    beta_2: float = 0.99
    learning_rate: float = 0.001
    critic_repeats: int = 1
    use_r1: bool = True
    num_workers: int = 2
    display_step: int = 250
    checkpoint_step: int = 2000
    refresh_stat_step: int = 5
    batch_progression: Tuple[int, ...] = (24, 16, 16, 16, 12, 10, 5, 5)
    epoch_progression: Tuple[int, ...] = (10, 20, 20, 30, 30, 20, 20, 15)
    fade_percentage: float = 0.5
    # the JAX package's own knobs
    channel_divisor: int = 1
    mapping_depth: int = 8
    seed: int = 0
    compute_dtype: str = "bfloat16"
    remat: bool = False
    remat_progression: Optional[Tuple[bool, ...]] = None
    data_axis: int = 1
    model_axis: int = 1
    checkpoint_dir: str = "./checkpoints"
    output_dir: str = "./output"
    mapping_lr_mult: float = 0.01
    eval_step: int = 0
    eval_images: int = 64
    ema_beta: float = 0.0
    r1_interval: int = 1
    max_checkpoints: int = 0
    style_mix_prob: float = 0.0
    aug_p: float = 0.0
    ada_target: float = 0.0
    ada_speed: int = 500_000
    ada_rt_beta: float = 0.9
    plr_weight: float = 0.0
    plr_interval: int = 8
    plr_decay: float = 0.01
    plr_batch_shrink: int = 2
    show_noise_count: int = 25
    show_noise_trunc: float = 0.75
    noise_trunc: float = 0.75

    def __post_init__(self):
        if len(self.batch_progression) < len(self.epoch_progression):
            raise ValueError(
                f"batch_progression has {len(self.batch_progression)} entries "
                f"but epoch_progression defines {len(self.epoch_progression)} "
                "stages; every stage needs a batch size"
            )
        if self.remat_progression is not None and len(self.remat_progression) != len(self.epoch_progression):
            raise ValueError(
                f"remat_progression has {len(self.remat_progression)} flags "
                f"for {len(self.epoch_progression)} stages"
            )
        if self.data_axis < 1 or self.model_axis < 1:
            raise ValueError(f"data_axis and model_axis must be >= 1, got {self.data_axis}, {self.model_axis}")
        if self.r1_interval > 1 and not self.use_r1:
            raise ValueError("r1_interval > 1 requires use_r1=True")
        if self.ada_target > 0 and not self.use_r1:
            # byogan_tpu/train/steps.py:118-125
            raise ValueError(
                "ada_target > 0 requires use_r1=True: the controller's r_t = E[sign(D(real))] "
                "is calibrated for the logistic loss only; a fixed aug_p works with either loss"
            )
        if self.plr_weight > 0 and (self.plr_interval < 1 or self.plr_batch_shrink < 1):
            raise ValueError(
                "plr_interval and plr_batch_shrink must be >= 1 when plr_weight > 0 "
                f"(got {self.plr_interval}, {self.plr_batch_shrink})"
            )

    @property
    def num_stages(self) -> int:
        return len(self.epoch_progression)

    @property
    def use_aug(self) -> bool:
        """Augmentation is on: at a fixed aug_p or under the ADA controller."""
        return self.aug_p > 0 or self.ada_target > 0

    def stage_batch(self, stage_index: int) -> int:
        return self.batch_progression[stage_index]

    def stage_remat(self, stage_index: int) -> bool:
        """Per-stage remat flag (remat_progression overrides global remat)."""
        if self.remat_progression is None:
            return self.remat
        if len(self.remat_progression) != self.num_stages:
            raise ValueError(
                f"remat_progression has {len(self.remat_progression)} flags "
                f"for {self.num_stages} stages"
            )
        return self.remat_progression[stage_index]

    def stage_epochs(self, stage_index: int) -> int:
        return self.epoch_progression[stage_index]


def _parse_int_list(s: str) -> Tuple[int, ...]:
    return tuple(int(v) for v in s.split(","))


def config_from_mapping(section: Mapping[str, str]) -> TrainConfig:
    """Build a TrainConfig from a configparser section (reference key names)."""
    get = section.get
    d = TrainConfig.__dataclass_fields__

    def default(name):
        return d[name].default

    remat_prog = get("remat_progression")
    return TrainConfig(
        data=get("data", None),
        device=get("device", default("device")),
        c_lambda=float(int(get("gradient_lambda", 10))),  # int() parse, train.py:18
        noise_size=int(get("noise_length", 512)),
        beta_1=float(get("beta_1", 0.00)),
        beta_2=float(get("beta_2", 0.99)),
        learning_rate=float(get("lr", 0.001)),  # code default 0.001, train.py:23
        critic_repeats=int(get("critic_repeats", 1)),
        use_r1=str(get("use_r1", "True")) == "True",  # exact match, train.py:25
        num_workers=int(get("dataloader_threads", 2)),
        display_step=int(get("display_step", 250)),
        checkpoint_step=int(get("checkpoint_step", 2000)),
        refresh_stat_step=int(get("refresh_stat_step", 5)),
        batch_progression=_parse_int_list(get("batch_progression", "24,16,16,16,12,10,5,5")),
        epoch_progression=_parse_int_list(get("epoch_progression", "10,20,20,30,30,20,20,15")),
        fade_percentage=float(get("fade_percentage", 0.5)),
        channel_divisor=int(get("channel_divisor", default("channel_divisor"))),
        mapping_depth=int(get("mapping_depth", default("mapping_depth"))),
        seed=int(get("seed", default("seed"))),
        compute_dtype=get("compute_dtype", default("compute_dtype")),
        remat=str(get("remat", "False")) == "True",
        remat_progression=(
            tuple(v.strip() == "True" for v in remat_prog.split(",")) if remat_prog else None
        ),
        data_axis=int(get("data_axis", default("data_axis"))),
        model_axis=int(get("model_axis", default("model_axis"))),
        checkpoint_dir=get("checkpoint_dir", default("checkpoint_dir")),
        output_dir=get("output_dir", default("output_dir")),
        ema_beta=float(get("ema_beta", default("ema_beta"))),
        r1_interval=int(get("r1_interval", default("r1_interval"))),
        style_mix_prob=float(get("style_mix_prob", default("style_mix_prob"))),
        max_checkpoints=int(get("max_checkpoints", default("max_checkpoints"))),
        aug_p=float(get("aug_p", default("aug_p"))),
        ada_target=float(get("ada_target", default("ada_target"))),
        ada_speed=int(get("ada_speed", default("ada_speed"))),
        ada_rt_beta=float(get("ada_rt_beta", default("ada_rt_beta"))),
        plr_weight=float(get("plr_weight", default("plr_weight"))),
        plr_interval=int(get("plr_interval", default("plr_interval"))),
        plr_decay=float(get("plr_decay", default("plr_decay"))),
        plr_batch_shrink=int(get("plr_batch_shrink", default("plr_batch_shrink"))),
        eval_step=int(get("eval_step", default("eval_step"))),
        eval_images=int(get("eval_images", default("eval_images"))),
    )


def load_ini_config(path: str, section: str) -> TrainConfig:
    """Load ``config.txt``-style INI (reference main.py:21-24)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    parser = configparser.ConfigParser()
    parser.read(path)
    try:
        return config_from_mapping(parser[section])
    except ValueError as e:
        raise ValueError(f"{path} [{section}]: {e}") from e
