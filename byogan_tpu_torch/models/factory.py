"""Model construction from a serializable spec (byogan_tpu/models/factory.py).

``ModelSpec()`` is the reference architecture: 8 stages 4 -> 512 px,
``GENERATOR_CHANNELS``, style_dim 512, mapping depth 8.  Fewer stages and
divided widths give the small models of the tests; checkpoints may carry
the spec under ``model``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from byogan_tpu_torch.models.critic import CRITIC_CHANNELS, CRITIC_FROM_RGB, Critic
from byogan_tpu_torch.models.generator import GENERATOR_CHANNELS, Generator

_MIN_CHANNELS = 4


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    num_stages: int = 8
    channel_divisor: int = 1
    style_dim: int = 512
    mapping_depth: int = 8

    def __post_init__(self):
        if not 1 <= self.num_stages <= len(GENERATOR_CHANNELS):
            raise ValueError(f"num_stages must be in [1, 8], got {self.num_stages}")
        if self.channel_divisor < 1:
            raise ValueError("channel_divisor must be >= 1")

    def _scale(self, c: int) -> int:
        return max(c // self.channel_divisor, _MIN_CHANNELS)

    def generator_channels(self) -> Tuple[Tuple[int, int], ...]:
        return tuple(
            (self._scale(ic), self._scale(oc))
            for ic, oc in GENERATOR_CHANNELS[: self.num_stages]
        )

    def critic_from_rgb(self) -> Tuple[int, ...]:
        # Critic tables are highest-resolution first: an n-stage model keeps
        # the LAST n entries.
        return tuple(self._scale(c) for c in CRITIC_FROM_RGB[len(CRITIC_FROM_RGB) - self.num_stages :])

    def critic_blocks(self) -> Tuple[Tuple[int, int], ...]:
        return tuple(
            (self._scale(ic), self._scale(oc))
            for ic, oc in CRITIC_CHANNELS[len(CRITIC_CHANNELS) - self.num_stages :]
        )

    def generator_style_dim(self) -> int:
        if self.channel_divisor > 1:
            return self._scale(self.style_dim)
        return self.style_dim

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Optional[Mapping[str, Any]]) -> "ModelSpec":
        if not d:
            return cls()
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


def z_dim_from_params(gen_state: Mapping[str, torch.Tensor]) -> int:
    """The latent size a checkpoint was trained with: the input width of
    the mapping net's first dense weight, (out, in) in torch layout."""
    return int(gen_state["to_w_noise.0.layers.0.0.weight"].shape[1])


def build_generator(
    spec: ModelSpec = ModelSpec(),
    dtype: Optional[torch.dtype] = None,
    z_dim: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
) -> Generator:
    return Generator(
        channels=spec.generator_channels(),
        style_dim=spec.generator_style_dim(),
        mapping_depth=spec.mapping_depth,
        z_dim=z_dim,
        dtype=dtype,
        generator=generator,
    )


def build_critic(
    spec: ModelSpec = ModelSpec(), generator: Optional[torch.Generator] = None
) -> Critic:
    return Critic(spec.critic_from_rgb(), spec.critic_blocks(), generator=generator)
