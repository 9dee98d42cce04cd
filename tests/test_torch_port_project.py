"""``cli.project``'s target against the JAX CLI's: the port's ``load_target``
resizes an original of another size than the stage's with Pillow's
bilinear filter, bit for bit with the JAX CLI's ``im.resize((res, res),
Image.BILINEAR)``, for square and non-square originals, shrunk and
enlarged.  The JAX CLI runs with its checkpoint loader, generator and
``project`` patched, so that it stops at ``project`` and records the
target it built."""

from __future__ import annotations

from unittest import mock

import numpy as np
import pytest
from PIL import Image

import torch_port_codec_fixtures as fx


class _Stop(Exception):
    pass


def jax_cli_target(paths, steps: int) -> np.ndarray:
    """The (N, res, res, 3) target the JAX package's ``cli.project`` hands to
    ``project`` for ``paths`` under a checkpoint of ``steps`` stages."""
    from byogan_tpu import projector as jax_projector
    from byogan_tpu.cli import project as jax_cli
    from byogan_tpu.models import factory as jax_factory
    from byogan_tpu.train import checkpoint as jax_ckpt

    seen = []

    def record(gen, params, target, **kw):
        seen.append(np.asarray(target))
        raise _Stop

    save = {"gen_params": {}, "gen_ema": None, "step": steps, "alpha": 1.0, "model": None}
    with mock.patch.object(jax_ckpt, "load_checkpoint", lambda _: dict(save)), \
            mock.patch.object(jax_factory, "build_generator", lambda spec: None), \
            mock.patch.object(jax_factory, "z_dim_from_params", lambda params: 8), \
            mock.patch.object(jax_projector, "project", record):
        with pytest.raises(_Stop):
            jax_cli.main(["unused.pkl", *map(str, paths), "-d", "cpu"])
    return seen[0]


# (height, width) of each original; the stage's resolution is 4 * 2^(steps-1)
SIZES = {
    "shrunk-square": (64, 64),
    "enlarged-square": (10, 10),
    "shrunk-wide": (23, 37),
    "shrunk-tall": (41, 19),
    "enlarged-wide": (7, 12),
    "mixed": (40, 9),
    "stage-size": (16, 16),
}


@pytest.mark.parametrize("steps", [3, 4])
def test_load_target_resizes_as_the_jax_cli(tmp_path, steps):
    from byogan_tpu_torch.cli.project import load_target

    r = np.random.default_rng(9 + steps)
    paths = []
    for name, (h, w) in SIZES.items():
        path = tmp_path / f"{name}.png"
        Image.fromarray(r.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(path)
        paths.append(path)
    want = jax_cli_target(paths, steps)
    res = 4 * 2 ** (steps - 1)
    assert want.shape == (len(paths), res, res, 3)
    for path, expected in zip(paths, want):
        np.testing.assert_array_equal(load_target(str(path), res), expected, err_msg=path.name)


def test_load_target_resizes_other_formats_as_the_jax_cli(tmp_path):
    """A Lab TIFF, a BigTIFF and a Group 4 TIFF under listed names, shrunk
    and enlarged to the stage: Pillow's RGB of the file, then its filter."""
    from byogan_tpu_torch.cli.project import load_target

    r = np.random.default_rng(5)
    lab = r.integers(0, 256, (21, 30, 3), dtype=np.uint8)
    files = {
        "lab.jpg": fx.tiff_bytes(lab, photometric=8),
        "big.bmp": fx.tiff_bytes(r.integers(0, 256, (12, 9, 3), dtype=np.uint8), big=True),
        "fax.png": fx.ccitt_tiff(r.random((26, 45)) < 0.3, compression=4),
    }
    paths = []
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
        paths.append(tmp_path / name)
    want = jax_cli_target(paths, 4)
    for path, expected in zip(paths, want):
        np.testing.assert_array_equal(load_target(str(path), 32), expected, err_msg=path.name)
