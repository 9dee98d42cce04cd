"""Offline multi-resolution dataset preparation (byogan_tpu/data/prep.py).

The JAX package's layout: the originals move into ``<data>/original/
images/``, and each size of the pyramid goes to ``<data>/prepared/
set_{k}/images/image-{n}.png``, ``n`` the original's place in sorted file
order, so a dataset prepared by either package trains in both.  Each
original is decoded once and resized to every size, largest first, each
size from the previous result, with Pillow's ``Image.BILINEAR`` filter
reproduced bit for bit (``core/resize.py``): the sets equal the JAX
package's.  Decoding (``data/images.py``: PNG, JPEG, WebP, GIF and TIFF
through the port's own codecs, which need no libpng, libjpeg, libwebp or
libtiff; the other formats Pillow opens, BMP to SPIDER, in numpy with the
native library's loops; each in the lane of the JAX package's prep,
Pillow's ``convert("RGB")``, so a 16-bit gray PNG clips at 255) and encoding
(``serve.encode_png``)
run on a pool of host threads; the resizes run on ``device``, the GPU
unless ``"cpu"`` is asked for.  An original of a format the port does not
read, as ``Image.open``'s walk of Pillow's plugins finds it
(``images.identify``), raises before any set is written, naming the file
and the format or Pillow's verdict.
"""

from __future__ import annotations

import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional

import torch

from byogan_tpu_torch.core.device import resolve_device
from byogan_tpu_torch.core.resize import resize_uint8_bilinear_pil
from byogan_tpu_torch.data.images import HEAD, READ, identify, is_image, read_image, unreadable
from byogan_tpu_torch.serve import encode_png


def _gather_sizes(start_size: int, end_size: int) -> List[int]:
    sizes = []
    cur = start_size
    while cur <= end_size:
        sizes.append(cur)
        cur *= 2
    return sizes


def prepare_pyramid(
    datapath: str,
    start_size: int = 4,
    end_size: int = 512,
    workers: int = 8,
    overwrite: Optional[Callable[[str], bool]] = None,
    progress: Optional[Callable[[int, int], None]] = None,
    device: Optional[str] = None,
) -> List[str]:
    """Build the resolution pyramid.  Returns the list of set directories.

    ``overwrite(set_name) -> bool`` decides whether to rebuild an existing
    set (the CLI asks, or ``-y`` says yes); without it existing sets are
    kept.  ``progress(done, total)`` is called per original.
    """
    dev = resolve_device(device)
    dest = os.path.join(datapath, "original", "images")
    if not os.path.exists(dest):
        os.makedirs(dest)
        for name in sorted(os.listdir(datapath)):
            if name not in ("original", "prepared"):
                shutil.move(os.path.join(datapath, name), dest)
    files = sorted(os.path.join(dest, f) for f in os.listdir(dest) if is_image(f))
    for path in files:  # every original's format, as Image.open's walk finds it, before any set is written
        fmt = identify(path)
        if fmt not in READ:
            with open(path, "rb") as f:
                raise unreadable(path, f.read(HEAD), fmt)

    sizes = _gather_sizes(start_size, end_size)
    prepared = os.path.join(datapath, "prepared")
    os.makedirs(prepared, exist_ok=True)
    out_dirs, build_sizes, build_dirs = [], [], []
    for index, size in enumerate(sizes):
        set_dir = os.path.join(prepared, f"set_{index + 1}", "images")
        out_dirs.append(os.path.dirname(set_dir))
        if os.path.exists(set_dir):
            if overwrite is not None and overwrite(f"set_{index + 1}"):
                shutil.rmtree(set_dir)
            else:
                continue
        os.makedirs(set_dir)
        build_sizes.append(size)
        build_dirs.append(set_dir)
    if not build_sizes:
        return out_dirs
    chain = sorted(zip(build_sizes, build_dirs), reverse=True)

    def process(item) -> None:
        n, path = item
        img = torch.from_numpy(read_image(path, lane="pillow")).to(dev)
        for size, set_dir in chain:
            img = resize_uint8_bilinear_pil(img, size)
            with open(os.path.join(set_dir, f"image-{n}.png"), "wb") as f:
                f.write(encode_png(img.cpu().numpy()))

    with ThreadPoolExecutor(max_workers=workers) as pool:
        for i, _ in enumerate(pool.map(process, enumerate(files))):
            if progress is not None:
                progress(i + 1, len(files))
    return out_dirs
