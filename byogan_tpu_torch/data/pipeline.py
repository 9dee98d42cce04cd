"""Per-stage training data (byogan_tpu/data/pipeline.py:33-377).

A stage reads ``<root>/prepared/set_{stage}`` (ImageFolder layout: files
under class subdirectories), or derives it from a higher set with prep's
2x bilinear filter.  ``packed.npy`` (``pack_stage``) is read as a uint8 NHWC
memmap with no decode.  Files are listed by extension and decoded by
format (``data/images.py``: PNG, JPEG and WebP through the native lane,
BMP in numpy; any other raises, naming the file), on ``workers`` threads
as the JAX package's are (byogan_tpu/data/pipeline.py:91-168).  The loader keeps
the JAX loader's order of random draws (one permutation per epoch, then
one flip draw per batch from ``np.random.default_rng(seed)``), so the same
seed gives the same batches, drops the ragged tail and yields flipped
uint8 batches: the train step maps them to [-1, 1] on the device.  ``to_device`` copies them from pinned
memory ahead of use.
"""

from __future__ import annotations

import collections
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, List, Optional

import numpy as np
import torch

from byogan_tpu_torch.data.images import is_image, read_image

#: a stage's decoded images are kept in memory when they fit in this
CACHE_LIMIT_BYTES = 1 << 30


class StageDataset:
    """Images of one progressive stage.  ``derive_shift=k`` reads the files
    of ``set_{stage}`` and downsamples each by 2^k.  ``maybe_cache`` keeps
    the decoded set in memory when it fits in ``cache_limit_bytes`` (0: never)."""

    def __init__(self, root: str, stage: int, cache_limit_bytes: int = CACHE_LIMIT_BYTES, derive_shift: int = 0):
        self.set_dir = os.path.join(root, "prepared", f"set_{stage}")
        self.derive_shift = derive_shift
        self.cache_limit_bytes = cache_limit_bytes
        if not os.path.isdir(self.set_dir):
            raise OSError(f"Did not detect prepared dataset! (missing {self.set_dir})")
        self.files: List[str] = []
        for dirpath, _, names in sorted(os.walk(self.set_dir)):
            for name in sorted(names):
                if is_image(name):
                    self.files.append(os.path.join(dirpath, name))
        self._cache: Optional[np.ndarray] = None
        self._file_shape: Optional[tuple] = None  # (H, W) of the last file decoded: a hint, see decode
        packed = os.path.join(self.set_dir, "packed.npy")
        self._packed: Optional[np.ndarray] = None
        if derive_shift == 0 and os.path.exists(packed):
            self._packed = np.load(packed, mmap_mode="r")
        if not self.files and self._packed is None:
            raise OSError(f"no images under {self.set_dir}")

    def __len__(self) -> int:
        return len(self.files) if self._packed is None else int(self._packed.shape[0])

    def decode(self, index: int) -> np.ndarray:
        # A set's files share one size, so the last one's lets the native
        # lane decode in one call; a file of another size is still read.
        img = read_image(self.files[index], self._file_shape)
        self._file_shape = img.shape[:2]
        return _downsample_u8(img, self.derive_shift) if self.derive_shift else img

    def fill(self, out: np.ndarray, indices: Iterable[int], workers: int = 8) -> None:
        """``out[j] = decode(indices[j])`` on ``workers`` threads; a file of
        another size than ``out``'s rows raises, naming it."""
        def one(j_index):
            j, index = j_index
            img = self.decode(int(index))
            if img.shape != out.shape[1:]:
                raise OSError(f"{self.files[index]}: size {img.shape} differs from the set's {out.shape[1:]}")
            out[j] = img

        _threaded(one, list(enumerate(indices)), workers)

    def maybe_cache(self, workers: int = 8) -> bool:
        """Decode everything into one uint8 NHWC array if under budget."""
        if self._packed is not None or self._cache is not None:
            return True
        probe = self.decode(0)
        if probe.nbytes * len(self.files) > self.cache_limit_bytes:
            return False
        cache = np.empty((len(self.files),) + probe.shape, np.uint8)
        cache[0] = probe
        self.fill(cache[1:], range(1, len(self.files)), workers)
        self._cache = cache
        return True

    def get_batch_uint8(self, indices: np.ndarray, workers: int = 8) -> np.ndarray:
        if self._packed is not None:
            order = np.argsort(indices)
            out = np.empty((len(indices),) + self._packed.shape[1:], np.uint8)
            out[order] = self._packed[indices[order]]
            return out
        if self._cache is not None:
            return self._cache[indices]
        batch = _threaded(self.decode, [int(i) for i in indices], workers)
        for index, img in zip(indices, batch):
            if img.shape != batch[0].shape:
                raise OSError(f"{self.files[index]}: size {img.shape} differs from the batch's {batch[0].shape}")
        return np.stack(batch)


def _threaded(fn, items: list, workers: int) -> list:
    """``[fn(x) for x in items]`` on up to ``workers`` threads."""
    if workers <= 1 or len(items) <= 1:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(max_workers=min(workers, len(items))) as pool:
        return list(pool.map(fn, items))


def pack_stage(root: str, stage: int, workers: int = 8) -> str:
    """Write set_{stage} as one uint8 NHWC ``packed.npy``, which later reads
    take with no decode, decoding on ``workers`` threads.  Returns its path."""
    ds = StageDataset(root, stage, cache_limit_bytes=0)
    probe = ds.decode(0)
    path = os.path.join(ds.set_dir, "packed.npy")
    tmp = path + ".tmp.npy"
    arr = np.lib.format.open_memmap(tmp, mode="w+", dtype=np.uint8, shape=(len(ds),) + probe.shape)
    arr[0] = probe
    ds.fill(arr[1:], range(1, len(ds)), workers)
    arr.flush()
    del arr
    os.replace(tmp, path)
    return path


def _halve_axis0(x: np.ndarray) -> np.ndarray:
    """One 2x reduction along axis 0 with PIL's BILINEAR filter for an
    integer factor: taps (1,3,3,1)/8 inside, (3,3,1)/7 at the borders."""
    n = x.shape[0] // 2
    if n == 1:
        return (x[0:1] + x[1:2]) / 2.0
    out = np.empty((n,) + x.shape[1:], np.float64)
    out[0] = (3.0 * x[0] + 3.0 * x[1] + x[2]) / 7.0
    out[n - 1] = (x[2 * n - 3] + 3.0 * x[2 * n - 2] + 3.0 * x[2 * n - 1]) / 7.0
    if n > 2:
        out[1:-1] = (
            x[1 : 2 * n - 3 : 2] + 3.0 * x[2 : 2 * n - 2 : 2]
            + 3.0 * x[3 : 2 * n - 1 : 2] + x[4 : 2 * n : 2]
        ) / 8.0
    return out


def _downsample_u8(img: np.ndarray, shift: int) -> np.ndarray:
    """2^shift downsample of an HWC uint8 image by repeated 2x halvings,
    rounding to uint8 between them as prep's resize chain does."""
    for _ in range(shift):
        x = _halve_axis0(img.astype(np.float64))
        x = _halve_axis0(x.transpose(1, 0, 2)).transpose(1, 0, 2)
        img = np.clip(np.floor(x + 0.5), 0, 255).astype(np.uint8)
    return img


def open_stage_dataset(root: str, stage: int, cache_limit_bytes: int = CACHE_LIMIT_BYTES) -> StageDataset:
    """set_{stage}, or the next higher set that exists, downsampled."""
    prepared = os.path.join(root, "prepared")
    if os.path.isdir(os.path.join(prepared, f"set_{stage}")):
        return StageDataset(root, stage, cache_limit_bytes)
    for higher in range(stage + 1, 16):
        if os.path.isdir(os.path.join(prepared, f"set_{higher}")):
            return StageDataset(root, higher, cache_limit_bytes, derive_shift=higher - stage)
    raise OSError(f"Did not detect prepared dataset! (missing {prepared}/set_{stage})")


def _flip_u8(batch: np.ndarray, flips: np.ndarray) -> np.ndarray:
    if flips.any():
        batch = batch.copy()
        batch[flips] = batch[flips, :, ::-1]
    return batch


def make_stage_loader(
    dataset: StageDataset,
    batch_size: int,
    seed: int = 0,
    skip_batches: int = 0,
    process_index: int = 0,
    process_count: int = 1,
    workers: int = 8,
) -> Iterator[np.ndarray]:
    """Yield one epoch of shuffled, randomly flipped uint8 NHWC batches of
    ``batch_size``, the ragged tail dropped, prepared on a worker thread two
    batches ahead.  ``skip_batches`` skips the first batches but still makes
    their random draws, so the stream continues as an uninterrupted one
    would (batch-exact resume).  ``workers`` threads decode each batch
    (and the stage's cache): they change who decodes, not what.

    Data parallelism (byogan_tpu/data/pipeline.py:274-335): with
    ``process_count > 1`` every process draws the same global shuffle and
    flips (same seed) but decodes only its contiguous ``batch_size /
    process_count`` rows of each global batch, the rows of its rank."""
    if batch_size % process_count != 0:
        raise ValueError(f"batch_size {batch_size} not divisible by process_count {process_count}")
    local_rows = batch_size // process_count
    lo_row = process_index * local_rows
    dataset.maybe_cache(workers)
    rng = np.random.default_rng(seed)
    n = len(dataset)
    q: "queue.Queue" = queue.Queue(maxsize=2)
    stop = threading.Event()
    done = object()

    def producer():
        try:
            order = rng.permutation(n)
            for lo in range(0, n - n % batch_size, batch_size):
                if stop.is_set():
                    return
                idx = order[lo : lo + batch_size]
                flips = rng.random(len(idx)) < 0.5  # the global batch's, then this process's rows
                if lo // batch_size < skip_batches:
                    continue
                rows = slice(lo_row, lo_row + local_rows)
                q.put(_flip_u8(dataset.get_batch_uint8(idx[rows], workers), flips[rows]))
        except Exception as e:  # handed to the consumer
            q.put(e)
        finally:
            q.put(done)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                break
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        while thread.is_alive():
            try:
                q.get_nowait()
            except queue.Empty:
                break
        thread.join(timeout=5)


def batches_per_epoch(dataset_len: int, batch_size: int) -> int:
    """len(DataLoader) with the tail dropped (train.py:119's fade span)."""
    return dataset_len // batch_size


def to_device(batches: Iterator[np.ndarray], device: torch.device, depth: int = 2):
    """Move batches to ``device`` ``depth`` ahead of use; on CUDA from
    pinned memory without blocking the host."""
    buf: collections.deque = collections.deque()
    cuda = device.type == "cuda"
    for b in batches:
        t = torch.from_numpy(b)
        buf.append(t.pin_memory().to(device, non_blocking=True) if cuda else t)
        if len(buf) >= depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()
