"""Batch assembly for ragged image sets: size bucketing + pad-to-canvas.

XLA wants static shapes; real directories hold mixed-size images.  Strategy
(SURVEY.md §7 'hard part #1'): round each image's (H, W) up to a bucket
canvas (powers-of-two-ish ladder, always a multiple of 128 so canvases
tile evenly), group items by canvas, and batch groups to fixed batch sizes
so the jit cache stays small.  Per-image true extents travel alongside as an
int32 [B, 2] 'sizes' array; device ops maintain the zeros-outside-valid
invariant (ops/geometry.py).
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

# Canvas ladder: multiples of 128 up to 1024, then multiples of 512.
# Multiples of 128 tile evenly into 16-pixel JPEG iMCUs and wide vector
# accesses on both H and W.
_LADDER = [128, 256, 384, 512, 640, 768, 896, 1024, 1536, 2048, 3072, 4096]


def bucket_dim(n: int) -> int:
    """Smallest ladder canvas extent >= n (exact multiples of 512 beyond)."""
    for v in _LADDER:
        if n <= v:
            return v
    return int(math.ceil(n / 512) * 512)


def canvas_for(h: int, w: int, scale: float = 1.0) -> Tuple[int, int]:
    """Bucket canvas for an image, optionally scaled (e.g. rotation diag)."""
    return bucket_dim(int(math.ceil(h * scale))), bucket_dim(int(math.ceil(w * scale)))


def pad_to_canvas(arr: np.ndarray, canvas: Tuple[int, int],
                  channels: int = None) -> np.ndarray:
    """Zero-pad uint8 HWC to (canvas_h, canvas_w, channels)."""
    h, w, c = arr.shape
    ch = channels or c
    out = np.zeros((canvas[0], canvas[1], ch), dtype=arr.dtype)
    out[:h, :w, :c] = arr
    if ch > c:
        # promote RGB→RGBA with opaque alpha inside the valid region
        if ch == 4 and c == 3:
            out[:h, :w, 3] = 255
        elif ch == 3 and c == 1:
            out[:h, :w, 1] = arr[:, :, 0]
            out[:h, :w, 2] = arr[:, :, 0]
    return out


class Bucketizer:
    """Groups loaded items by canvas shape and yields fixed-size batches.

    Batch sizes are drawn from a short ladder (1, 2, 4, ..., max_batch) so a
    directory of N images compiles at most O(log max_batch) programs per
    canvas; the final ragged remainder is padded up to the next ladder size
    with duplicated rows and a per-row validity flag.
    """

    def __init__(self, max_batch: int = 64):
        self.max_batch = max_batch
        self._groups: Dict[Tuple, List] = defaultdict(list)

    def add(self, key: Tuple, item) -> None:
        self._groups[key].append(item)

    @staticmethod
    def batch_ladder(n: int, max_batch: int, mode: str = "pow2") -> List[int]:
        """Split n items into chunks.

        'pow2' (default): full batches + one power-of-two remainder chunk —
        O(log max_batch) programs per canvas, minimal padding waste.
        'fixed': everything padded to max_batch — exactly ONE program per
        canvas shape, best when compiles are expensive (cold caches,
        remote compile) and padding waste is acceptable.
        """
        sizes = []
        remaining = n
        while remaining >= max_batch:
            sizes.append(max_batch)
            remaining -= max_batch
        if remaining > 0:
            if mode == "fixed":
                sizes.append(max_batch)
            else:
                b = 1
                while b < remaining:
                    b *= 2
                sizes.append(min(b, max_batch))
        return sizes

    def batches(self) -> Iterable[Tuple[Tuple, List, int]]:
        """Yield (key, padded_item_list, n_valid) per batch.

        The item list is padded to the ladder size by repeating the last
        item; callers must ignore rows >= n_valid.
        """
        for key, items in self._groups.items():
            pos = 0
            for bsz in self.batch_ladder(len(items), self.max_batch):
                chunk = items[pos:pos + bsz]
                n_valid = len(chunk)
                while len(chunk) < bsz:
                    chunk.append(chunk[-1])
                yield key, chunk, n_valid
                pos += n_valid


def stack_field(items: Sequence[dict], field: str) -> np.ndarray:
    return np.stack([it[field] for it in items], axis=0)
