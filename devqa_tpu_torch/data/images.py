"""Image providers: path → raw uint8 [S, S, 3] (counterpart of ``devqa_tpu/data/images.py``)."""
from __future__ import annotations

import zlib
from typing import Protocol

import numpy as np


class ImageProvider(Protocol):
    def __call__(self, path: str) -> np.ndarray:  # [S, S, 3] uint8
        ...


class SyntheticImageProvider:
    """Deterministic path-seeded random images, for tests and benches
    where no image corpus exists (same pixels as the JAX package's)."""

    def __init__(self, image_size: int):
        self.image_size = image_size

    def __call__(self, path: str) -> np.ndarray:
        seed = zlib.crc32(str(path).encode()) % (2 ** 31)
        rng = np.random.default_rng(seed)
        return rng.integers(0, 256, (self.image_size, self.image_size, 3),
                            dtype=np.uint8).astype(np.uint8)
