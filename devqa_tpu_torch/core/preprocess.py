"""Image normalization (counterpart of ``devqa_tpu/core/preprocess.py``).

The JAX package skips its cubic resize when images already arrive at the
model size, which image providers deliver. The port has normalization
only: ``torch.nn.functional.interpolate``'s bicubic kernel uses another
cubic coefficient than ``jax.image.resize``, so any other size raises
until a matching resize is ported.
"""
from __future__ import annotations

import torch

# OpenAI-CLIP normalization constants (BLIP-2 / CLIP / LAVIS processors).
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def preprocess_images(images_u8: torch.Tensor, image_size: int,
                      mean=CLIP_MEAN, std=CLIP_STD) -> torch.Tensor:
    """[B, S, S, 3] uint8 → normalized float32, S == ``image_size``."""
    if tuple(images_u8.shape[1:3]) != (image_size, image_size):
        raise NotImplementedError(
            "images of size %s need a resize to %d, which is not ported"
            % (tuple(images_u8.shape[1:3]), image_size))
    x = images_u8.to(torch.float32) / 255.0
    mean = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x - mean) / std
