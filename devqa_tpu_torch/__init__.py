"""devqa_tpu_torch — the PyTorch / CUDA port of ``devqa_tpu`` for NVIDIA Hopper.

A second package beside the JAX one, with the same layout and public names
so each module's counterpart is easy to find:

- ``core``      — BLIP-2 (EVA ViT-g, Q-Former, OPT) as plain functions over
                  parameter dicts, and ``TorchVLLM``, the stateful wrapper.
- ``ops``       — layers, attention, and the hand-written Hopper kernels
                  (``ops/csrc``) with their plain PyTorch versions.
- ``data``      — EVQA loading, t×i probe synthesis, xym label semantics.
- ``retrieval`` — embedding store + top-k search for probe synthesis.
- ``editors``   — LiveEdit (inference).
- ``eval``      — the dynamic-evaluation harness.
- ``utils``     — configs and the JAX-parameter converter.

The port never imports ``jax`` or ``devqa_tpu``; only its tests import both.

Numerics contract (``ops/layers.py``): matmuls accumulate in float32 and
round once to the input dtype. Float32 products therefore run in full
float32 (no TF32) and bf16 products never reduce in bf16; the flags below
are set for every user of the package.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

__version__ = "0.1.0"
