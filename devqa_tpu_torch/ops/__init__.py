"""Layers, attention, and the hand-written Hopper kernels (csrc/) with their plain versions."""
