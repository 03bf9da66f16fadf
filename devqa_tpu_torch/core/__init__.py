"""Models: BLIP-2 (EVA ViT-g, Q-Former, OPT) and the TorchVLLM wrapper."""
