"""Sharding of renders and training steps over torch.distributed ranks."""
