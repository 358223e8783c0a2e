"""Sharded rendering of the PyTorch/CUDA port over torch.distributed."""
