"""Tensor-level operations of the PyTorch/CUDA port."""
