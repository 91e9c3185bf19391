"""Host utilities of the PyTorch/CUDA port."""
