"""Keys, texts and per-key device engines of the PyTorch/CUDA port."""
