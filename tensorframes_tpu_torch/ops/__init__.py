"""Op lowering rules and the hand-written kernels of the PyTorch port."""
