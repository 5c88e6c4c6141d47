"""Test harnesses of the PyTorch port (fault injection)."""
