"""Array-level ops of the PyTorch port (the Threefry RNG core)."""
