"""Models of the PyTorch port: reference oracle, presets, transformer, generation."""
