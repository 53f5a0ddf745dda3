"""SE(3) Lie ops, pinhole camera, Umeyama alignment (PyTorch)."""
