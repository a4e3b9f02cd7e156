"""Optimizers of the PyTorch port."""
