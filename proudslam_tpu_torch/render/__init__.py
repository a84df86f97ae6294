"""render layer of the PyTorch port."""
