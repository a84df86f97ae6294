"""engine layer of the PyTorch port."""
