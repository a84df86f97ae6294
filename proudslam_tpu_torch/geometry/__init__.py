"""geometry layer of the PyTorch port."""
