"""Model stack (PyTorch port of ``repro/models``): the dense and vlm
training path so far."""
