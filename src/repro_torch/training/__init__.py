"""Training (PyTorch port of ``repro/training``): optimizer, sketch-based
gradient compression and the train loop."""
