"""Sketch serving, PyTorch port: the streaming top-k endpoint and the async
serving engine (sketch_engine.py) behind the submit/flush protocol."""
