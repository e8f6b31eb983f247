"""Sketch serving, PyTorch port: the streaming top-k endpoint and the async
serving engine (sketch_engine.py) behind the submit/flush protocol, the
windowed service (windowed_topk.py), hot spec migration (migration.py) and
the auto-tuner (autotune.py)."""
