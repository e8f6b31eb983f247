"""Serving, PyTorch port: model serving (model_engine.py: prefill, decode,
``ServeEngine`` and ``SlotScheduler``; kv_cache.py) and sketch serving (the
streaming top-k endpoint and the async serving engine, sketch_engine.py,
the windowed service, windowed_topk.py, hot spec migration, migration.py,
and the auto-tuner, autotune.py), both behind the submit/flush protocol;
engine.py re-exports the pre-split names."""
