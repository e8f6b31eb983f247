"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

One run drives one cell of ``BENCHMARK.json`` once:

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Nothing here imports ``jax`` or the JAX package; ``perfbench/reference/``
imports nothing of ``repro_torch`` either.  See ``perfbench/README.md``.
"""
