"""What the tests of ``examples_torch/`` share: a loader that imports a
twin by path, and the key stand-in built from the JAX package's own draws,
with which a twin's answers must equal the example's."""
import importlib.util
import sys
from pathlib import Path

import jax
import numpy as np

from repro import configs as rconfigs
from repro.core import hashing as rh
from repro.core import sketch as rsk
from repro.training import train_loop as rtl
from repro.training.optimizer import OptimizerConfig as ROptimizerConfig
from repro_torch import interop

ROOT = Path(__file__).resolve().parents[1]
TWINS = ROOT / "examples_torch"
NAMES = ("quickstart", "stream_pipeline", "heavy_hitters", "async_serving",
         "windowed_topk", "sharded_serving", "fault_recovery", "ngram_stats")


def load_twin(name: str):
    """``examples_torch/<name>.py`` as a module (its ``_common`` import
    needs the directory on ``sys.path``)."""
    if str(TWINS) not in sys.path:
        sys.path.insert(0, str(TWINS))
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}",
                                                  TWINS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ref_spec(spec):
    """The reference's twin of a port ``SketchSpec``."""
    return rsk.SketchSpec(rh.KeySchema(spec.schema.domains), spec.partition, spec.ranges,
                          spec.width)


class RefKey:
    """The twins' key object made of ``jax.random.PRNGKey(k)``'s draws:
    ``params(spec)`` is the reference's ``init_params(spec, key)``,
    ``draw(n, spec)`` its ``init_params(spec, fold_in(key, n))``, and
    ``train_state`` the reference's ``init_train_state(cfg, tcfg, key)``
    (the example's reduced gemma2 and optimizer) carried across."""

    def __init__(self, k: int):
        self.key = jax.random.PRNGKey(k)

    def params(self, spec):
        p = rsk.init_params(ref_spec(spec), self.key)
        return np.asarray(p.q), np.asarray(p.r)

    def draw(self, n, spec):
        p = rsk.init_params(ref_spec(spec), jax.random.fold_in(self.key, n))
        return np.asarray(p.q), np.asarray(p.r)

    def train_state(self, cfg, tcfg, device):
        rstate = self.ref_train_state()
        qr = (np.asarray(rstate["sketch_params"].q), np.asarray(rstate["sketch_params"].r))
        return interop.train_state_from_numpy(
            cfg, tcfg, jax.tree.map(np.asarray, rstate["params"]), qr, device=device)

    def ref_train_state(self):
        return rtl.init_train_state(rconfigs.get_reduced("gemma2-9b"), ngram_train_config(),
                                    self.key)


def ngram_train_config():
    """``examples/ngram_stats.py``'s train config, on the reference."""
    return rtl.TrainConfig(optimizer=ROptimizerConfig(lr=1e-3, total_steps=60))
