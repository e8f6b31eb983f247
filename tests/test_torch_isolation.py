"""Import guard for the port: ``repro_torch`` and ``chip_smoke.py`` stand
alone.

No module of the port imports ``jax`` or anything of the JAX package
``repro`` (checked both by importing everything with jax made unimportable
and by scanning the sources), and no entry point quietly runs on the CPU:
with no device named and no CUDA card, it raises.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_port_imports_with_jax_unimportable():
    code = f"""
import importlib, pkgutil, sys
sys.modules["jax"] = None            # any `import jax` now raises ImportError
sys.path.insert(0, {str(ROOT)!r})
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke                    # its work sits behind __main__
bad = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert not bad, bad
assert sys.modules["jax"] is None
print(len(names))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(), cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_reference(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def _entry_points():
    from repro_torch import interop
    from repro_torch.core import countsketch as cs
    from repro_torch.core import hierarchy as hh
    from repro_torch.core import sketch as sk
    from repro_torch.core.hashing import KeySchema
    from repro_torch.core.exhaustive import exhaustive_config
    from repro_torch.core.greedy import greedy_config
    from repro_torch.core.selection import choose_sketch, migration_gain
    from repro_torch.kernels.ops import KernelHierarchy, KernelSketch
    from repro_torch.serving.sketch_engine import SketchTopKEndpoint

    spec = sk.mod_sketch_spec(KeySchema((256, 256)), [(0,), (1,)], (8, 8), 2)
    hspec = hh.HierarchySpec.from_spec(spec)
    gen = torch.Generator().manual_seed(0)
    items = np.zeros((4, 2), np.uint32)
    freqs = np.ones(4, np.int64)
    return {
        "SketchTopKEndpoint": lambda: SketchTopKEndpoint(spec, gen),
        "KernelSketch": lambda: KernelSketch(spec, gen),
        "KernelHierarchy": lambda: KernelHierarchy(hspec, gen),
        "KernelSketch_signed": lambda: KernelSketch(spec, gen, mode="signed"),
        "KernelHierarchy_signed": lambda: KernelHierarchy(hspec, gen, mode="signed"),
        "countsketch.init_hierarchy": lambda: cs.init_hierarchy(hspec, gen),
        "init_hierarchy": lambda: hh.init_hierarchy(hspec, gen),
        "build_hierarchy": lambda: hh.build_hierarchy(hspec, gen, items, freqs),
        "init_state": lambda: sk.init_state(spec, gen),
        "build_sketch": lambda: sk.build_sketch(spec, gen, items, freqs),
        "params_from_numpy": lambda: interop.params_from_numpy(
            np.zeros((2, 2), np.uint32), np.zeros((2, 2), np.uint32)),
        "SketchTopKEndpoint_conservative": lambda: SketchTopKEndpoint(
            spec, gen, mode="conservative"),
        "KernelSketch_conservative": lambda: KernelSketch(spec, gen, mode="conservative"),
        "choose_sketch": lambda: choose_sketch(items, freqs, spec.schema, 64, 2),
        "migration_gain": lambda: migration_gain(spec, spec, items, freqs),
        "greedy_config": lambda: greedy_config(items, freqs, spec.schema, 64, 2),
        "exhaustive_config": lambda: exhaustive_config(items, freqs, spec.schema, 64, 2),
    }


@pytest.mark.parametrize("name", sorted(
    ["SketchTopKEndpoint", "KernelSketch", "KernelHierarchy", "init_hierarchy",
     "build_hierarchy", "init_state", "build_sketch", "params_from_numpy",
     "KernelSketch_signed", "KernelHierarchy_signed", "countsketch.init_hierarchy",
     "SketchTopKEndpoint_conservative", "KernelSketch_conservative", "choose_sketch",
     "migration_gain", "greedy_config", "exhaustive_config"]))
def test_entry_points_without_a_card_raise(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()


def test_chip_smoke_refuses_without_a_card(monkeypatch, capsys):
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main([]) == 2
    assert capsys.readouterr().out == ""


def test_chip_smoke_alone_fails(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                         text=True, env=env, cwd=tmp_path, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
