"""What a run loads: never ``jax``, ``jaxlib``, ``flax`` or the JAX package
(top-level names compared whole: ``repro_torch`` starts with ``repro``),
and, for the plain references, nothing of the program either.  Each check
runs in a fresh interpreter, since the test process loads the JAX package
for other tests."""
import json
import subprocess
import sys

from perfbench import harness

PRELUDE = f"""
import sys, json
sys.path[:0] = [{str(harness.ROOT)!r}, {str(harness.ROOT / 'src')!r}]
"""
REPORT = "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"


def _loaded(body: str) -> set:
    out = subprocess.run([sys.executable, "-c", PRELUDE + body + "\n" + REPORT],
                         capture_output=True, text=True, timeout=240, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_nor_the_jax_package():
    loaded = _loaded("""
from perfbench import harness, calibrate, counts, peaks, trace
from perfbench.tests import tiny
r = tiny.ingest(seconds=0.05)
harness.system(r.config["system"]).run(r)
import perfbench.run
""")
    assert "repro_torch" in loaded           # the program ran
    assert not loaded & set(harness.FORBIDDEN)


def test_the_references_load_nothing_of_the_program():
    loaded = _loaded("""
import torch
from perfbench.reference import conservative, hashing
cells = torch.randint(0, 8, (2, 30))
conservative.fold_serial_(torch.zeros((2, 8), dtype=torch.int64), cells, torch.ones(30))
g = torch.Generator().manual_seed(0)
q, r = torch.randint(0, hashing.P31, (2, 4), generator=g), torch.randint(0, 9, (2, 2))
hashing.cells(torch.randint(0, 1 << 32, (5, 2)), q, r, (1 << 32, 1 << 32), [[0], [1]], (4, 4))
""")
    assert "torch" in loaded
    assert not loaded & (set(harness.FORBIDDEN) | {"repro_torch"})
