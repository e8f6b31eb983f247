"""CPU tests of the benchmark; they run with the repository's test suite."""
import sys
from pathlib import Path

_SRC = str(Path(__file__).resolve().parents[2] / "src")
if _SRC not in sys.path:   # the program, as run.py finds it
    sys.path.append(_SRC)
