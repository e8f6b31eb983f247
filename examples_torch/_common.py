"""What the twins of ``examples/`` share: the key stand-in, their common
flags, the device's name and a mesh of repeated devices.

The twins import it as ``_common``: their own directory is on
``sys.path`` when one runs as a script, and a loader that imports a twin
by path puts it there first.
"""
import argparse

import torch

from repro_torch.core import sketch as sk
from repro_torch.core.selection import seeded_draw
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.training import train_loop as tl


class SeedKey:
    """The stand-in for an example's ``jax.random.PRNGKey(seed)``.

    An example passes one jax key wherever it builds state, and for the
    same spec that key always gives the same hash parameters: two
    endpoints built from it can be merged, and a recovered endpoint
    replays its log into the same hash functions.  A ``torch.Generator``
    gives a new draw at every call, so a twin takes a key object with
    these three members instead (the tests pass one built from the JAX
    package's own draws):

    - ``params(spec)``: the ``(q, r)`` hash parameters of ``spec``, the
      same tensors at every call for the same spec;
    - ``draw(n, spec)``: the search's candidate ``n``
      (``core.selection.seeded_draw``);
    - ``train_state(cfg, tcfg, device)``: a fresh train state.
    """

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self.draw = seeded_draw(self.seed)

    def _generator(self) -> torch.Generator:
        return torch.Generator().manual_seed(self.seed)

    def params(self, spec) -> sk.SketchParams:
        return sk.init_params(spec, self._generator(), "cpu")

    def train_state(self, cfg, tcfg, device) -> dict:
        return tl.init_train_state(cfg, tcfg, self._generator(), device)


def parser(doc: str) -> argparse.ArgumentParser:
    """The flags every twin takes: ``--device`` (default: the card, an
    error without one) and ``--seed`` (the example's ``PRNGKey``)."""
    ap = argparse.ArgumentParser(description=doc.strip().split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu, for the plain PyTorch versions")
    ap.add_argument("--seed", type=int, default=0,
                    help="stands in for the example's jax.random.PRNGKey(0)")
    return ap


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "the CPU"


def data_mesh(n: int, device: torch.device) -> Mesh:
    """A 1-D ``data`` mesh of ``n`` positions: dealt round the visible
    cards (``launch.mesh.make_mesh``), or ``n`` positions on the CPU."""
    if device.type == "cuda":
        return make_mesh((n,), ("data",))
    return Mesh((n,), ("data",), [device] * n)
