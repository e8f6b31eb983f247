"""Device meshes, PyTorch port of ``repro/launch/mesh.py``.

The reference is single-controller: one process owns a ``jax.sharding.Mesh``
and every sharded surface (``ShardedTopKService``, the distributed folds)
takes the whole mesh.  The port keeps that model.  A :class:`Mesh` is a
shape, its axis names and one ``torch.device`` per position, row-major.
Devices may repeat: CPU tests put every position on ``cpu``, and one card
can hold every shard of a service.  A collective over mesh axes is a
reduction over the shards' tensors in shard order onto the destination
device (``core/distributed.psum``); across cards its copies are peer
copies.

Constructors are functions, so importing this module touches no device.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.device import DeviceLike


class Mesh:
    """``prod(shape)`` devices laid out row-major over named axes.

    ``shape`` maps each axis name to its size, in axis order, as the
    reference's ``mesh.shape`` does."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices: Sequence[DeviceLike]):
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names} do not match")
        if len(devices) != math.prod(shape):
            raise ValueError(f"a {shape} mesh needs {math.prod(shape)} devices, "
                             f"got {len(devices)}")
        self.axis_names = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, shape))
        self.devices: List[torch.device] = [torch.device(d) for d in devices]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def first_device(self) -> torch.device:
        """Where merged (replicated) state and queries live."""
        return self.devices[0]

    def axis_size(self, axes: Sequence[str]) -> int:
        """The product of the sizes of ``axes`` (the shard count over them)."""
        return math.prod(self.shape[a] for a in axes)

    def axis_devices(self, axes: Sequence[str]) -> List[torch.device]:
        """One device for each position of ``axes`` (row-major over them),
        the other axes at index 0: shard s of a stream split over ``axes``
        lives on the s-th."""
        axes = tuple(axes)
        unknown = [a for a in axes if a not in self.shape]
        if unknown:
            raise ValueError(f"axes {unknown} are not mesh axes {self.axis_names}")
        strides, s = {}, 1
        for a in reversed(self.axis_names):
            strides[a] = s
            s *= self.shape[a]
        out = []
        for pos in range(self.axis_size(axes)):
            flat, rem = 0, pos
            for a in reversed(axes):
                flat += (rem % self.shape[a]) * strides[a]
                rem //= self.shape[a]
            out.append(self.devices[flat])
        return out

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]})"


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """A mesh on the visible cards: position i on ``cuda:{i % count}``, so
    a mesh larger than the card count folds several positions onto each
    card.  Raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; build a Mesh with device 'cpu' "
            "positions to run the plain PyTorch versions on the CPU")
    n = torch.cuda.device_count()
    return Mesh(shape, axes, [f"cuda:{i % n}" for i in range(math.prod(shape))])


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 (data, model) single pod; 2x16x16 (pod, data, model) for two.
    Raises unless that many cards are visible: 256 or 512 shards are never
    folded silently onto fewer cards."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        raise RuntimeError(f"the production mesh {shape} needs {need} CUDA devices, "
                           f"{have} are visible")
    return make_mesh(shape, axes)


def make_test_mesh(shape: Tuple[int, ...] = (2, 2),
                   axes: Tuple[str, ...] = ("data", "model")) -> Mesh:
    """Small mesh for tests on the cards (positions dealt round them).  A
    CPU test builds its ``Mesh`` with ``"cpu"`` positions."""
    return make_mesh(shape, axes)


def sketch_data_axes(mesh: Mesh) -> tuple:
    """Data-parallel axes for sketch serving on any of the meshes above.

    Sketch ingest shards the *stream*, never the table rows, so every axis
    except "model" is a data axis: ("data",) on the single pod / test mesh,
    ("pod", "data") on the two-pod mesh."""
    return tuple(a for a in mesh.axis_names if a != "model")
