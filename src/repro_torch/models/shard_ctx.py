"""Activation-sharding context, PyTorch port of ``repro/models/shard_ctx.py``.

The launcher activates a mesh for the model code it runs.  Tokens for
:func:`constrain`:

    DP   -- the data-parallel axes ("data" or ("pod", "data"))
    MP   -- the model axis
    None -- unsharded dim

The context is what MoE's mesh paths read (``models/moe.py``: the
per-data-shard group count of ``moe_dispatch="local"`` and the expert
dispatch of ``moe_dispatch="ep_shardmap"``).

Deliberate difference from the reference: the port's mesh is
single-controller (``launch/mesh.py``).  One caller owns every position and
no partitioner decides where an intermediate lives, so there is nothing for
a ``with_sharding_constraint`` pin to tell.  :func:`constrain` returns its
argument itself, in a context and outside one, and the port's model code
need not call it.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

from repro_torch.launch.mesh import Mesh

DP = "__dp__"
MP = "__mp__"

_state = threading.local()


@contextlib.contextmanager
def activation_sharding(mesh: Mesh):
    """Make ``mesh`` the current mesh of this thread: data axes are every
    axis but the last, the model axis the last."""
    names = mesh.axis_names
    prev = getattr(_state, "ctx", None)
    _state.ctx = (mesh, tuple(names[:-1]), names[-1])
    try:
        yield
    finally:
        _state.ctx = prev


def current_mesh() -> Optional[Mesh]:
    ctx = getattr(_state, "ctx", None)
    return ctx[0] if ctx else None


def constrain(x, *tokens):
    """``x`` itself: a single-controller mesh has no partitioner to pin."""
    return x
