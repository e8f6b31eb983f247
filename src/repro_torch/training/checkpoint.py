"""Checkpoint save/restore, PyTorch port of ``repro/training/checkpoint.py``:
atomic, manifest-driven, async-capable, and the reference's on-disk format.

Layout (one directory per step)::

    <dir>/step_00000042/
        manifest.json          # step, tree paths, shapes, dtypes, CRC32s
        proc00_shard000.npz    # this process's leaf data

Writes go to ``step_xxx.tmp`` and are renamed into place only after the
manifest is fsync'd: a crashed writer never corrupts the latest complete
checkpoint, and restore picks the newest *complete* step (manifest
present).  :class:`AsyncCheckpointer` moves the write off the caller's
thread (the host copy happens at ``submit``, so later in-place updates of
the live tensors cannot leak into the checkpoint), surfaces worker
failures on the next ``wait()``/``submit()``, and retries I/O errors with
backoff.

Manifests are versioned (``format_version: 2``) and carry a CRC32 per
array, so a restore detects silent corruption
(:class:`CheckpointCorruptionError`); serving recovery falls back to the
previous snapshot on it.  Version-1 manifests (no CRC) still restore.

Trees are nested dicts, lists, tuples and NamedTuples of tensors, numpy
arrays or numbers (``None`` is an empty subtree, as in jax), plus objects
that name their array fields in ``_tree_fields`` (the compressor's
``LeafCompressor``).  A leaf's path joins its dict keys and sequence
indices with "/", as the reference's ``tree_flatten_with_path`` strings
do; NamedTuple and ``_tree_fields`` levels add their field names.

bfloat16 leaves are stored as raw 2-byte words (numpy's ``|V2``) under the
manifest dtype ``"bfloat16"``: numpy has no bfloat16 without
``ml_dtypes``, and the reference's archives hold its bfloat16 leaves the
same way.  They are read back by that dtype string into
``torch.bfloat16``; the CRC is over the raw bytes either way.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

PyTree = Any

FORMAT_VERSION = 2
BF16 = "bfloat16"


class CheckpointCorruptionError(RuntimeError):
    """A stored array failed its CRC32 check (or the archive is unreadable)."""


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _process_index() -> int:
    """This process's index in the archive names: the port runs one
    controller process (the reference's ``jax.process_index()``)."""
    return 0


# --------------------------------------------------------------------------
# trees
# --------------------------------------------------------------------------

def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """(key, child) pairs of an inner node in the reference's leaf order;
    None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    fields = getattr(node, "_tree_fields", None)
    if fields is not None:
        return [(f, getattr(node, f)) for f in fields]
    return None


def flatten_with_paths(tree: PyTree) -> List[Tuple[str, Any]]:
    """(path, leaf) pairs, depth first, dict keys sorted; ``None`` holds no
    leaf."""
    out: List[Tuple[str, Any]] = []
    _walk(tree, "", out)
    return out


def _walk(node, path: str, out: list) -> None:
    if node is None:
        return
    kids = _children(node)
    if kids is None:
        out.append((path, node))
        return
    for key, child in kids:
        _walk(child, f"{path}/{key}" if path else key, out)


def _rebuild(template, leaves) -> Any:
    """``template`` with its leaves replaced, in order, from the iterator
    ``leaves``."""
    if template is None:
        return None
    kids = _children(template)
    if kids is None:
        return next(leaves)
    vals = [_rebuild(child, leaves) for _, child in kids]
    if isinstance(template, dict):
        return dict(zip(sorted(template), vals))
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*vals)
    if isinstance(template, (list, tuple)):
        return type(template)(vals)
    return dataclasses.replace(template, **dict(zip(template._tree_fields, vals)))


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as the array the archive stores, and its manifest dtype."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(np.dtype("V2")), BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str, like) -> Any:
    """A stored array as a leaf shaped like the template's ``like``: a
    tensor on its device for a tensor template, else a numpy array.
    bfloat16 words always come back as a ``torch.bfloat16`` tensor."""
    if dtype == BF16:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
        return t.to(like.device) if isinstance(like, torch.Tensor) else t
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(like.device)
    return arr


# --------------------------------------------------------------------------
# save / restore
# --------------------------------------------------------------------------

def save(directory: str, step: int, trees: Dict[str, PyTree], keep_last: int = 3) -> str:
    """Write a checkpoint; returns the final path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    proc = _process_index()
    manifest: Dict[str, Any] = {"step": step, "trees": {},
                                "format_version": FORMAT_VERSION,
                                "n_processes": 1,
                                "time": time.time()}
    arrays: Dict[str, np.ndarray] = {}
    for name, tree in trees.items():
        entries = []
        for path, leaf in flatten_with_paths(tree):
            arr, dtype = _to_numpy(leaf)
            entries.append({"path": path, "shape": list(arr.shape), "dtype": dtype,
                            "crc32": _crc(arr)})
            arrays[f"{name}::{path}"] = arr
        manifest["trees"][name] = entries
    np.savez(os.path.join(tmp, f"proc{proc:02d}_shard000.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _prune(directory, keep_last)
    return final


def _prune(directory: str, keep_last: int) -> None:
    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def list_steps(directory: str) -> List[int]:
    """All complete checkpoint steps under ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for d in os.listdir(directory):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, d, "manifest.json")):
                steps.append(int(d.split("_")[1]))
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    steps = list_steps(directory)
    return steps[-1] if steps else None


def _load_step_arrays(directory: str, step: Optional[int], verify: bool,
                      ) -> Tuple[int, Dict[str, Any], Dict[str, np.ndarray]]:
    """(step, manifest, {"name::path": array}) with the optional CRC check."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no complete checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    npz_path = os.path.join(path, f"proc{_process_index():02d}_shard000.npz")
    try:
        with np.load(npz_path) as data:
            arrays = {k: data[k] for k in data.files}
    except (OSError, ValueError, zlib.error) as e:
        raise CheckpointCorruptionError(f"unreadable archive {npz_path}: {e}")
    if verify and manifest.get("format_version", 1) >= 2:
        for name, entries in manifest["trees"].items():
            for e in entries:
                key = f"{name}::{e['path']}"
                if key not in arrays:
                    raise CheckpointCorruptionError(
                        f"step {step}: array {key} missing from archive")
                got = _crc(arrays[key])
                if got != e["crc32"]:
                    raise CheckpointCorruptionError(
                        f"step {step}: CRC mismatch for {key} "
                        f"(stored {e['crc32']:#010x}, got {got:#010x})")
    return manifest["step"], manifest, arrays


def restore(directory: str, templates: Dict[str, PyTree], step: Optional[int] = None,
            verify: bool = True) -> Tuple[int, Dict[str, PyTree]]:
    """Restore trees shaped like ``templates`` from the newest (or given)
    step.  Leaves are matched by position, as the reference matches them; a
    tensor leaf comes back as a tensor on its template's device."""
    step, manifest, data = _load_step_arrays(directory, step, verify)
    out: Dict[str, PyTree] = {}
    for name, template in templates.items():
        like = [leaf for _, leaf in flatten_with_paths(template)]
        entries = manifest["trees"][name]
        if len(entries) != len(like):
            raise ValueError(f"tree {name}: checkpoint has {len(entries)} leaves, "
                             f"template has {len(like)}")
        vals = [_from_numpy(data[f"{name}::{e['path']}"], e["dtype"], leaf)
                for e, leaf in zip(entries, like)]
        out[name] = _rebuild(template, iter(vals))
    return step, out


def restore_trees(directory: str, step: Optional[int] = None, verify: bool = True,
                  ) -> Tuple[int, Dict[str, Dict[str, Any]]]:
    """Template-free restore: ``(step, {tree_name: {leaf_path: array}})`` in
    manifest order.  Serving recovery cannot always build a template before
    reading (the saved shard count decides how the backend is rebuilt).
    Arrays come back as numpy, bfloat16 leaves as ``torch.bfloat16``
    tensors."""
    step, manifest, data = _load_step_arrays(directory, step, verify)
    out: Dict[str, Dict[str, Any]] = {}
    for name, entries in manifest["trees"].items():
        out[name] = {e["path"]: _from_numpy(data[f"{name}::{e['path']}"], e["dtype"], None)
                     for e in entries}
    return step, out


# --------------------------------------------------------------------------
# async writer
# --------------------------------------------------------------------------

def _host_copy(tree: PyTree) -> PyTree:
    """Every leaf copied to host memory now: tensors to CPU tensors (a copy
    even of a CPU tensor, which the caller may update in place), the rest
    to numpy arrays."""
    leaves = []
    for _, leaf in flatten_with_paths(tree):
        if isinstance(leaf, torch.Tensor):
            leaves.append(leaf.detach().to("cpu", copy=True))
        else:
            leaves.append(np.array(leaf, copy=True))
    return _rebuild(tree, iter(leaves))


class AsyncCheckpointer:
    """Background checkpoint writer (one in flight; host copy at submit).

    ``submit`` first waits on the in-flight write, so a failed prior write
    raises there rather than being dropped; ``wait`` re-raises the worker's
    exception.  I/O errors (``OSError``) are retried ``retries`` times with
    exponential backoff before giving up; anything else fails at once.
    """

    def __init__(self, directory: str, keep_last: int = 3, retries: int = 2,
                 backoff: float = 0.05):
        self.directory = directory
        self.keep_last = keep_last
        self.retries = int(retries)
        self.backoff = float(backoff)
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[Exception] = None

    def _save_with_retry(self, step: int, trees: Dict[str, PyTree]) -> None:
        # calls the module-global ``save`` on each attempt, so a test can
        # monkeypatch in transient failures
        for attempt in range(self.retries + 1):
            try:
                save(self.directory, step, trees, self.keep_last)
                return
            except OSError:
                if attempt == self.retries:
                    raise
                time.sleep(self.backoff * (2 ** attempt))

    def submit(self, step: int, trees: Dict[str, PyTree]) -> None:
        self.wait()  # raises if the previous write failed -- never dropped
        host_trees = {k: _host_copy(t) for k, t in trees.items()}

        def work():
            try:
                self._save_with_retry(step, host_trees)
            except Exception as e:  # surfaced on the next wait()/submit()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err
