"""Build, load and call the CUDA kernels in ``csrc/`` through ctypes.

The sources are compiled with ``nvcc`` for ``sm_90a`` -- one ``nvcc`` per
source, all started together -- and linked into one shared library with a
plain C interface, at first use, into ``build/`` at the root of the
checkout.  The file name carries a hash of the sources and flags, so an
edit rebuilds and an unchanged tree reuses the library.  Nothing here runs
at import: the CPU tests import every module on a machine without nvcc.

``LAUNCHES`` counts kernel launches per kernel name.  Each wrapper adds one
where it launches its kernel and nowhere else, so a run can show that the
main path went through the kernels (``reset_launches`` before, read after).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("sketch_kernels.cu", "signed_kernels.cu", "conservative_kernels.cu")
HEADERS = ("hashes.cuh", "hier_fold.cuh", "hier_query.cuh", "point_query.cuh")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

MAX_CHUNKS = 64
MAX_GROUPS = 16
MAX_LEVELS = 16

LAUNCHES: Dict[str, int] = {
    "sketch_update": 0, "sketch_query": 0, "hier_update": 0, "hier_query": 0,
    "sketch_update_signed": 0, "sketch_query_signed": 0, "sketch_query_signed_median": 0,
    "hier_update_signed": 0, "hier_query_signed": 0, "hier_query_signed_median": 0,
    "sketch_update_conservative": 0, "conservative_fold": 0,
    "sketch_update_f32": 0, "hier_update_f32": 0, "hier_query_f32": 0,
    "sketch_update_signed_f32": 0, "hier_update_signed_f32": 0}

_lock = threading.Lock()
_lib = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class IndexPlanC(ctypes.Structure):
    """Mirror of ``struct IndexPlanC`` in csrc/hashes.cuh."""
    _fields_ = [
        ("n_groups", ctypes.c_int32),
        ("total_chunks", ctypes.c_int32),
        ("group_start", ctypes.c_int32 * (MAX_GROUPS + 1)),
        ("cols", ctypes.c_int32 * MAX_CHUNKS),
        ("ranges", ctypes.c_uint32 * MAX_GROUPS),
        ("strides", ctypes.c_uint32 * MAX_GROUPS),
    ]


class LevelsC(ctypes.Structure):
    """Mirror of ``struct LevelsC`` in csrc/hashes.cuh."""
    _fields_ = [
        ("n_levels", ctypes.c_int32),
        ("divs", ctypes.c_uint32 * MAX_LEVELS),
        ("offsets", ctypes.c_int64 * MAX_LEVELS),
    ]


class ConsLevelsC(ctypes.Structure):
    """Mirror of ``struct ConsLevelsC`` in csrc/conservative_kernels.cu."""
    _fields_ = [
        ("n_levels", ctypes.c_int32),
        ("w", ctypes.c_int32),
        ("tables", ctypes.c_void_p * MAX_LEVELS),
        ("idx", ctypes.c_void_p * MAX_LEVELS),
        ("row_stride", ctypes.c_int64 * MAX_LEVELS),
        ("cols", ctypes.c_int64 * MAX_LEVELS),
        ("shared", ctypes.c_int32 * MAX_LEVELS),
    ]


@functools.lru_cache(maxsize=64)
def plan_struct(plan) -> IndexPlanC:
    """The C form of a ``kernels.hashes.IndexPlan`` (cached per plan)."""
    if plan.table_size >= 1 << 31:
        raise ValueError("the CUDA kernels need table sizes below 2^31 cells")
    if len(plan.ranges) > MAX_GROUPS or plan.total_chunks > MAX_CHUNKS:
        raise ValueError(
            f"the CUDA kernels take at most {MAX_GROUPS} groups and "
            f"{MAX_CHUNKS} chunks")
    s = IndexPlanC()
    s.n_groups = len(plan.ranges)
    s.total_chunks = plan.total_chunks
    pos = 0
    for j, cols in enumerate(plan.group_cols):
        s.group_start[j] = pos
        for c in cols:
            s.cols[pos] = c
            pos += 1
        s.ranges[j] = int(plan.ranges[j])
        s.strides[j] = int(plan.strides[j])
    s.group_start[len(plan.group_cols)] = pos
    return s


@functools.lru_cache(maxsize=64)
def levels_struct(offsets, divs) -> LevelsC:
    if len(offsets) > MAX_LEVELS:
        raise ValueError(f"the CUDA kernels take at most {MAX_LEVELS} levels")
    s = LevelsC()
    s.n_levels = len(offsets)
    for l, (off, div) in enumerate(zip(offsets, divs)):
        s.offsets[l] = int(off)
        s.divs[l] = int(div)
    return s


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")    # the toolkit's install default
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libsketch_kernels_{h.hexdigest()[:16]}.so"


def _nvcc_all(cmds, what: str) -> None:
    """Run the nvcc commands together and wait for every one of them; raise
    with the first failure's output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for cmd in cmds]
    outs = [proc.communicate() for proc in procs]
    for cmd, proc, (out, err) in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to {what} ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}{err}")


def build(force: bool = False) -> Path:
    """Compile the kernels unless the hashed library already exists
    (``force`` compiles anyway, e.g. to prove the sources build): one
    ``nvcc -c`` per source in parallel, then one link."""
    out = library_path()
    if out.exists() and not force:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(src).stem}.o" for src in SOURCES]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        _nvcc_all([[_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj),
                    str(CSRC / src)] for src, obj in zip(SOURCES, objs)], "compile")
        _nvcc_all([[_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
                    *map(str, objs)]], "link")
        os.replace(tmp, out)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


def _declare(lib) -> None:
    vp, i32, i64, u32 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_uint32
    sigs = {
        "sk_sketch_update": [vp, vp, i64, i32, vp, vp, i64, vp, vp, i32, i64, vp],
        "sk_sketch_update_f32": [vp, vp, i64, i32, vp, vp, i64, vp, vp, i32, i64, vp],
        "sk_sketch_query": [vp, vp, i64, i32, vp, i64, vp, vp, vp, i32, vp],
        "sk_hier_update": [vp, vp, vp, i64, i32, vp, vp, i64, vp, vp, u32, i32, i64, i64, vp],
        "sk_hier_update_f32": [vp, vp, vp, i64, i32, vp, vp, i64, vp, vp, u32, i32, i64, i64,
                               vp],
        "sk_hier_query": [vp, i64, i64, i32, vp, i64, vp, i64, i64, i64, i64, vp, vp],
        "sk_hier_query_f32": [vp, i64, i64, i32, vp, i64, vp, i64, i64, i64, i64, vp, vp],
        "sk_sketch_update_signed": [vp, vp, i64, i32, vp, vp, i64, vp, vp, vp, vp, vp],
        "sk_sketch_update_signed_f32": [vp, vp, i64, i32, vp, vp, i64, vp, vp, vp, vp, vp],
        "sk_sketch_query_signed": [vp, vp, i64, i32, vp, i64, vp, vp, vp, vp, vp, i32, vp],
        "sk_sketch_query_signed_median": [vp, vp, i64, i32, vp, i64, vp, vp, vp, vp, vp, i32,
                                          vp],
        "sk_hier_update_signed": [vp, vp, vp, i64, i32, vp, vp, i64, vp, vp, vp, vp, u32,
                                  i32, i64, i64, vp],
        "sk_hier_update_signed_f32": [vp, vp, vp, i64, i32, vp, vp, i64, vp, vp, vp, vp,
                                      u32, i32, i64, i64, vp],
        "sk_hier_query_signed": [vp, i64, i64, i32, vp, vp, i64, vp, vp, i64, i64, i64, i64,
                                 vp, vp],
        "sk_hier_query_signed_median": [vp, i64, i64, i32, vp, vp, i64, vp, vp, i64, i64, i64,
                                        i64, vp, vp],
        "sk_conservative_update_i32": [vp, vp, i64, i32, vp, vp, i64, vp, vp, i32, i32, vp],
        "sk_conservative_update_f32": [vp, vp, i64, i32, vp, vp, i64, vp, vp, i32, i32, vp],
        "sk_conservative_rounds_i32": [vp, vp, i64, i32, vp, vp, i64, vp, vp, i32, vp, i32, vp,
                                       vp, vp],
        "sk_conservative_rounds_f32": [vp, vp, i64, i32, vp, vp, i64, vp, vp, i32, vp, i32, vp,
                                       vp, vp],
        "sk_conservative_rounds_grid": [vp, i32, i32, i32, vp, vp],
        "sk_conservative_fold_i32": [vp, vp, i64, i32, vp],
        "sk_conservative_fold_f32": [vp, vp, i64, i32, vp],
        "sk_chain_probe": [vp, i64, i64, i32, vp, vp],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int


def library():
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
        return _lib


@functools.lru_cache(maxsize=16)
def sm_count(index: int) -> int:
    """The SMs of CUDA device ``index`` (the launch rules' card)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def require_table_dtype(table: torch.Tensor, kernel: str,
                        dtypes=(torch.int32,)) -> None:
    """The kernel's table types: int32 and float32 for the folds (K1, K3,
    K5, K5i, K6, K8); int32 alone for the reads (K2, K4, K7, K7m, K9, K9m), as
    the reference's query kernels, and float32 alone for K4f."""
    require(table.dtype in dtypes,
            f"{kernel}: the CUDA kernel takes "
            f"{' or '.join(str(d).replace('torch.', '') for d in dtypes)} "
            f"tables, got {table.dtype}")


def require_int32_table(table: torch.Tensor, kernel: str) -> None:
    require_table_dtype(table, kernel)


FOLD_DTYPES = (torch.int32, torch.float32)


def fold_variant(table: torch.Tensor, name: str, symbol: str):
    """(launch-count name, C function name, value dtype) of a fold for the
    table's dtype: the int32 body, or its float32 twin (``*_f32``)."""
    if table.dtype == torch.float32:
        return f"{name}_f32", f"{symbol}_f32", torch.float32
    return name, symbol, torch.int32


def require_on(device: torch.device, kernel: str, **tensors) -> None:
    for name, t in tensors.items():
        require(t.device == device,
                f"{kernel}: {name} is on {t.device}, the table on {device}")
        require(t.is_contiguous(), f"{kernel}: {name} must be contiguous")


def require_hash_inputs(kernel: str, plan, table: torch.Tensor,
                        chunks: torch.Tensor, q: torch.Tensor,
                        r: torch.Tensor, dtypes=(torch.int32,), signs=()) -> None:
    """Checks shared by the kernels that hash in place (K1-K3, K5-K8, K7m):
    a contiguous [w, cols] table of one of ``dtypes``, int64 chunks [B, C]
    and params q [w, C] / r [w, m] on the table's device, matching
    ``plan``.  The signed kernels (K6-K8, K7m) pass their sign params as
    ``signs`` (sq, sr), held to q's and r's rules."""
    require_table_dtype(table, kernel, dtypes)
    require_on(table.device, kernel, table=table, chunks=chunks, q=q, r=r)
    require(chunks.dtype == q.dtype == r.dtype == torch.int64,
            f"{kernel}: chunks, q and r must be int64")
    w = table.shape[0]
    require(chunks.dim() == 2 and chunks.shape[1] == plan.total_chunks
            and tuple(q.shape) == (w, plan.total_chunks)
            and tuple(r.shape) == (w, len(plan.ranges))
            and w == plan.width and w <= 65535,
            f"{kernel}: chunks {tuple(chunks.shape)}, q {tuple(q.shape)}, "
            f"r {tuple(r.shape)} and table {tuple(table.shape)} do not "
            "match the plan")
    if signs:
        sq, sr = signs
        require_on(table.device, kernel, sq=sq, sr=sr)
        require(sq.dtype == sr.dtype == torch.int64 and sq.shape == q.shape
                and sr.shape == r.shape,
                f"{kernel}: sq {tuple(sq.shape)} {sq.dtype} and sr {tuple(sr.shape)} "
                f"{sr.dtype} must be int64 of q's and r's shapes "
                f"{tuple(q.shape)}, {tuple(r.shape)}")
