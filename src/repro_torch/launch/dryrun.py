"""Multi-pod dry-run: count every (arch x shape x mesh) cell without a card,
PyTorch port of ``repro/launch/dryrun.py``.

The production meshes are built on meta positions -- (16, 16) ("data",
"model") for one pod and (2, 16, 16) ("pod", "data", "model") for two --
and every cell's state is a tree of meta tensors made by the port's real
init functions (``launch/specs.py``).  Per cell it writes one JSON with:

  * the bytes one mesh position holds of the cell's state (params,
    optimizer and batch for ``train``; params, batch and the caches
    ``prefill`` returns for ``prefill``; params, cache and tokens for
    ``decode``), from ``sharding.local_shape`` over the sanitized specs,
    and whether that fits the card's 80 GB;
  * FLOPs counted by ``torch.utils.flop_counter.FlopCounterMode`` on the
    meta stand-ins (``train``: the loss's forward and backward), beside
    ``roofline.model_flops_for``;
  * the wire bytes of the parameter collectives the specs imply: an
    all-gather of every leaf split over data axes, and on ``train`` a
    reduce-scatter of its gradient, with the ring factors of
    ``roofline.wire_bytes``;
  * the ``Roofline`` terms.

Counting is fast because the stack is homogeneous: one block of each kind
(decoder, encoder) is counted at the cell's shape, and the whole is
extrapolated from the counts at one and two blocks; an SSM layer's chunk
scan is counted alone at one and two chunks and extrapolated to the
cell's chunks (:func:`count_flops`, exact: a test holds it equal to the
count of the whole forward at a short length).

Deliberate differences from the reference's per-partition HLO count, also
listed in every cell's JSON under ``left_out``:

  * FLOPs per chip are the counted global FLOPs / chips;
  * FlopCounterMode counts matrix products, convolutions and attention
    kernels only, not elementwise work (norms, activations, softmax, the
    optimizer update);
  * bytes are the state touched once, a lower bound on HBM traffic;
  * activation collectives are not counted, only the parameters';
  * what cannot run on meta is left out: the train step's n-gram sketch
    fold (a kernel wrapper, no matrix products), any ``.item()`` or copy
    to numpy, and the gradient compressor's descent.

Usage:
    python -m repro_torch.launch.dryrun --arch gemma2-9b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod-only|--single-pod-only]
    python -m repro_torch.launch.dryrun --all --variant <name>
    python -m repro_torch.launch.dryrun --sketch-cells
Results go to ``build/dryrun/`` (``--out DIR`` elsewhere), one file a cell,
kept across runs unless ``--force``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import time
import traceback
from pathlib import Path
from typing import Any, Dict, List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import roofline as rl
from repro_torch import tree as tr
from repro_torch.configs import ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import Mesh, sketch_data_axes
from repro_torch.models import sharding as shd
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tfm

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
META = sp.META


# --------------------------------------------------------------------------
# variants: config/sharding transformations of the reference's hillclimb
# --------------------------------------------------------------------------
VARIANTS: Dict[str, Dict[str, Any]] = {
    "baseline": {},
    "noremat": {"cfg": {"remat": False}},
    "attn_chunk_512": {"cfg": {"attn_chunk": 512}},
    "attn_chunk_2048": {"cfg": {"attn_chunk": 2048}},
    "ssm_chunk_256": {"cfg": {"ssm_chunk": 256}},
    "ssm_chunk_512": {"cfg": {"ssm_chunk": 512}},
    "no_sketch": {"sketch": False},
    "cap_factor_1": {"cfg": {"capacity_factor": 1.0}},
    "loss_chunk512": {"cfg": {"loss_chunk": 512}},
    "moe_local": {"cfg": {"moe_dispatch": "local"}},
    "moe_local_lc": {"cfg": {"moe_dispatch": "local", "loss_chunk": 512}},
    "mamba_opt": {"cfg": {"loss_chunk": 512, "ssm_chunk": 256}},
    "mamba_opt2": {"cfg": {"loss_chunk": 512, "ssm_chunk": 512}},
    "moe_local_v2": {"cfg": {"moe_dispatch": "local"}},
    "moe_local_v2_lc": {"cfg": {"moe_dispatch": "local", "loss_chunk": 512}},
    "moe_local_cap1": {"cfg": {"moe_dispatch": "local", "capacity_factor": 1.0}},
    "moe_local_fshard": {"cfg": {"moe_dispatch": "local",
                                 "moe_weight_shard": "f_allaxes"}},
    "moe_best": {"cfg": {"moe_dispatch": "local", "capacity_factor": 1.0,
                         "moe_weight_shard": "f_allaxes"}},
    "moe_ep": {"cfg": {"moe_dispatch": "ep_shardmap"}},
    "moe_2d_global": {"cfg": {"moe_dispatch": "global"}},
    "moe_ep_cap1": {"cfg": {"moe_dispatch": "ep_shardmap",
                            "capacity_factor": 1.0}},
    "vocab_pad": {"cfg": {"vocab_pad_multiple": 256}},
    "mamba_best": {"cfg": {"vocab_pad_multiple": 256, "loss_chunk": 512}},
}

LEFT_OUT = [
    "FLOPs per chip are the counted global FLOPs / chips, not a per-partition count",
    "FlopCounterMode counts matrix products, convolutions and attention kernels only: "
    "elementwise work (norms, activations, softmax, the optimizer update) adds none",
    "HBM bytes are the cell's state touched once, a lower bound on its traffic",
    "activation collectives are not counted, only the parameters' all-gathers "
    "(and, on train, their gradients' reduce-scatters)",
    "what cannot run on meta tensors: the train step's n-gram sketch fold, any "
    ".item() or copy to numpy, the gradient compressor's descent",
]


def _apply_variant(cfg: ModelConfig, variant: str):
    v = VARIANTS[variant]
    if "cfg" in v:
        cfg = dataclasses.replace(cfg, **{k: val for k, val in v["cfg"].items()
                                          if hasattr(cfg, k)})
    return cfg, v


def production_mesh(multi_pod: bool) -> Mesh:
    """The production mesh on meta positions (no card needed)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, ["meta"] * math.prod(shape))


def mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


# --------------------------------------------------------------------------
# FLOP counting on meta
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _scan_chunks_flops(cfg: ModelConfig, sig, n_chunks: int, grad: bool) -> int:
    """FLOPs (forward, and backward from y where ``grad``) of
    ``ssm._ssd_chunk_scan`` over ``n_chunks`` chunks of its inputs'
    ``sig`` (shape, dtype, requires_grad each): counted at one and two
    chunks, extrapolated (every chunk after the first does the same
    work)."""
    q = min(cfg.ssm_chunk, sig[0][0][1])

    def one(n: int) -> int:
        args = []
        for i, (shape, dtype, rg) in enumerate(sig):
            if i < 4:                       # x, dtv, bmat, cmat: [B, S, ...]
                shape = (shape[0], n * q) + shape[2:]
            args.append(torch.empty(shape, dtype=dtype, device=META).requires_grad_(rg))
        with FlopCounterMode(display=False) as fc, torch.set_grad_enabled(grad):
            y, _ = _REAL_SCAN(cfg, *args)
            if grad and y.requires_grad:
                torch.autograd.backward([y], [torch.empty_like(y)])
        return fc.get_total_flops()

    f1 = one(1)
    return f1 if n_chunks == 1 else f1 + (n_chunks - 1) * (one(2) - f1)


_REAL_SCAN = ssm_mod._ssd_chunk_scan


def _scan_stand_in(cfg, x, dtv, bmat, cmat, a, d_skip, h0):
    """Outputs of the scan's shapes, joined to every input by elementwise
    operations only (FlopCounterMode counts none of them), so the rest of
    the graph, backward included, is counted as with the real scan."""
    f32 = torch.float32
    t = (x.to(f32) + dtv[..., None] + a[:, None] + d_skip[:, None]
         + (bmat.sum(-1) + cmat.sum(-1)).to(f32)[:, :, None, None])
    return t.to(x.dtype), h0 + t.sum(1)[:, :, None, :]


@contextlib.contextmanager
def _scans_counted_alone(calls: List[Tuple]):
    """Within: ``ssm._ssd_chunk_scan`` is the stand-in, and each call
    appends its (config, signature, chunks, grad) to ``calls``, to be
    counted alone (:func:`_scan_chunks_flops`) once the outer count ends."""
    def recording(cfg, x, dtv, bmat, cmat, a, d_skip, h0):
        args = (x, dtv, bmat, cmat, a, d_skip, h0)
        sig = tuple((tuple(t.shape), t.dtype, t.requires_grad) for t in args)
        q = min(cfg.ssm_chunk, x.shape[1])
        calls.append((cfg, sig, -(-x.shape[1] // q), torch.is_grad_enabled()))
        return _scan_stand_in(cfg, *args)

    ssm_mod._ssd_chunk_scan = recording
    try:
        yield
    finally:
        ssm_mod._ssd_chunk_scan = _REAL_SCAN


def _step_flops(cfg: ModelConfig, kind: str, b: int, s: int, lb_coef: float) -> int:
    """FlopCounterMode's count of one step of ``cfg`` on meta stand-ins."""
    params = sp.meta_params(cfg)
    with FlopCounterMode(display=False) as fc:
        if kind == "train":
            leaves = tr.leaves(params)
            for p in leaves:
                p.requires_grad_(True)
            batch = sp.batch_input_specs(cfg, b, s)
            loss, _ = tfm.loss_fn(cfg, params, batch["tokens"], embeds=batch.get("embeds"),
                                  lb_coef=lb_coef)
            loss.backward()
        elif kind == "prefill":
            batch = sp.batch_input_specs(cfg, b, s)
            with torch.no_grad():
                tfm.prefill(cfg, params, batch["tokens"], embeds=batch.get("embeds"))
        else:
            din = sp.decode_input_specs(cfg, b, s)
            with torch.no_grad():
                tfm.decode_step(cfg, params, din["cache"], din["tokens_last"], s - 1)
    return fc.get_total_flops()


def count_flops(cfg: ModelConfig, kind: str, b: int, s: int, lb_coef: float = 0.01,
                scaled: bool = True) -> int:
    """Global FLOPs of one ``kind`` step at batch ``b``, length ``s``.

    ``scaled``: count the model at one block (and one encoder block) and at
    two, and extrapolate to ``n_blocks`` (``n_enc_layers``); each SSM chunk
    scan counted alone (:func:`_scans_counted_alone`).  Without it, the
    whole model as it is."""
    if not scaled:
        return _step_flops(cfg, kind, b, s, lb_coef)

    def at(n_blocks: int, n_enc: int) -> int:
        c = dataclasses.replace(cfg, n_layers=cfg.block_period * n_blocks, n_enc_layers=n_enc)
        calls: List[Tuple] = []
        with _scans_counted_alone(calls):
            flops = _step_flops(c, kind, b, s, lb_coef)
        return flops + sum(_scan_chunks_flops(*call) for call in calls)

    enc1 = min(1, cfg.n_enc_layers)
    f11 = at(1, enc1)
    total = f11
    if cfg.n_blocks > 1:
        total += (cfg.n_blocks - 1) * (at(2, enc1) - f11)
    if cfg.n_enc_layers > 1:
        total += (cfg.n_enc_layers - 1) * (at(1, 2) - f11)
    return total


# --------------------------------------------------------------------------
# model cells
# --------------------------------------------------------------------------

def _tokens_spec(mesh, b: int) -> shd.P:
    dp_axes, _ = shd.mesh_axes(mesh)
    dp = dp_axes if len(dp_axes) > 1 else dp_axes[0]
    return shd.P(dp, None) if b >= mesh.shape[dp_axes[0]] else shd.P(None, None)


def param_collectives(pspecs, params, mesh, train: bool) -> Dict[str, Any]:
    """Per-chip collectives the param specs imply: each leaf split over
    data axes is all-gathered over them (its result: the local slice x the
    data group), and on ``train`` its gradient reduce-scattered."""
    dp_axes, _ = shd.mesh_axes(mesh)
    counts: Dict[str, int] = {}
    result: Dict[str, int] = {}
    wire = 0
    spec_of = dict(tr.flatten(pspecs))
    for path, leaf in tr.flatten(params):
        spec = spec_of[path]
        group = math.prod(mesh.shape[a] for e in spec for a in shd._entry_axes(e)
                          if a in dp_axes)
        if group <= 1:
            continue
        local = math.prod(shd.local_shape(spec, leaf.shape, mesh)) * leaf.element_size()
        ops = [("all-gather", local * group)] + ([("reduce-scatter", local)] if train else [])
        for op, nbytes in ops:
            counts[op] = counts.get(op, 0) + 1
            result[op] = result.get(op, 0) + nbytes
            wire += rl.wire_bytes(op, nbytes, group)
    return {"counts": counts, "result_bytes": result, "wire_bytes": wire}


def state_bytes(cfg: ModelConfig, kind: str, b: int, s: int, mesh,
                tcfg=None) -> Tuple[Dict[str, int], Any, Any]:
    """(bytes one position holds by part, param specs, meta params)."""
    out: Dict[str, int] = {}
    if kind == "train":
        tcfg = tcfg or sp.default_train_config(cfg)
        state = sp.train_state_specs(cfg, tcfg)
        params = state["params"]
        pspecs = shd.param_specs(cfg, params, mesh)
        out["params"] = shd.local_bytes(pspecs, params, mesh)
        out["opt"] = shd.local_bytes(
            shd.opt_state_specs(cfg, state["opt"], pspecs, mesh), state["opt"], mesh)
        rest = {k: v for k, v in state.items() if k not in ("params", "opt")}
        # the sketch (and any other state) is replicated
        out["sketch"] = shd.local_bytes(tr.map_leaves(lambda t: shd.P(), rest), rest, mesh)
        batch = sp.batch_input_specs(cfg, b, s)
        out["batch"] = shd.local_bytes(shd.sanitize_specs(
            shd.batch_specs(cfg, mesh, "embeds" in batch), batch, mesh), batch, mesh)
    else:
        params = sp.meta_params(cfg)
        pspecs = shd.param_specs(cfg, params, mesh)
        out["params"] = shd.local_bytes(pspecs, params, mesh)
        if kind == "prefill":
            batch = sp.batch_input_specs(cfg, b, s)
            out["batch"] = shd.local_bytes(shd.sanitize_specs(
                shd.batch_specs(cfg, mesh, "embeds" in batch), batch, mesh), batch, mesh)
            cache = sp.prefill_cache_specs(cfg, b, s)
        else:
            din = sp.decode_input_specs(cfg, b, s)
            cache = din["cache"]
            tok = din["tokens_last"]
            out["tokens"] = shd.local_bytes(
                {"t": shd.sanitize_spec(_tokens_spec(mesh, b), tuple(tok.shape), mesh)},
                {"t": tok}, mesh)
        out["cache"] = shd.local_bytes(shd.cache_specs(cfg, cache, mesh, b), cache, mesh)
    out["total"] = sum(out.values())
    return out, pspecs, params


_FLOPS: Dict[Tuple, Tuple[int, float]] = {}


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               variant: str = "baseline") -> Dict[str, Any]:
    """Count one (arch x shape x mesh x variant) cell."""
    cfg, vflags = _apply_variant(get_config(arch), variant)
    mesh = production_mesh(multi_pod)
    sh = SHAPES[shape_name]
    b, s, kind = sh["global_batch"], sh["seq_len"], sh["kind"]
    tcfg = sp.default_train_config(cfg)
    if not vflags.get("sketch", True):
        tcfg = dataclasses.replace(tcfg, sketch_enabled=False)

    by_part, pspecs, params = state_bytes(cfg, kind, b, s, mesh, tcfg)
    key = (cfg, kind, b, s)
    if key not in _FLOPS:           # the count does not depend on the mesh
        t0 = time.perf_counter()
        flops = count_flops(cfg, kind, b, s, tcfg.lb_coef)
        _FLOPS[key] = (flops, time.perf_counter() - t0)
    flops, t_count = _FLOPS[key]
    coll = param_collectives(pspecs, params, mesh, kind == "train")
    chips = mesh.size
    roof = rl.build_roofline(arch, shape_name, mesh_name(multi_pod), chips,
                             flops_per_chip=flops / chips,
                             hbm_bytes_per_chip=by_part["total"],
                             wire_bytes_per_chip=coll["wire_bytes"],
                             model_flops=rl.model_flops_for(cfg, kind, b, s),
                             collectives=coll)
    left_out = list(LEFT_OUT)
    if cfg.remat:
        left_out.append("remat: the port recomputes nothing in the backward pass, "
                        "where the reference's remat=True recomputes each block's forward")
    counts = cfg.param_count()
    return {
        **roof.as_dict(),
        "variant": variant,
        "kind": kind,
        "global_batch": b,
        "seq_len": s,
        "per_position_bytes": by_part,
        "largest_position": 0,
        "positions_equal": True,      # sanitized specs divide every dim evenly
        "fits": by_part["total"] <= rl.HBM_BYTES,
        "hbm_bytes_capacity": rl.HBM_BYTES,
        "flops_counted": flops,
        "count_s": t_count,
        "n_params_total": counts["total"],
        "n_params_active": counts["active"],
        "device": "none: meta tensors, nothing ran on a device",
        "left_out": left_out,
    }


def cell_path(out_dir: Path, arch: str, shape: str, mesh_label: str, variant: str) -> Path:
    out_dir.mkdir(parents=True, exist_ok=True)
    return out_dir / f"{arch}__{shape}__{mesh_label}__{variant}.json"


def _write_or_err(path: Path, fn, what: Dict[str, Any]):
    """Run ``fn``; write its result to ``path``, or the error beside it."""
    try:
        res = fn()
    except Exception as e:  # one failed cell must not stop the sweep
        err = {**what, "error": str(e), "traceback": traceback.format_exc()}
        path.with_suffix(".json.err").write_text(json.dumps(err, indent=1))
        print(f"  FAIL: {type(e).__name__}: {str(e)[:300]}", flush=True)
        return None
    path.write_text(json.dumps(res, indent=1))
    return res


def run_cells(archs, shapes, meshes, variant: str, out_dir: Path = RESULTS_DIR,
              skip_existing: bool = True) -> List[Dict[str, Any]]:
    summary = []
    for multi_pod in meshes:
        label = mesh_name(multi_pod)
        for arch in archs:
            cfg = get_config(arch)
            for shape in shapes:
                if not shape_applicable(cfg, shape):
                    print(f"SKIP {arch} x {shape} (inapplicable: needs sub-quadratic "
                          "decode)", flush=True)
                    continue
                path = cell_path(out_dir, arch, shape, label, variant)
                if skip_existing and path.exists():
                    print(f"HAVE {arch} x {shape} x {label}", flush=True)
                    continue
                print(f"CELL {arch} x {shape} x {label} ...", flush=True)
                res = _write_or_err(path, lambda: lower_cell(arch, shape, multi_pod, variant),
                                    {"arch": arch, "shape": shape, "mesh": label,
                                     "variant": variant})
                if res is not None:
                    print(f"  ok: count={res['count_s']:.2f}s bottleneck={res['bottleneck']} "
                          f"t=({res['t_compute_s']:.2e},{res['t_memory_s']:.2e},"
                          f"{res['t_collective_s']:.2e})s "
                          f"GB/position={res['per_position_bytes']['total'] / 1e9:.2f} "
                          f"fits={res['fits']}", flush=True)
                    summary.append(res)
    return summary


# --------------------------------------------------------------------------
# sketch-serving cells: the sharded heavy-hitter pipeline's three units
# (serving/sharded_topk.py), counted on the production meshes and the
# (2, 2) test mesh:
#   sketch_ingest -- per-shard fold of one stream block into every
#                    hierarchy level (no collective),
#   sketch_sync   -- the psum merging the per-shard level tables,
#   sketch_build  -- fold + psum in one (core/hierarchy.sharded_hierarchy_build).
# --------------------------------------------------------------------------

SKETCH_CELLS = ("sketch_ingest", "sketch_sync", "sketch_build")
SKETCH_MESHES = ("pod16x16", "pod2x16x16", "test2x2")
SKETCH_BATCH = 1 << 20          # rows per ingested block (global)


def _sketch_mesh(mesh_kind: str) -> Mesh:
    if mesh_kind == "test2x2":
        return Mesh((2, 2), ("data", "model"), ["meta"] * 4)
    return production_mesh(mesh_kind == "pod2x16x16")


def lower_sketch_cell(cell: str, mesh_kind: str, batch: int = SKETCH_BATCH) -> Dict[str, Any]:
    from repro_torch.core import hierarchy as hh
    from repro_torch.core import sketch as sk
    from repro_torch.core.hashing import KeySchema

    if cell not in SKETCH_CELLS:
        raise ValueError(f"unknown sketch cell {cell!r}")
    mesh = _sketch_mesh(mesh_kind)
    data_axes = sketch_data_axes(mesh)
    n_shards = mesh.axis_size(data_axes)
    b = max(batch // n_shards, 1) * n_shards
    # telemetry-shaped keys: two 32-bit modules (edge / routed-token pairs)
    schema = KeySchema(domains=(1 << 32, 1 << 32))
    hspec = hh.HierarchySpec.from_spec(
        sk.mod_sketch_spec(schema, [(0,), (1,)], (512, 512), 4))
    table_bytes = hspec.table_cells * 4              # int32 cells, every level
    block_bytes = (b // n_shards) * (4 * schema.modularity + 4)  # uint32 keys, int32 freqs
    coll: Dict[str, Any] = {"counts": {}, "result_bytes": {}, "wire_bytes": 0}
    if cell in ("sketch_sync", "sketch_build"):
        coll = {"counts": {"all-reduce": 1}, "result_bytes": {"all-reduce": table_bytes},
                "wire_bytes": rl.wire_bytes("all-reduce", table_bytes, n_shards)}
    return {
        "cell": cell, "mesh": mesh_kind, "chips": mesh.size, "n_shards": n_shards,
        "data_axes": list(data_axes), "batch": b, "levels": hspec.n_levels,
        "table_cells": hspec.table_cells,
        "per_shard_table_bytes": table_bytes,
        "per_shard_block_bytes": block_bytes if cell != "sketch_sync" else 0,
        "collectives": coll,
        "t_collective_s": coll["wire_bytes"] / rl.LINK_BW,
        "device": "none: counted from the shapes, nothing ran",
        "left_out": ["no FLOP or time count: the fold is integer hashing and "
                     "scatter-adds, which FlopCounterMode does not count",
                     "the descent (a host-driven loop over batched queries)"],
    }


def sketch_cell_path(out_dir: Path, cell: str, mesh_kind: str) -> Path:
    out_dir.mkdir(parents=True, exist_ok=True)
    return out_dir / f"sketch__{cell}__{mesh_kind}.json"


def run_sketch_cells(out_dir: Path = RESULTS_DIR, skip_existing: bool = True):
    summary = []
    for mesh_kind in SKETCH_MESHES:
        for cell in SKETCH_CELLS:
            path = sketch_cell_path(out_dir, cell, mesh_kind)
            if skip_existing and path.exists():
                print(f"HAVE {cell} x {mesh_kind}", flush=True)
                continue
            print(f"CELL {cell} x {mesh_kind} ...", flush=True)
            res = _write_or_err(path, lambda: lower_sketch_cell(cell, mesh_kind),
                                {"cell": cell, "mesh": mesh_kind})
            if res is not None:
                print(f"  ok: shards={res['n_shards']} table={res['per_shard_table_bytes']} B "
                      f"collectives={res['collectives']['counts']}", flush=True)
                summary.append(res)
    return summary


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", default="baseline", choices=list(VARIANTS))
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--sketch-cells", action="store_true",
                    help="count the sharded sketch-serving cells (ingest/sync/build "
                         "on every mesh) instead of the model cells")
    ap.add_argument("--out", default=str(RESULTS_DIR),
                    help="directory for the cells' JSON (default build/dryrun)")
    args = ap.parse_args(argv)
    out_dir = Path(args.out)
    t0 = time.perf_counter()
    if args.sketch_cells:
        run_sketch_cells(out_dir, skip_existing=not args.force)
    else:
        archs = ARCHS if args.all or not args.arch else [args.arch]
        shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
        meshes = [False, True]
        if args.multi_pod_only:
            meshes = [True]
        if args.single_pod_only:
            meshes = [False]
        run_cells(archs, shapes, meshes, args.variant, out_dir,
                  skip_existing=not args.force)
    print(f"dry-run done in {time.perf_counter() - t0:.1f} s -> {out_dir}", flush=True)


if __name__ == "__main__":
    main()
