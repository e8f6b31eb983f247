"""K1 and K6: fold a stream block into a flat sketch table.

Port of ``repro/kernels/sketch_update.py`` (``sketch_update_pallas``).  The
TPU kernel turns the scatter into one-hot x frequency MXU matmuls with
12-bit frequency limbs.  On Hopper a flat sketch is a hierarchy of one
level (offset 0, divisor 1, ``h_pad`` columns), so K1 launches the
hierarchy folds' body (``csrc/hier_fold.cuh``, through
``launch_flat_fold`` in ``csrc/sketch_kernels.cu``) as
``sk_flat_update_kernel``: CTAs for each row walking spans of its keys
(:func:`flat_deal`), the fused hash and exact int32 ``atomicAdd``s.
:func:`sketch_update_ref` is its plain PyTorch version; the wrapper runs it
only for tensors on the CPU.  On a float32 table the same body (K1f, the
reference's ``_update_kernel_f32``) adds float32 values with float
``atomicAdd``s.

K6 is the signed (Count-Sketch) fold of ``sketch_update_signed_pallas``:
``cell += s_k(x) * f`` with f of either sign.  Its kernel
(``sk_update_signed_kernel`` in ``csrc/signed_kernels.cu``) runs one thread
per key over all w rows: it reads the key once, hashes each row's cell and
packed sign bits in one fused pass (``index_and_sign_bits`` in
``csrc/hashes.cuh``, the hierarchy folds' hash) and adds the signed value
with one int32 ``atomicAdd`` a row; :func:`sketch_update_signed_ref` is its
plain version.  On a float32 table (K6f, ``_update_kernel_signed_f32``) the sign
negates the float32 value exactly and a float ``atomicAdd`` adds it.

Float atomics add in any order, so a float32 table equals its plain
version bit for bit while every cell's partial sums are integers below
2^24, and within float32 rounding otherwise: the reference's contract.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels import hier_update as hu
from repro_torch.kernels.hashes import IndexPlan, all_indices, all_sign_bits


def padded_table_size(h: int, tile_h: int) -> int:
    return ((h + tile_h - 1) // tile_h) * tile_h


# kFlatCtasPerSm in csrc/hier_fold.cuh: the flat kernel's __launch_bounds__
FLAT_CTAS_PER_SM = 8


def flat_deal(w: int, n: int, sms: int) -> Tuple[int, int]:
    """(CTAs a row, span tiles) of K1/K1f for a block of n keys into w rows
    on a card of ``sms`` SMs: the shortest span that lets the w rows' CTAs,
    one a span, run in one wave of FLAT_CTAS_PER_SM an SM.  K1 runs that
    many CTAs for each row, all on global atomics.

    Not ``hier_update._deal``, which sizes one grid at CTAS_PER_SM an SM
    and rounds the span down (a full wave, spans dealt round the CTAs):
    K1's grid is w rows deep, and two sweeps (``tools/fold_ab.py
    --spans``, H100 80GB HBM3 at 700 W, device us, PERF.md section 6)
    want one wave.  The accuracy path's ``[5, 4096]`` (1.2 waves at one
    tile) took 2 tiles best: count-min 8.59-8.74 against 8.96-9.18 at one
    tile and 9.51-10.01 at four; equal-sketch's block 7 17.84-17.92
    against 23.63-24.46, mod-sketch's 18.60-18.61 against 28.94-28.95.
    On the flat path's ``[4, 2^24]`` (one wave at one tile) one and two
    tiles were within 5% (block 0 17.66 and 18.89 at one, 18.25 and 18.10
    at two; block 7 8.74-8.79 against 8.84-9.42).  ``_deal`` would give
    both one tile."""
    tiles = -(-n // hu.THREADS)
    wave = max(1, sms * FLAT_CTAS_PER_SM // w)      # one wave's CTAs a row
    span = max(1, min(hu.SPAN_TILES, -(-tiles // wave)))
    return -(-tiles // span), span


def sketch_update_ref(plan: IndexPlan, table: torch.Tensor, chunks: torch.Tensor,
                      freqs: torch.Tensor, q: torch.Tensor,
                      r: torch.Tensor) -> torch.Tensor:
    """Plain version: scatter-add over the (padded) table, in place."""
    w, h_pad = table.shape
    idx = all_indices(plan, chunks, q, r)                     # [w, B]
    rows = torch.arange(w, dtype=torch.int64, device=table.device)[:, None]
    flat = (rows * h_pad + idx).reshape(-1)
    f = freqs.to(table.dtype).expand(w, freqs.shape[0]).reshape(-1)
    table.view(-1).index_add_(0, flat, f)
    return table


def sketch_update(plan: IndexPlan, table: torch.Tensor, chunks: torch.Tensor,
                  freqs: torch.Tensor, q: torch.Tensor,
                  r: torch.Tensor) -> torch.Tensor:
    """Fold one block into ``table`` ([w, h_pad]) in place; returns it.

    chunks int64[B, C], freqs [B] (cast to the table dtype), q int64[w, C],
    r int64[w, m].  CUDA tensors launch K1 (int32 tables) or K1f (float32)
    in the CTAs and spans :func:`flat_deal` picks; CPU tensors take
    :func:`sketch_update_ref`.
    """
    if not table.is_cuda:
        return sketch_update_ref(plan, table, chunks, freqs, q, r)
    name, symbol, vdtype = _cuda.fold_variant(table, "sketch_update", "sk_sketch_update")
    _cuda.require_hash_inputs(name, plan, table, chunks, q, r, _cuda.FOLD_DTYPES)
    freqs = freqs.to(vdtype)
    _cuda.require_on(table.device, name, freqs=freqs)
    w, h_pad = table.shape
    b = chunks.shape[0]
    _cuda.require(tuple(freqs.shape) == (b,) and plan.table_size <= h_pad,
                  f"{name}: freqs {tuple(freqs.shape)} or table width {h_pad} "
                  "does not match the block and plan")
    ctas, span_tiles = flat_deal(w, b, _cuda.sm_count(table.device.index))
    plan_c = _cuda.plan_struct(plan)
    lib = _cuda.library()
    with torch.cuda.device(table.device):
        rc = getattr(lib, symbol)(
            ctypes.byref(plan_c), table.data_ptr(), h_pad, w,
            chunks.data_ptr(), freqs.data_ptr(), b, q.data_ptr(), r.data_ptr(), ctas,
            span_tiles, _cuda.stream_of(table))
    _cuda.check(rc, name)
    _cuda.LAUNCHES[name] += 1
    return table


def sketch_update_signed_ref(plan: IndexPlan, table: torch.Tensor,
                             chunks: torch.Tensor, freqs: torch.Tensor,
                             q: torch.Tensor, r: torch.Tensor, sq: torch.Tensor,
                             sr: torch.Tensor) -> torch.Tensor:
    """Plain version: signed scatter-add over the (padded) table, in place.
    The sign multiplies the frequency in the table's dtype (int32 wraps as
    the kernel's atomics do)."""
    w, h_pad = table.shape
    idx = all_indices(plan, chunks, q, r)                     # [w, B]
    bits = all_sign_bits(plan, chunks, sq, sr)
    sign = 1 - 2 * ((bits >> (len(plan.group_cols) - 1)) & 1)
    vals = sign.to(table.dtype) * freqs.to(table.dtype)[None, :]
    rows = torch.arange(w, dtype=torch.int64, device=table.device)[:, None]
    table.view(-1).index_add_(0, (rows * h_pad + idx).reshape(-1), vals.reshape(-1))
    return table


def sketch_update_signed(plan: IndexPlan, table: torch.Tensor,
                         chunks: torch.Tensor, freqs: torch.Tensor,
                         q: torch.Tensor, r: torch.Tensor, sq: torch.Tensor,
                         sr: torch.Tensor) -> torch.Tensor:
    """Signed fold of one block into ``table`` ([w, h_pad]) in place.

    As :func:`sketch_update`, plus the sign params sq int64[w, C] and sr
    int64[w, m]; freqs may be negative.  CUDA tensors launch K6 (int32
    tables) or K6f (float32); CPU tensors take
    :func:`sketch_update_signed_ref`.
    """
    if not table.is_cuda:
        return sketch_update_signed_ref(plan, table, chunks, freqs, q, r, sq, sr)
    name, symbol, vdtype = _cuda.fold_variant(table, "sketch_update_signed",
                                              "sk_sketch_update_signed")
    _cuda.require_hash_inputs(name, plan, table, chunks, q, r, _cuda.FOLD_DTYPES, (sq, sr))
    freqs = freqs.to(vdtype)
    _cuda.require_on(table.device, name, freqs=freqs)
    w, h_pad = table.shape
    b = chunks.shape[0]
    _cuda.require(tuple(freqs.shape) == (b,) and plan.table_size <= h_pad,
                  f"{name}: freqs {tuple(freqs.shape)} or table width {h_pad} "
                  "does not match the block and plan")
    plan_c = _cuda.plan_struct(plan)
    lib = _cuda.library()
    with torch.cuda.device(table.device):
        rc = getattr(lib, symbol)(
            ctypes.byref(plan_c), table.data_ptr(), h_pad, w,
            chunks.data_ptr(), freqs.data_ptr(), b, q.data_ptr(), r.data_ptr(),
            sq.data_ptr(), sr.data_ptr(), _cuda.stream_of(table))
    _cuda.check(rc, name)
    _cuda.LAUNCHES[name] += 1
    return table
