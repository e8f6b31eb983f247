"""Composite index computation shared by the update/query kernels.

Port of ``repro/kernels/hashes.py``.  The CUDA twin of :func:`row_indices`
(K0) and of the signed-mode sign bits (K0s: :func:`row_sign_bits` /
:func:`all_sign_bits`, and ``signs_from_bits``, shared with
core/countsketch.py) is the ``index_and_sign_bits`` device helper in
``csrc/hashes.cuh``, which computes both in one pass and which every kernel
that hashes inlines; the functions here are its plain PyTorch version and
the static layout both sides read.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.countsketch import signs_from_bits  # noqa: F401
from repro_torch.core.hashing import cw_hash
from repro_torch.core.sketch import SketchSpec


class IndexPlan(NamedTuple):
    """Static (hashable) layout extracted from a SketchSpec for kernels."""
    group_cols: Tuple[Tuple[int, ...], ...]   # chunk columns per group
    ranges: Tuple[int, ...]
    strides: Tuple[int, ...]
    total_chunks: int
    width: int

    @property
    def table_size(self) -> int:
        out = 1
        for r in self.ranges:
            out *= int(r)
        return out


def make_plan(spec: SketchSpec) -> IndexPlan:
    return IndexPlan(
        group_cols=tuple(spec.group_chunk_columns(j) for j in range(spec.n_groups)),
        ranges=spec.ranges,
        strides=spec.strides,
        total_chunks=spec.schema.total_chunks,
        width=spec.width,
    )


def all_indices(plan: IndexPlan, chunks: torch.Tensor, q: torch.Tensor,
                r: torch.Tensor) -> torch.Tensor:
    """Composite cell indices for every row at once: int64[w, B].

    chunks: int64[B, C] 16-bit key digits; q: int64[w, C]; r: int64[w, m].
    """
    idx = torch.zeros((q.shape[0], chunks.shape[0]), dtype=torch.int64,
                      device=chunks.device)
    for j, (cols, rng_j, stride_j) in enumerate(
            zip(plan.group_cols, plan.ranges, plan.strides)):
        cols = list(cols)
        h = cw_hash(chunks[None, :, cols], q[:, None, cols], r[:, j, None])
        idx += (h % int(rng_j)) * int(stride_j)
    return idx


def row_indices(plan: IndexPlan, chunks: torch.Tensor, q_row: torch.Tensor,
                r_row: torch.Tensor) -> torch.Tensor:
    """Composite cell index for ONE sketch row: int64[B] in [0, h).

    chunks: int64[B, C]; q_row: int64[C]; r_row: int64[m].
    """
    return all_indices(plan, chunks, q_row[None], r_row[None])[0]


def all_sign_bits(plan: IndexPlan, chunks: torch.Tensor, sq: torch.Tensor,
                  sr: torch.Tensor) -> torch.Tensor:
    """Packed cumulative sign-parity bits for every row at once: int64[w, B].

    Bit L is the XOR of the CW-hash parities of groups 0..L under the sign
    params (sq int64[w, C], sr int64[w, m]).  The parity is that of the
    canonical residue in [0, P31) that :func:`cw_hash` returns, as the
    reference's uint32 limbs give it.
    """
    bits = torch.zeros((sq.shape[0], chunks.shape[0]), dtype=torch.int64,
                       device=chunks.device)
    cum = torch.zeros_like(bits)
    for j, cols in enumerate(plan.group_cols):
        cols = list(cols)
        h = cw_hash(chunks[None, :, cols], sq[:, None, cols], sr[:, j, None])
        cum = cum ^ (h & 1)
        bits = bits | (cum << j)
    return bits


def row_sign_bits(plan: IndexPlan, chunks: torch.Tensor, sq_row: torch.Tensor,
                  sr_row: torch.Tensor) -> torch.Tensor:
    """Packed cumulative sign-parity bits for ONE sketch row (signed mode):
    int64[B], bit L the sign of the level-L prefix (the flat / finest sign
    is the top group's bit).

    chunks: int64[B, C]; sq_row: int64[C]; sr_row: int64[m].
    """
    return all_sign_bits(plan, chunks, sq_row[None], sr_row[None])[0]
