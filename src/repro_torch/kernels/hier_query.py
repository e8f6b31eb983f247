"""K4, K9 and K9m: all candidate children of heavy prefixes in one launch.

Port of ``repro/kernels/hier_query.py`` (``hier_candidate_query``,
``hier_candidate_query_batched`` and ``hier_candidate_query_signed``).  The
mixed-radix cell address is separable -- ``idx(p, c) = pp[k, p] + cp[k,
c]`` per row k -- so the kernels take the two partial-index factors and
evaluate the full P x C grid without materialising the key grid.  The TPU
kernels gather through one-hot MXU contractions on 16-bit table limbs,
accumulated over a sequential tile grid.

The Hopper kernels share one body (``csrc/hier_query.cuh``): one thread
per (p, c) lane over all w rows, its loads issued before their first use,
a CTA per prefix and run of candidates.  K4 (``sk_hier_query_kernel``)
keeps the Count-Min minimum; K9 (``sk_hier_query_signed_kernel``) writes
the signed int32 rows of ``hier_candidate_query_signed``, the sign of
child (p, c) at row k being ``sp[k, p] * sc[k, c]`` (cumulative parities
XOR, so +-1 signs multiply; ``core.countsketch.candidate_signed_partials``
computes both factors); K9m (``sk_hier_query_signed_median_kernel``) takes
the median over K9's rows in registers, so the signed descent
(``core.countsketch.candidate_estimates``) gets float32 [P, C] from one
launch.  They read a level view through its row stride, so no level is
copied.  Where :func:`query_geometry` picks the window route, each CTA
first stages its prefix's ``w x span`` cells in shared memory; ``span`` is
the level's last range, which the descents pass (a child partial is below
it), and a lane whose child partial is not below ``span`` reads global
memory, so the answers never depend on it.

The plain versions are :func:`hier_candidate_query_ref`,
:func:`hier_candidate_query_signed_ref` and
:func:`hier_candidate_median_signed_ref`; the wrappers run them only for
tensors on the CPU.  The signed plain version signs in float32, as the
reference's oracle does, and K9 in int32, as the reference's kernel does:
the two agree exactly except on a cell holding -2^31 under sign -1, where
int32 wraps.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.countsketch import median_rows
from repro_torch.kernels import _cuda

THREADS = 256          # kQueryThreads in csrc/hier_query.cuh: the lanes of a CTA
UNROLLED_ROWS = 8      # kUnrolledRows there: wider w takes a runtime loop
BAR_BYTES = 16         # kBarBytes there: the window's mbarrier
SM_SHARED_BYTES = 233_472
CTA_RESERVED_BYTES = 1_024
CTAS_PER_SM = 2048 // THREADS
# The route rule.  The direct route gives a thread up to DIRECT_LANES
# candidates, as many as keep one CTA an SM busy: the next candidate's
# partials load while this one's cells are reduced, and fewer CTAs repeat
# the prefix's reads.  The window route stages at most WINDOW_BYTES a CTA,
# so that two CTAs share an SM and one stages while the other gathers.
# Staging moves a prefix's w x span cells to the SM once; the direct route
# moves a 32-byte sector of 8 cells per (lane, row), which the L1 catches
# only within a CTA.  So the window repays when a CTA's c_tile lanes read
# each staged sector SECTOR_READS times or more: 8 x c_tile >= SECTOR_READS
# x span.  tools/query_ab.py times both routes and their tiles at every
# grid the main path launches; on an H100 80GB HBM3 at 700 W (w = 4, span
# 4,096), K4's device time in us, direct at 256 / 512 / 1,024 candidates a
# CTA and window at 1,024 / 4,096: 1 x 4,096, 2.5 / 3.0 / 4.2 and 5.2 /
# 11.7; 16 x 4,096, 4.2 / 3.9 / 4.4 and 5.2 / 11.1; 91 x 4,096, 12.0 /
# 11.7 / 9.8 and 8.6 / 13.0; 2,190 x 4,096, 238 / 227 / 223 and 142 / 102.
# The rule picks the best or within 4% of it at every main-path grid.
DIRECT_LANES = 4
WINDOW_BYTES = SM_SHARED_BYTES // 2 - CTA_RESERVED_BYTES
SECTOR_READS = 2


class QueryGeometry(NamedTuple):
    """The launch of a candidate-grid query: the cells a row each CTA
    stages in shared memory (0: the direct route), the candidates a CTA
    covers, and its dynamic shared bytes."""
    span: int
    c_tile: int
    shared_bytes: int


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def window_bytes(w: int, span: int) -> int:
    """Shared bytes of the window route: w staged rows of span cells from
    their 16-byte-aligned start (``window_pitch`` in hier_query.cuh), and
    the barrier."""
    return 4 * w * ((span + 7) // 4 * 4) + BAR_BYTES


def query_geometry(w: int, p: int, c: int, span: Optional[int],
                   sms: int) -> QueryGeometry:
    """The route rule of K4, K9 and K9m for a [P, C] grid over w rows on a
    card of ``sms`` SMs.  The window route when ``span`` is given, w staged
    rows fit WINDOW_BYTES, and a prefix's candidates cut into as many CTAs
    as the SMs hold at once beside the other prefixes' (at least one) give
    a CTA enough lanes to read each staged sector SECTOR_READS times.  Else
    the direct route, THREADS lanes a CTA of up to DIRECT_LANES candidates
    each.  Both routes run the same kernel."""
    lanes = min(DIRECT_LANES, max(1, _ceil(p * c, sms * THREADS)))
    direct = QueryGeometry(0, THREADS * lanes, 0)
    if not span:
        return direct
    smem = window_bytes(w, span)
    if smem > WINDOW_BYTES:
        return direct
    per_sm = min(CTAS_PER_SM, SM_SHARED_BYTES // (smem + CTA_RESERVED_BYTES))
    tiles = min(_ceil(c, THREADS), max(1, sms * per_sm // p))
    c_tile = _ceil(_ceil(c, tiles), THREADS) * THREADS
    if 8 * c_tile < SECTOR_READS * span:
        return direct
    return QueryGeometry(int(span), c_tile, smem)


def _check(name: str, table: torch.Tensor, pp: torch.Tensor, cp: torch.Tensor,
           signs=()) -> None:
    """The kernels' inputs: a unit-stride int32 [w, cols] view, int64 [w, P]
    and [w, C] partials and, signed, float32 sign partials of their shapes,
    all on the table's device."""
    _cuda.require_int32_table(table, name)
    _cuda.require(table.dim() == 2 and table.stride(1) == 1,
                  f"{name}: table rows must be unit-stride")
    _cuda.require_on(table.device, name, pp=pp, cp=cp)
    w = table.shape[0]
    _cuda.require(pp.dtype == cp.dtype == torch.int64 and pp.dim() == cp.dim() == 2
                  and pp.shape[0] == cp.shape[0] == w and w <= 65535,
                  f"{name}: pp {tuple(pp.shape)} and cp {tuple(cp.shape)} must be "
                  f"int64[{w}, *]")
    if signs:
        sp, sc = signs
        _cuda.require_on(table.device, name, sp=sp, sc=sc)
        _cuda.require(sp.dtype == sc.dtype == torch.float32
                      and sp.shape == pp.shape and sc.shape == cp.shape,
                      f"{name}: sp {tuple(sp.shape)} and sc {tuple(sc.shape)} must be "
                      f"float32 of pp's and cp's shapes {tuple(pp.shape)}, "
                      f"{tuple(cp.shape)}")


def _launch(name: str, symbol: str, table: torch.Tensor, pp: torch.Tensor,
            cp: torch.Tensor, signs, span: Optional[int],
            out: torch.Tensor) -> torch.Tensor:
    """Launch K4, K9 or K9m with the route :func:`query_geometry` picks;
    raise if the launch fails (nothing falls back)."""
    _check(name, table, pp, cp, signs)
    _cuda.require(span is None or int(span) >= 1, f"{name}: span must be >= 1, got {span}")
    w, cols = table.shape
    p, c = pp.shape[1], cp.shape[1]
    if p == 0 or c == 0:
        return out
    g = query_geometry(w, p, c, None if span is None else min(int(span), cols),
                       _cuda.sm_count(table.device.index))
    sp = (signs[0].data_ptr(),) if signs else ()     # K4 takes no signs
    sc = (signs[1].data_ptr(),) if signs else ()
    lib = _cuda.library()
    with torch.cuda.device(table.device):
        rc = getattr(lib, symbol)(
            table.data_ptr(), table.stride(0), cols, w, pp.data_ptr(), *sp, p,
            cp.data_ptr(), *sc, c, g.span, g.c_tile, g.shared_bytes, out.data_ptr(),
            _cuda.stream_of(table))
    _cuda.check(rc, name)
    _cuda.LAUNCHES[name] += 1
    return out


def hier_candidate_query_ref(table: torch.Tensor, pp: torch.Tensor,
                             cp: torch.Tensor) -> torch.Tensor:
    """Plain version: [P, C] in the table's dtype (exact for any dtype)."""
    w = table.shape[0]
    idx = (pp[:, :, None] + cp[:, None, :]).reshape(w, -1)
    vals = torch.gather(table, 1, idx)
    return vals.min(dim=0).values.reshape(pp.shape[1], cp.shape[1])


def hier_candidate_query(table: torch.Tensor, pp: torch.Tensor, cp: torch.Tensor, *,
                         span: Optional[int] = None) -> torch.Tensor:
    """Count-Min estimates for every (prefix, candidate) child: int32[P, C].

    table int32[w, h] (rows may be strided, e.g. a level view); pp int64[w,
    P] prefix partials (pre-scaled); cp int64[w, C] child partials; span the
    level's last range (the window route where the rule picks it; None: the
    direct route).  CUDA tensors launch K4; CPU tensors take
    :func:`hier_candidate_query_ref`.
    """
    if not table.is_cuda:
        if table.dtype != torch.int32:
            raise ValueError(
                f"hier_candidate_query supports int32 tables only (got "
                f"{table.dtype}); use hier_candidate_query_ref")
        return hier_candidate_query_ref(table, pp, cp)
    out = torch.empty((pp.shape[1], cp.shape[1]), dtype=torch.int32, device=table.device)
    return _launch("hier_query", "sk_hier_query", table, pp, cp, (), span, out)


def hier_candidate_query_batched(table: torch.Tensor, pp: torch.Tensor, cp: torch.Tensor,
                                 *, span: Optional[int] = None) -> torch.Tensor:
    """Count-Min estimates for Q requests' (prefix, candidate) grids:
    int32[Q, P, C] from [w, Q, P] prefix partials, one launch total (the
    request axis rides the prefix axis)."""
    w, q, p = pp.shape
    flat = hier_candidate_query(table, pp.reshape(w, q * p), cp, span=span)
    return flat.reshape(q, p, cp.shape[1])


def hier_candidate_query_batched_ref(table: torch.Tensor, pp: torch.Tensor,
                                     cp: torch.Tensor) -> torch.Tensor:
    """Plain request-axis version: [w, Q, P] partials -> [Q, P, C]."""
    w, q, p = pp.shape
    flat = hier_candidate_query_ref(table, pp.reshape(w, q * p), cp)
    return flat.reshape(q, p, cp.shape[1])


def hier_candidate_query_signed_ref(table: torch.Tensor, pp: torch.Tensor,
                                    cp: torch.Tensor, sp: torch.Tensor,
                                    sc: torch.Tensor) -> torch.Tensor:
    """Plain version: float32[w, P, C] per-row estimates (gather in the
    table's dtype, sign applied in float32; any dtype)."""
    w = table.shape[0]
    p, c = pp.shape[1], cp.shape[1]
    idx = (pp[:, :, None] + cp[:, None, :]).reshape(w, -1)
    vals = torch.gather(table, 1, idx).to(torch.float32).reshape(w, p, c)
    return vals * sp.to(torch.float32)[:, :, None] * sc.to(torch.float32)[:, None, :]


def hier_candidate_query_signed(table: torch.Tensor, pp: torch.Tensor,
                                cp: torch.Tensor, sp: torch.Tensor,
                                sc: torch.Tensor, *,
                                span: Optional[int] = None) -> torch.Tensor:
    """Per-row signed estimates for every (prefix, candidate) child:
    int32[w, P, C] on the card.

    table int32[w, h] (rows may be strided, e.g. a level view); pp int64[w,
    P] and cp int64[w, C] bucket partials; sp float32[w, P] and sc
    float32[w, C] +-1 sign partials; span as in
    :func:`hier_candidate_query`.  CUDA tensors launch K9; CPU tensors take
    :func:`hier_candidate_query_signed_ref`.
    """
    if not table.is_cuda:
        return hier_candidate_query_signed_ref(table, pp, cp, sp, sc)
    out = torch.empty((table.shape[0], pp.shape[1], cp.shape[1]), dtype=torch.int32,
                      device=table.device)
    return _launch("hier_query_signed", "sk_hier_query_signed", table, pp, cp, (sp, sc),
                   span, out)


def hier_candidate_median_signed_ref(table: torch.Tensor, pp: torch.Tensor,
                                     cp: torch.Tensor, sp: torch.Tensor,
                                     sc: torch.Tensor) -> torch.Tensor:
    """Plain version of K9m: the median over rows of
    :func:`hier_candidate_query_signed_ref`, float32[P, C].

    It differs from K9m only where K9's plain version differs from K9: a
    cell holding -2^31 under sign -1 (K9 wraps in int32).  A zero under
    sign -1 is -0.0 here and 0.0 in K9m, equal by value."""
    return median_rows(hier_candidate_query_signed_ref(table, pp, cp, sp, sc))


def hier_candidate_median_signed(table: torch.Tensor, pp: torch.Tensor,
                                 cp: torch.Tensor, sp: torch.Tensor,
                                 sc: torch.Tensor, *,
                                 span: Optional[int] = None) -> torch.Tensor:
    """Median signed estimates for every (prefix, candidate) child:
    float32[P, C], ``median_rows`` of :func:`hier_candidate_query_signed`.

    Inputs as :func:`hier_candidate_query_signed`.  CUDA tensors launch K9m,
    whose result equals ``median_rows`` of K9's rows bit for bit; CPU
    tensors take :func:`hier_candidate_median_signed_ref`.
    """
    if not table.is_cuda:
        return hier_candidate_median_signed_ref(table, pp, cp, sp, sc)
    out = torch.empty((pp.shape[1], cp.shape[1]), dtype=torch.float32, device=table.device)
    return _launch("hier_query_signed_median", "sk_hier_query_signed_median", table, pp, cp,
                   (sp, sc), span, out)
