"""The residency rule and launch geometry of the hierarchy folds (K3, K3f,
K8, K8f): ``kernels/hier_update.fold_geometry``.

Pure Python, no card: which levels a CTA folds in shared memory, the
shared bytes, the CTAs and their spans, for the shapes the port's callers
launch (the main path's block, the starcoder2-7b compressor's nine leaves,
the turnstile block) and for random ones; and a walk of the kernel's
grid-stride loop over the spans, which must cover every key exactly once.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import tree as tr
from repro_torch.configs import get_config
from repro_torch.core import hierarchy as hh
from repro_torch.core import sketch as sk
from repro_torch.core.hashing import KeySchema
from repro_torch.kernels import hier_update as hu
from repro_torch.kernels.ops import KernelHierarchy
from repro_torch.models import transformer as tfm
from repro_torch.training import grad_compression as gc

SMS = 132   # an H100 SXM

# The compressed leaves of starcoder2-7b at 2 layers (chip_smoke.py's
# training path): name, shape
STARCODER2_LEAVES = [
    ("blocks/layer_0/attn/wk", (2, 4608, 512)),
    ("blocks/layer_0/attn/wo", (2, 4608, 4608)),
    ("blocks/layer_0/attn/wq", (2, 4608, 4608)),
    ("blocks/layer_0/attn/wv", (2, 4608, 512)),
    ("blocks/layer_0/mlp/b_in", (2, 18432)),
    ("blocks/layer_0/mlp/w_in", (2, 4608, 18432)),
    ("blocks/layer_0/mlp/w_out", (2, 18432, 4608)),
    ("embed", (49152, 4608)),
    ("lm_head", (4608, 49152)),
]


def _hplan(ranges, w, partition=None, tile_h=512):
    schema = KeySchema(domains=(1 << 32,) * len(ranges))
    partition = partition or [(j,) for j in range(len(ranges))]
    spec = sk.mod_sketch_spec(schema, partition, ranges, w)
    return hu.make_hier_plan(hh.HierarchySpec.from_spec(spec), tile_h=tile_h)


def _check_invariants(g, hplan, w, n, itemsize, sms):
    assert len(g.shared) == hplan.n_levels and not g.shared[-1]
    assert g.shared_bytes == sum(w * pad * itemsize
                                 for on, pad in zip(g.shared, hplan.level_pads) if on)
    assert 0 <= g.shared_bytes <= hu.SHARED_BYTES
    assert g.shared_mask < 1 << hplan.n_levels
    assert 1 <= g.span_tiles <= hu.SPAN_TILES
    tiles = -(-n // hu.THREADS)
    assert g.ctas <= -(-tiles // g.span_tiles)                 # no CTA without a span
    per_sm = -(-g.ctas // sms)                                  # the CTAs fit at once
    assert per_sm <= hu.CTAS_PER_SM
    assert per_sm * (g.shared_bytes + hu.CTA_RESERVED_BYTES) <= hu.SM_SHARED_BYTES or n == 0


def test_starcoder2_leaf_list_is_the_compressors():
    cfg = dataclasses.replace(get_config("starcoder2-7b"), n_layers=2)
    params = tfm.init_params(cfg, torch.Generator(), device="meta")
    cc = gc.CompressionConfig(enabled=True)
    leaves = [("/".join(path), tuple(p.shape)) for path, p in tr.flatten(params)
              if p.numel() >= cc.min_size]
    assert leaves == STARCODER2_LEAVES


@pytest.mark.parametrize("name,shape", STARCODER2_LEAVES)
def test_compressor_leaves_fold_level0_in_shared_and_finest_global(name, shape):
    cc = gc.CompressionConfig(enabled=True)
    plan = gc._leaf_plan(cc, shape)
    hplan = hu.make_hier_plan(plan.hspec, tile_h=1)       # as hier_fold_zero_tables
    n = plan.rows * plan.cols
    g = hu.fold_geometry(hplan, cc.width, n, 4, SMS)
    assert g.shared == (True, False)
    assert g.shared_bytes == cc.width * hplan.level_sizes[0] * 4
    _check_invariants(g, hplan, cc.width, n, 4, SMS)
    if n >= hu.THREADS * SMS * hu.CTAS_PER_SM:            # the big leaves fill the card
        assert g.ctas == SMS * hu.CTAS_PER_SM


@pytest.mark.parametrize("n,level0", [(65536, True), (54608, True), (1000, True),
                                      (1, False)])
def test_turnstile_block_folds_level0_in_shared(n, level0):
    """chip_smoke.py's turnstile spec: ranges 4,096 x 4,096, w = 4, int32,
    blocks of 65,536 rows (54,608 in the stream's last).  A lone key does
    not repay zeroing and scanning a 16,384-cell copy."""
    hplan = _hplan((4096, 4096), 4)
    g = hu.fold_geometry(hplan, 4, n, 4, SMS)
    assert g.shared == (level0, False)
    assert g.shared_bytes == (4 * 4096 * 4 if level0 else 0)
    _check_invariants(g, hplan, 4, n, 4, SMS)
    if n == 65536:
        assert (g.ctas, g.span_tiles) == (256, 1)


def _main_path_hplan():
    """chip_smoke.py's main path: per-(src, dst) heavy hitters over a
    two-module 32-bit key, ranges 4,096 x 4,096, w = 4, the hierarchy as
    the endpoint's ``KernelHierarchy`` lays it out."""
    spec = sk.mod_sketch_spec(KeySchema(domains=(1 << 32, 1 << 32)), [(0,), (1,)],
                              (4096, 4096), 4)
    hspec = hh.HierarchySpec.from_spec(spec)
    q = torch.zeros((4, spec.schema.total_chunks), dtype=torch.int64)
    r = torch.zeros((4, spec.n_groups), dtype=torch.int64)
    return KernelHierarchy(hspec, (q, r), device="cpu").hplan


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("n,level0", [(65536, True), (14560, True), (1000, True),
                                      (1, False)])
def test_main_path_block_folds_level0_in_shared(dtype, n, level0):
    """K3 (int32) and K3f (float32) on the main path's blocks of 65,536 rows
    (14,560 in the stream's last): level 0's 4 x 4,096 cells (65,536 B) in
    shared memory, 256 CTAs of one tile each, the finest level global."""
    hplan = _main_path_hplan()
    itemsize = torch.empty((), dtype=dtype).element_size()
    g = hu.fold_geometry(hplan, 4, n, itemsize, SMS)
    assert g.shared == (level0, False)
    assert g.shared_bytes == (65536 if level0 else 0)
    _check_invariants(g, hplan, 4, n, itemsize, SMS)
    if n == 65536:
        assert (g.ctas, g.span_tiles) == (256, 1)


@pytest.mark.parametrize("ranges,want", [((65536, 64), (False, False)),
                                         ((64, 65536, 16), (True, False, False)),
                                         ((8192, 2, 1024), (True, False, False))])
def test_coarse_level_over_the_budget_goes_global(ranges, want):
    hplan = _hplan(ranges, 4)
    n = 1 << 20
    g = hu.fold_geometry(hplan, 4, n, 4, SMS)
    assert g.shared == want
    _check_invariants(g, hplan, 4, n, 4, SMS)


def test_two_coarse_levels_share_the_budget():
    """The card tests' three-level hierarchy: both coarse levels fit and
    repay at 5,003 keys; at 100 keys (one CTA) level 1 does not repay."""
    schema = KeySchema(domains=(1 << 32, 256, 1000, 4096))
    base = sk.mod_sketch_spec(schema, [(1, 2), (0,), (3,)], (48, 90, 7), 4)
    hplan = hu.make_hier_plan(hh.HierarchySpec.from_spec(base), tile_h=128)
    g = hu.fold_geometry(hplan, 4, 5003, 4, SMS)
    assert g.shared == (True, True, False)
    assert g.shared_bytes == 4 * (128 + 4352) * 4
    _check_invariants(g, hplan, 4, 5003, 4, SMS)
    assert hu.fold_geometry(hplan, 4, 100, 4, SMS).shared == (True, False, False)


def test_no_shared_budget_keeps_every_level_global():
    hplan = _hplan((4096, 4096), 4)
    g = hu.fold_geometry(hplan, 4, 65536, 4, SMS, shared_bytes=0)
    assert g.shared == (False, False) and g.shared_bytes == 0 and g.shared_mask == 0
    _check_invariants(g, hplan, 4, 65536, 4, SMS)


@pytest.mark.parametrize("seed", range(4))
def test_random_specs_stay_inside_the_budget(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        levels = int(rng.integers(2, 5))
        ranges = tuple(int(x) for x in 2 ** rng.integers(1, 14, levels))
        if np.prod(ranges, dtype=np.float64) >= 2 ** 31:
            continue
        w = int(rng.integers(1, 9))
        itemsize = int(rng.choice([4, 8]))
        n = int(rng.integers(0, 1 << 24))
        sms = int(rng.choice([1, 78, 132]))
        hplan = _hplan(ranges, w, tile_h=int(rng.choice([1, 128, 512])))
        g = hu.fold_geometry(hplan, w, n, itemsize, sms)
        _check_invariants(g, hplan, w, n, itemsize, sms)


def _walk(g, n):
    """The kernel's loop: CTA c takes spans c, c + ctas, ... of span_tiles
    tiles of THREADS keys each, cut at n.  Returns each CTA's [start, end)
    ranges."""
    span = g.span_tiles * hu.THREADS
    return [[(start, min(start + span, n))
             for start in range(c * span, n, g.ctas * span)] for c in range(g.ctas)]


@pytest.mark.parametrize("fold", ["compressor", "main"])
@pytest.mark.parametrize("n", [1, 255, 257, 4097, 65537, 1_000_003, 226_492_417])
def test_the_walk_covers_every_key_once(fold, n):
    """The compressor's leaf plan (K8f) and the main path's (K3, K3f), at
    odd n and n around a tile."""
    hplan, w = (_hplan((2172, 2172), 3), 3) if fold == "compressor" else (_main_path_hplan(), 4)
    g = hu.fold_geometry(hplan, w, n, 4, SMS)
    walks = _walk(g, n)
    ranges = sorted(rng for walk in walks for rng in walk)
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))   # no gap, no overlap
    assert all(lo < hi for lo, hi in ranges)
    counts = [len(walk) for walk in walks]
    assert min(counts) >= 1 and max(counts) - min(counts) <= 1      # every CTA, balanced
