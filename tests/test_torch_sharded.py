"""Port parity: the mesh, the distributed folds and the sharded service.

The port's ``ShardedTopKService`` on CPU meshes of 1, 2, 4 and 8 shards is
held against the reference's service on a one-device mesh (in process),
fed the same uneven blocks with the reference's own hash draw: merged
tables, candidates, ``heavy_hitters`` and ``topk`` (ties included) equal,
and ``state_dict``s interchangeable.  The same holds through the sync
cadences, ``remesh`` mid-stream, ``to_sharded``, a snapshot restored
across shard counts and a migration.  The distributed folds
(``sharded_build``, ``sharded_signed_build``, the lazy locals,
``sharded_hierarchy_build``, ``KernelSketch.sharded_update``) are held
against the reference's serial builds, and ``row_sharded_query`` against
its query.  Int32 tables throughout: tolerance 0.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import countsketch as rcs
from repro.core import distributed as rdist
from repro.core.hashing import KeySchema as RKeySchema
from repro.core import hierarchy as rhh
from repro.core import sketch as rsk
from repro.kernels import ops as rops
from repro.serving import sketch_engine as rse
from repro.serving.sharded_topk import ShardedTopKService as RefService
from repro.streams import zipf_hh_workload as r_zipf_hh_workload
from repro_torch.core import countsketch as pcs
from repro_torch.core import distributed as dist
from repro_torch.core import hierarchy as hh
from repro_torch.core import sketch as psk
from repro_torch.core.hashing import KeySchema
from repro_torch.kernels.ops import KernelSketch
from repro_torch.launch import mesh as pmesh
from repro_torch.launch.mesh import Mesh
from repro_torch.serving.sharded_topk import ShardedTopKService
from repro_torch.serving.sketch_engine import SketchServeEngine, SketchTopKEndpoint
from repro_torch.streams import zipf_hh_workload
from repro_torch.training.fault_tolerance import elastic_remesh

KEY = jax.random.PRNGKey(7)
CAP = 4096                     # pools under capacity: the shard fold is exact
MESH1 = jax.make_mesh((1,), ("data",))


def cpu_mesh(n: int, axes=("data",), shape=None) -> Mesh:
    shape = (n,) if shape is None else shape
    return Mesh(shape, axes, ["cpu"] * int(np.prod(shape)))


@functools.lru_cache(maxsize=1)
def _workload():
    kw = dict(n_src=300, n_tgt=600, n_edges=3000, n_occurrences=30_000, seed=4)
    wl, rwl = zipf_hh_workload(**kw), r_zipf_hh_workload(**kw)
    np.testing.assert_array_equal(wl.stream.items, rwl.stream.items)
    np.testing.assert_array_equal(wl.stream.freqs, rwl.stream.freqs)
    return wl.stream


def _blocks(stream, sizes=(700, 256, 1000, 333)):
    out, s, i = [], 0, 0
    n = stream.items.shape[0]
    while s < n:
        e = min(n, s + sizes[i % len(sizes)])
        out.append((stream.items[s:e], stream.freqs[s:e]))
        s, i = e, i + 1
    return out


def _specs(stream, ranges=(64, 32), w=3):
    return (rsk.mod_sketch_spec(stream.schema, [(0,), (1,)], ranges, w),
            psk.mod_sketch_spec(KeySchema(stream.schema.domains), [(0,), (1,)],
                                ranges, w))


def _params(rspec, key=KEY):
    """The reference's finest-level draw for ``rspec`` as numpy (q, r)."""
    p = rhh.init_hierarchy(rhh.HierarchySpec.from_spec(rspec), key).states[-1].params
    return np.asarray(p.q), np.asarray(p.r)


@functools.lru_cache(maxsize=1)
def _reference():
    """The reference's service on a one-device mesh over the whole stream:
    its tables, candidates and answers."""
    stream = _workload()
    rspec, _ = _specs(stream)
    ref = RefService(rspec, KEY, MESH1, sync_every=2, max_candidates_per_group=CAP)
    for it, fr in _blocks(stream):
        ref.ingest(it, fr)
    return {"tables": [np.asarray(s.table) for s in ref.state().states],
            "cands": ref.candidates(), "topk": ref.topk(40),
            "hh": ref.heavy_hitters(60), "sd": ref.state_dict(), "total": ref.total}


def _service(n, **kw):
    stream = _workload()
    rspec, pspec = _specs(stream)
    kw.setdefault("max_candidates_per_group", CAP)
    return ShardedTopKService(pspec, _params(rspec), cpu_mesh(n), **kw)


def _assert_answer(want, got):
    assert got[0].dtype == np.uint32 and got[1].dtype == np.int64
    np.testing.assert_array_equal(want[0], got[0])
    np.testing.assert_array_equal(want[1], got[1])


def _assert_matches_reference(svc):
    ref = _reference()
    assert svc.total == ref["total"]
    for want, got in zip(ref["tables"], svc.state().states):
        assert got.table.dtype == torch.int32
        np.testing.assert_array_equal(want, got.table.numpy())
    for want, got in zip(ref["cands"], svc.candidates()):
        np.testing.assert_array_equal(want, got)
    _assert_answer(ref["topk"], svc.topk(40))
    _assert_answer(ref["hh"], svc.heavy_hitters(60))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_sharded_service_matches_reference_one_device_mesh(n):
    svc = _service(n, sync_every=2)
    assert svc.n_shards == n and len(svc._local) == n
    for it, fr in _blocks(_workload()):
        svc.ingest(it, fr)
    _assert_matches_reference(svc)
    sd, want = svc.state_dict(), _reference()["sd"]
    assert int(sd["meta.n_shards"]) == n
    shared = [k for k in want if not k.startswith(("shard", "meta.n_shards"))]
    for k in shared:
        assert sd[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(sd[k], want[k], err_msg=k)
    if n == 1:
        assert sd.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(sd[k], want[k], err_msg=k)
    # and the port's single-shard endpoint agrees on the same stream: the
    # same tables, and the same heavy hitters up to tie order (its
    # candidates are in pool order, the service's sorted)
    stream = _workload()
    rspec, pspec = _specs(stream)
    ep = SketchTopKEndpoint(pspec, _params(rspec), max_candidates_per_group=CAP,
                            device="cpu")
    for it, fr in _blocks(stream):
        ep.ingest(it, fr)
    for a, b in zip(ep.state.states, svc.state().states):
        assert torch.equal(a.table, b.table)
    (ei, ee), (si, se) = ep.heavy_hitters(60), svc.heavy_hitters(60)
    np.testing.assert_array_equal(ee, se)
    assert {tuple(r) for r in ei.tolist()} == {tuple(r) for r in si.tolist()}


@pytest.mark.parametrize("sync_every", [1, 4, None])
def test_sync_cadence(sync_every):
    svc = _service(4, sync_every=sync_every)
    for i, (it, fr) in enumerate(_blocks(_workload())):
        svc.ingest(it, fr)
        pending = sync_every is None or (i + 1) % sync_every != 0
        assert svc._dirty == pending
        assert svc._blocks_since_sync == (0 if not pending else
                                          (i + 1 if sync_every is None else (i + 1) % sync_every))
    # a query syncs first: never stale
    _assert_matches_reference(svc)
    assert not svc._dirty and all(int(b.abs().sum()) == 0 for b in svc._local)


def test_remesh_mid_stream_bitwise():
    blocks = _blocks(_workload())
    third = len(blocks) // 3
    svc = _service(4, sync_every=3)
    for it, fr in blocks[:third]:
        svc.ingest(it, fr)
    before = [s.table.clone() for s in svc.state().states]
    svc.remesh(cpu_mesh(2))
    assert svc.n_shards == 2 and len(svc._local) == 2 and len(svc._shard_pools) == 2
    for a, b in zip(before, svc.state().states):
        assert torch.equal(a, b.table)              # queries agree across the remesh
    for it, fr in blocks[third:2 * third]:
        svc.ingest(it, fr)
    svc.remesh(cpu_mesh(8))
    assert svc.n_shards == 8 and len(svc._local) == 8
    for it, fr in blocks[2 * third:]:
        svc.ingest(it, fr)
    _assert_matches_reference(svc)


def test_endpoint_to_sharded_continuation():
    stream = _workload()
    rspec, pspec = _specs(stream)
    blocks = _blocks(stream)
    half = len(blocks) // 2
    for kernel in (False, True):
        ep = SketchTopKEndpoint(pspec, _params(rspec), max_candidates_per_group=CAP,
                                use_update_kernel=kernel, device="cpu")
        for it, fr in blocks[:half]:
            ep.ingest(it, fr)
        svc = ep.to_sharded(cpu_mesh(4), sync_every=2)
        # the tables were copied: more endpoint ingest leaves the service alone
        snap = [s.table.clone() for s in svc.state().states]
        ep.ingest(*blocks[half])
        for a, b in zip(snap, svc.state().states):
            assert torch.equal(a, b.table)
        for it, fr in blocks[half:]:
            svc.ingest(it, fr)
        _assert_matches_reference(svc)
    # the reference's own promotion agrees: one-device mesh, same halves
    rep = rse.SketchTopKEndpoint(rspec, KEY, max_candidates_per_group=CAP)
    for it, fr in blocks[:half]:
        rep.ingest(it, fr)
    rsvc = rep.to_sharded(MESH1)
    for it, fr in blocks[half:]:
        rsvc.ingest(it, fr)
    _assert_answer(rsvc.topk(40), svc.topk(40))


@pytest.mark.parametrize("flag", [None, False, True])
def test_kernel_switch_is_kept_as_given_across_meshes(flag):
    """``use_kernel`` reaches the service as its caller gave it, through
    ``to_sharded``, ``remesh`` and a migration's successor, and is resolved
    against the mesh the merged tables are on at query time: ``None`` is
    off on a CPU mesh and on once they are on the card."""
    stream = _workload()
    rspec, pspec = _specs(stream)
    ep = SketchTopKEndpoint(pspec, _params(rspec), max_candidates_per_group=CAP,
                            use_kernel=flag, device="cpu")
    svc = ep.to_sharded(cpu_mesh(2))
    assert svc._use_kernel is flag and svc.use_kernel is bool(flag)
    svc.remesh(cpu_mesh(4))
    assert svc._use_kernel is flag and svc.use_kernel is bool(flag)
    assert svc._build_successor(pspec, _params(rspec))._use_kernel is flag
    svc.mesh = Mesh((1,), ("data",), ["cuda"])    # where a remesh onto a card puts them
    assert svc.use_kernel is (flag is not False)


def test_snapshot_restores_across_shard_counts_and_packages():
    blocks = _blocks(_workload())
    half = len(blocks) // 2
    src = _service(4, sync_every=3)
    for it, fr in blocks[:half]:
        src.ingest(it, fr)
    sd = src.state_dict()
    for n in (4, 2, 1):
        dst = _service(n, sync_every=3)
        dst.load_state_dict(sd)
        assert dst.n_shards == n
        for it, fr in blocks[half:]:
            dst.ingest(it, fr)
        _assert_matches_reference(dst)
    # the port's 4-shard snapshot loads into the reference's one-device
    # service, and the reference's snapshot into a port service
    rspec, _ = _specs(_workload())
    ref = RefService(rspec, KEY, MESH1, sync_every=3, max_candidates_per_group=CAP)
    ref.load_state_dict(sd)
    for it, fr in blocks[half:]:
        ref.ingest(it, fr)
    _assert_answer(_reference()["topk"], ref.topk(40))
    port = _service(2)
    port.load_state_dict(_reference()["sd"])
    _assert_matches_reference(port)
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        _service(2, max_candidates_per_group=CAP + 1).load_state_dict(sd)


def test_sharded_migration_shard_invariant():
    stream = _workload()
    rold, pold = _specs(stream, ranges=(64, 16), w=4)
    rnew, pnew = _specs(stream, ranges=(16, 64), w=4)
    mig_key = jax.random.fold_in(KEY, 7)
    items, freqs = stream.items, stream.freqs
    n = items.shape[0]
    cut1, cut2 = n // 3, 2 * n // 3
    warm = int(freqs[cut1:cut2].sum())
    results = []
    for c in (1, 2, 4):
        svc = ShardedTopKService(pold, _params(rold), cpu_mesh(c),
                                 max_candidates_per_group=CAP)
        svc.ingest(items[:cut1], freqs[:cut1])
        svc.begin_migration(pnew, _params(rnew, mig_key), warmup=warm)
        assert svc.migrating
        with pytest.raises(ValueError, match="warmup window"):
            svc.remesh(cpu_mesh(2))
        with pytest.raises(ValueError, match="abort_migration"):
            svc.state_dict()
        svc.ingest(items[cut1:cut2], freqs[cut1:cut2])
        assert not svc.migrating and svc.hspec.base == pnew
        svc.ingest(items[cut2:], freqs[cut2:])
        results.append((svc.topk(16), [s.table.clone() for s in svc.state().states]))
    # the reference on its one-device mesh, and a fresh service on the new spec
    ref = RefService(rold, KEY, MESH1, max_candidates_per_group=CAP)
    ref.ingest(items[:cut1], freqs[:cut1])
    ref.begin_migration(rnew, mig_key, warmup=warm)
    ref.ingest(items[cut1:cut2], freqs[cut1:cut2])
    ref.ingest(items[cut2:], freqs[cut2:])
    fresh = ShardedTopKService(pnew, _params(rnew, mig_key), cpu_mesh(4),
                               max_candidates_per_group=CAP)
    fresh.ingest(items[cut1:cut2], freqs[cut1:cut2])
    fresh.ingest(items[cut2:], freqs[cut2:])
    for (ans, tables) in results:
        _assert_answer(ref.topk(16), ans)
        _assert_answer(fresh.topk(16), ans)
        for want, got in zip(ref.state().states, tables):
            np.testing.assert_array_equal(np.asarray(want.table), got.numpy())


def test_engine_drives_the_psum_cadence():
    stream = _workload()
    rspec, _ = _specs(stream)
    svc = _service(4, sync_every=None)
    eng = SketchServeEngine(svc, max_staleness=0, shard_sync_every=4)
    ref = rse.SketchServeEngine(
        RefService(rspec, KEY, MESH1, sync_every=None, max_candidates_per_group=CAP),
        max_staleness=0)
    for i, (it, fr) in enumerate(_blocks(stream)):
        eng.ingest(it, fr)
        ref.ingest(it, fr)
        assert svc._dirty == ((i + 1) % 4 != 0)
        if i % 5 == 4:
            _assert_answer(ref.topk(10), eng.topk(10))
    eng.submit_topk(25)
    eng.submit_heavy_hitters(80)
    ref.submit_topk(25)
    ref.submit_heavy_hitters(80)
    for a, b in zip(ref.flush(), eng.flush()):
        _assert_answer((a.items, a.est), (b.items, b.est))


# --------------------------------------------------------------------------
# the distributed folds against the reference's serial builds
# --------------------------------------------------------------------------

def _flat_case(seed, n_items=4096, ranges=(32, 64), w=4):
    schema_domains = (1 << 20, 1 << 20)
    rspec = rsk.mod_sketch_spec(RKeySchema(schema_domains), [(0,), (1,)], ranges, w)
    pspec = psk.mod_sketch_spec(KeySchema(schema_domains), [(0,), (1,)], ranges, w)
    rng = np.random.default_rng(seed)
    items = rng.integers(0, 1 << 20, size=(n_items, 2), dtype=np.int64).astype(np.uint32)
    freqs = rng.integers(1, 9, size=n_items).astype(np.int32)
    return rspec, pspec, items, freqs


@pytest.mark.parametrize("n", [1, 4, 8])
def test_flat_sharded_folds_match_serial(n):
    rspec, pspec, items, freqs = _flat_case(n)
    rparams = rsk.init_params(rspec, jax.random.PRNGKey(n))
    pparams = psk.resolve_params(pspec, (np.asarray(rparams.q), np.asarray(rparams.r)),
                                 "cpu")
    serial = np.asarray(rsk.build_sketch(rspec, jax.random.PRNGKey(n), items, freqs).table)
    mesh = cpu_mesh(n)
    merged = dist.sharded_build(pspec, pparams, mesh, ("data",), items, freqs)
    np.testing.assert_array_equal(serial, merged.numpy())
    state = psk.SketchState(pparams, torch.ones((4, pspec.table_size), dtype=torch.int32))
    upd = dist.sharded_update(pspec, mesh, ("data",), state, items, freqs)
    np.testing.assert_array_equal(serial + 1, upd.table.numpy())
    local = dist.init_local_tables(mesh, ("data",), n, (4, pspec.table_size), torch.int32)
    for s in range(0, items.shape[0], 1024):
        dist.lazy_local_update(pspec, mesh, ("data",), local, pparams,
                               items[s:s + 1024], freqs[s:s + 1024])
    np.testing.assert_array_equal(
        serial, dist.merge_local_tables(mesh, ("data",), local).numpy())
    # signed: the reference's Count-Sketch fold of the whole stream
    rcp = rcs.init_params(rspec, jax.random.PRNGKey(n + 100))
    pcp = pcs.resolve_params(pspec, tuple(np.asarray(x) for x in (
        rcp.base.q, rcp.base.r, rcp.sign_q, rcp.sign_r)), "cpu")
    signed = freqs * np.where(np.arange(items.shape[0]) % 3 == 0, -1, 1).astype(np.int32)
    zero = jax.numpy.zeros((rspec.width, rspec.table_size), jax.numpy.int32)
    want = rcs.update(rspec, rcs.CountSketchState(rcp, zero), items, signed).table
    got = dist.sharded_signed_build(pspec, pcp, mesh, ("data",), items, signed)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("mode", ["linear", "signed"])
def test_kernel_sketch_sharded_update_matches_reference(mode):
    rspec, pspec, items, freqs = _flat_case(5, n_items=700, ranges=(16, 16), w=3)
    if mode == "signed":
        freqs = freqs * np.where(np.arange(700) % 2 == 0, -1, 1).astype(np.int32)
    ref = rops.KernelSketch(rspec, jax.random.PRNGKey(5), mode=mode)
    sd = ref.state_dict()
    params = ((sd["params.q"], sd["params.r"]) if mode == "linear" else
              (sd["params.q"], sd["params.r"], sd["params.sign_q"], sd["params.sign_r"]))
    port = KernelSketch(pspec, params, device="cpu", mode=mode)
    for (s, e), n in (((0, 300), 4), ((300, 700), 2)):   # uneven blocks, padded
        ref.sharded_update(MESH1, ("data",), items[s:e], freqs[s:e])
        port.sharded_update(cpu_mesh(n), ("data",), items[s:e], freqs[s:e])
    np.testing.assert_array_equal(ref.table_view(), port.table_view())
    if mode == "linear":
        want = rsk.build_sketch(rspec, jax.random.PRNGKey(5), items, freqs)
        np.testing.assert_array_equal(np.asarray(want.table), port.table_view())
    rsd, psd = ref.state_dict(), port.state_dict()
    for k in rsd:
        np.testing.assert_array_equal(rsd[k], psd[k], err_msg=k)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_sharded_hierarchy_build_matches_build_hierarchy(n):
    rng = np.random.default_rng(n)
    for ranges, w, n_items in (((16, 16), 3, 4096), ((32, 8), 2, 2048)):
        schema = (1 << 20, 1 << 20)
        rbase = rsk.mod_sketch_spec(RKeySchema(schema), [(0,), (1,)], ranges, w)
        pbase = psk.mod_sketch_spec(KeySchema(schema), [(0,), (1,)], ranges, w)
        rhspec, phspec = (rhh.HierarchySpec.from_spec(rbase),
                          hh.HierarchySpec.from_spec(pbase))
        key = jax.random.PRNGKey(w)
        items = rng.integers(0, 1 << 20, size=(n_items, 2), dtype=np.int64).astype(np.uint32)
        freqs = rng.integers(1, 9, size=n_items).astype(np.int32)
        want = rhh.build_hierarchy(rhspec, key, items, freqs)
        fine = rhh.init_hierarchy(rhspec, key).states[-1].params
        state0 = hh.init_hierarchy(phspec, (np.asarray(fine.q), np.asarray(fine.r)),
                                   device="cpu")
        got = hh.sharded_hierarchy_build(phspec, state0, cpu_mesh(n), ("data",), items, freqs)
        for g, t in zip(got.states, want.states):
            np.testing.assert_array_equal(np.asarray(t.table), g.table.numpy())
        assert all(int(s.table.abs().sum()) == 0 for s in state0.states)   # a copy
        # float32 levels take the same fold; integer partial sums are exact
        f32 = hh.init_hierarchy(phspec, (np.asarray(fine.q), np.asarray(fine.r)),
                                dtype=torch.float32, device="cpu")
        got32 = hh.sharded_hierarchy_build(phspec, f32, cpu_mesh(n), ("data",), items, freqs)
        for g, t in zip(got32.states, want.states):
            assert g.table.dtype == torch.float32
            np.testing.assert_array_equal(np.asarray(t.table).astype(np.float32),
                                          g.table.numpy())


def test_sharded_hierarchy_build_matches_reference_four_device_leg(tmp_path):
    """The reference's ``sharded_hierarchy_build`` on four forced host
    devices (a subprocess, as its own multi-device tests run; this leg
    passes with the installed jax) against the port's four CPU shards."""
    import os
    import subprocess
    import sys
    import textwrap

    out = tmp_path / "ref.npz"
    code = f"""
        import jax, numpy as np
        from repro.core import hierarchy as hh, sketch as sk
        from repro.core.hashing import KeySchema
        mesh = jax.make_mesh((4,), ("data",))
        base = sk.mod_sketch_spec(KeySchema(domains=(1 << 20, 1 << 20)), [(0,), (1,)],
                                  (16, 16), 3)
        hspec = hh.HierarchySpec.from_spec(base)
        rng = np.random.default_rng(0)
        items = rng.integers(0, 1 << 20, size=(4096, 2), dtype=np.int64).astype(np.uint32)
        freqs = rng.integers(1, 9, size=4096).astype(np.int32)
        state = hh.init_hierarchy(hspec, jax.random.PRNGKey(3))
        got = hh.sharded_hierarchy_build(hspec, state, mesh, ("data",), items, freqs)
        p = state.states[-1].params
        np.savez({str(out)!r}, items=items, freqs=freqs, q=np.asarray(p.q), r=np.asarray(p.r),
                 **{{f"t{{i}}": np.asarray(s.table) for i, s in enumerate(got.states)}})
        print("REF OK")
    """
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0 and "REF OK" in res.stdout, res.stderr[-4000:]
    ref = np.load(out)
    base = psk.mod_sketch_spec(KeySchema((1 << 20, 1 << 20)), [(0,), (1,)], (16, 16), 3)
    hspec = hh.HierarchySpec.from_spec(base)
    state = hh.init_hierarchy(hspec, (ref["q"], ref["r"]), device="cpu")
    got = hh.sharded_hierarchy_build(hspec, state, cpu_mesh(4), ("data",), ref["items"],
                                     ref["freqs"])
    for i, st in enumerate(got.states):
        np.testing.assert_array_equal(ref[f"t{i}"], st.table.numpy())


def test_row_sharded_query_matches_query():
    rspec, pspec, items, freqs = _flat_case(0, ranges=(32, 64), w=4)
    rparams = rsk.init_params(rspec, jax.random.PRNGKey(0))
    serial = rsk.build_sketch(rspec, jax.random.PRNGKey(0), items, freqs)
    want = np.asarray(rsk.query(rspec, serial, items[:64]))
    pparams = psk.resolve_params(pspec, (np.asarray(rparams.q), np.asarray(rparams.r)),
                                 "cpu")
    table = torch.from_numpy(np.array(serial.table))
    mesh = cpu_mesh(0, axes=("data", "model"), shape=(4, 2))
    got = dist.row_sharded_query(pspec, mesh, "model", pparams, table, items[:64])
    np.testing.assert_array_equal(want, got.numpy())
    with pytest.raises(ValueError, match="do not split"):
        dist.row_sharded_query(pspec, cpu_mesh(0, ("model",), (3,)), "model", pparams,
                               table, items[:4])


def test_conservative_refuses_every_sharded_entry_point():
    stream = _workload()
    rspec, pspec = _specs(stream, ranges=(8, 8), w=2)
    phspec, rhspec = hh.HierarchySpec.from_spec(pspec), rhh.HierarchySpec.from_spec(rspec)
    params = _params(rspec)
    mesh = cpu_mesh(2)

    def message(fn):
        with pytest.raises(ValueError) as got:
            fn()
        return str(got.value)

    want = message(lambda: RefService(rspec, KEY, MESH1, mode="conservative"))
    assert message(lambda: ShardedTopKService(pspec, params, mesh, mode="conservative")) \
        == want
    item, freq = np.zeros((2, 2), np.uint32), np.ones(2, np.int32)
    pairs = [
        (lambda: rops.KernelSketch(rspec, KEY, mode="conservative").sharded_update(
            MESH1, ("data",), item, freq),
         lambda: KernelSketch(pspec, params, device="cpu", mode="conservative")
         .sharded_update(mesh, ("data",), item, freq)),
        (lambda: rhh.sharded_hierarchy_build(rhspec, rhh.init_hierarchy(rhspec, KEY), MESH1,
                                             ("data",), item, freq, mode="conservative"),
         lambda: hh.sharded_hierarchy_build(phspec, hh.init_hierarchy(phspec, params,
                                                                      device="cpu"),
                                            mesh, ("data",), item, freq,
                                            mode="conservative")),
        (lambda: rdist.lazy_hierarchy_update(rhspec, MESH1, ("data",), (), (), item, freq,
                                             mode="conservative"),
         lambda: dist.lazy_hierarchy_update(phspec, mesh, ("data",), (), (), item, freq,
                                            mode="conservative")),
        (lambda: rse.SketchTopKEndpoint(rspec, KEY, mode="conservative").to_sharded(MESH1),
         lambda: SketchTopKEndpoint(pspec, params, mode="conservative",
                                    device="cpu").to_sharded(mesh)),
    ]
    for ref_fn, port_fn in pairs:
        assert message(port_fn) == message(ref_fn)
    assert ShardedTopKService(pspec, params, mesh).mode == "linear"


def test_mesh_placement_and_elastic_remesh(monkeypatch):
    mesh = cpu_mesh(0, axes=("pod", "data", "model"), shape=(2, 2, 2))
    assert mesh.shape == {"pod": 2, "data": 2, "model": 2} and mesh.size == 8
    assert pmesh.sketch_data_axes(mesh) == ("pod", "data")
    assert mesh.axis_size(("pod", "data")) == 4
    # position i of a mesh, by name, to see which positions an axis walks
    named = Mesh((2, 2, 2), ("pod", "data", "model"), ["cpu"] * 8)
    named.devices = list(range(8))
    assert named.axis_devices(("pod", "data")) == [0, 2, 4, 6]
    assert named.axis_devices(("model",)) == [0, 1]
    assert named.axis_devices(("data", "model")) == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="devices"):
        Mesh((2, 2), ("data", "model"), ["cpu"] * 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (pmesh.make_mesh, pmesh.make_test_mesh):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make((2,), ("data",))
    with pytest.raises(RuntimeError, match="256 CUDA devices"):
        pmesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="512 CUDA devices"):
        pmesh.make_production_mesh(multi_pod=True)
    # elastic_remesh: every leaf is copied onto the new mesh's first device,
    # through dicts, lists and NamedTuples, None kept
    x = torch.arange(1024, dtype=torch.float32).reshape(8, 128)
    params = psk.SketchParams(q=torch.arange(3), r=torch.arange(3) + 7)
    state = {"table": x, "step": torch.tensor(11), "levels": [x[:2], None],
             "params": params}
    for n in (4, 1, 8):
        out = elastic_remesh(state, cpu_mesh(n))
        leaves = [(out["table"], x), (out["step"], state["step"]),
                  (out["levels"][0], x[:2]), (out["params"].q, params.q),
                  (out["params"].r, params.r)]
        assert out["levels"][1] is None and isinstance(out["params"], psk.SketchParams)
        for got, want in leaves:
            assert got.device == torch.device("cpu") and torch.equal(got, want)
            assert got.data_ptr() != want.data_ptr()
