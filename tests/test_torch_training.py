"""The port's training path (optimizer, sketch-based gradient compression,
the train step and loop) against the JAX reference, on the CPU.

Both packages get the same numpy inputs; hash draws and weights are the
reference's own, carried across by ``repro_torch.interop`` (each
compressed leaf's draw keyed by its path).  Tolerances, each with its
reason:

- optimizer: rtol 1e-6 (the same float32 arithmetic; ``pow`` and ``cos``
  may differ in the last bit between the two libraries);
- compression on integer-valued gradients: 0 (every partial sum is an
  exact integer, so tables, selections, outputs and residuals are exact);
  on Gaussian gradients the tables within rtol 1e-5 (float sums in
  another order);
- one train step in float32: rtol 1e-5 with atol 1e-6 times each
  leaf's scale (forward and backward sum in other orders);
- the n-gram table: 0 (int32 counts).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.core import countsketch as rcs
from repro.models import transformer as rtfm
from repro.streams import ngram as rngram
from repro.training import grad_compression as rgc
from repro.training import optimizer as ropt
from repro.training import train_loop as rtl
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch import tree as tr
from repro_torch.core import countsketch as tcs
from repro_torch.models import transformer as ttfm
from repro_torch.streams import ngram as tngram
from repro_torch.training import checkpoint as tckpt
from repro_torch.training import fault_tolerance as tft
from repro_torch.training import grad_compression as tgc
from repro_torch.training import optimizer as topt
from repro_torch.training import train_loop as ttl

DENSE = [a for a in rconfigs.ARCHS
         if rconfigs.get_config(a).family in ("dense", "vlm")]
# the reference's compressor pieces, jitted as its own tests run them
# (eager, each new shape costs seconds of op-by-op compiles)
R_FOLD = jax.jit(rcs.hier_fold_tables, static_argnums=0)
R_DESCEND = jax.jit(rgc._descend_topk, static_argnums=0)
R_COMPRESS = jax.jit(rgc.compress_decompress, static_argnums=0)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _f32_close(got, want, rtol=1e-5):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=1e-6 * scale)


# --------------------------------------------------------------------------
# optimizer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["adamw", "adamw8bit"])
def test_optimizer_matches_reference_for_three_steps(name):
    kw = dict(name=name, lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=1.0)
    rcfg, tcfg = ropt.OptimizerConfig(**kw), topt.OptimizerConfig(**kw)
    rng = np.random.default_rng(0)
    p0 = {"w": rng.standard_normal((8, 16)).astype(np.float32),
          "blocks": {"q": rng.standard_normal((2, 4, 256)).astype(np.float32)},
          "b": rng.standard_normal(3).astype(np.float32)}
    rp, tp = jax.tree.map(jnp.asarray, p0), tr.map_leaves(_t, p0)
    rs, ts = ropt.init_state(rcfg, rp), topt.init_state(tcfg, tp)
    if name == "adamw8bit":
        assert isinstance(ts["m"]["blocks"]["q"], topt.Moment8)
        assert not isinstance(ts["m"]["b"], topt.Moment8)
    assert topt.state_bytes(ts) == ropt.state_bytes(rs)
    for step in range(3):
        g = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 0.5).astype(np.float32), p0)
        rp, rs, rmet = ropt.apply_updates(rcfg, rp, jax.tree.map(jnp.asarray, g), rs)
        tp, ts, tmet = topt.apply_updates(tcfg, tp, tr.map_leaves(_t, g), ts)
        for (path, got), want in zip(tr.flatten(tp), jax.tree.leaves(rp)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                       atol=1e-7, err_msg=str((step, path)))
        for key in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tmet[key]), float(rmet[key]), rtol=1e-6)
    assert int(ts["step"]) == int(rs["step"]) == 3
    for s in (0, 1, 2, 5, 10, 12):
        np.testing.assert_allclose(float(topt.lr_schedule(tcfg, s)),
                                   float(ropt.lr_schedule(rcfg, jnp.int32(s))),
                                   rtol=1e-6)


def test_clipping_and_round_half_to_even_match_reference():
    tree = {"a": np.full((10,), 100.0, np.float32), "b": np.ones((3, 2), np.float32)}
    rc, rn = ropt.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), 1.0)
    tc, tn = topt.clip_by_global_norm(tr.map_leaves(_t, tree), 1.0)
    np.testing.assert_allclose(float(tn), float(rn), rtol=1e-6)
    for got, want in zip(tr.leaves(tc), jax.tree.leaves(rc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    # a block whose quotients land on .5: both round half to even
    x = np.array([[0.5, 1.5, 2.5, -0.5, -1.5, 127.0] + [0.0] * 122], np.float32)
    rq, rs_ = ropt._quantize_sym(jnp.asarray(x))
    tq, ts_ = topt._quantize_sym(_t(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(ts_.numpy(), np.asarray(rs_))


# --------------------------------------------------------------------------
# gradient compression
# --------------------------------------------------------------------------

def _ref_draws(state):
    """Each compressed leaf's (q, r, sign_q, sign_r), keyed by its path."""
    comps = jax.tree_util.tree_flatten_with_path(
        state.compressors, is_leaf=lambda x: isinstance(x, rgc.LeafCompressor))[0]
    return {tuple(k.key for k in path): tuple(np.asarray(a) for a in (
        c.params.base.q, c.params.base.r, c.params.sign_q, c.params.sign_r))
        for path, c in comps}


def _compressors(cfg_kw, grads, key=0):
    rcfg = rgc.CompressionConfig(enabled=True, **cfg_kw)
    tcfg = tgc.CompressionConfig(enabled=True, **cfg_kw)
    rstate = rgc.init_compression(rcfg, jax.tree.map(jnp.asarray, grads),
                                  jax.random.PRNGKey(key))
    tstate = interop.compression_state_from_numpy(
        tcfg, tr.map_leaves(_t, grads), _ref_draws(rstate))
    return rcfg, tcfg, rstate, tstate


def _int_grads(rng, shapes):
    return {name: rng.integers(-9, 10, shape).astype(np.float32)
            for name, shape in shapes.items()}


def _check_leaf_tables_and_selection(rstate, tstate, grads, exact=True):
    rcomp = dict((tuple(k.key for k in p), c) for p, c in
                 jax.tree_util.tree_flatten_with_path(
                     rstate.compressors,
                     is_leaf=lambda x: isinstance(x, rgc.LeafCompressor))[0])
    for path, tcomp in tr.flatten(tstate.compressors):
        if tcomp is None:
            continue
        rc = rcomp[path]
        plan = rc.plan
        assert tcomp.plan.k == plan.k and tcomp.plan.beam == plan.beam
        vals = dict(tr.flatten(grads))[path].reshape(-1)
        zeros_r = tuple(jnp.zeros((s.width, s.table_size), jnp.float32)
                        for s in plan.hspec.levels)
        zeros_t = tuple(torch.zeros((s.width, s.table_size)) for s in plan.hspec.levels)
        rtab = R_FOLD(plan.hspec, rc.params, zeros_r, rc.coords, jnp.asarray(vals))
        ttab = tcs.hier_fold_tables(tcomp.plan.hspec, tcomp.params, zeros_t,
                                    tcomp.coords, _t(vals))
        for a, b in zip(ttab, rtab):
            if exact:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            else:
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                           atol=1e-5 * float(np.abs(b).max()))
        if exact:
            np.testing.assert_array_equal(
                tgc._descend_topk(tcomp.plan, tcomp.params, ttab).numpy(),
                np.asarray(R_DESCEND(plan, rc.params, rtab)))


def _check_steps_exact(rcfg, tcfg, rstate, tstate, grads, steps=2):
    for _ in range(steps):
        rout, rstate, rmet = R_COMPRESS(rcfg, jax.tree.map(jnp.asarray, grads), rstate)
        tout, tstate, tmet = tgc.compress_decompress(tcfg, tr.map_leaves(_t, grads),
                                                     tstate)
        for (path, got), want in zip(tr.flatten(tout), jax.tree.leaves(rout)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), str(path))
        rres = dict((tuple(k.key for k in p), r) for p, r in
                    jax.tree_util.tree_flatten_with_path(rstate.residual)[0])
        for path, got in tr.flatten(tstate.residual):
            if got is None:
                assert path not in rres
            else:
                np.testing.assert_array_equal(got.numpy(), np.asarray(rres[path]))
        np.testing.assert_allclose(float(tmet["compress_rel_err"]),
                                   float(rmet["compress_rel_err"]), rtol=1e-6)
    return tout


def test_compression_exact_on_integer_gradients():
    rng = np.random.default_rng(0)
    grads = _int_grads(rng, {"w": (32, 32), "b": (8,), "blocks": (2, 48, 40)})
    grads["blocks"] = {"u": grads.pop("blocks"), "v": rng.integers(
        -3, 4, (300,)).astype(np.float32)}
    rcfg, tcfg, rstate, tstate = _compressors(
        dict(width=5, ratio=4.0, min_size=256), grads)
    assert [p for p, c in tr.flatten(tstate.compressors) if c is not None] == \
        [("blocks", "u"), ("blocks", "v"), ("w",)]
    _check_leaf_tables_and_selection(rstate, tstate, grads)
    _check_steps_exact(rcfg, tcfg, rstate, tstate, grads)


def test_compression_beam_descent_exact_on_integer_gradients():
    """A row-resolving split (beam < rows): the level-0 query and its top-k
    over rows, then the beam's grid."""
    rng = np.random.default_rng(8)
    g = rng.integers(-2, 3, (1024, 64)).astype(np.float32)
    hot = rng.choice(1024 * 64, 12, replace=False)
    g.reshape(-1)[hot] += rng.choice([-80.0, 80.0], 12).astype(np.float32)
    grads = {"w": g}
    rcfg, tcfg, rstate, tstate = _compressors(
        dict(width=5, ratio=2.0, min_size=256, beta_rows_cols=256.0, k=24), grads)
    plan = tstate.compressors["w"].plan
    assert plan.beam < plan.rows
    _check_leaf_tables_and_selection(rstate, tstate, grads)
    _check_steps_exact(rcfg, tcfg, rstate, tstate, grads)


def test_compression_ties_select_the_reference_coordinates():
    """64 coordinates share the k-th magnitude (and the rest tie at 0): the
    stable top-k picks exactly the reference's k."""
    g = np.zeros((32, 32), np.float32)
    g.reshape(-1)[:64] = 3.0
    grads = {"w": g}
    rcfg, tcfg, rstate, tstate = _compressors(
        dict(width=5, ratio=4.0, min_size=256, k=8), grads)
    _check_leaf_tables_and_selection(rstate, tstate, grads)
    out = _check_steps_exact(rcfg, tcfg, rstate, tstate, grads, steps=3)
    assert int((out["w"] != 0).sum()) == 8


def test_compression_tables_on_gaussian_gradients():
    rng = np.random.default_rng(7)
    grads = {"w": rng.standard_normal((64, 48)).astype(np.float32),
             "v": rng.standard_normal((4, 40, 32)).astype(np.float32)}
    _, _, rstate, tstate = _compressors(dict(width=3, ratio=4.0, min_size=256), grads)
    _check_leaf_tables_and_selection(rstate, tstate, grads, exact=False)


@pytest.mark.parametrize("cfg_kw", [{}, dict(width=5, ratio=8.0, beta_rows_cols=4.0)])
@pytest.mark.parametrize("arch", rconfigs.ARCHS)
def test_leaf_plans_and_ratio_match_reference_at_full_size(arch, cfg_kw):
    """Every leaf's plan, the MoE experts' [n_blocks, E, d, f] included."""
    rcfg = rgc.CompressionConfig(enabled=True, **cfg_kw)
    tcfg = tgc.CompressionConfig(enabled=True, **cfg_kw)
    want = jax.eval_shape(lambda: rtfm.init_params(rconfigs.get_config(arch),
                                                   jax.random.PRNGKey(0)))
    got = ttfm.init_params(tconfigs.get_config(arch), None, device="meta")
    for (path, leaf), ref in zip(tr.flatten(got), jax.tree.leaves(want)):
        a, b = tgc._leaf_plan(tcfg, tuple(leaf.shape)), rgc._leaf_plan(rcfg, ref.shape)
        assert (a.shape, a.rows, a.cols, a.k, a.beam) == \
            (b.shape, b.rows, b.cols, b.k, b.beam), path
        for la, lb in zip(a.hspec.levels, b.hspec.levels):
            assert (la.schema.domains, la.partition, la.ranges, la.width) == \
                (lb.schema.domains, lb.partition, lb.ranges, lb.width), path
    assert tgc.compression_ratio(tcfg, got) == rgc.compression_ratio(rcfg, want)


def test_starcoder2_two_layer_plan():
    """The card's training phase: starcoder2-7b at full width, 2 layers."""
    cfg = dataclasses.replace(tconfigs.get_config("starcoder2-7b"), n_layers=2)
    params = ttfm.init_params(cfg, None, device="meta")
    ccfg = tgc.CompressionConfig(enabled=True)
    assert ttfm.param_count(params) == 887_207_936
    assert len(tr.leaves(params)) == 20
    assert sum(p.numel() >= ccfg.min_size for p in tr.leaves(params)) == 9
    assert round(tgc.compression_ratio(ccfg, params), 2) == 6.86


def test_compression_refusals_name_their_items():
    """``axis_name`` was refused until the data-parallel compressor was
    ported; it now runs over replicas stacked on a leading axis, and two
    identical replicas reproduce the single-device result bit for bit."""
    one = tgc.CompressionConfig(enabled=True, min_size=4)
    dp = dataclasses.replace(one, axis_name="dp")
    rng = np.random.default_rng(3)
    grads = {"w": _t(rng.integers(-9, 10, (8, 8)).astype(np.float32)),
             "b": _t(rng.standard_normal(2).astype(np.float32))}
    state = tgc.init_compression(one, grads, torch.Generator().manual_seed(0))
    out1, st1, _ = tgc.compress_decompress(one, grads, state)
    out2, st2, met = tgc.compress_decompress(
        dp, tr.map_leaves(lambda x: torch.stack([x, x]), grads), tgc.replicate_state(state, 2))
    for rep in range(2):
        assert torch.equal(out2["w"][rep], out1["w"])
        assert torch.equal(st2.residual["w"][rep], st1.residual["w"])
        assert torch.equal(out2["b"][rep], grads["b"])
    assert met["compress_rel_err"].shape == (2,)


def test_dp_compressor_matches_reference_pmap_leg(tmp_path):
    """The reference's 2-device ``pmap`` leg (tests/test_training.py's
    test_compression_dp_tables_allreduce, run in a subprocess on two forced
    host devices) on integer-valued gradients, where every table, mean and
    selection is exact: the port's replicas equal it bit for bit, for
    identical replicas and for replicas fed different gradients."""
    import os
    import subprocess
    import sys
    import textwrap

    code = f"""
        import jax, jax.numpy as jnp, numpy as np
        from repro.training import grad_compression as gc
        cfg1 = gc.CompressionConfig(enabled=True, width=5, ratio=4.0, min_size=256)
        cfg2 = gc.CompressionConfig(enabled=True, width=5, ratio=4.0, min_size=256,
                                    axis_name="dp")
        rng = np.random.default_rng(0)
        g = rng.integers(-9, 10, (32, 32)).astype(np.float32)
        b = rng.integers(-9, 10, 8).astype(np.float32)
        grads = {{"w": jnp.asarray(g), "b": jnp.asarray(b)}}
        state = gc.init_compression(cfg1, grads, jax.random.PRNGKey(0))
        out1, st1, _ = gc.compress_decompress(cfg1, grads, state)
        step = jax.pmap(lambda g, s: gc.compress_decompress(cfg2, g, s), axis_name="dp")
        s2 = jax.tree.map(lambda x: jnp.stack([x, x]), state)
        out2, st2, _ = step(jax.tree.map(lambda x: jnp.stack([x, x]), grads), s2)
        outA, stA, _ = step(jax.tree.map(lambda x: jnp.stack([x, jnp.zeros_like(x)]), grads), s2)
        c = state.compressors["w"].params
        np.savez({str(tmp_path / "ref.npz")!r}, g=g, b=b, w1=np.asarray(out1["w"]),
                 w2=np.asarray(out2["w"]), r2=np.asarray(st2.residual["w"]),
                 b2=np.asarray(out2["b"]), wA=np.asarray(outA["w"]),
                 rA=np.asarray(stA.residual["w"]), bA=np.asarray(outA["b"]),
                 q=np.asarray(c.base.q), r=np.asarray(c.base.r),
                 sq=np.asarray(c.sign_q), sr=np.asarray(c.sign_r))
        print("DP OK")
    """
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["JAX_PLATFORMS"] = "cpu"
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0 and "DP OK" in out.stdout, out.stderr[-4000:]
    ref = np.load(tmp_path / "ref.npz")
    dp = tgc.CompressionConfig(enabled=True, width=5, ratio=4.0, min_size=256,
                               axis_name="dp")
    grads = {"w": _t(ref["g"]), "b": _t(ref["b"])}
    state = interop.compression_state_from_numpy(
        dataclasses.replace(dp, axis_name=None), grads,
        {("w",): (ref["q"], ref["r"], ref["sq"], ref["sr"])})
    s2 = tgc.replicate_state(state, 2)
    for lo, (w, r, b) in (("2", ("w2", "r2", "b2")), ("A", ("wA", "rA", "bA"))):
        second = (lambda x: x) if lo == "2" else torch.zeros_like
        stacked = tr.map_leaves(lambda x: torch.stack([x, second(x)]), grads)
        got, st, _ = tgc.compress_decompress(dp, stacked, s2)
        assert torch.equal(got["w"][0], got["w"][1]), "replicas diverged"
        np.testing.assert_array_equal(got["w"].numpy(), ref[w])
        np.testing.assert_array_equal(st.residual["w"].numpy(), ref[r])
        np.testing.assert_array_equal(got["b"].numpy(), ref[b])
    np.testing.assert_array_equal(ref["w2"][0], ref["w1"])


# --------------------------------------------------------------------------
# train step and loop
# --------------------------------------------------------------------------

def _train_cfgs(**kw):
    opt_kw = kw.pop("optimizer", {})
    comp_kw = kw.pop("compression", {})
    return (rtl.TrainConfig(optimizer=ropt.OptimizerConfig(**opt_kw),
                            compression=rgc.CompressionConfig(**comp_kw), **kw),
            ttl.TrainConfig(optimizer=topt.OptimizerConfig(**opt_kw),
                            compression=tgc.CompressionConfig(**comp_kw), **kw))


def _train_states(rc, tc, rtcfg, ttcfg, key=0):
    rstate = rtl.init_train_state(rc, rtcfg, jax.random.PRNGKey(key))
    draws = _ref_draws(rstate["compression"]) if rtcfg.compression.enabled else None
    qr = ((np.asarray(rstate["sketch_params"].q), np.asarray(rstate["sketch_params"].r))
          if rtcfg.sketch_enabled else None)
    tstate = interop.train_state_from_numpy(tc, ttcfg, _np_tree(rstate["params"]),
                                            qr, draws, device="cpu")
    return rstate, tstate


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_float32_matches_reference(microbatches):
    rc = dataclasses.replace(rconfigs.get_reduced("starcoder2-7b"), dtype="float32")
    tc = dataclasses.replace(tconfigs.get_reduced("starcoder2-7b"), dtype="float32")
    # eps 1e-3: at Adam's first step the update is g / (|g| + eps), so with
    # the default 1e-8 a gradient entry of magnitude ~1e-8 would have its
    # update set by its last bits; the moments still compare the gradients
    rtcfg, ttcfg = _train_cfgs(optimizer=dict(lr=1e-3, warmup_steps=0, eps=1e-3),
                               microbatches=microbatches)
    rstate, tstate = _train_states(rc, tc, rtcfg, ttcfg)
    batch = rtl.synthetic_batches(rc, 4, 24)(0)
    rnew, rmet = jax.jit(rtl.make_train_step(rc, rtcfg))(
        rstate, {"tokens": jnp.asarray(batch["tokens"])})
    tnew, tmet = ttl.make_train_step(tc, ttcfg)(tstate, {"tokens": _t(batch["tokens"])})
    assert sorted(tmet) == sorted(rmet)
    for k in rmet:
        _f32_close(float(tmet[k]), float(rmet[k]))
    for (path, got), want in zip(tr.flatten(tnew["params"]),
                                 jax.tree.leaves(rnew["params"])):
        _f32_close(got.numpy(), want)
    for (path, got), want in zip(tr.flatten(tnew["opt"]["m"]),
                                 jax.tree.leaves(rnew["opt"]["m"])):
        _f32_close(got.numpy(), want)
    np.testing.assert_array_equal(tnew["sketch_table"].numpy(),
                                  np.asarray(rnew["sketch_table"]))
    # the step is pure: the input state is unchanged
    assert int(tstate["sketch_table"].sum()) == 0
    assert int(tstate["opt"]["step"]) == 0


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "mamba2-130m"])
def test_train_step_float32_matches_reference_moe_and_ssm(arch):
    """One step of the MoE and SSM families with the n-gram sketch and
    gradient compression on: loss, lb_loss and every updated param and
    moment (the experts' leaves compressed by shape)."""
    rc = dataclasses.replace(rconfigs.get_reduced(arch), dtype="float32")
    tc = dataclasses.replace(tconfigs.get_reduced(arch), dtype="float32")
    rtcfg, ttcfg = _train_cfgs(optimizer=dict(lr=1e-3, warmup_steps=0, eps=1e-3),
                               compression=dict(enabled=True, min_size=4096))
    rstate, tstate = _train_states(rc, tc, rtcfg, ttcfg)
    batch = rtl.synthetic_batches(rc, 4, 24)(0)
    rnew, rmet = jax.jit(rtl.make_train_step(rc, rtcfg))(
        rstate, {"tokens": jnp.asarray(batch["tokens"])})
    tnew, tmet = ttl.make_train_step(tc, ttcfg)(tstate, {"tokens": _t(batch["tokens"])})
    assert sorted(tmet) == sorted(rmet)
    assert (float(tmet["lb_loss"]) > 0) == bool(tc.n_experts)
    for k in ("loss", "ce", "lb_loss", "dropped_frac", "grad_norm"):
        _f32_close(float(tmet[k]), float(rmet[k]))
    comps = [p for p, c in tr.flatten(tstate["compression"].compressors) if c is not None]
    if tc.n_experts:
        assert ("blocks", "layer_0", "moe", "w_in") in comps
    for tree in ("params", "m"):
        got = tnew["params"] if tree == "params" else tnew["opt"]["m"]
        want = rnew["params"] if tree == "params" else rnew["opt"]["m"]
        for (path, g), w in zip(tr.flatten(got), jax.tree.leaves(want)):
            _f32_close(g.numpy(), w)
    np.testing.assert_array_equal(tnew["sketch_table"].numpy(),
                                  np.asarray(rnew["sketch_table"]))


def test_microbatching_matches_single_batch():
    tc = dataclasses.replace(tconfigs.get_reduced("starcoder2-7b"), dtype="float32")
    _, base = _train_cfgs(optimizer=dict(lr=0.0, clip_norm=1e9, weight_decay=0.0),
                          sketch_enabled=False)
    micro = dataclasses.replace(base, microbatches=2)
    state = ttl.init_train_state(tc, base, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, tc.vocab_size, (4, 32)).astype(np.int32))
    _, m1 = ttl.make_train_step(tc, base)(state, {"tokens": tokens})
    _, m2 = ttl.make_train_step(tc, micro)(state, {"tokens": tokens})
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m2["grad_norm"]), float(m1["grad_norm"]), rtol=1e-4)
    with pytest.raises(ValueError, match="microbatches"):
        ttl.make_train_step(tc, dataclasses.replace(base, microbatches=3))(
            state, {"tokens": tokens})


def test_train_loop_descends_and_ngram_table_equals_reference():
    """Mirrors tests/test_training.py's loop test: gemma-7b reduced, 12
    steps of 4 x 32 tokens; the in-step bigram table equals the
    reference's exactly."""
    rc, tc = rconfigs.get_reduced("gemma-7b"), tconfigs.get_reduced("gemma-7b")
    rtcfg, ttcfg = _train_cfgs(optimizer=dict(lr=2e-3, total_steps=40))
    rstate, tstate = _train_states(rc, tc, rtcfg, ttcfg)
    rfinal, _ = rtl.train(rc, rtcfg, num_steps=12, batch=4, seq=32,
                          key=jax.random.PRNGKey(0))
    tfinal, hist = ttl.train(tc, ttcfg, num_steps=12, batch=4, seq=32, key=tstate,
                             log_every=1)
    assert len(hist["loss"]) == len(hist["step_time_s"]) == 12
    assert hist["loss"][-1] < hist["loss"][0]
    tbl = tfinal["sketch_table"].numpy()
    np.testing.assert_array_equal(tbl, np.asarray(rfinal["sketch_table"]))
    assert (tbl.sum(axis=1) == 12 * 4 * 31).all()


def test_ngram_items_match_reference():
    tokens = np.random.default_rng(2).integers(0, 500, (3, 9)).astype(np.int32)
    for n in (1, 2, 3):
        want = np.asarray(rngram.ngram_items(jnp.asarray(tokens), n))
        np.testing.assert_array_equal(tngram.ngram_items(_t(tokens), n).numpy(), want)
        np.testing.assert_array_equal(tngram.ngram_items_np(tokens, n),
                                      rngram.ngram_items_np(tokens, n))
    experts = np.random.default_rng(3).integers(0, 8, (27, 2)).astype(np.int32)
    np.testing.assert_array_equal(
        tngram.moe_routing_items(_t(tokens.reshape(-1)), _t(experts), 16).numpy(),
        np.asarray(rngram.moe_routing_items(jnp.asarray(tokens.reshape(-1)),
                                            jnp.asarray(experts), 16)))
    assert tngram.ngram_schema(500, 2) == tngram.ngram_schema(500, 2)
    assert tngram.routing_schema(8).domains == rngram.routing_schema(8).domains
    with pytest.raises(ValueError, match="sequence length"):
        tngram.ngram_items(_t(tokens), 10)


def test_synthetic_batches_and_sketch_spec_match_reference():
    for arch in ("gemma-7b", "internvl2-26b"):
        rc, tc = rconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
        want, got = rtl.synthetic_batches(rc, 3, 16, seed=4)(5), \
            ttl.synthetic_batches(tc, 3, 16, seed=4)(5)
        assert sorted(want) == sorted(got)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        a, b = ttl.make_sketch_spec(tc), rtl.make_sketch_spec(rc)
        assert (a.schema.domains, a.partition, a.ranges, a.width) == \
            (b.schema.domains, b.partition, b.ranges, b.width)


def test_training_refusals_name_their_items(tmp_path):
    """``ckpt_dir`` was refused until checkpoint/restart was ported; it now
    runs (and writes the checkpoint).  The model families of ROADMAP item
    15 were refused until they were ported; they now initialise too."""
    tc = tconfigs.get_reduced("gemma-7b")
    _, ttcfg = _train_cfgs()
    ttl.train(tc, ttcfg, 1, 2, 8, torch.Generator(), ckpt_dir=str(tmp_path), device="cpu")
    assert tckpt.latest_step(str(tmp_path)) == 1
    state = ttl.init_train_state(tconfigs.get_reduced("mixtral-8x22b"), ttcfg,
                                 torch.Generator(), "cpu")
    assert state["params"]["blocks"]["layer_0"]["moe"]["w_in"].shape == (2, 4, 64, 128)


def _leaves_equal(a, b):
    fa, fb = tckpt.flatten_with_paths(a), tckpt.flatten_with_paths(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        assert type(x) is type(y), path
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), path
        else:
            np.testing.assert_array_equal(x, y, err_msg=path)


def test_train_ckpt_restart_equals_uninterrupted(tmp_path, monkeypatch):
    """gemma-7b reduced in bfloat16 with compression (every matrix a
    compressed leaf) and the bigram sketch: 4 steps uninterrupted, 2 + 2
    across a restart from the checkpoint, and 4 with a step that fails once
    and is replayed from the last checkpoint, all end bit for bit alike."""
    tc = tconfigs.get_reduced("gemma-7b")
    _, ttcfg = _train_cfgs(optimizer=dict(lr=2e-3), compression=dict(enabled=True,
                                                                      min_size=1024))

    def gen():
        return torch.Generator().manual_seed(0)

    whole, _ = ttl.train(tc, ttcfg, 4, 2, 16, gen(), ckpt_dir=str(tmp_path / "a"),
                         save_every=2, device="cpu")
    plain, _ = ttl.train(tc, ttcfg, 4, 2, 16, gen(), device="cpu")
    _leaves_equal(whole, plain)
    assert any(p.dtype == torch.bfloat16 for p in tr.leaves(whole["params"]))
    ttl.train(tc, ttcfg, 2, 2, 16, gen(), ckpt_dir=str(tmp_path / "b"), save_every=2,
              device="cpu")
    resumed, _ = ttl.train(tc, ttcfg, 2, 2, 16, gen(), ckpt_dir=str(tmp_path / "b"),
                           save_every=2, device="cpu")
    assert tckpt.latest_step(str(tmp_path / "b")) == 4
    _leaves_equal(whole, resumed)

    real = ttl.make_train_step
    calls = {"n": 0}

    def flaky(cfg, tcfg):
        step = real(cfg, tcfg)

        def run(state, batch):
            calls["n"] += 1
            if calls["n"] == 4:
                raise RuntimeError("injected device loss")
            return step(state, batch)
        return run

    monkeypatch.setattr(ttl, "make_train_step", flaky)
    failed, _ = ttl.train(tc, ttcfg, 4, 2, 16, gen(), ckpt_dir=str(tmp_path / "c"),
                          save_every=2, device="cpu")
    assert calls["n"] == 6          # steps 0-2, the failure, then 2 and 3 again
    _leaves_equal(whole, failed)


def _table_steps():
    """A step loop whose state is a flat sketch table: step i folds block i
    (data keyed by the step number, so a replay folds the same blocks)."""
    from repro_torch.core import sketch as tsk
    from repro_torch.core.hashing import KeySchema
    from repro_torch.kernels.ops import KernelSketch

    rng = np.random.default_rng(1)
    spec = tsk.mod_sketch_spec(KeySchema((100, 200)), [(0,), (1,)], (32, 32), 4)
    ks = KernelSketch(spec, torch.Generator().manual_seed(0), block_b=64, device="cpu")
    blocks = [(rng.integers(0, 100, (50, 2)).astype(np.uint32),
               rng.integers(1, 5, 50).astype(np.int64)) for _ in range(12)]

    def step_fn(i, state):
        ks.table = state["table"].clone()
        ks.update(*blocks[i % len(blocks)])
        return {"table": ks.table, "step_no": np.asarray(i + 1)}

    return step_fn, lambda: {"table": torch.zeros_like(ks.table), "step_no": np.asarray(0)}


def test_supervisor_restart_replay_backoff_and_budget(tmp_path):
    import time

    step_fn, init = _table_steps()
    _, want = tft.Supervisor(str(tmp_path / "ref"), save_every=3).run(init(), step_fn, 0, 12)
    boom = {"armed": True}

    def flaky(i, state):
        if i == 5 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected device loss")
        return step_fn(i, state)

    sup = tft.Supervisor(str(tmp_path / "ck"), save_every=3)
    step, got = sup.run(init(), flaky, 0, 12)
    assert step == 12 and sup.restarts == 1 and int(got["step_no"]) == 12
    assert torch.equal(got["table"], want["table"])

    def always(i, state):
        raise RuntimeError("persistent failure")

    sup = tft.Supervisor(str(tmp_path / "bad"), save_every=3, max_restarts=2)
    with pytest.raises(RuntimeError, match="max_restarts"):
        sup.run(init(), always, 0, 12)
    assert sup.restarts == 3
    left = {"n": 2}

    def twice(i, state):
        if left["n"]:
            left["n"] -= 1
            raise RuntimeError("injected")
        return step_fn(i, state)

    sup = tft.Supervisor(str(tmp_path / "slow"), save_every=100, max_restarts=3,
                         restart_backoff=0.05, async_save=False)
    t0 = time.perf_counter()
    sup.run(init(), twice, 0, 3)
    assert time.perf_counter() - t0 >= 0.15 and sup.restarts == 2


def test_straggler_monitor_flags_and_recovers():
    mon = tft.StragglerMonitor(threshold=2.0, ewma=0.5)
    for step in range(3):
        mon.record(step, {h: 0.010 for h in range(4)})
    assert mon.reports[-1].stragglers == []
    for step in range(3, 8):
        times = {h: 0.010 for h in range(4)}
        times[2] = 0.100
        rep = mon.record(step, times)
    assert rep.stragglers == [2]
    for step in range(8, 20):
        rep = mon.record(step, {h: 0.010 for h in range(4)})
    assert rep.stragglers == []


def test_flatten_keeps_no_leaf_alive():
    """``tree.flatten`` leaves no reference cycle: a flattened tree's leaves
    are freed by reference counting once nothing refers to them, without
    Python's cyclic collector (a self-referencing closure once kept a train
    step's params, gradients and moments alive until it ran)."""
    import gc
    import weakref

    gc.disable()
    try:
        leaf = torch.zeros(3)
        ref = weakref.ref(leaf)
        pairs = tr.flatten({"b": {"c": leaf}, "a": None})
        assert [path for path, _ in pairs] == [("a",), ("b", "c")]
        del pairs, leaf
        assert ref() is None
    finally:
        gc.enable()


def test_train_steps_leave_no_cyclic_garbage():
    """Two train steps (compression and the n-gram sketch on) create no
    reference cycles, so every step's tensors are freed as soon as the next
    step no longer needs them."""
    import gc

    cfg = tconfigs.get_reduced("starcoder2-7b")
    tcfg = ttl.TrainConfig(optimizer=topt.OptimizerConfig(lr=1e-3, warmup_steps=0),
                           compression=tgc.CompressionConfig(enabled=True))
    state = ttl.init_train_state(cfg, tcfg, torch.Generator().manual_seed(0), "cpu")
    gc.collect()
    gc.disable()
    try:
        state, _ = ttl.train(cfg, tcfg, 2, 2, 64, state)
        assert gc.collect() == 0
    finally:
        gc.enable()
