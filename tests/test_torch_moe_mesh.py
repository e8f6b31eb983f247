"""MoE's mesh dispatches against the JAX reference, on the CPU: ``local``
(per-data-shard capacity, the group count from the active mesh) and
``ep_shardmap`` (each (data, model) position routes its data shard and
computes its F-slice of every expert, the partials summed over ``model``).

Float32 copies of the reduced mixtral-8x22b and dbrx-132b, under CPU
meshes of (4, 2) and (2, 2).  ``local`` is held against the reference's
serial ``_grouped_dispatch`` with the same G (the reference's own jitted
local-dispatch test does not run in this container); ``ep_shardmap``
against the reference's global ``apply_moe`` where every path is dropless
(T*k <= 4,096 per shard, or capacity factor E/k), and against the
reference's own ``ep_shardmap`` under ``shard_map`` on 8 forced host
devices in a subprocess.  Tolerance: rtol 1e-5, atol 1e-6 x the output's
scale (F-slices reorder the expert down-projection's float sums);
``dropped_frac`` exactly; ``lb_loss`` within rtol 1e-6.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import moe as rmoe
from repro.models import shard_ctx as rctx
from repro_torch import configs as tconfigs
from repro_torch.launch.mesh import Mesh
from repro_torch.models import moe as tmoe
from repro_torch.models import shard_ctx as tctx

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = ["mixtral-8x22b", "dbrx-132b"]
MESHES = [(4, 2), (2, 2)]


def _case(arch, **kw):
    rc = dataclasses.replace(rconfigs.get_reduced(arch), dtype="float32", **kw)
    tc = dataclasses.replace(tconfigs.get_reduced(arch), dtype="float32", **kw)
    p = {k: np.asarray(v) for k, v in rmoe.make_moe_params(rc, jax.random.PRNGKey(0)).items()}
    return rc, tc, p, {k: torch.from_numpy(v.copy()) for k, v in p.items()}


def _cpu_mesh(shape):
    return Mesh(shape, ("data", "model"), ["cpu"] * int(np.prod(shape)))


def _close(got, want):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=1e-5, atol=1e-6 * scale)


def _ref_grouped(rc, p, x, g):
    """The reference's ``apply_moe`` branch for ``groups = g``: its router,
    then its serial ``_grouped_dispatch`` (``constrain`` is a no-op outside a
    context)."""
    b, s, d = x.shape
    t, k, e = b * s, rc.top_k, rc.n_experts
    xt = jnp.asarray(x).reshape(t, d)
    logits = xt @ p["router"]
    weights, experts = jax.lax.top_k(jax.nn.softmax(logits, -1), k)
    weights = weights / jnp.sum(weights, axis=-1, keepdims=True)
    out, aux = rmoe._grouped_dispatch(
        rc, {kk: jnp.asarray(v) for kk, v in p.items()}, xt.reshape(g, t // g, d),
        experts.reshape(g, t // g, k), weights.reshape(g, t // g, k))
    me = jnp.mean(jax.nn.softmax(logits, -1), axis=0)
    ce = jnp.mean(jax.nn.one_hot(experts[:, 0], e), axis=0)
    return out.reshape(b, s, d), {**aux, "lb_loss": e * jnp.sum(me * ce),
                                  "expert_choice": experts}


@pytest.mark.parametrize("t", [64, 6, 7, 2])
@pytest.mark.parametrize("shape", MESHES + [(2, 4, 2)])
def test_dispatch_groups_equal_reference(shape, t):
    axes = ("pod", "data", "model")[-len(shape):]
    duck = types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)))
    mesh = Mesh(shape, axes, ["cpu"] * int(np.prod(shape)))
    for mode in ("local", "global", "ep_shardmap"):
        rc = dataclasses.replace(rconfigs.get_reduced("mixtral-8x22b"), moe_dispatch=mode)
        tc = dataclasses.replace(tconfigs.get_reduced("mixtral-8x22b"), moe_dispatch=mode)
        assert tmoe._dispatch_groups(tc, t) == 1
        with rctx.activation_sharding(duck), tctx.activation_sharding(mesh):
            assert tmoe._dispatch_groups(tc, t) == rmoe._dispatch_groups(rc, t)
            if mode == "local":
                g = int(np.prod(shape[:-1]))
                while g > 1 and t % g:
                    g //= 2
                assert tmoe._dispatch_groups(tc, t) == g


@pytest.mark.parametrize("kw,bs", [({}, (4, 16)),                       # dropless
                                   ({"capacity_factor": 1.0}, (4, 2200))])  # drops
@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_local_dispatch_equals_reference_grouped(arch, shape, kw, bs):
    rc, tc, p, tp = _case(arch, moe_dispatch="local", **kw)
    x = np.random.default_rng(1).standard_normal((*bs, rc.d_model)).astype(np.float32)
    g = shape[0]
    want, waux = _ref_grouped(rc, p, x, g)
    with tctx.activation_sharding(_cpu_mesh(shape)):
        got, gaux = tmoe.apply_moe(tc, tp, torch.from_numpy(x))
    _close(got.numpy(), want)
    np.testing.assert_array_equal(gaux["expert_choice"].numpy(),
                                  np.asarray(waux["expert_choice"]))
    assert float(gaux["dropped_frac"]) == float(waux["dropped_frac"])
    assert (float(gaux["dropped_frac"]) > 0) == bool(kw)
    np.testing.assert_allclose(float(gaux["lb_loss"]), float(waux["lb_loss"]), rtol=1e-6)
    # an explicit group count overrides the mesh's
    with tctx.activation_sharding(_cpu_mesh(shape)):
        one, _ = tmoe.apply_moe(tc, tp, torch.from_numpy(x), groups=1)
    plain, _ = tmoe.apply_moe(dataclasses.replace(tc, moe_dispatch="global"), tp,
                              torch.from_numpy(x))
    assert torch.equal(one, plain)


@pytest.mark.parametrize("bs,cf", [((4, 16), None),          # T*k <= 4,096 a shard
                                   ((4, 2200), "E/k")])      # the capacity rule at E/k
@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_ep_shardmap_equals_reference_global_when_dropless(arch, shape, bs, cf):
    kw = {}
    if cf:
        cfg = rconfigs.get_reduced(arch)
        kw["capacity_factor"] = cfg.n_experts / cfg.top_k
    rc, tc, p, tp = _case(arch, **kw)
    x = np.random.default_rng(2).standard_normal((*bs, rc.d_model)).astype(np.float32)
    want, waux = rmoe.apply_moe(rc, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    assert float(waux["dropped_frac"]) == 0.0
    tc_ep = dataclasses.replace(tc, moe_dispatch="ep_shardmap")
    with tctx.activation_sharding(_cpu_mesh(shape)):
        got, gaux = tmoe.apply_moe(tc_ep, tp, torch.from_numpy(x))
    _close(got.numpy(), want)
    assert float(gaux["dropped_frac"]) == 0.0
    assert gaux["expert_choice"].shape == (1, tc.top_k)
    assert gaux["expert_choice"].dtype == torch.int32 and not gaux["expert_choice"].any()
    # lb_loss: the mean over data shards of the reference's loss on each
    n_data = shape[0]
    shard_lb = [float(rmoe.apply_moe(rc, {k: jnp.asarray(v) for k, v in p.items()},
                                     jnp.asarray(xs))[1]["lb_loss"])
                for xs in np.split(x, n_data)]
    np.testing.assert_allclose(float(gaux["lb_loss"]), np.mean(shard_lb), rtol=1e-6)


def test_ep_shardmap_refuses_what_does_not_split():
    rc, tc, p, tp = _case("dbrx-132b", moe_dispatch="ep_shardmap")
    x = torch.zeros(3, 4, tc.d_model)
    with tctx.activation_sharding(_cpu_mesh((2, 2))), pytest.raises(ValueError, match="divide"):
        tmoe.apply_moe(tc, tp, x)


def test_ep_shardmap_equals_reference_shard_map(tmp_path):
    """The reference's ``ep_shardmap`` under ``shard_map`` on a (4, 2) mesh of
    8 forced host devices, in a subprocess (its own device count), against
    the port's on a (4, 2) CPU mesh."""
    out = tmp_path / "ref.npz"
    code = textwrap.dedent(f"""
        import dataclasses
        import jax, jax.numpy as jnp, numpy as np
        from repro.configs import get_reduced
        from repro.models import moe as moe_mod, shard_ctx
        mesh = jax.make_mesh((4, 2), ("data", "model"))
        res = {{}}
        for arch in {ARCHS!r}:
            cfg = dataclasses.replace(get_reduced(arch), dtype="float32",
                                      moe_dispatch="ep_shardmap")
            p = moe_mod.make_moe_params(cfg, jax.random.PRNGKey(0))
            x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, cfg.d_model), jnp.float32)
            with shard_ctx.activation_sharding(mesh):
                y, aux = jax.jit(lambda p, x: moe_mod.apply_moe(cfg, p, x))(p, x)
            for k, v in p.items():
                res[arch + "/p/" + k] = np.asarray(v)
            res[arch + "/x"] = np.asarray(x)
            res[arch + "/y"] = np.asarray(y)
            for k, v in aux.items():
                res[arch + "/aux/" + k] = np.asarray(v)
        np.savez({str(out)!r}, **res)
    """)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + env.get("PYTHONPATH", "")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    ref = np.load(out)
    for arch in ARCHS:
        tc = dataclasses.replace(tconfigs.get_reduced(arch), dtype="float32",
                                 moe_dispatch="ep_shardmap")
        p = {k.split("/")[-1]: torch.from_numpy(ref[k].copy())
             for k in ref.files if k.startswith(arch + "/p/")}
        with tctx.activation_sharding(_cpu_mesh((4, 2))):
            y, aux = tmoe.apply_moe(tc, p, torch.from_numpy(ref[arch + "/x"].copy()))
        _close(y.numpy(), ref[arch + "/y"])
        assert float(aux["dropped_frac"]) == float(ref[arch + "/aux/dropped_frac"]) == 0.0
        np.testing.assert_allclose(float(aux["lb_loss"]), float(ref[arch + "/aux/lb_loss"]),
                                   rtol=1e-6)
        np.testing.assert_array_equal(aux["expert_choice"].numpy(),
                                      ref[arch + "/aux/expert_choice"])
