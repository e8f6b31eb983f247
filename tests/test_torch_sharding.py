"""The port's sharding rules and activation-sharding context against the
JAX reference, on the CPU.

The port's ``param_specs``, ``opt_state_specs`` (adamw and adamw8bit),
``batch_specs`` and ``cache_specs`` must equal the reference's leaf by leaf,
as tuples, for all ten architectures at full width, on the production
meshes (16, 16) and (2, 16, 16) and the small (2, 2) and (4, 2), in both
``moe_weight_shard`` modes.  The reference side runs on ``jax.eval_shape``
trees and a duck-typed mesh (axis names and sizes), so no 256-device
backend is needed; the port side on meta tensors.  ``shard`` then
``unshard`` round-trips bit for bit; ``constrain`` is the identity.
"""
import dataclasses
import functools
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from repro import configs as rconfigs
from repro.models import sharding as rshd
from repro.models import transformer as rtfm
from repro.training import optimizer as ropt
from repro_torch import configs as tconfigs
from repro_torch import tree as tr
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import Mesh
from repro_torch.models import shard_ctx
from repro_torch.models import sharding as tshd
from repro_torch.models import transformer as ttfm
from repro_torch.training import optimizer as topt

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "4x2": ((4, 2), ("data", "model")),
}


def _mesh(name):
    shape, axes = MESHES[name]
    return types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)))


def _key(k) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def _ref_flat(specs):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return {"/".join(_key(k) for k in path): tuple(s) for path, s in flat}


def _port_flat(specs):
    out = {}
    for path, s in tr.flatten(specs):
        if isinstance(s, topt.Moment8):
            out["/".join(path) + "/q"] = tuple(s.q)
            out["/".join(path) + "/scale"] = tuple(s.scale)
        else:
            out["/".join(path)] = tuple(s)
    return out


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    """(reference eval_shape params, port meta params) at full width."""
    rcfg, tcfg = rconfigs.get_config(arch), tconfigs.get_config(arch)
    rparams = jax.eval_shape(lambda k: rtfm.init_params(rcfg, k), jax.random.PRNGKey(0))
    return rparams, tspecs.meta_params(tcfg)


@functools.lru_cache(maxsize=None)
def _opt_shapes(arch, name):
    rparams, tparams = _shapes(arch)
    rcfg = ropt.OptimizerConfig(name=name)
    ropt_shape = jax.eval_shape(lambda p: ropt.init_state(rcfg, p), rparams)
    return ropt_shape, topt.init_state(topt.OptimizerConfig(name=name), tparams)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_param_and_opt_specs_equal_reference(arch, mesh_name):
    mesh = _mesh(mesh_name)
    rparams, tparams = _shapes(arch)
    for mode in ("2d", "f_allaxes"):
        rcfg = dataclasses.replace(rconfigs.get_config(arch), moe_weight_shard=mode)
        tcfg = dataclasses.replace(tconfigs.get_config(arch), moe_weight_shard=mode)
        rps = rshd.param_specs(rcfg, rparams, mesh)
        tps = tshd.param_specs(tcfg, tparams, mesh)
        want = _ref_flat(rps)
        assert _port_flat(tps) == want
        if mode == "f_allaxes" and tcfg.n_experts:
            # the mode moves the expert weights' split (the test sees it)
            assert any(len(s) == 4 and isinstance(s[3], tuple) for s in want.values())
        for name in ("adamw", "adamw8bit"):
            ropt_shape, topt_shape = _opt_shapes(arch, name)
            got = _port_flat(tshd.opt_state_specs(tcfg, topt_shape, tps, mesh))
            assert got == _ref_flat(rshd.opt_state_specs(rcfg, ropt_shape, rps, mesh))
            if name == "adamw8bit":
                assert any(k.endswith("/scale") for k in got)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_batch_and_cache_specs_equal_reference(arch, mesh_name):
    mesh = _mesh(mesh_name)
    rcfg, tcfg = rconfigs.get_config(arch), tconfigs.get_config(arch)
    for emb in (False, True):
        assert _port_flat(tshd.batch_specs(tcfg, mesh, emb)) == \
            _ref_flat(rshd.batch_specs(rcfg, mesh, emb))
    enc = rcfg.frontend_len if rcfg.n_enc_layers else 0
    # a batch that fills the data axes, and one smaller (long_500k's 1)
    for batch in (128, 1):
        rcache = jax.eval_shape(lambda: rtfm.init_cache(rcfg, batch, 4096, enc_len=enc))
        tcache = ttfm.init_cache(tcfg, batch, 4096, enc_len=enc, device="meta")
        want = _ref_flat(rshd.cache_specs(rcfg, rcache, mesh, batch))
        assert _port_flat(tshd.cache_specs(tcfg, tcache, mesh, batch)) == want
    assert want  # every family has a cache


@pytest.mark.parametrize("spec,shape", [
    (("data", "model"), (32, 48)),
    (("model", ("pod", "data")), (48, 64)),
    ((("pod", "data"), None), (6, 8)),      # pod divides, pod x data does not
    ((("pod", "data", "model"), None), (1, 8)),
    ((None, "model", None), (4, 24, 8)),    # 24 % 16: dropped
    (("data",), (32, 7, 5)),                # shorter than the shape
    ((), (3,)),
])
def test_sanitize_spec_cases(spec, shape):
    mesh = _mesh("2x16x16")
    got = tshd.sanitize_spec(tshd.P(*spec), shape, mesh)
    assert isinstance(got, tshd.P) and len(got) == len(shape)
    assert tuple(got) == tuple(rshd.sanitize_spec(PartitionSpec(*spec), shape, mesh))
    for dim, entry in zip(shape, got):
        assert dim % tshd._axes_size(mesh, tshd._entry_axes(entry)) == 0


@pytest.mark.parametrize("shape,axes,spec,tshape", [
    ((2, 2), ("data", "model"), ("data", "model"), (6, 10)),
    ((2, 2), ("data", "model"), (None, ("data", "model"), None), (3, 8, 5)),
    ((2, 2, 2), ("pod", "data", "model"), (("pod", "data"), None, "model"), (8, 3, 4)),
    ((2, 2, 2), ("pod", "data", "model"), ("model",), (6, 3)),     # replicas
    ((4, 2), ("data", "model"), (), (5, 7)),                        # replicated
])
def test_shard_unshard_round_trip(shape, axes, spec, tshape):
    mesh = Mesh(shape, axes, ["cpu"] * int(np.prod(shape)))
    rng = np.random.default_rng(0)
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        t = torch.from_numpy(rng.standard_normal(tshape).astype(np.float32) * 100).to(dtype)
        shards = tshd.shard(t, tshd.P(*spec), mesh)
        assert len(shards) == mesh.size
        local = tshd.local_shape(spec, tshape, mesh)
        for coords, piece in zip(tshd.positions(mesh), shards):
            assert tuple(piece.shape) == local and piece.is_contiguous()
            # the slice is the one the coordinates name, row-major over a
            # dim's axes
            want = t
            for d, entry in enumerate(list(spec) + [None] * (len(tshape) - len(spec))):
                idx = 0
                for a in tshd._entry_axes(entry):
                    idx = idx * mesh.shape[a] + coords[a]
                want = want.narrow(d, idx * local[d], local[d])
            assert torch.equal(piece, want)
            assert piece.data_ptr() != t.data_ptr()
        back = tshd.unshard(shards, tshd.P(*spec), mesh)
        assert back.dtype == dtype and torch.equal(back, t)
        assert tshd.local_bytes({"t": tshd.P(*spec)}, {"t": t}, mesh) == \
            int(np.prod(local)) * t.element_size()


def test_shard_refuses_a_spec_that_does_not_divide():
    mesh = Mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    with pytest.raises(ValueError, match="does not split"):
        tshd.shard(torch.zeros(3, 4), tshd.P("data", None), mesh)


def test_shard_to_meta_positions_costs_no_memory():
    mesh = Mesh((2, 2), ("data", "model"), ["cpu", "meta", "meta", "meta"])
    shards = tshd.shard(torch.arange(16.0).reshape(4, 4), tshd.P("data", "model"), mesh)
    assert shards[0].device.type == "cpu" and torch.equal(shards[0], torch.tensor(
        [[0.0, 1.0], [4.0, 5.0]]))
    assert all(s.device.type == "meta" and s.shape == (2, 2) for s in shards[1:])


def test_constrain_is_the_identity_in_and_out_of_a_context():
    x = torch.randn(4, 6)
    assert shard_ctx.current_mesh() is None
    assert shard_ctx.constrain(x, shard_ctx.DP, shard_ctx.MP) is x
    outer = Mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    inner = Mesh((2, 2, 2), ("pod", "data", "model"), ["cpu"] * 8)
    with shard_ctx.activation_sharding(outer):
        assert shard_ctx.current_mesh() is outer
        assert shard_ctx.constrain(x, shard_ctx.DP, None) is x
        with shard_ctx.activation_sharding(inner):
            assert shard_ctx.current_mesh() is inner
            assert shard_ctx._state.ctx[1:] == (("pod", "data"), "model")
        assert shard_ctx.current_mesh() is outer
    assert shard_ctx.current_mesh() is None


def test_mesh_axes_wants_a_trailing_model_axis():
    with pytest.raises(ValueError, match="trailing 'model'"):
        tshd.mesh_axes(_mesh_named(("model", "data")))
    assert tshd.mesh_axes(_mesh("2x16x16")) == (("pod", "data"), "model")


def _mesh_named(axes):
    return types.SimpleNamespace(axis_names=axes, shape={a: 2 for a in axes})
