"""The port's decode path and the MoE/SSM layers against the JAX reference,
on the CPU: cross attention, single-token attention against a KV cache,
the Mamba2 mixer (chunked scan, returned state, O(1) decode), the MoE FFN
(dropless and dropping dispatch, per-group capacity), the stacked decode
cache, and ``prefill`` followed by ``decode_step`` for six families.

Each part is held against the reference's own function on the same numpy
inputs (weights from the reference's init where a whole model runs).
float32 tolerance: rtol 1e-5, atol 1e-6 times the output's scale (max
|value|, at least 1), as tests/test_torch_models.py, with the atol scaled
by depth for the 8-layer reduced jamba; integer outputs (expert choices,
dropped fractions, cache shapes) exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import attention as rattn
from repro.models import moe as rmoe
from repro.models import ssm as rssm
from repro.models import transformer as rtfm
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch import tree as tr
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttfm

DECODE_ARCHS = ["gemma2-9b", "command-r-35b", "seamless-m4t-medium", "mamba2-130m",
                "mixtral-8x22b", "jamba-1.5-large-398b"]


def _configs(arch, **kw):
    return (dataclasses.replace(rconfigs.get_reduced(arch), dtype="float32", **kw),
            dataclasses.replace(tconfigs.get_reduced(arch), dtype="float32", **kw))


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _f32_close(got, want, layers=2):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=1e-5,
                               atol=1e-6 * max(1.0, layers / 2) * scale)


def _rand_params(p, rng, names=(), scale=0.1):
    """The reference's params with ``names`` (zero- or one-initialised
    leaves) replaced by random values, so that they matter."""
    p = _np(p)
    for name in names:
        p[name] = (rng.standard_normal(p[name].shape) * scale).astype(np.float32)
    return p, {k: _t(v) for k, v in p.items()}


# --------------------------------------------------------------------------
# attention: cross attention, decode against a KV cache
# --------------------------------------------------------------------------

def _attn_case(n_kv=2, **kw):
    rc = rconfigs.base.ModelConfig(name="t", family="dense", n_layers=1, d_model=64,
                                   n_heads=4, n_kv_heads=n_kv, d_ff=128, vocab_size=64,
                                   dtype="float32", use_bias=True, **kw)
    tc = tconfigs.base.ModelConfig(**dataclasses.asdict(rc))
    rng = np.random.default_rng(n_kv)
    p, tp = _rand_params(rattn.make_attn_params(rc, jax.random.PRNGKey(n_kv)), rng,
                         ("bq", "bk", "bv", "bo"))
    return rc, tc, p, tp, rng


@pytest.mark.parametrize("n_kv", [4, 2, 1])
def test_cross_attention_matches_reference(n_kv):
    rc, tc, p, tp, rng = _attn_case(n_kv)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    enc = rng.standard_normal((2, 11, 64)).astype(np.float32)
    want = rattn.cross_attention(rc, p, jnp.asarray(x), jnp.asarray(enc))
    got = tattn.cross_attention(tc, tp, _t(x), _t(enc))
    assert tuple(got.shape) == (2, 7, 64)
    _f32_close(got.numpy(), want)


@pytest.mark.parametrize("window,positions", [(0, (0, 5, 15)), (4, (3, 9, 15)),
                                              (0, (16, 21)), (4, (17, 30))])
def test_decode_self_attention_matches_reference(window, positions):
    """One token at a time against a 16-slot cache holding 16 random
    positions; positions 16 and beyond write the last slot (the reference's
    ``dynamic_update_slice`` clamps the start), and the updated caches must
    equal the reference's."""
    rc, tc, p, tp, rng = _attn_case(2, attn_softcap=30.0)
    cache = {k: rng.standard_normal((2, 16, 2, 16)).astype(np.float32) for k in "kv"}
    rcache = {k: jnp.asarray(v) for k, v in cache.items()}
    tcache = {k: _t(v) for k, v in cache.items()}
    for pos in positions:
        x = rng.standard_normal((2, 1, 64)).astype(np.float32)
        want, rcache = rattn.decode_self_attention(rc, p, rcache, jnp.asarray(x),
                                                   jnp.int32(pos), window)
        got, out_cache = tattn.decode_self_attention(tc, tp, tcache, _t(x), pos, window)
        assert out_cache is tcache, "the port writes the cache in place"
        _f32_close(got.numpy(), want)
        for k in "kv":
            _f32_close(tcache[k].numpy(), rcache[k])


def test_scatter_time_clamps_like_dynamic_update_slice():
    cache = np.zeros((2, 5, 3), np.float32)
    for pos in (-2, 0, 3, 4, 5, 9):
        new = np.full((2, 1, 3), pos + 100, np.float32)
        want = rattn._scatter_time(jnp.asarray(cache), jnp.asarray(new), jnp.int32(pos))
        got = _t(cache)
        tattn._scatter_time(got, _t(new), pos)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# the Mamba2 mixer
# --------------------------------------------------------------------------

def _ssm_case(arch="mamba2-130m", seed=0):
    rc, tc = _configs(arch)
    rng = np.random.default_rng(seed)
    p, tp = _rand_params(rssm.make_ssm_params(rc, jax.random.PRNGKey(seed)), rng,
                         ("dt_bias", "conv_b"))
    return rc, tc, p, tp, rng


@pytest.mark.parametrize("arch,s", [("mamba2-130m", 2), ("mamba2-130m", 16),
                                    ("mamba2-130m", 37), ("jamba-1.5-large-398b", 1),
                                    ("jamba-1.5-large-398b", 37)])
def test_ssm_forward_and_state_match_reference(arch, s):
    """S = 1 and 2 are shorter than ``ssm_conv - 1`` (the conv ring's tail
    starts with zeros), 16 is one chunk, 37 leaves a padded tail; with a
    nonzero initial state too."""
    rc, tc, p, tp, rng = _ssm_case(arch, s)
    u = rng.standard_normal((2, s, rc.d_model)).astype(np.float32)
    _f32_close(tssm.ssm_forward(tc, tp, _t(u)).numpy(),
               rssm.ssm_forward(rc, p, jnp.asarray(u)))
    h0 = (rng.standard_normal((2, rc.ssm_heads, rc.ssm_state, rc.ssm_head_dim))
          * 0.5).astype(np.float32)
    want, wst = rssm.ssm_forward(rc, p, jnp.asarray(u), h0=jnp.asarray(h0),
                                 return_state=True)
    got, gst = tssm.ssm_forward(tc, tp, _t(u), h0=_t(h0), return_state=True)
    _f32_close(got.numpy(), want)
    assert sorted(gst) == sorted(wst) == ["conv", "ssm"]
    assert tuple(gst["conv"].shape) == (2, rc.ssm_conv - 1, rc.ssm_inner + 2 * rc.ssm_state)
    for k in gst:
        _f32_close(gst[k].numpy(), wst[k])


def test_ssm_decode_matches_reference_from_a_prefilled_state():
    rc, tc, p, tp, rng = _ssm_case()
    u = rng.standard_normal((2, 21, rc.d_model)).astype(np.float32)
    _, rcache = rssm.ssm_forward(rc, p, jnp.asarray(u[:, :13]), return_state=True)
    tcache = interop.cache_from_numpy(_np(rcache), "cpu")
    for t in range(13, 21):
        want, rcache = rssm.ssm_decode(rc, p, rcache, jnp.asarray(u[:, t : t + 1]))
        got, out = tssm.ssm_decode(tc, tp, tcache, _t(u[:, t : t + 1]))
        assert out is tcache
        _f32_close(got.numpy(), want)
        for k in tcache:
            _f32_close(tcache[k].numpy(), rcache[k])
    # a fresh cache is the reference's
    fresh = tssm.init_ssm_cache(tc, 3, "cpu")
    for k, v in rssm.init_ssm_cache(rc, 3).items():
        assert tuple(fresh[k].shape) == v.shape and fresh[k].dtype == torch.float32


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------

def _moe_case(arch="mixtral-8x22b", **kw):
    rc, tc = _configs(arch, **kw)
    p = _np(rmoe.make_moe_params(rc, jax.random.PRNGKey(0)))
    return rc, tc, p, {k: _t(v) for k, v in p.items()}


@pytest.mark.parametrize("arch,shape,kw", [
    ("mixtral-8x22b", (2, 9, 64), {}),               # dropless, T*k = 36
    ("dbrx-132b", (2, 9, 64), {}),                   # top-4 of 16, layernorm
    ("mixtral-8x22b", (4, 600, 64), {"capacity_factor": 1.0}),  # drops
    ("mixtral-8x22b", (2, 1026, 64), {}),            # cap 1282.5 rounds to 1282
])
def test_apply_moe_matches_reference(arch, shape, kw):
    rc, tc, p, tp = _moe_case(arch, **kw)
    x = np.random.default_rng(shape[1]).standard_normal(shape).astype(np.float32)
    t = shape[0] * shape[1]
    assert tmoe.capacity(tc, t) == (
        t * tc.top_k if t * tc.top_k <= 4096
        else int(max(1, round(t * tc.top_k * tc.capacity_factor / tc.n_experts))))
    want, waux = rmoe.apply_moe(rc, p, jnp.asarray(x))
    got, gaux = tmoe.apply_moe(tc, tp, _t(x))
    _f32_close(got.numpy(), want)
    np.testing.assert_array_equal(gaux["expert_choice"].numpy(),
                                  np.asarray(waux["expert_choice"]))
    assert float(gaux["dropped_frac"]) == float(waux["dropped_frac"])
    assert (float(gaux["dropped_frac"]) > 0) == (t * tc.top_k > 4096
                                                 and "capacity_factor" in kw)
    _f32_close(float(gaux["lb_loss"]), float(waux["lb_loss"]))


def test_moe_ties_route_to_the_lower_expert():
    """A zero router gives every expert the same gate: ``jax.lax.top_k``
    picks the lowest k experts, and so must the port."""
    rc, tc, p, tp = _moe_case("dbrx-132b")
    p["router"] = np.zeros_like(p["router"])
    tp["router"].zero_()
    x = np.random.default_rng(5).standard_normal((2, 8, 64)).astype(np.float32)
    want, waux = rmoe.apply_moe(rc, p, jnp.asarray(x))
    got, gaux = tmoe.apply_moe(tc, tp, _t(x))
    assert (gaux["expert_choice"].numpy() == np.arange(tc.top_k)).all()
    np.testing.assert_array_equal(gaux["expert_choice"].numpy(),
                                  np.asarray(waux["expert_choice"]))
    _f32_close(got.numpy(), want)


@pytest.mark.parametrize("tl", [8, 2100])
def test_grouped_dispatch_matches_reference(tl):
    """Two groups, each with its own capacity (dropless at Tl = 8, the
    capacity rule at Tl = 2,100)."""
    rc, tc, p, tp = _moe_case(capacity_factor=1.0)
    rng = np.random.default_rng(tl)
    xg = rng.standard_normal((2, tl, 64)).astype(np.float32)
    eg = rng.integers(0, tc.n_experts, (2, tl, tc.top_k)).astype(np.int32)
    wg = rng.uniform(0.1, 1.0, (2, tl, tc.top_k)).astype(np.float32)
    want, waux = rmoe._grouped_dispatch(rc, p, *map(jnp.asarray, (xg, eg, wg)))
    got, gaux = tmoe._grouped_dispatch(tc, tp, _t(xg), _t(eg).long(), _t(wg))
    _f32_close(got.numpy(), want)
    assert float(gaux["dropped_frac"]) == float(waux["dropped_frac"])
    # apply_moe(groups=2) takes that dispatch over the router's choices
    x = xg.reshape(1, 2 * tl, 64)
    out, aux = tmoe.apply_moe(tc, tp, _t(x), groups=2)
    gates, weights, experts = tmoe._route(tc, tp, _t(x[0]))
    again, _ = tmoe._grouped_dispatch(tc, tp, _t(xg), experts.reshape(2, tl, -1),
                                      weights.reshape(2, tl, -1))
    assert torch.equal(out.reshape(2 * tl, 64), again)


@pytest.mark.parametrize("dispatch", ["ep_shardmap", "local"])
def test_mesh_dispatch_modes_take_the_global_path_without_a_mesh(dispatch):
    rc, tc, p, tp = _moe_case(moe_dispatch=dispatch)
    x = np.random.default_rng(2).standard_normal((2, 5, 64)).astype(np.float32)
    want, _ = rmoe.apply_moe(rc, p, jnp.asarray(x))
    got, _ = tmoe.apply_moe(tc, tp, _t(x))
    _f32_close(got.numpy(), want)


# --------------------------------------------------------------------------
# caches, prefill and decode of whole models
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", rconfigs.ARCHS)
def test_init_cache_matches_reference_shapes(arch):
    rc, tc = rconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    enc_len = 5 if rc.n_enc_layers else 0
    want = rtfm.init_cache(rc, 3, 11, enc_len=enc_len)
    got = ttfm.init_cache(tc, 3, 11, enc_len=enc_len, device="cpu")
    wflat = dict((tuple(k.key for k in path), leaf) for path, leaf in
                 jax.tree_util.tree_flatten_with_path(want)[0])
    gflat = tr.flatten(got)
    assert [path for path, _ in gflat] == sorted(wflat)
    ptrs = set()
    for path, leaf in gflat:
        assert tuple(leaf.shape) == wflat[path].shape, path
        assert str(leaf.dtype).replace("torch.", "") == str(wflat[path].dtype), path
        assert not bool(leaf.any())
        # each block's cache is its own memory (decode writes it in place)
        assert leaf.stride(0) == leaf[0].numel()
        ptrs.add(leaf.data_ptr())
    assert len(ptrs) == len(gflat)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """``prefill`` of 13 tokens into a cache of max_len positions, then 3
    ``decode_step`` calls: logits and every cache leaf equal the
    reference's after each call."""
    rc, tc = _configs(arch)
    p = _np(rtfm.init_params(rc, jax.random.PRNGKey(0)))
    tp = interop.model_params_from_numpy(tc, p, "cpu")
    rng = np.random.default_rng(3)
    tok = rng.integers(0, rc.vocab_size, (2, 16)).astype(np.int32)
    emb = None
    if rc.frontend:
        emb = (rng.standard_normal((2, rc.frontend_len, rc.d_model)) * 0.02).astype(np.float32)
    n_prefix = 0 if (rc.n_enc_layers or not rc.frontend) else rc.frontend_len
    max_len = n_prefix + 13 + 5
    r_emb = None if emb is None else jnp.asarray(emb)
    t_emb = None if emb is None else _t(emb)
    want, rcache = rtfm.prefill(rc, p, jnp.asarray(tok[:, :13]), embeds=r_emb,
                                max_len=max_len)
    got, tcache = ttfm.prefill(tc, tp, _t(tok[:, :13]), embeds=t_emb, max_len=max_len)

    def same_caches():
        wflat = [leaf for _, leaf in sorted(
            (tuple(k.key for k in path), leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(rcache)[0])]
        gflat = tr.flatten(tcache)
        assert len(wflat) == len(gflat)
        for (path, g), w in zip(gflat, wflat):
            assert tuple(g.shape) == w.shape, path
            _f32_close(g.numpy(), w, tc.n_layers)

    _f32_close(got.numpy(), want, tc.n_layers)
    same_caches()
    pos = n_prefix + 13
    for t in range(13, 16):
        want, rcache = rtfm.decode_step(rc, p, rcache, jnp.asarray(tok[:, t : t + 1]),
                                        jnp.int32(pos))
        got, out = ttfm.decode_step(tc, tp, tcache, _t(tok[:, t : t + 1]), pos)
        assert out is tcache and tuple(got.shape) == (2, 1, tc.padded_vocab)
        _f32_close(got.numpy(), want, tc.n_layers)
        same_caches()
        pos += 1


def test_decode_step_from_the_reference_cache():
    """A reference cache carried across (``interop.cache_from_numpy``) decodes
    in the port as in the reference."""
    rc, tc = _configs("jamba-1.5-large-398b")
    p = _np(rtfm.init_params(rc, jax.random.PRNGKey(1)))
    tp = interop.model_params_from_numpy(tc, p, "cpu")
    tok = np.random.default_rng(4).integers(0, rc.vocab_size, (2, 12)).astype(np.int32)
    _, rcache = rtfm.prefill(rc, p, jnp.asarray(tok[:, :11]), max_len=16)
    tcache = interop.cache_from_numpy(_np(rcache), "cpu")
    want, _ = rtfm.decode_step(rc, p, rcache, jnp.asarray(tok[:, 11:]), jnp.int32(11))
    got, _ = ttfm.decode_step(tc, tp, tcache, _t(tok[:, 11:]), 11)
    _f32_close(got.numpy(), want, tc.n_layers)
