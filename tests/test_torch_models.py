"""The port's model stack (configs, layers, attention, the transformer of
every family) against the JAX reference, on the CPU.

Weights are the reference's own init, carried across as numpy by
``repro_torch.interop.model_params_from_numpy``; inputs come from numpy
with a seed.  Tolerances: float32 runs rtol 1e-5 and atol 1e-6 times the
output's scale (max |value|, at least 1): the two frameworks sum and fuse
in different orders, which leaves errors of a few 1e-6 on logits of
magnitude ~4 even where a logit itself is near 0.  bfloat16 runs rtol
2e-2 of the output's scale (torch and XLA round bf16 products at other
places).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import attention as rattn
from repro.models import layers as rlayers
from repro.models import transformer as rtfm
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch import tree as tr
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttfm

PORTED = list(rconfigs.ARCHS)


def _configs(arch, dtype="float32", **kw):
    return (dataclasses.replace(rconfigs.get_reduced(arch), dtype=dtype, **kw),
            dataclasses.replace(tconfigs.get_reduced(arch), dtype=dtype, **kw))


def _t(x):
    return torch.from_numpy(np.array(x))


def _f32_close(got, want, layers=2):
    """float32 parity; ``layers``: the stack's depth.  The reduced configs
    have 2 layers; the reduced jamba has 8 (a whole hybrid period), and its
    atol grows with depth (1e-6 x scale a pair of layers): each layer adds
    its own last-bit differences (exp, silu, the SSD scan's cumsum, which
    XLA adds in sequence and torch in double)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-6 * max(1.0, layers / 2)
                               * max(1.0, float(np.abs(want).max())))


def _bf16_close(got, want, rtol=2e-2):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("arch", rconfigs.ARCHS)
def test_configs_are_the_reference_configs(arch):
    for get in ("get_config", "get_reduced"):
        rc, tc = getattr(rconfigs, get)(arch), getattr(tconfigs, get)(arch)
        assert dataclasses.asdict(rc) == dataclasses.asdict(tc)
        assert rc.param_count() == tc.param_count()
        assert rc.block_period == tc.block_period
        for i in range(rc.n_layers):
            assert (rc.layer_kind(i), rc.layer_window(i), rc.layer_is_moe(i)) == \
                   (tc.layer_kind(i), tc.layer_window(i), tc.layer_is_moe(i))
    assert tconfigs.get_reduced(arch).activation_dtype == torch.bfloat16
    assert _configs(arch)[1].activation_dtype == torch.float32


@pytest.mark.parametrize("arch", PORTED)
def test_param_tree_matches_reference_at_full_size(arch):
    """Every leaf's path, shape and dtype, at the published widths (the
    reference by eval_shape, the port on the meta device)."""
    rc, tc = rconfigs.get_config(arch), tconfigs.get_config(arch)
    want = jax.eval_shape(lambda: rtfm.init_params(rc, jax.random.PRNGKey(0)))
    want = {tuple(k.key for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]}
    got = tr.flatten(ttfm.init_params(tc, None, device="meta"))
    assert [p for p, _ in got] == sorted(want)
    for path, leaf in got:
        assert tuple(leaf.shape) == want[path].shape, path
        assert str(leaf.dtype).replace("torch.", "") == str(want[path].dtype), path
    assert ttfm.param_count(tr.unflatten(got)) == sum(
        int(np.prod(v.shape)) for v in want.values())


def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    for norm_type in ("rmsnorm", "layernorm"):
        rc, tc = _configs("starcoder2-7b", norm_type=norm_type)
        p = {"scale": rng.standard_normal(64).astype(np.float32),
             "bias": rng.standard_normal(64).astype(np.float32)}
        _f32_close(
            tlayers.apply_norm(tc, {k: _t(v) for k, v in p.items()}, _t(x)).numpy(),
            np.asarray(rlayers.apply_norm(rc, p, jnp.asarray(x))))
    q = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = np.arange(7)
    for theta in (10_000.0, 100_000.0):
        _f32_close(
            tlayers.apply_rope(_t(q), _t(pos), theta).numpy(),
            np.asarray(rlayers.apply_rope(jnp.asarray(q), jnp.asarray(pos), theta)))
    for mlp_type in ("swiglu", "geglu", "gelu"):
        rc, tc = _configs("starcoder2-7b", mlp_type=mlp_type)
        p = {"w_gate": rng.standard_normal((64, 96)).astype(np.float32) * 0.1,
             "w_in": rng.standard_normal((64, 96)).astype(np.float32) * 0.1,
             "w_out": rng.standard_normal((96, 64)).astype(np.float32) * 0.1,
             "b_in": rng.standard_normal(96).astype(np.float32),
             "b_out": rng.standard_normal(64).astype(np.float32)}
        _f32_close(
            tlayers.apply_mlp(tc, {k: _t(v) for k, v in p.items()}, _t(x)).numpy(),
            np.asarray(rlayers.apply_mlp(rc, p, jnp.asarray(x))))
    big = (x * 40).astype(np.float32)
    _f32_close(tlayers.softcap(_t(big), 30.0).numpy(),
                               np.asarray(rlayers.softcap(jnp.asarray(big), 30.0)))


def _attn_case(n_kv, window, **kw):
    rc = rconfigs.base.ModelConfig(name="t", family="dense", n_layers=1, d_model=64,
                                   n_heads=4, n_kv_heads=n_kv, d_ff=128,
                                   vocab_size=64, dtype="float32", use_bias=True, **kw)
    tc = tconfigs.base.ModelConfig(**dataclasses.asdict(rc))
    p = jax.tree.map(np.asarray, rattn.make_attn_params(rc, jax.random.PRNGKey(n_kv)))
    rng = np.random.default_rng(n_kv + window)
    for name in ("bq", "bk", "bv", "bo"):
        p[name] = rng.standard_normal(p[name].shape).astype(np.float32) * 0.1
    x = rng.standard_normal((2, 64, 64)).astype(np.float32)
    return rc, tc, p, {k: _t(v) for k, v in p.items()}, x


@pytest.mark.parametrize("n_kv,window", [(4, 0), (2, 0), (1, 0), (2, 8)])
def test_self_attention_gqa_and_window_match_reference(n_kv, window):
    rc, tc, p, tp, x = _attn_case(n_kv, window)
    want = rattn.self_attention(rc, p, jnp.asarray(x), jnp.arange(64), window)
    got = tattn.self_attention(tc, tp, _t(x), torch.arange(64), window)
    _f32_close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("window", [0, 8])
def test_blockwise_attention_equals_dense_and_reference(window):
    rc, tc, p, tp, x = _attn_case(2, window, attn_chunk=16, attn_chunk_threshold=8)
    dense = dataclasses.replace(tc, attn_chunk_threshold=10_000)
    got = tattn.self_attention(tc, tp, _t(x), torch.arange(64), window)
    np.testing.assert_allclose(
        got.numpy(), tattn.self_attention(dense, tp, _t(x), torch.arange(64),
                                          window).numpy(), rtol=2e-5, atol=2e-5)
    want = rattn.self_attention(rc, p, jnp.asarray(x), jnp.arange(64), window)
    _f32_close(got.numpy(), np.asarray(want))


def _model_case(arch, dtype, seq=16, **kw):
    rc, tc = _configs(arch, dtype, **kw)
    p = jax.tree.map(np.asarray, rtfm.init_params(rc, jax.random.PRNGKey(0)))
    tp = interop.model_params_from_numpy(tc, p, "cpu")
    rng = np.random.default_rng(1)
    tok = rng.integers(0, rc.vocab_size, (2, seq)).astype(np.int32)
    emb = None
    if rc.frontend:
        emb = (rng.standard_normal((2, rc.frontend_len, rc.d_model)) * 0.02).astype(np.float32)
    r_emb = None if emb is None else jnp.asarray(emb).astype(rc.activation_dtype)
    t_emb = None if emb is None else _t(emb).to(tc.activation_dtype)
    return rc, tc, p, tp, tok, r_emb, t_emb


@pytest.mark.parametrize("arch", PORTED)
def test_forward_and_loss_match_reference_float32(arch):
    rc, tc, p, tp, tok, r_emb, t_emb = _model_case(arch, "float32")
    want, _ = rtfm.forward(rc, p, jnp.asarray(tok), embeds=r_emb)
    got, aux = ttfm.forward(tc, tp, _t(tok), embeds=t_emb)
    _f32_close(got.numpy(), want, tc.n_layers)
    assert (float(aux["lb_loss"]) > 0.0) == bool(tc.n_experts)
    rloss, rmet = rtfm.loss_fn(rc, p, jnp.asarray(tok), embeds=r_emb)
    tloss, tmet = ttfm.loss_fn(tc, tp, _t(tok), embeds=t_emb)
    _f32_close(float(tloss), float(rloss))
    assert sorted(tmet) == sorted(rmet)
    for k in rmet:
        _f32_close(float(tmet[k]), float(rmet[k]))


@pytest.mark.parametrize("arch", ["gemma-7b", "starcoder2-7b", "mixtral-8x22b",
                                  "mamba2-130m"])
def test_forward_and_loss_match_reference_bfloat16(arch):
    rc, tc, p, tp, tok, r_emb, t_emb = _model_case(arch, "bfloat16")
    want, _ = rtfm.forward(rc, p, jnp.asarray(tok), embeds=r_emb)
    got, _ = ttfm.forward(tc, tp, _t(tok), embeds=t_emb)
    assert got.dtype == torch.float32
    _bf16_close(got.numpy(), want)
    rloss, _ = rtfm.loss_fn(rc, p, jnp.asarray(tok), embeds=r_emb)
    tloss, _ = ttfm.loss_fn(tc, tp, _t(tok), embeds=t_emb)
    np.testing.assert_allclose(float(tloss), float(rloss), rtol=2e-2)


@pytest.mark.parametrize("loss_chunk", [8, 5])
def test_chunked_loss_matches_reference_and_full_loss(loss_chunk):
    rc, tc, p, tp, tok, _, _ = _model_case("starcoder2-7b", "float32", seq=24,
                                           loss_chunk=loss_chunk)
    rloss, _ = rtfm.loss_fn(rc, p, jnp.asarray(tok))
    tloss, _ = ttfm.loss_fn(tc, tp, _t(tok))
    full, _ = ttfm.loss_fn(dataclasses.replace(tc, loss_chunk=0), tp, _t(tok))
    _f32_close(float(tloss), float(rloss))
    _f32_close(float(tloss), float(full))
    # the chunked loss is differentiable through its recomputed chunks
    leaves = [x.detach().requires_grad_(True) for x in tr.leaves(tp)]
    live = tr.unflatten(zip([path for path, _ in tr.flatten(tp)], leaves))
    (g_head,) = torch.autograd.grad(ttfm.loss_fn(tc, live, _t(tok))[0],
                                    [live["lm_head"]])
    (g_full,) = torch.autograd.grad(
        ttfm.loss_fn(dataclasses.replace(tc, loss_chunk=0), live, _t(tok))[0],
        [live["lm_head"]])
    np.testing.assert_allclose(g_head.numpy(), g_full.numpy(), rtol=1e-5, atol=1e-7)


def test_init_params_from_a_generator():
    tc = tconfigs.get_reduced("gemma2-9b")
    a = ttfm.init_params(tc, torch.Generator().manual_seed(3), device="cpu")
    b = ttfm.init_params(tc, torch.Generator().manual_seed(3), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(tr.leaves(a), tr.leaves(b)))
    assert a["blocks"]["layer_1"]["attn"]["wq"].shape == (2, 64, 64)
    assert ttfm.param_count(a) == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(
        rtfm.init_params(rconfigs.get_reduced("gemma2-9b"), jax.random.PRNGKey(0))))
    logits, _ = ttfm.forward(tc, a, torch.zeros((1, 8), dtype=torch.int64))
    assert bool(torch.isfinite(logits).all())
