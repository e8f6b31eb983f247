"""The port's model serving (serving/kv_cache.py, serving/model_engine.py,
the serving/engine.py shim) and its serve and train launchers, on the CPU.

The cache helpers and the greedy engine are held against the reference's
own on the same weights (the reference's init, carried across by
``interop.model_params_from_numpy``) in float32.  Greedy tokens are
compared up to the first step whose top-2 logit margin in the reference is
within the float32 tolerance (there the two argmaxes may part), and the
logits of the reference's tokens, teacher-forced through both packages'
``forward``, everywhere (rtol 1e-5, atol 1e-6 x the logits' scale).
Temperature sampling draws from a ``torch.Generator``, which cannot
reproduce ``jax.random.categorical``: it is held to its own seed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import transformer as rtfm
from repro.serving import engine as rengine
from repro.serving import kv_cache as rkv
from repro.serving import model_engine as rme
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch import tree as tr
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as ttfm
from repro_torch.serving import engine as tengine
from repro_torch.serving import kv_cache as tkv
from repro_torch.serving import model_engine as tme
from repro_torch.serving import sketch_engine as tse
from repro_torch.serving.protocol import ServeEngineProtocol


def _configs(arch, **kw):
    return (dataclasses.replace(rconfigs.get_reduced(arch), dtype="float32", **kw),
            dataclasses.replace(tconfigs.get_reduced(arch), dtype="float32", **kw))


def _models(arch, seed=0, **kw):
    rc, tc = _configs(arch, **kw)
    p = jax.tree.map(np.asarray, rtfm.init_params(rc, jax.random.PRNGKey(seed)))
    return rc, tc, p, interop.model_params_from_numpy(tc, p, "cpu")


def _ref_leaves(tree):
    return [leaf for _, leaf in sorted(
        (tuple(k.key for k in path), leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0])]


# --------------------------------------------------------------------------
# kv_cache
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma-7b", "mamba2-130m", "seamless-m4t-medium",
                                  "jamba-1.5-large-398b"])
def test_cache_helpers_match_reference(arch):
    rc, tc = rconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    want = rkv.new_cache(rc, 3, 16)
    got = tkv.new_cache(tc, 3, 16, device="cpu")
    assert tkv.cache_bytes(got) == rkv.cache_bytes(want) > 0
    assert tkv.cache_bytes(tkv.new_cache(tc, 6, 16, device="cpu")) == \
        2 * tkv.cache_bytes(got)
    flat = tr.flatten(got)
    assert [tuple(x.shape) for _, x in flat] == [x.shape for x in _ref_leaves(want)]
    # reset_slots on a filled cache: the reference's result, a new tree
    rng = np.random.default_rng(1)
    filled = [rng.standard_normal(x.shape).astype(np.float32) for _, x in flat]
    mask = np.array([True, False, True])
    ref_tree = jax.tree.unflatten(jax.tree.structure(want),
                                  [jnp.asarray(x) for x in filled])
    port_tree = tr.unflatten((path, torch.from_numpy(x.copy()))
                             for (path, _), x in zip(flat, filled))
    out = tkv.reset_slots(port_tree, mask)
    for (path, a), b, x in zip(tr.flatten(out), _ref_leaves(rkv.reset_slots(ref_tree, mask)),
                               filled):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=str(path))
    for (_, before), x in zip(tr.flatten(port_tree), filled):
        np.testing.assert_array_equal(before.numpy(), x)   # the input is kept
    assert not bool(tr.leaves(out)[0][:, 0].any()) and bool(tr.leaves(out)[0][:, 1].any())


def test_encoder_decoder_cache_holds_cross_entries():
    tc = tconfigs.get_reduced("seamless-m4t-medium")
    cache = tkv.new_cache(tc, 2, 16, device="cpu")
    assert tuple(cache["layer_0"]["cross_k"].shape) == (
        tc.n_blocks, 2, tc.frontend_len, tc.n_kv_heads, tc.resolved_head_dim)
    assert "cross_k" not in tkv.new_cache(tconfigs.get_reduced("gemma-7b"), 2, 16,
                                          device="cpu")["layer_0"]


# --------------------------------------------------------------------------
# ServeEngine against the reference's
# --------------------------------------------------------------------------

def _greedy_case(arch, n_new=6):
    rc, tc, p, tp = _models(arch)
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, rc.vocab_size, (3, 10)).astype(np.int32)
    embeds = None
    if rc.frontend:
        embeds = (rng.standard_normal((3, rc.frontend_len, rc.d_model)) * 0.02).astype(np.float32)
    n_prefix = rc.frontend_len if rc.frontend and not rc.n_enc_layers else 0
    scfg = dict(max_len=n_prefix + 10 + n_new + 2)
    want = rme.ServeEngine(rc, p, rme.ServeConfig(**scfg)).generate(prompts, n_new, embeds)
    got = tme.ServeEngine(tc, tp, tme.ServeConfig(**scfg)).generate(prompts, n_new, embeds)
    return rc, tc, p, tp, prompts, embeds, n_prefix, np.asarray(want), got


@pytest.mark.parametrize("arch", ["mamba2-130m", "mixtral-8x22b", "seamless-m4t-medium"])
def test_greedy_tokens_match_reference_engine(arch):
    rc, tc, p, tp, prompts, embeds, n_prefix, want, got = _greedy_case(arch)
    assert got.dtype == np.int32 and got.shape == want.shape == (3, 6)
    # teacher-force the reference's tokens through both forwards
    seq = np.concatenate([prompts, want[:, :-1]], axis=1)
    r_emb = None if embeds is None else jnp.asarray(embeds)
    t_emb = None if embeds is None else torch.from_numpy(embeds)
    rl = np.asarray(rtfm.forward(rc, p, jnp.asarray(seq), embeds=r_emb)[0])
    tl = ttfm.forward(tc, tp, torch.from_numpy(seq), embeds=t_emb)[0].numpy()
    steps = slice(n_prefix + 9, n_prefix + 15)
    rl, tl = rl[:, steps, : rc.vocab_size], tl[:, steps, : tc.vocab_size]
    scale = max(1.0, float(np.abs(rl).max()))
    np.testing.assert_allclose(tl, rl, rtol=1e-5, atol=1e-6 * scale)
    np.testing.assert_array_equal(np.argmax(rl, -1), want)     # the reference is greedy
    top2 = np.sort(rl, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * (1e-6 * scale + 1e-5 * np.abs(top2[..., 1]))
    for b in range(3):
        n = int(np.argmin(clear[b])) if not clear[b].all() else clear.shape[1]
        np.testing.assert_array_equal(got[b, :n], want[b, :n])
    assert clear.mean() > 0.5


def test_temperature_sampling_is_seeded_and_never_serves_padded_rows():
    """gemma2's logit softcap leaves a padded row at -softcap, not -1e30, so
    only a sampler that looks at the real vocabulary never serves one."""
    tc = dataclasses.replace(tconfigs.get_reduced("gemma2-9b"), dtype="float32",
                             vocab_pad_multiple=384)
    assert tc.padded_vocab == 768 and tc.logit_softcap
    params = ttfm.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    prompts = np.random.default_rng(0).integers(0, tc.vocab_size, (4, 6))
    logits, _ = ttfm.prefill(tc, params, torch.from_numpy(prompts))
    assert bool((logits[:, tc.vocab_size:] > -1e3).all())
    scfg = tme.ServeConfig(max_len=32, temperature=1e4)

    def run(seed):
        return tme.ServeEngine(tc, params, scfg, seed=seed).generate(prompts, 20)

    a, b, c = run(7), run(7), run(8)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.max() < tc.vocab_size and c.max() < tc.vocab_size
    assert len(np.unique(a)) > 20          # a hot temperature spreads the draws


def test_slot_scheduler_serves_in_submission_order():
    _, tc, _, tp = _models("gemma-7b")
    engine = tme.ServeEngine(tc, tp, tme.ServeConfig(max_len=32))
    sched = tme.SlotScheduler(engine, n_slots=2)
    assert isinstance(sched, ServeEngineProtocol)
    rng = np.random.default_rng(3)
    reqs = [tme.Request(rid=i, prompt=rng.integers(0, tc.vocab_size, (8 + i,)),
                        max_new=3 + i % 2) for i in range(5)]
    for r in reqs:
        sched.submit(r)
    done = sched.flush()
    assert [r.rid for r in done] == list(range(5)) and all(r.done for r in done)
    assert [len(r.out) for r in done] == [r.max_new for r in reqs]
    assert sched.queue == [] and sched.flush() == done
    # each cohort is one generate() of its prompts cut to the shortest
    for lo in (0, 2, 4):
        cohort = reqs[lo : lo + 2]
        s = min(len(r.prompt) for r in cohort)
        toks = engine.generate(np.stack([r.prompt[:s] for r in cohort]),
                               max(r.max_new for r in cohort))
        for r, row in zip(cohort, toks):
            assert r.out == row[: r.max_new].tolist()


def test_engine_shim_reexports_the_split_modules():
    assert tengine.__all__ == rengine.__all__
    for name in tengine.__all__:
        src = tse if name == "SketchTopKEndpoint" else tme
        assert getattr(tengine, name) is getattr(src, name)


# --------------------------------------------------------------------------
# the launchers, on the CPU
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mamba2-130m", "seamless-m4t-medium", "internvl2-26b",
                                  "dbrx-132b"])
def test_serve_launcher_on_the_cpu(arch, capsys):
    out = tserve.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                       "--slots", "2", "--prompt-len", "8", "--max-new", "4"])
    assert [r.rid for r in out["requests"]] == [0, 1, 2]
    assert all(len(r.out) == 4 and max(r.out) < out["cfg"].vocab_size
               for r in out["requests"])
    assert out["tokens"] == 12 and "served 3 requests, 12 tokens" in capsys.readouterr().out


def test_serve_launcher_sketch_autotune_on_the_cpu(capsys):
    args = ["--sketch-autotune", "--device", "cpu"]
    out = tserve.main(args)
    ep = out["endpoint"]
    assert any(d.migrated for d in out["tuner"].decisions)
    assert ep.hspec.base.ranges != out["frozen"].hspec.base.ranges
    assert "auto-tuned=" in capsys.readouterr().out
    assert out["are"]["auto_tuned"] < out["are"]["stale"]
    # the run is deterministic: a second run reaches the same tables
    again = tserve.main(args)["endpoint"]
    for a, b in zip(ep.state.states, again.state.states):
        assert torch.equal(a.table, b.table)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "mamba2-130m", "jamba-1.5-large-398b",
                                  "seamless-m4t-medium"])
def test_train_launcher_on_the_cpu(arch, capsys):
    out = ttrain.main(["--arch", arch, "--device", "cpu", "--steps", "2", "--batch", "2",
                       "--seq", "16", "--grad-compression"])
    assert np.isfinite(out["history"]["loss"]).all()
    assert out["estimates"].shape == (8,) and int(out["estimates"].min()) >= 1
    assert int(out["state"]["sketch_table"].to(torch.int64).sum(dim=1)[0]) == 2 * 2 * 15
    assert "sketch n-gram estimates" in capsys.readouterr().out
