"""The port's dry-run stack against the JAX reference, on the CPU: the meta
stand-ins of ``launch/specs.py``, ``roofline.py``, the FLOP count of
``launch/dryrun.py`` and the profiler-trace reader ``trace_analysis.py``.

  * every ``specs`` tree equals the reference's ``jax.eval_shape`` tree
    leaf by leaf in shape and dtype, for every arch x applicable shape
    (train for all ten); the one dtype that differs by design is the
    n-gram sketch's hash params, int64 in the port (its integer hashing
    runs in int64) where the reference holds uint32;
  * ``model_flops_for`` equals the reference's exactly, and the
    ``Roofline`` terms equal the reference's once its constants are the
    port's; ``wire_bytes`` equals the reference's HLO collective parser on
    the same collective;
  * the block- and chunk-scaled FLOP count equals FlopCounterMode over the
    whole step exactly, for all ten reduced architectures;
  * three model cells and one sketch cell end to end into a temp dir;
  * the trace reader on a synthetic chrome trace of known kernels, gaps
    and memcpys, and on a real CPU profile.
"""
import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch

from repro import roofline as rrl
from repro.configs import SHAPES as RSHAPES
from repro.configs import get_config as rget_config
from repro.configs import shape_applicable as rapplicable
from repro.launch import specs as rsp
from repro.models import sharding as rshd
from repro.models import transformer as rtfm
from repro_torch import configs as tconfigs
from repro_torch import roofline as trl
from repro_torch import trace_analysis as ta
from repro_torch import tree as tr
from repro_torch.launch import dryrun as dr
from repro_torch.launch import specs as tsp
from repro_torch.models import sharding as tshd

CELLS = [(arch, shape) for arch in tconfigs.ARCHS for shape in tconfigs.SHAPES
         if tconfigs.shape_applicable(tconfigs.get_config(arch), shape)]


def _key(k) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def _ref_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(_key(k) for k in path): (tuple(x.shape), str(np.dtype(x.dtype)))
            for path, x in flat}


def _port_leaves(tree):
    out = {}
    for path, leaf in tr.flatten(tree):
        parts = leaf._asdict().items() if isinstance(leaf, tuple) else [(None, leaf)]
        for field, t in parts:
            name = "/".join(path + ((field,) if field else ()))
            out[name] = (tuple(t.shape), str(t.dtype).replace("torch.", ""))
    return out


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_reference_eval_shape(arch, shape):
    want_tree, got_tree = rsp.input_specs(arch, shape), tsp.input_specs(arch, shape)
    assert got_tree.pop("kind") == want_tree.pop("kind") == RSHAPES[shape]["kind"]
    want, got = _ref_leaves(want_tree), _port_leaves(got_tree)
    assert all(t.device.type == "meta" for _, leaf in tr.flatten(got_tree)
               for t in (leaf if isinstance(leaf, tuple) else (leaf,)))
    assert got.keys() == want.keys()
    for name in want:
        if "sketch_params" in name:      # hash params: int64 here, uint32 there
            assert got[name] == (want[name][0], "int64") and want[name][1] == "uint32"
        else:
            assert got[name] == want[name], name
    assert rapplicable(rget_config(arch), shape)


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_prefill_cache_specs_equal_reference(arch):
    """The caches ``prefill`` returns (``max_len=None``), at a short prompt."""
    rcfg, tcfg = rget_config(arch), tconfigs.get_config(arch)
    b, s = 2, 1024
    params = jax.eval_shape(lambda k: rtfm.init_params(rcfg, k), jax.random.PRNGKey(0))
    batch = rsp.batch_input_specs(rcfg, b, s)
    want = jax.eval_shape(lambda p, t, e: rtfm.prefill(rcfg, p, t, embeds=e, max_len=None)[1],
                          params, batch["tokens"], batch.get("embeds"))
    assert _port_leaves(tsp.prefill_cache_specs(tcfg, b, s)) == _ref_leaves(want)


def test_default_train_config_equals_reference():
    for arch in tconfigs.ARCHS:
        got = tsp.default_train_config(tconfigs.get_config(arch)).optimizer.name
        assert got == rsp.default_train_config(rget_config(arch)).optimizer.name
        assert got == ("adamw8bit" if tconfigs.get_config(arch).param_count()["total"] > 60e9
                       else "adamw")


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_model_flops_for_equals_reference(arch):
    for shape, sh in tconfigs.SHAPES.items():
        for kind in ("train", "prefill", "decode"):
            args = (kind, sh["global_batch"], sh["seq_len"])
            assert trl.model_flops_for(tconfigs.get_config(arch), *args) == \
                rrl.model_flops_for(rget_config(arch), *args)


@pytest.mark.parametrize("flops,hbm,wire", [(3e15, 2e10, 1e9), (1e9, 7e10, 3e8),
                                            (1e6, 1e3, 9e10), (0.0, 0.0, 0.0)])
def test_roofline_terms_equal_reference_with_the_ports_constants(monkeypatch, flops, hbm, wire):
    args = dict(arch="a", shape="s", mesh="m", chips=256, flops_per_chip=flops,
                hbm_bytes_per_chip=hbm, wire_bytes_per_chip=wire, model_flops=2e17,
                collectives={"counts": {}})
    got = trl.Roofline(**args).as_dict()
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(rrl, name, getattr(trl, name))
    assert got == rrl.Roofline(**args).as_dict()
    assert trl.build_roofline("a", "s", "m", 256, flops, hbm, wire, 2e17,
                              {"counts": {}}).as_dict() == got
    # the constants are the H100's published peaks
    assert (trl.PEAK_FLOPS, trl.HBM_BW, trl.LINK_BW, trl.INT_OPS, trl.HBM_BYTES) == \
        (989e12, 3.35e12, 450e9, 67e12, 80e9)


@pytest.mark.parametrize("op", ["all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                                "collective-permute"])
@pytest.mark.parametrize("group", [2, 4, 16])
def test_wire_bytes_equal_reference_collective_parser(op, group):
    members = ",".join(str(i) for i in range(group))
    line = (f"  %c = f32[96,64]{{1,0}} {op}(f32[96,64]{{1,0}} %x), "
            f"replica_groups={{{{{members}}}}}")
    want = rrl.parse_collectives(line).wire_bytes
    assert trl.wire_bytes(op, 96 * 64 * 4, group) == want


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_scaled_flop_count_equals_whole_count(arch, kind):
    """One block of each kind at one and two blocks, each SSM scan alone at
    one and two chunks, extrapolated: equal to the whole step's count."""
    cfg = tconfigs.get_reduced(arch)
    if cfg.ssm_state:
        cfg = dataclasses.replace(cfg, ssm_chunk=16)     # 4 chunks of 64 tokens
    whole = dr.count_flops(cfg, kind, 2, 64, scaled=False)
    assert whole > 0
    assert dr.count_flops(cfg, kind, 2, 64) == whole


def _cells(tmp_path, argv):
    dr.main(argv + ["--out", str(tmp_path)])
    return {p.name: json.loads(p.read_text()) for p in tmp_path.glob("*.json")}


def _ref_param_bytes(arch, mesh_shape, axes):
    """Bytes a position holds of the params, from the reference's specs and
    shapes (numpy arithmetic)."""
    import types

    mesh = types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, mesh_shape)))
    cfg = rget_config(arch)
    params = jax.eval_shape(lambda k: rtfm.init_params(cfg, k), jax.random.PRNGKey(0))
    specs = rshd.param_specs(cfg, params, mesh)
    total = 0
    for x, s in zip(jax.tree.leaves(params), jax.tree.leaves(
            specs, is_leaf=lambda v: isinstance(v, jax.sharding.PartitionSpec))):
        div = 1
        for e in s:
            for a in (e if isinstance(e, tuple) else (e,) if e else ()):
                div *= mesh.shape[a]
        total += math.prod(x.shape) // div * np.dtype(x.dtype).itemsize
    return total


def test_dryrun_cells_end_to_end(tmp_path):
    cells = _cells(tmp_path, ["--arch", "starcoder2-7b", "--shape", "train_4k",
                              "--single-pod-only"])
    cells |= _cells(tmp_path, ["--arch", "mixtral-8x22b", "--shape", "decode_32k",
                               "--multi-pod-only"])
    cells |= _cells(tmp_path, ["--arch", "mamba2-130m", "--shape", "long_500k",
                               "--single-pod-only"])
    assert set(cells) == {"starcoder2-7b__train_4k__pod16x16__baseline.json",
                          "mixtral-8x22b__decode_32k__pod2x16x16__baseline.json",
                          "mamba2-130m__long_500k__pod16x16__baseline.json"}
    for name, c in cells.items():
        arch = c["arch"]
        assert c["left_out"] and all(isinstance(s, str) for s in c["left_out"])
        by = c["per_position_bytes"]
        assert by["total"] == sum(v for k, v in by.items() if k != "total")
        assert c["fits"] == (by["total"] <= 80e9) and c["hbm_bytes_per_chip"] == by["total"]
        assert c["chips"] == (512 if "pod2x" in name else 256)
        assert c["flops_per_chip"] * c["chips"] == c["flops_counted"] > 0
        sh = tconfigs.SHAPES[c["shape"]]
        assert c["model_flops"] == rrl.model_flops_for(
            rget_config(arch), c["kind"], sh["global_batch"], sh["seq_len"])
        assert c["bottleneck"] in ("compute", "memory", "collective")
        mesh = ((2, 16, 16), ("pod", "data", "model")) if "pod2x" in name else \
            ((16, 16), ("data", "model"))
        assert by["params"] == _ref_param_bytes(arch, *mesh)
        assert c["wire_bytes_per_chip"] == c["collectives"]["wire_bytes"] > 0
    train = cells["starcoder2-7b__train_4k__pod16x16__baseline.json"]
    assert set(train["collectives"]["counts"]) == {"all-gather", "reduce-scatter"}
    assert train["per_position_bytes"]["opt"] > 0
    assert "cache" in cells["mamba2-130m__long_500k__pod16x16__baseline.json"][
        "per_position_bytes"]
    # a cell that exists is kept unless --force
    (tmp_path / "marker").write_text("")
    dr.main(["--arch", "mamba2-130m", "--shape", "long_500k", "--single-pod-only",
             "--out", str(tmp_path)])
    assert json.loads((tmp_path / "mamba2-130m__long_500k__pod16x16__baseline.json")
                      .read_text()) == cells["mamba2-130m__long_500k__pod16x16__baseline.json"]


def test_sketch_cells_end_to_end(tmp_path):
    from repro.core import hierarchy as rhh
    from repro.core import sketch as rsk
    from repro.core.hashing import KeySchema

    cells = _cells(tmp_path, ["--sketch-cells"])
    assert len(cells) == 9
    base = rsk.mod_sketch_spec(KeySchema(domains=(1 << 32, 1 << 32)), [(0,), (1,)],
                               (512, 512), 4)
    cells_ref = rhh.HierarchySpec.from_spec(base).table_cells
    shards = {"pod16x16": 16, "pod2x16x16": 32, "test2x2": 2}
    for name, c in cells.items():
        n = shards[c["mesh"]]
        assert c["n_shards"] == n and c["table_cells"] == cells_ref
        assert c["per_shard_table_bytes"] == 4 * cells_ref
        assert c["batch"] == (1 << 20) // n * n and c["left_out"]
        if c["cell"] == "sketch_ingest":
            assert c["collectives"]["wire_bytes"] == 0
            assert c["per_shard_block_bytes"] == c["batch"] // n * 12
        else:
            line = (f"  %a = s32[{cells_ref}]{{0}} all-reduce(s32[{cells_ref}]{{0}} %t), "
                    f"replica_groups={{{{{','.join(map(str, range(n)))}}}}}")
            assert c["collectives"]["wire_bytes"] == rrl.parse_collectives(line).wire_bytes


# --------------------------------------------------------------------------
# trace_analysis
# --------------------------------------------------------------------------

def _synthetic_trace():
    """Two streams of kernels, copies and a set over a 1,000 us window, with
    known gaps (after the copies settle: 100-200, 450-600, 700-900 us idle)."""
    def x(cat, name, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": ts,
                "dur": dur, "args": args}
    return {"traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "python"}},
        x("cpu_op", "aten::mm", 0.0, 1000.0),
        x("cuda_runtime", "cudaLaunchKernel", 5.0, 3.0),
        x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 10.0, 40.0, bytes=4096),
        x("kernel", "sk_flat_update_kernel", 50.0, 50.0),
        x("kernel", "sk_flat_update_kernel", 200.0, 100.0),
        x("kernel", "ampere_sgemm_128x64", 250.0, 200.0),      # overlaps the one before
        x("gpu_memset", "Memset (Device)", 600.0, 10.0),
        x("kernel", "ncclDevKernel_AllReduce_Sum_f32", 610.0, 90.0),
        x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 900.0, 20.0, bytes=512),
        x("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 920.0, 5.0, bytes=64),
        x("gpu_memcpy", "Memcpy PtoP (Device -> Device)", 925.0, 5.0, bytes=32),
    ]}


def test_trace_reader_on_a_synthetic_chrome_trace(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(_synthetic_trace()))
    for source in (path, str(path), _synthetic_trace()):
        s = ta.summarize(ta.read(source), wall_s=0.002)
        assert list(s["kernels"]) == ["ampere_sgemm_128x64", "sk_flat_update_kernel",
                                      "ncclDevKernel_AllReduce_Sum_f32"]
        assert [v[1] for v in s["kernels"].values()] == [1, 2, 1]
        assert [v[0] for v in s["kernels"].values()] == pytest.approx([0.2, 0.15, 0.09])
        assert s["launches"] == 4 and s["memsets"] == 1
        assert s["device_busy_s"] == pytest.approx(520e-6)
        assert s["device_busy_union_s"] == pytest.approx(470e-6)
        assert s["idle_share"] == pytest.approx(1 - 520e-6 / 0.002)
        # union [10, 100] [200, 450] [600, 700] [900, 930] us: gaps after
        # 0.69, 0.44 and 0.09 ms of the first device work, longest first
        assert [g["after_ms"] for g in s["longest_gaps"]] == pytest.approx([0.69, 0.44, 0.09])
        assert [g["gap_ms"] for g in s["longest_gaps"]] == pytest.approx([0.2, 0.15, 0.1])
        assert {k: (v["count"], v["bytes"]) for k, v in s["memcpy"].items()} == {
            "HtoD": (1, 4096), "DtoH": (1, 512), "DtoD": (1, 64), "PtoP": (1, 32)}
        assert [v["ms"] for v in s["memcpy"].values()] == pytest.approx([0.04, 0.02, 0.005,
                                                                         0.005])
        assert s["collectives"]["count"] == 1
        assert s["collectives"]["ms"] == pytest.approx(0.09)
        assert ta.host_totals(ta.read(source)) == {"aten::mm": [1.0, 1]}
    # without a wall time, the trace's own span
    assert ta.summarize(ta.read(path))["wall_s"] == pytest.approx(1e-3)


def test_trace_reader_on_a_real_cpu_profile(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(32, 32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            a = torch.tanh(a @ a)
    path = tmp_path / "cpu.json"
    prof.export_chrome_trace(str(path))
    from_events, from_json = ta.read(prof.events()), ta.read(path)
    assert ta.read(prof).host == from_events.host
    for trace in (from_events, from_json):
        s = ta.summarize(trace)
        assert s["kernels"] == {} and s["device_busy_s"] == 0.0 and s["idle_share"] == 1.0
        assert s["memcpy"] == {} and s["collectives"]["count"] == 0
        host = ta.host_totals(trace)
        assert host["aten::mm"][1] == 5 and host["aten::tanh"][1] == 5
    assert {k: v[1] for k, v in ta.host_totals(from_events).items()} == \
        {k: v[1] for k, v in ta.host_totals(from_json).items()}
    assert ta.summarize(from_json)["wall_s"] == pytest.approx(
        ta.summarize(from_events)["wall_s"], rel=1e-6)


def test_meta_specs_cost_no_memory():
    """The stand-ins for mixtral-8x22b's whole train state (140.6B params)
    are meta tensors."""
    cfg = tconfigs.get_config("mixtral-8x22b")
    state = tsp.train_state_specs(cfg, tsp.default_train_config(cfg))
    tensors = [t for _, leaf in tr.flatten(state)
               for t in (leaf if isinstance(leaf, tuple) else (leaf,))]
    assert all(t.device.type == "meta" for t in tensors)
    assert sum(t.numel() for _, t in tr.flatten(state["params"])) > 140e9
    assert isinstance(tshd.P(), tuple)
