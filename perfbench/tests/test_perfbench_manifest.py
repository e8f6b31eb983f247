"""The manifest, and every file it names found by name."""
import json
import re

import pytest

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def man():
    return harness.manifest()


def test_keys_and_limits(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert man["command"] == ["python3", "perfbench/run.py"]
    assert man["paths"] == ["perfbench"]
    assert 1 <= man["run_seconds"] <= 51 and isinstance(man["run_seconds"], int)
    assert len(json.dumps(man)) <= 64 * 1024
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in man[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in man["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in man["end_to_end"])


@pytest.mark.parametrize("kind", ["configs", "workloads", "per_layer"])
def test_named_files_exist(man, kind):
    for entry in man[kind]:
        if kind == "configs":
            config = harness.load_json(harness.ROOT / entry["file"])
            assert entry["file"].startswith("perfbench/")
            assert set(entry["reduced"]) <= set(config) | set(config.get("model", {}))
            assert (harness.BENCH / "systems" / f"{config['system']}.py").is_file()
        elif kind == "workloads":
            traffic = harness.traffic(entry["traffic"])
            assert (harness.BENCH / "generators" / f"{traffic['generator']}.py").is_file()
            assert harness.cell(entry["name"])["limits"]
            assert entry["chips"] in (1, 4) and len(entry["why"]) <= 200
        else:
            assert callable(harness.metric_reader(entry["name"]).read)


def test_every_cell_reports_what_it_must(man):
    for wl in man["workloads"]:
        e2e = {m["name"] for m in harness.end_to_end_metrics(man, wl["name"])}
        layer = harness.per_layer_metrics(man, wl["name"])
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        assert all(m["moves"] in e2e for m in layer)
    used = {wl["config"] for wl in man["workloads"]}
    assert used == {c["name"] for c in man["configs"]}


def test_config_traffic_and_cell_by_name(man):
    wl = harness.workload(man, "twitter-cu.ingest")
    assert harness.config_of(man, wl)["system"] == "conservative_ingest"
    assert harness.traffic(wl["traffic"])["generator"] == "edge_blocks"
    with pytest.raises(harness.BenchError):
        harness.workload(man, "no-such-cell")
    with pytest.raises(harness.BenchError):
        harness.traffic("no_such_traffic")
