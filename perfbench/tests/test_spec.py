"""Everything BENCHMARK.json names is found by name, in a file of its own."""

import json

import pytest

from perfbench import spec
from perfbench.traffic import Traffic

BENCH = spec.benchmark()
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cell_loads_with_its_config_mix_and_limits(workload):
    cell = spec.load_cell(workload, BENCH)
    assert set(cell.limits) == {"fwd_err", "inv_err"}
    assert all(0 < v < 1e-4 for v in cell.limits.values())
    spec.module("entries", cell.config["entry"]).build
    spec.module("references", cell.config["reference"]).transform
    assert cell.traffic.batch >= 1


@pytest.mark.parametrize("name", METRICS)
def test_every_metric_has_a_reader(name):
    assert callable(spec.module("metrics", name).read)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(workload):
    e2e = {m["name"] for m in spec.cell_metrics(BENCH, workload, False)}
    layer = spec.cell_metrics(BENCH, workload, True)
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in layer:                 # each moves a metric the cell reports
        assert m["moves"] in e2e


def test_config_files_are_the_ones_named():
    for c in BENCH["configs"]:
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        with open(spec.REPO / c["file"]) as f:
            assert "source" in json.load(f)


@pytest.mark.parametrize("bad", [
    {"storage": "planar"}, {"directions": "forward"}, {"loop": "stream"},
    {"batch": 0}, {"check_pairs": 0}, {"extra": 1}])
def test_traffic_rejects_what_the_generator_does_not_know(bad):
    good = {"batch": 2, "storage": "split", "directions": "roundtrip",
            "loop": "sync", "check_pairs": 1}
    with pytest.raises((ValueError, TypeError)):
        Traffic.from_dict({**good, **bad})


def test_sample_times_fall_inside_the_window_and_follow_the_seed():
    t = Traffic.from_dict({"batch": 1, "storage": "split",
                           "directions": "roundtrip", "loop": "sync",
                           "check_pairs": 64})
    a, b = t.sample_times(2 ** 31 + 5, 10.0), t.sample_times(7, 10.0)
    assert a == sorted(a) and len(a) == 64 and a != b
    assert a == t.sample_times(2 ** 31 + 5, 10.0)
    assert all(1.0 <= s <= 9.0 for s in a + b)
    assert [t.inverse(i) for i in range(4)] == [False, True, False, True]
