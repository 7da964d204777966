"""BENCHMARK.json keeps the benchmark's rules of form, and every name in it
finds its file."""

from __future__ import annotations

import json
import re

import pytest

from perfbench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
# a width may never be cut
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|_rank$"
                   r"|head|expansion|experts_per)")


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == TOP_KEYS
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/")
               for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(one_line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keep_the_rules(section):
    entries = BENCH[section]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        allowed = KEYS[section] | ({"workloads"} if section in
                                   ("end_to_end", "per_layer") else set())
        assert set(e) - allowed == set() and KEYS[section] <= set(e), e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer"):
            if key in e:
                assert one_line(e[key]), e[key]
        if section == "configs":
            assert one_line(e["source"]) and len(e["reduced"]) <= 16
            assert all(NAME.match(k) and not WIDTH.search(k) for k in e["reduced"])
        if section == "workloads":
            assert NAME.match(e["config"]) and NAME.match(e["traffic"])
            assert e["chips"] in (1, 4)


def test_metric_sources_and_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline_pct")
    assert len(BENCH["workloads"]) <= 24 and len(BENCH["configs"]) <= 24
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(BENCH["workloads"]) // 4)


def test_every_layer_is_named_in_perf_md_s_list_of_layers():
    text = (harness.ROOT / "PERF.md").read_text()
    layers = text.split("## 3. Layers", 1)[1].split("## 4.", 1)[0]
    for m in BENCH["per_layer"]:
        assert f"| {m['layer']} |" in layers, m["layer"]


def test_every_configuration_is_used_and_its_file_lies_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert (harness.BENCH_DIR / "reference" / f"{cfg['reference']}.py").exists()
        assert set(cfg["limits"]) >= {"start_mismatch"}


def test_pairs_of_configuration_and_traffic_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


@pytest.mark.parametrize("work", [w["name"] for w in BENCH["workloads"]])
def test_cell_finds_its_files_and_reports_what_it_must(work):
    cell = harness.load_cell(work)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.reader(m["name"]))
    for m in cell.per_layer:
        # the end-to-end metric this one moves is reported in this cell
        assert m["moves"] in names
    # the traffic's driver, the configuration's world factory and its
    # reference, each found by the name its data file gives
    assert cell.traffic["name"] == cell.entry["traffic"]
    assert callable(cell.driver().Driver) and callable(cell.world().build)
    ref = harness.module("reference", cell.config["reference"])
    assert all(callable(getattr(ref, f)) for f in ("acc", "step", "update_parts"))


def test_every_per_layer_metric_moves_an_end_to_end_metric_of_each_cell():
    for m in BENCH["per_layer"]:
        for work in m.get("workloads", [w["name"] for w in BENCH["workloads"]]):
            reported = {e["name"] for e in harness.load_cell(work).end_to_end}
            assert m["moves"] in reported, (m["name"], work)


def test_result_line_and_checks_come_last(cpu_cuda_backend):
    """The keys a result line holds, with ``checks`` last (a CPU run)."""
    import time

    from perfbench.tests.conftest import small_cell

    out = harness.run(small_cell("direct-65k.run"), 5, 0.2, False, "cpu",
                      time.perf_counter())
    assert list(out)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert set(out["metrics"]) == {"substep_ms.direct", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in out["metrics"].values())
    json.dumps(out)


def test_a_split_metric_takes_its_kinds_reader():
    """``<metric>.<kind>`` reads with ``<metric>.py`` where it has no file of
    its own; a name with neither file is refused."""
    assert harness.reader("substep_ms.p3m") is harness.reader("substep_ms")
    assert harness.reader("enqueue_ms.direct") is harness.reader("enqueue_ms")
    with pytest.raises(SystemExit):
        harness.reader("no_such_metric.direct")
