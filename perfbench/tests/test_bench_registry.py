"""``BENCHMARK.json`` against the benchmark's contract, and the harness
finding every piece by name, a new cell and metric added as files
alone."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from perfbench import harness

import tiny

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 seconds
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


def test_entries_have_the_contract_keys_and_names():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    for kind, want in keys.items():
        names = [e["name"] for e in BENCH[kind]]
        assert len(set(names)) == len(names)
        for e in BENCH[kind]:
            extra = set(e) - want
            assert extra <= ({"workloads"} if kind in ("end_to_end",
                                                        "per_layer")
                             else set()), (kind, e["name"], extra)
            assert want <= set(e)
            assert NAME.match(e["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_pieces_by_name(cell):
    c = harness.find_cell(harness.ROOT, cell)
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert cell == f"{w['config']}.{w['traffic']}" and w["chips"] == 1
    assert c.config["name"] == w["config"]
    assert {m["name"] for m in c.e2e} >= {"setup_s"} and len(c.e2e) >= 2
    assert c.per_layer and set(c.readers) == {
        m["name"] for m in c.e2e + c.per_layer}
    assert all(callable(r.read) for r in c.readers.values())
    for name in ("setup", "unit", "drain", "check"):
        assert callable(getattr(c.driver, name))
    # every per-layer metric that lists this cell moves one of its metrics
    e2e = {m["name"] for m in c.e2e}
    assert all(m["moves"] in e2e for m in c.per_layer)


def test_every_config_is_used_and_lies_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["file"].startswith("perfbench/")
        data = json.loads((harness.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]


def test_unknown_cell_is_refused():
    with pytest.raises(harness.Refused):
        harness.find_cell(harness.ROOT, "no-such.cell")


def _copy(tmp_path):
    shutil.copytree(harness.ROOT / "perfbench", tmp_path / "perfbench")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(BENCH))
    return tmp_path / "perfbench"


@pytest.mark.parametrize("traffic, change", [
    ("serve-bf16-coco8", {"clients": 4}),
    ("serve-bf16-coco8", {"compute_dtype": "float16"}),
    ("train-f32-800x1333", {"compute_dtype": "bfloat16"}),
    ("enc-f32-800x1333", {"dtype": "bfloat16"}),
])
def test_a_mix_the_driver_would_not_honour_is_refused(tmp_path, traffic,
                                                       change):
    """A key that the cell's driver does not read, or a value it does not
    support, is refused before the run, not run as something else."""
    here = _copy(tmp_path)
    path = here / "traffic" / f"{traffic}.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), **change}))
    cell = next(w["name"] for w in BENCH["workloads"]
                if w["traffic"] == traffic)
    with pytest.raises(harness.Refused, match=next(iter(change))):
        harness.find_cell(tmp_path, cell)


def test_a_configuration_value_the_driver_does_not_support_is_refused(
        tmp_path):
    here = _copy(tmp_path)
    path = here / "configs" / "msda-op-ddetr.json"
    path.write_text(json.dumps({**json.loads(path.read_text()),
                                "dtype": "float64"}))
    with pytest.raises(harness.Refused, match="dtype"):
        harness.find_cell(tmp_path, "msda-op-ddetr.enc-f32-800x1333")


def test_a_metric_part_without_its_own_file_uses_the_shared_reader():
    cell = harness.find_cell(harness.ROOT, "ddetr-refine.serve-bf16-coco8")
    assert cell.readers["idle_pct.serve"].__file__.endswith(
        "metrics/idle_pct.py")
    assert not (harness.ROOT / "perfbench" / "metrics" /
                "idle_pct.serve.py").exists()


def test_a_cell_and_metric_added_as_files_alone(tmp_path):
    """A copy of the benchmark gains a traffic mix, a cell, its limits and
    a per-layer metric without a ``workloads`` list by new files and
    entries only; the harness runs the new cell and reports the metric
    there, and in every other cell that reports what it moves."""
    shutil.copytree(harness.ROOT / "perfbench", tmp_path / "perfbench")
    here = tmp_path / "perfbench"
    bench = json.loads(json.dumps(BENCH))
    traffic = json.loads((here / "traffic" / "enc-f32-800x1333.json")
                         .read_text())
    traffic["size"] = [640, 640]
    (here / "traffic" / "enc-f32-640x640.json").write_text(
        json.dumps(traffic))
    name = "msda-op-ddetr.enc-f32-640x640"
    (here / "limits" / f"{name}.json").write_text(
        (here / "limits" / "msda-op-ddetr.enc-f32-800x1333.json").read_text())
    (here / "metrics" / "calls_per_s.op.py").write_text(
        "def read(run):\n    return run.units / run.window_s\n")
    bench["workloads"].append({"name": name, "config": "msda-op-ddetr",
                               "traffic": "enc-f32-640x640", "chips": 1,
                               "why": "a smaller encoder call"})
    for m in bench["end_to_end"]:
        if m["name"] == "op_fwdbwd_ms":
            m["workloads"].append(name)
    bench["per_layer"].append({"name": "calls_per_s.op", "unit": "1/s",
                               "better": "higher", "source": "host_clock",
                               "layer": "Op (ops/msda.py, ops/library.py)",
                               "moves": "op_fwdbwd_ms"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.find_cell(tmp_path, name)
    assert "calls_per_s.op" in cell.readers
    other = harness.find_cell(tmp_path, "msda-op-ddetr.enc-f32-1600x2666")
    assert "calls_per_s.op" in other.readers
    serve = harness.find_cell(tmp_path, "ddetr-refine.serve-bf16-coco8")
    assert "calls_per_s.op" not in serve.readers
    result = tiny.run(name, trace=True, root=tmp_path)
    assert result["correct"] and result["metrics"]["calls_per_s.op"][
        "value"] > 0
