"""BENCHMARK.json against the benchmark's contract, and every part of a
cell found by its file name, so that a later change adds a model, a mix,
a cell or a metric by adding files and entries alone."""
import json
import shutil

import pytest

from benchlib import spec

BENCH = spec.load_benchmark()
ALLOWED_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                  "workloads"},
}
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "proj", "head",
               "expansion", "expand", "experts_per_tok")


def entries():
    for group in ALLOWED_KEYS:
        for e in BENCH[group]:
            yield group, e


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


@pytest.mark.parametrize("group,entry", list(entries()),
                         ids=lambda v: v if isinstance(v, str)
                         else v["name"])
def test_names_units_and_keys(group, entry):
    assert set(entry) <= ALLOWED_KEYS[group]
    assert spec.NAME.match(entry["name"]), entry["name"]
    if "unit" in entry:
        assert spec.UNIT.match(entry["unit"]), entry["unit"]
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
    for key in ("why", "layer", "source"):
        if key in entry:
            v = entry[key]
            assert 1 <= len(v) <= 200 and "\n" not in v and "\t" not in v
    for key in ("config", "traffic"):
        if key in entry:
            assert spec.NAME.match(entry[key])


def test_command_and_paths():
    assert len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert 1 <= len(word) <= 200 and not word.startswith("/")
        assert ".." not in word
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert len(p) <= 200 and not p.endswith("_torch")
        assert (spec.ROOT / p).is_dir()
    script = BENCH["command"][-1]
    assert any(script.startswith(p + "/") for p in BENCH["paths"])


def test_run_seconds_fit_the_check_of_24_cells():
    s = BENCH["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_bounds_and_end_to_end_metrics():
    names = [m["name"] for m in BENCH["end_to_end"]]
    assert "setup_s" in names and 1 <= len(names) <= 16
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25 and "workloads" not in setup


def test_every_cell_reports_setup_another_e2e_and_a_per_layer_metric():
    for w in BENCH["workloads"]:
        e2e, per = spec.metrics_of(w["name"], BENCH)
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2, w["name"]
        assert per, w["name"]
        for m in per:
            assert m["moves"] in names, (w["name"], m["name"])


def test_cells_configs_and_chips():
    cells = BENCH["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    assert all(w["chips"] in (1, 4) for w in cells)
    used = {w["config"] for w in cells}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert spec.NAME.match(key)
            assert not key.endswith(("_dim", "_rank"))
            assert not any(w in key for w in WIDTH_WORDS), key


def test_layers_are_named_alike():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values()), by_layer


def test_shares_are_percent_and_named():
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_is_found_by_its_name(name):
    cell = spec.load_cell(name)
    assert cell.name == name
    assert callable(cell.driver.run)
    assert callable(cell.reference.forward)
    assert spec.workload_path(name).is_file()
    assert spec.traffic_path(cell.traffic_name).is_file()
    assert spec.reference_path(cell.config_name).is_file()


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_each_metric_has_its_reader(name):
    mod = spec.load_module(spec.metric_path(name))
    assert callable(mod.read)


def test_adding_a_cell_edits_no_file(tmp_path):
    """A new mix, cell and metric in a copy of the benchmark: files and
    entries are added, every file that was there is byte for byte the
    same, and the new cell loads."""
    root = tmp_path / "repo"
    shutil.copytree(spec.BENCH, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "BENCHMARK.json").write_text(json.dumps(BENCH))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "vgg16.b8.pool", "config": "vgg16",
                               "traffic": "closed_b8", "chips": 1,
                               "why": "a smaller batch"})
    bench["per_layer"].append({"name": "extra_ms", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "device", "moves": "images_per_s",
                               "workloads": ["vgg16.b8.pool"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "vgg16.b128.pool" in m["workloads"]:
            m["workloads"].append("vgg16.b8.pool")
    bp = root / "perfbench"
    (bp / "traffic" / "closed_b8.json").write_text(json.dumps(
        dict(json.loads((bp / "traffic" / "closed_b128.json").read_text()),
             batch=8)))
    (bp / "workloads" / "vgg16.b8.pool.json").write_text(
        (bp / "workloads" / "vgg16.b128.pool.json").read_text())
    (bp / "metrics" / "extra_ms.py").write_text("def read(obs):\n"
                                                "    return 1.0\n")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for p, data in before.items():
        if p.name != "BENCHMARK.json":
            assert p.read_bytes() == data, p
    orig = spec.BENCH
    try:
        spec.BENCH = bp
        cell = spec.load_cell("vgg16.b8.pool", root)
    finally:
        spec.BENCH = orig
    assert cell.traffic["batch"] == 8
    assert [m["name"] for m in cell.per_layer][-1] == "extra_ms"
