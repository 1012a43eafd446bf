"""BENCHMARK.json against the contract, every name found as a file, the
result line's keys, the generators' reproducibility and B1's byte count."""
import json
import math
import re

import pytest
import torch

torch.set_num_threads(1)

from perfbench.disciplines.open_poisson import offsets  # noqa: E402
from perfbench.harness import inputs  # noqa: E402
from perfbench.harness.cells import Run, make_pool  # noqa: E402
from perfbench.harness.main import result_line  # noqa: E402
from perfbench.harness.manifest import NAME, PERFBENCH, ROOT, Cell, check_names, load, reader  # noqa: E402
from perfbench.roofline import b1  # noqa: E402
from perfbench.tests._tiny import manifest, tiny  # noqa: E402

MANIFEST = load()
WORKLOADS = [w["name"] for w in MANIFEST["workloads"]]
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_manifest_keys_and_names():
    assert set(MANIFEST) == TOP_KEYS
    assert MANIFEST["paths"] == ["perfbench"]
    assert MANIFEST["command"] == ["python3", "perfbench/run.py"]
    assert check_names(MANIFEST) == []
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert len(json.dumps(MANIFEST)) < 64 * 1024


def test_run_seconds_fit_the_check():
    per_run = MANIFEST["run_seconds"] + 60
    assert (2 + 14 * 24) * per_run + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cell_finds_its_files(workload):
    cell = Cell(MANIFEST, workload)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in names
        assert callable(reader(m["name"]))
    assert set(cell.limits) >= {"sketch_gap", "draw_dev", "marginal_gap", "value_gap"}
    assert cell.kind.__name__ == f"perfbench.kinds.{cell.config['kind']}"
    assert cell.pattern.__name__ == f"perfbench.patterns.{cell.config['pattern']}"
    assert cell.discipline.__name__ == f"perfbench.disciplines.{cell.traffic['discipline']}"


@pytest.mark.parametrize("workload", [w["name"] for w in manifest()["workloads"]])
def test_every_key_of_a_cell_is_read(workload, tmp_path):
    """A configuration or mix key that no module reads is refused, as is a
    discipline of another kind of cell, so no key is a setting that
    changes nothing."""
    m = manifest()
    Cell(m, workload)
    entry = next(w for w in m["workloads"] if w["name"] == workload)
    config = next(c for c in m["configs"] if c["name"] == entry["config"])
    for folder in ("configs", "traffic", "limits"):
        (tmp_path / "perfbench" / folder).mkdir(parents=True)
    for name in (f"traffic/{entry['traffic']}.json", f"limits/{workload}.json"):
        (tmp_path / "perfbench" / name).write_text((PERFBENCH / name).read_text())
    data = json.loads((ROOT / config["file"]).read_text())
    (tmp_path / config["file"]).write_text(json.dumps(data | {"pattern_share": 0.5}))
    with pytest.raises(ValueError, match="no module reads"):
        Cell(m, workload, root=tmp_path)
    (tmp_path / config["file"]).write_text(json.dumps(data | {"cost": "wfr"}))
    with pytest.raises(ValueError, match="the reference judges"):
        Cell(m, workload, root=tmp_path)
    (tmp_path / config["file"]).write_text(json.dumps(data))
    Cell(m, workload, root=tmp_path)
    traffic = json.loads((PERFBENCH / "traffic" / f"{entry['traffic']}.json").read_text())
    other = "closed_clients" if data["kind"] == "estimate" else "closed_estimates"
    (tmp_path / "perfbench" / "traffic" / f"{entry['traffic']}.json").write_text(
        json.dumps(traffic | {"discipline": other}))
    with pytest.raises(ValueError, match="drives"):
        Cell(m, workload, root=tmp_path)


@pytest.mark.parametrize("metric", [m["name"] for m in MANIFEST["per_layer"]])
def test_readers_return_nothing_without_records(metric):
    assert reader(metric)({}) is None


def test_paths_hold_only_named_characters():
    for path in PERFBENCH.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel
        assert all(NAME.match(part) for part in rel.split("/")), rel


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_has_the_contract_keys(traced):
    cell = Cell(MANIFEST, "mf_n131072.log")
    run = Run(attempted=3, failed=0, setup_s=12.5, e2e={"estimate_ms": 200.0, "estimate_peak_gb": 1.5})
    checks = {"value_gap": {"value": math.inf, "limit": 1e-6}}
    line = result_line(cell, run, False, checks, traced, "NVIDIA H100 80GB HBM3", 1)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    json.loads(json.dumps(line, allow_nan=False))
    if not traced:
        assert set(line["metrics"]) == {"setup_s", "estimate_ms", "estimate_peak_gb"}


@pytest.mark.parametrize("workload", ["mf_n131072.log", "serve_mf.closed64"])
def test_seeds_reproduce_inputs(workload):
    big = 2**33 + 12345
    cell = tiny(workload)
    p1, p2 = make_pool(cell, big, "cpu"), make_pool(cell, big, "cpu")
    other = make_pool(cell, big + 1, "cpu")
    for key in ("x", "a", "b"):
        assert all(torch.equal(p[key], q[key]) for p, q in zip(p1, p2))
    assert not torch.equal(p1[0]["x"], other[0]["x"])
    # every seed gets the same work: the same sizes and kinds in the same order
    assert [(p["x"].shape, p["lam"]) for p in p1] == [(p["x"].shape, p["lam"]) for p in other]


def test_served_pool_holds_equal_shares():
    cell = tiny("serve_mf.closed64")
    pool = make_pool(cell, 7, "cpu")
    sizes = cell.config["sizes"]
    assert sorted(p["x"].shape[0] for p in pool) == sorted(sizes * (len(pool) // len(sizes)))
    assert sum(math.isinf(p["lam"]) for p in pool) == len(pool) // 2
    uot = [p for p in pool if not math.isinf(p["lam"])]
    assert all(abs(float(p["a"].sum()) - cell.config["mass_a"]) < 1e-9 for p in uot)


def test_arrivals_are_one_schedule_for_every_seed():
    d1 = offsets(20.0, 30.0, inputs.generator("cpu", inputs.SHARED, "arrivals"))
    d2 = offsets(20.0, 30.0, inputs.generator("cpu", inputs.SHARED, "arrivals"))
    d3 = offsets(20.0, 30.0, inputs.generator("cpu", inputs.SHARED, "trace-arrivals"))
    assert d1 == d2 and d1 != d3 and len(d1) == len(d3) == 600
    assert max(d1) < 30.0 and abs(max(d1) - max(d3)) < 30.0 / 600 * 10


def test_b1_bytes_at_the_main_path():
    assert b1.bytes_per_launch(131072, 5, 10_127_143) == 248_294_312
    assert abs(b1.bound_ms(131072, 5, 10_127_143) - 0.0741) < 1e-4
