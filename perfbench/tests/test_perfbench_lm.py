"""The language-model cell and the kinds' own references: a whole run of
`mamba2_130m.gen_b512` cut to the program's ``:smoke`` size, judged
correct, and not correct under the control and under each fault its kind
plants (perfbench/harness/lm_faults.py); the reference's recurrence
against the quadratic (masked-matrix) form of the SSD; a kind judged by
the reference it names; the served log-domain cell's run and faults."""
import json
import math
import types

import pytest
import torch

torch.set_num_threads(1)

from perfbench.harness import lm_faults  # noqa: E402
from perfbench.harness.judge import judge, readings  # noqa: E402
from perfbench.harness.cells import Run  # noqa: E402
from perfbench.harness.manifest import PERFBENCH, ROOT, Cell  # noqa: E402
from perfbench.kinds import lm_decode  # noqa: E402
from perfbench.reference import spar_sink, ssm_lm  # noqa: E402
from perfbench.roofline import ssm_decode  # noqa: E402
from perfbench.tests._tiny import SEED, drive, manifest, tiny  # noqa: E402

LM = "mamba2_130m.gen_b512"


@pytest.mark.parametrize("seed", [SEED, 2**31 + 7])
def test_sound_decode_is_correct(seed):
    correct, checks = drive(LM, seed=seed)
    assert correct, checks


@pytest.mark.parametrize("fault", lm_faults.FAULTS)
def test_decode_fault_is_not_correct(fault):
    correct, checks = drive(LM, fault)
    assert not correct, checks


def test_decode_control_is_not_correct(monkeypatch):
    """At the smoke widths and the cell's depth, where the control's float8
    error adds up over the layers as it does at full size."""
    import gc

    from repro_torch import configs

    cell = tiny(LM)
    depth = Cell(manifest(), LM).config["n_layer"]
    deep = configs.get(cell.config["arch"]).replace(num_layers=depth)
    monkeypatch.setattr(configs, "get", lambda name: deep)
    cell.config["n_layer"] = depth
    items = cell.kind.control(cell, SEED, torch.device("cpu"))
    gc.unfreeze()
    got = readings(items, cell.kind.REFERENCE)
    assert any(got[k] > cell.limits[k]["limit"] for k in ssm_lm.NUMBERS), got


def _quadratic_ssd(x, dt, A, B, C, D):
    """y = (L o C B^T) (dt x) + D x, L[t, s] = exp(cum_t - cum_s) for s <= t."""
    cum = torch.cumsum(dt * A, 0)  # (S, H)
    s = x.shape[0]
    diff = cum[:, None, :] - cum[None, :, :]  # (t, s, H)
    mask = torch.tril(torch.ones(s, s, dtype=torch.bool))[:, :, None]
    L = torch.where(mask, torch.exp(torch.where(mask, diff, 0.0)), 0.0)
    w = (C @ B.T)[:, :, None] * L * dt[None, :, :]  # (t, s, H)
    return torch.einsum("tsh,shp->thp", w, x) + D[None, :, None] * x


def test_recurrence_is_the_quadratic_ssd():
    g = torch.Generator().manual_seed(3)
    s, h, n, p = 24, 3, 5, 4
    x = torch.randn((s, h, p), generator=g, dtype=torch.float64)
    dt = torch.rand((s, h), generator=g, dtype=torch.float64) * 0.5
    A = -torch.rand(h, generator=g, dtype=torch.float64) * 4 - 0.1
    B, C = torch.randn((s, n), generator=g, dtype=torch.float64), torch.randn((s, n), generator=g, dtype=torch.float64)
    D = torch.randn(h, generator=g, dtype=torch.float64)
    got = ssm_lm.ssd_scan(x, dt, A, B, C, D, state_dtype=torch.float64)
    torch.testing.assert_close(got, _quadratic_ssd(x, dt, A, B, C, D), rtol=1e-12, atol=1e-12)


def test_a_kind_is_judged_by_the_reference_it_names():
    seen = []

    def own_judge(inputs, out):
        seen.append((inputs, out))
        return {"a_gap": out, "b_gap": 2 * out}

    own = types.SimpleNamespace(NUMBERS=("b_gap", "a_gap"), judge=own_judge)
    cell = types.SimpleNamespace(kind=types.SimpleNamespace(REFERENCE=own),
                                 limits={"a_gap": {"limit": 1.0}, "b_gap": {"limit": 1.0}})
    ok, checks = judge(cell, Run(items=[("i1", 0.25), ("i2", 0.5)]))
    assert seen == [("i1", 0.25), ("i2", 0.5)]
    assert list(checks) == ["b_gap", "a_gap", "failed"] and checks["b_gap"]["value"] == 1.0 and ok
    ok, checks = judge(cell, Run(items=[("i1", 0.25), ("i3", None)]))
    assert not ok and math.isinf(checks["a_gap"]["value"])


@pytest.mark.parametrize("workload", [w["name"] for w in manifest()["workloads"]])
def test_each_kind_names_its_reference_faults_and_control(workload):
    kind = Cell(manifest(), workload).kind
    assert kind.REFERENCE is (ssm_lm if kind is lm_decode else spar_sink)
    assert callable(kind.control) and callable(kind.FAULTS.planted) and kind.FAULTS.FAULTS


def test_an_lm_configuration_needs_no_cost_and_reads_every_key(tmp_path):
    m = manifest()
    config = next(c for c in m["configs"] if c["name"] == "mamba2_130m")
    data = json.loads((ROOT / config["file"]).read_text())
    assert "cost" not in data
    for folder in ("configs", "traffic", "limits"):
        (tmp_path / "perfbench" / folder).mkdir(parents=True)
    for name in ("traffic/gen_b512.json", f"limits/{LM}.json"):
        (tmp_path / "perfbench" / name).write_text((PERFBENCH / name).read_text())
    (tmp_path / config["file"]).write_text(json.dumps(data))
    Cell(m, LM, root=tmp_path)
    (tmp_path / config["file"]).write_text(json.dumps(data | {"rope_theta": 10000.0}))
    with pytest.raises(ValueError, match="no module reads"):
        Cell(m, LM, root=tmp_path)
    (tmp_path / config["file"]).write_text(json.dumps(data | {"d_state": 64}))
    with pytest.raises(ValueError, match="differs from the file"):
        Cell(m, LM, root=tmp_path)


def test_judged_sequences_fall_in_distinct_halves():
    cell = Cell(manifest(), LM)
    half = cell.traffic["batch"] // 2
    for seed in (1, 2**40 + 3, 7):
        got = lm_decode.sample(cell, seed)
        assert len(got) == cell.traffic["sample"] == len({(b, r // half) for b, r in got})
        assert all(0 <= b < cell.traffic["sample_from"] and 0 <= r < cell.traffic["batch"] for b, r in got)
    assert lm_decode.sample(cell, 5) == lm_decode.sample(cell, 5) != lm_decode.sample(cell, 6)
    kept = lm_decode.kept_positions(cell.traffic)
    steps = cell.traffic["prompt_len"] + cell.traffic["gen_len"]
    assert len(kept) >= 64 and kept[-16:] == list(range(steps - 16, steps))


def test_decode_counts_at_mamba2_130m():
    dims = lm_decode.dims(Cell(manifest(), LM).config)
    body, emb = ssm_decode.params(dims)
    assert (body, emb) == (90_325_440, 38_615_040)
    assert ssm_decode.state_bytes(dims, 512) == 9_927_917_568
    assert abs(ssm_decode.step_min_ms(dims, 512) - 6.0348) < 1e-3
    assert ssm_decode.step_min_bytes(dims, 64) == 2_752_732_032
    assert abs(ssm_decode.step_flops(dims, 512) / 512 - (2 * body + 2 * 768 * 50280 + 6 * 24 * 24 * 128 * 64)) < 1


def test_weights_come_from_the_seed():
    cell = tiny(LM)
    vocab = lm_decode.vocab_rows(cell.config)

    def draw(seed):
        from perfbench.harness.inputs import generator

        return cell.pattern.make(cell.config, vocab, "cpu", generator("cpu", seed, "weights"))

    a, b, c = draw(2**33 + 1), draw(2**33 + 1), draw(2**33 + 2)
    assert torch.equal(a["blocks"][1]["ssm"]["in_proj"]["w"], b["blocks"][1]["ssm"]["in_proj"]["w"])
    assert not torch.equal(a["embed"]["w"], c["embed"]["w"])
    a_log = a["blocks"][0]["ssm"]["A_log"]
    assert float(a_log.exp().min()) >= 1 and float(a_log.exp().max()) <= 16


def test_served_log_cell_runs_in_the_log_domain():
    cell = tiny("serve_mf.log")
    assert cell.traffic["stabilize"] is True
    assert {k: v for k, v in cell.traffic.items() if k not in ("stabilize", "about")} == \
        {k: v for k, v in tiny("serve_mf.closed64").traffic.items() if k not in ("stabilize", "about")}


def test_served_log_cell_is_correct():
    correct, checks = drive("serve_mf.log")
    assert correct, checks


@pytest.mark.parametrize("fault", ["unchanged_step", "half_draw", "half_batch", "altered_value"])
def test_served_log_fault_is_not_correct(fault):
    correct, checks = drive("serve_mf.log", fault)
    assert not correct, checks
