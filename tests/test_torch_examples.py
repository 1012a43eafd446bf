"""The seven examples of ``examples_torch/``, on the CPU at small sizes.

Each example's ``main`` runs with ``--device cpu``; with no card and no
``--device`` each raises instead of falling back to the CPU. The examples
are loaded by path: ``examples_torch/`` is not a package. The SSAE's
divergence keeps finite gradients where its sparse plan is zero, and the
MoE trainer's ~100M config is the reference's field for field.
"""
import dataclasses
import importlib.util
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

# one intra-op thread a process: the suite runs under six xdist workers
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "color_transfer", "barycenter", "echocardiogram", "batch_serving", "ssae",
            "train_moe_sinkhorn")
FORBIDDEN = re.compile(r"^\s*(import jax|from jax|import repro\b(?!_torch)|from repro\b(?!_torch))", re.M)


def load(name: str, folder: str = "examples_torch"):
    spec = importlib.util.spec_from_file_location(f"{folder}_{name}", ROOT / folder / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_reference_example_has_a_counterpart_that_imports_neither_jax_nor_the_reference():
    assert sorted(p.stem for p in (ROOT / "examples").glob("*.py")) == sorted(EXAMPLES)
    for name in EXAMPLES:
        assert not FORBIDDEN.search((ROOT / "examples_torch" / f"{name}.py").read_text()), name


@pytest.mark.parametrize("name", EXAMPLES)
def test_without_a_card_the_default_device_raises(name, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--out-dir", str(tmp_path)] if name in ("echocardiogram", "train_moe_sinkhorn") else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load(name).main(argv)


def test_quickstart(capsys):
    out = load("quickstart").main(["--device", "cpu", "--n", "200"])
    text = capsys.readouterr().out
    assert "registered solvers: dense, greenkhorn, log" in text
    assert "sparse plan: SparsePlan" in text and "diagnostics summary:" in text
    assert out["recovered"]
    for truth, value in (out["ot"], out["uot"]):
        assert math.isfinite(truth) and math.isfinite(value)
    assert abs(out["uot"][1] - out["uot"][0]) < 0.1 * abs(out["uot"][0])


def test_color_transfer(capsys):
    out = load("color_transfer").main(["--device", "cpu", "--n", "300"])
    assert "transferred RGB" in capsys.readouterr().out
    assert 0 <= out["color_diff"] < 0.2


def test_barycenter(capsys):
    out = load("barycenter").main(["--device", "cpu", "--n", "160"])
    text = capsys.readouterr().out
    assert "IBP:" in text and "Spar-IBP s=20x s0" in text
    assert out["ibp_iters"] > 0
    assert all(0 <= e < 2 for e in out["l1_err"].values())


def test_batch_serving_is_bitwise(capsys):
    out = load("batch_serving").main(["--device", "cpu", "--problems", "8", "--sizes", "48,64"])
    text = capsys.readouterr().out
    assert "bitwise identical: True" in text
    assert "values match batched dispatch: True" in text
    assert out["bitwise"] and out["served_match"]


def test_echocardiogram_distance_matrix(capsys, tmp_path):
    out = load("echocardiogram").main(["--device", "cpu", "--frames", "5", "--size", "16", "--stride", "4",
                                       "--out-dir", str(tmp_path)])
    text = capsys.readouterr().out
    assert set(out) == {"healthy", "heart_failure", "arrhythmia"}
    for name, D in out.items():
        assert f"[{name}] frames=5" in text
        assert D.shape == (5, 5) and np.array_equal(D, D.T) and np.all(np.isfinite(D))
        assert np.all(np.diag(D) == 0) and np.all(D[~np.eye(5, dtype=bool)] >= 0)
    pytest.importorskip("matplotlib")
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "echo_distance_arrhythmia.png", "echo_distance_healthy.png", "echo_distance_heart_failure.png"]


def test_ssae_loss_is_finite(capsys):
    out = load("ssae").main(["--device", "cpu", "--steps", "3", "--batch", "64"])
    text = capsys.readouterr().out
    assert "step   0  loss" in text and "step   2  loss" in text and "final latent mean" in text
    assert all(math.isfinite(v) for v in out.values())


def test_ssae_gradients_are_finite_where_the_plan_is_zero():
    ssae = load("ssae")
    gen = torch.Generator().manual_seed(3)
    x = ssae.data_batch(gen, 64).requires_grad_()
    y = torch.randn((64, 2), dtype=torch.float64, generator=gen).requires_grad_()
    div = ssae.spar_sink_divergence_fixed(gen, x, y)
    gx, gy = torch.autograd.grad(div, (x, y))
    assert torch.isfinite(div) and torch.all(torch.isfinite(gx)) and torch.all(torch.isfinite(gy))
    # the entropy term alone on a plan with zeros: the double where gives a
    # finite gradient, the single one NaN
    T = torch.tensor([[0.25, 0.0], [0.0, 0.75]], dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(ssae.entropy_term(T), T)
    assert torch.all(torch.isfinite(g)) and torch.all(g[T == 0] == 0)
    single = torch.sum(torch.where(T > 0, T * (torch.log(T) - 1), 0.0))
    (g_single,) = torch.autograd.grad(single, T)
    assert torch.isnan(g_single[T == 0]).all()


def _keep_all(monkeypatch, mod):
    """Both SSAE examples at s = 1e30: p* = min(1, s p) = 1 on every entry,
    so the real sketch keeps all of K with weight 1 (K~ = K, no draw left
    to chance) and both packages run the same arithmetic."""
    monkeypatch.setattr(mod, "s0", lambda n: 1e30)
    return mod


@pytest.mark.parametrize("fn", ["_ot_eps_fixed", "spar_sink_divergence_fixed"])
@pytest.mark.parametrize("far", [False, True], ids=["near", "far_point"])
def test_ssae_divergence_and_its_gradients_are_the_reference(monkeypatch, fn, far):
    """The SSAE's OT_eps and divergence, and their gradients in x and y,
    against ``examples/ssae.py`` on the same float64 inputs and keep-all
    sketch. ``far_point`` moves one point of x far enough that its row of
    K underflows to 0, so the plan has zeros and the entropy term's double
    ``where`` is on the path."""
    import jax
    import jax.numpy as jnp

    ref = _keep_all(monkeypatch, load("ssae", "examples"))
    port = _keep_all(monkeypatch, load("ssae"))
    rng = np.random.default_rng(5)
    x, y = rng.normal(size=(48, 2)), rng.normal(size=(48, 2))
    if far:
        x[7] = (30.0, -30.0)
    j_val, (j_gx, j_gy) = jax.value_and_grad(lambda a, b: getattr(ref, fn)(jax.random.PRNGKey(0), a, b),
                                             argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    tx, ty = (torch.tensor(v, requires_grad=True) for v in (x, y))
    val = getattr(port, fn)(torch.Generator().manual_seed(0), tx, ty)
    gx, gy = torch.autograd.grad(val, (tx, ty))
    if far:
        T_zero = float(torch.exp(-port.squared_euclidean_cost(tx, ty)[7].detach() / port.EPS).max())
        assert T_zero == 0.0
    np.testing.assert_allclose(val.item(), float(j_val), rtol=1e-10, atol=0)
    np.testing.assert_allclose(gx.numpy(), np.asarray(j_gx), rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(gy.numpy(), np.asarray(j_gy), rtol=1e-10, atol=1e-14)
    assert np.all(np.isfinite(gx.numpy())) and np.all(np.isfinite(gy.numpy()))


def test_train_moe_sinkhorn_two_steps(capsys, tmp_path):
    mod = load("train_moe_sinkhorn")
    out = mod.main(["--device", "cpu", "--steps", "2", "--out-dir", str(tmp_path)])
    text = capsys.readouterr().out
    assert "with router=spar_sink" in text
    assert [step for step, _ in out["history"]] == [0, 1]
    assert all(math.isfinite(m["loss"]) for _, m in out["history"])
    assert any(tmp_path.iterdir())  # the final checkpoint
    # a rerun with the same directory resumes instead of starting over
    again = mod.main(["--device", "cpu", "--steps", "3", "--out-dir", str(tmp_path)])
    assert "resumed from step 2" in capsys.readouterr().out
    assert [step for step, _ in again["history"]] == [2]
    done = mod.main(["--device", "cpu", "--steps", "3", "--out-dir", str(tmp_path)])
    assert done["history"] == [] and "nothing to train" in capsys.readouterr().out
    # a mesh of two devices needs a process group of two ranks (torchrun)
    with pytest.raises(RuntimeError, match="process group of 2 ranks"):
        mod.main(["--device", "cpu", "--mesh", "2x1", "--out-dir", str(tmp_path)])


def test_hundred_m_config_is_the_reference_field_for_field():
    ref = load("train_moe_sinkhorn", "examples").HUNDRED_M
    port = load("train_moe_sinkhorn").HUNDRED_M
    ref_fields = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
    port_fields = {f.name: getattr(port, f.name) for f in dataclasses.fields(port)}
    assert port_fields == ref_fields
    from repro_torch.models import init_params, param_count

    assert param_count(init_params(port, 0, device="meta")) == 142_680_576
