"""The echocardiogram study on the port, on the CPU: `repro_torch.data.echo`,
`wfr_eta_for_density`, `core.geometry.wfr_log_kernel`, and
``examples_torch/echocardiogram.py`` (the example's measures and MDS, and
Table 1's ED prediction) held against the reference's
``repro.data``/``repro.core`` functions, ``examples/echocardiogram.py`` and
``benchmarks/bench_echo.py`` on the same numpy inputs.
"""
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# one intra-op thread a process: the suite runs under six xdist workers
torch.set_num_threads(1)

from repro.core import wfr_log_kernel as j_wfr_log_kernel
from repro.data import synth_echo_video as j_synth_echo_video
from repro.data import wfr_eta_for_density as j_wfr_eta_for_density
from repro_torch.core import wfr_log_kernel
from repro_torch.data import synth_echo_video, wfr_eta_for_density

ROOT = Path(__file__).resolve().parents[1]


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def example():
    return _load(ROOT / "examples_torch" / "echocardiogram.py", "torch_echocardiogram_example")


@pytest.fixture(scope="module")
def bench_echo():
    # bench_echo imports ``benchmarks.common``: the repo root goes on sys.path
    import sys

    sys.path.insert(0, str(ROOT))
    try:
        yield _load(ROOT / "benchmarks" / "bench_echo.py", "reference_bench_echo")
    finally:
        sys.path.remove(str(ROOT))


@pytest.mark.parametrize(
    "kw",
    [
        dict(n_frames=24, size=48, period=10, seed=0),
        dict(n_frames=24, size=48, period=10, seed=1, failure=0.8),
        dict(n_frames=30, size=32, period=7, seed=2, arrhythmia=0.5),
        dict(n_frames=13, size=17, period=5, seed=3, noise=0.1, arrhythmia=0.2),
    ],
    ids=["healthy", "failure", "arrhythmia", "odd_size"],
)
def test_synth_echo_video_is_bitwise_the_reference(kw):
    video, t_ed, t_es = synth_echo_video(**kw)
    j_video, j_t_ed, j_t_es = j_synth_echo_video(**kw)
    assert video.dtype == j_video.dtype == np.float32
    assert np.array_equal(video, j_video)
    assert (t_ed, t_es) == (j_t_ed, j_t_es)
    assert t_ed and t_es


@pytest.mark.parametrize("density", [0.7, 0.5, 0.3])
def test_wfr_eta_for_density_is_the_reference(density):
    x = np.random.default_rng(5).uniform(size=(40, 3))
    assert wfr_eta_for_density(x, density) == j_wfr_eta_for_density(x, density)


@pytest.mark.parametrize("eps", [1.0, 0.01])
def test_wfr_log_kernel_matches_the_reference(eps):
    rng = np.random.default_rng(7)
    x, y = rng.uniform(size=(30, 2)), rng.uniform(size=(25, 2))
    eta = 0.1  # about three quarters of the pairs lie beyond pi * eta
    got = wfr_log_kernel(torch.as_tensor(x), torch.as_tensor(y), eta=eta, eps=eps).numpy()
    want = np.asarray(j_wfr_log_kernel(jnp.asarray(x), jnp.asarray(y), eta=eta, eps=eps))
    blocked = np.isneginf(want)
    assert 0 < blocked.sum() < blocked.size
    assert np.array_equal(np.isneginf(got), blocked)
    np.testing.assert_allclose(got[~blocked], want[~blocked], rtol=1e-12, atol=0)
    # from distances, and from x alone (y = x)
    d = np.sqrt(((x[:, None, :] - y[None, :, :]) ** 2).sum(-1))
    got_d = wfr_log_kernel(None, d=torch.as_tensor(d), eta=eta, eps=eps).numpy()
    want_d = np.asarray(j_wfr_log_kernel(None, d=jnp.asarray(d), eta=eta, eps=eps))
    assert np.array_equal(np.isneginf(got_d), np.isneginf(want_d))
    fin = ~np.isneginf(want_d)
    np.testing.assert_allclose(got_d[fin], want_d[fin], rtol=1e-12, atol=0)
    got_x = wfr_log_kernel(torch.as_tensor(x), eta=eta, eps=eps).numpy()
    want_x = np.asarray(j_wfr_log_kernel(jnp.asarray(x), eta=eta, eps=eps))
    assert np.array_equal(np.isneginf(got_x), np.isneginf(want_x))
    fin = ~np.isneginf(want_x)
    np.testing.assert_allclose(got_x[fin], want_x[fin], rtol=1e-12, atol=0)


def test_wfr_log_kernel_places_numpy_data_by_the_device_rule(monkeypatch):
    x = np.random.default_rng(0).uniform(size=(8, 2))
    assert wfr_log_kernel(x, eta=0.2, device="cpu").device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        wfr_log_kernel(x, eta=0.2)


def test_frame_measure_and_mds_are_the_reference_example(example):
    j_example = _load(ROOT / "examples" / "echocardiogram.py", "reference_echocardiogram_example")
    video, *_ = synth_echo_video(n_frames=8, size=36, period=6, seed=4)
    for stride in (1, 3, 4):
        mass, pts = example.frame_measure(video[3], stride, device="cpu")
        j_mass, j_pts = j_example.frame_measure(video[3], stride)
        assert mass.dtype == torch.float64
        assert np.array_equal(mass.numpy(), np.asarray(j_mass))
        assert np.array_equal(pts, j_pts)
    D = np.abs(np.random.default_rng(1).normal(size=(9, 9)))
    D = D + D.T
    np.fill_diagonal(D, 0.0)
    assert np.array_equal(example.classical_mds(D), j_example.classical_mds(D))


def _recording(monkeypatch, bench_echo):
    """Record each distance that ``bench_echo._predict_ed`` computes, in order."""
    seen = []
    dist = bench_echo._dist

    def recorded(*args, **kwargs):
        seen.append(dist(*args, **kwargs))
        return seen[-1]

    monkeypatch.setattr(bench_echo, "_dist", recorded)
    return seen


@pytest.mark.parametrize("pooled", [False, True], ids=["orig", "pooled"])
def test_predict_ed_sinkhorn_is_bench_echo(example, bench_echo, monkeypatch, pooled):
    seen = _recording(monkeypatch, bench_echo)
    video, t_es, t_ed = example.table1_video(1, 48 if pooled else 24, pooled)
    j_err = bench_echo._predict_ed(video, t_es, t_ed, "sinkhorn", jax.random.PRNGKey(0), 3, 16)
    pred = example.predict_ed(video, t_es, t_ed, "sinkhorn", (0, 1), 3, 16, device="cpu")
    assert list(pred.dists) == sorted(pred.dists)
    np.testing.assert_allclose(list(pred.dists.values()), seen, rtol=1e-10, atol=0)
    j_t_hat = list(pred.dists)[int(np.argmax(seen))]
    assert pred.t_hat == j_t_hat
    assert pred.error == j_err
    assert list(pred.solves) == list(pred.dists) and all(len(r) == 1 for r in pred.solves.values())
    assert all(n_iter > 0 and status in ("converged", "stall", "max_iter")
               for ((n_iter, status),) in pred.solves.values())


@pytest.mark.parametrize("nan_at", [0, 2], ids=["first_candidate", "later_candidate"])
def test_predict_ed_fails_where_a_candidate_distance_is_not_finite(example, monkeypatch, nan_at):
    """A NaN candidate distance makes no prediction, whether the
    reference's ``max`` would pick it (first) or skip it (later)."""
    video, t_es, t_ed = example.table1_video(1, 24)
    calls = []

    def fake(a, b, C, method, seed, s, n_seeds=2):
        calls.append(seed[-1])
        return (math.nan if len(calls) - 1 == nan_at else float(len(calls))), [(1, "stall")]

    monkeypatch.setattr(example, "echo_distance", fake)
    pred = example.predict_ed(video, t_es, t_ed, "rand_sink", (0, 1), 3, 16, device="cpu")
    assert len(calls) > nan_at and math.isnan(pred.dists[calls[nan_at]])
    assert pred.t_hat is None and math.isnan(pred.error)


def test_spar_sink_distance_lies_within_the_band_of_the_dense_one(example):
    """The band of ``tests/test_system.py::test_spar_sink_wfr_matches_dense_wfr``
    on Table 1's own pair: the ES frame and the ED frame of one cycle."""
    video, t_es, t_ed = example.table1_video(1, 24)
    a, pts = example.frame_measure(video[t_es], 3, device="cpu")
    b, _ = example.frame_measure(video[t_ed], 3, device="cpu")
    C = example.wfr_cost(torch.as_tensor(pts), eta=example.ETA)
    s = 16 * example.s0(pts.shape[0])
    dense, _ = example.echo_distance(a, b, C, "sinkhorn", (0,), s)
    sparse, solves = example.echo_distance(a, b, C, "spar_sink", (0,), s, n_seeds=5)
    assert len(solves) == 5
    assert abs(sparse - dense) / abs(dense) < 0.25
    uniform, _ = example.echo_distance(a, b, C, "rand_sink", (0,), s, n_seeds=2)
    assert math.isfinite(uniform)
    with pytest.raises(ValueError, match="unknown method"):
        example.echo_distance(a, b, C, "greenkhorn", (0,), s)


def test_generator_is_a_function_of_the_integers(example):
    draw = lambda *path: torch.rand(4, generator=example.generator("cpu", *path))
    assert torch.equal(draw(0, 1, 2), draw(0, 1, 2))
    assert not torch.equal(draw(0, 1, 2), draw(0, 2, 1))
