"""Port parity: sharded runs on a 2x4 gloo mesh (8 CPU processes).

The counterparts of the reference's ``tests/test_distributed.py``, which
runs its meshes on 8 host devices in a subprocess. Here the 8 ranks are
real gloo processes, started twice: once by this file run as a script
(``launch_ranks``; every scenario below, one after another) and once by
the train CLI's own launcher for the preemption drill.

Tolerances:

* the sharded ``qwen3_14b:smoke`` and ``mamba2_130m:smoke`` float32
  forwards against the port's single-device forward and against the JAX
  package's, and four decode steps of each against the single-device
  steps, all at ``rtol = atol = 1e-4`` (the reference's test's
  tolerance): the sharded products sum in another order;
* the sharded ``recurrentgemma_2b:smoke`` train step (the LRU scan through
  its `local_map`, kernels B5/B6's plain versions here) and the sharded
  ``olmoe_1b_7b:smoke`` step against the unsharded steps, float32, three
  steps: the losses and the global gradient
  norm at ``rtol = 1e-5``, every parameter after step 3 at ``rtol = 1e-4``
  and an atol of ``lr / 10`` (the same other orders of summation,
  compounded by AdamW's normalised update ``m / sqrt(v)``, which turns a
  rounding difference in a near-zero gradient into a step difference of
  a fraction of ``lr``);
* elastic restore and ``BucketedExecutor(mesh=)`` bitwise.
"""
import os
import pickle
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

# one intra-op thread a process: the suite runs under six xdist workers
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
MESH = (2, 4)
FWD_TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_RTOL = 1e-5
LR = 1e-3
PARAM_TOL = dict(rtol=1e-4, atol=LR / 10)
TRAIN_STEPS = 3
DECODE_STEPS = 4
STREAM = dict(sizes=(96, 128), count=6, seed=26)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env["OMP_NUM_THREADS"] = "1"
    return env


# --------------------------------------------------------------------------
# the ranks' work (this file run as a script)
# --------------------------------------------------------------------------


def _stream_problems():
    from repro_torch import OTProblem, PointCloudGeometry, UOTProblem

    rng = np.random.default_rng(STREAM["seed"])
    out = []
    for i in range(STREAM["count"]):
        n = STREAM["sizes"][i % 2]
        g = PointCloudGeometry(rng.uniform(size=(n, 3)), device="cpu")
        a, b = rng.dirichlet(np.ones(n)), rng.dirichlet(np.ones(n))
        out.append(UOTProblem(g, a * 5.0, b * 3.0, 0.1, lam=0.5) if i % 2 else OTProblem(g, a, b, 0.1))
    return out


def _rank_work(workdir: str) -> None:
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch import configs, interop
    from repro_torch.batch import BucketedExecutor
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import s0
    from repro_torch.distributed import batch_specs, decode_state_specs, distribute, param_specs, use_mesh
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import lm
    from repro_torch.obs import MetricsRegistry
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.step import init_train_state, make_serve_step, make_train_step, place_batch
    from repro_torch.tree import leaves

    rank = dist.get_rank()
    mesh = make_test_mesh(*MESH, device_type="cpu")
    out = {}
    full = lambda t: (t.full_tensor() if isinstance(t, DTensor) else t).detach().numpy()  # noqa: E731

    def forward_both(cfg, params, tok):
        with use_mesh(mesh):
            dparams = distribute(params, mesh, param_specs(params, cfg, mesh))
            dtok = distribute({"t": tok}, mesh, batch_specs(cfg, mesh, {"t": tok}))["t"]
            sharded = full(lm.forward(dparams, dtok, cfg)[0])
        return sharded, lm.forward(params, tok, cfg)[0].numpy()

    def decode_both(cfg, params, tok):
        """The logits of DECODE_STEPS decode steps fed ``tok``'s columns, the
        state placed by `decode_state_specs` on the mesh, and on one device."""
        got = []
        for m in (mesh, None):
            state = lm.init_decode_state(cfg, tok.shape[0], DECODE_STEPS, dtype=torch.float32, device="cpu")
            p = params
            if m is not None:
                p = distribute(params, m, param_specs(params, cfg, m))
                state = distribute(state, m, decode_state_specs(cfg, m, state, tok.shape[0]))
            step = make_serve_step(cfg, m)
            logits = []
            for i in range(DECODE_STEPS):
                lg, state = step(p, state, place_batch({"tokens": tok[:, i : i + 1]}, cfg, m)["tokens"], i)
                logits.append(full(lg))
            got.append(np.stack(logits))
        return got

    def train_both(cfg, tcfg, batch):
        """TRAIN_STEPS steps on the mesh and on one device from one seed: the
        (loss, grad_norm) of each step and the parameters after the last."""
        got = {}
        for name, m in (("sharded", mesh), ("single", None)):
            state = init_train_state(cfg, tcfg, 0, device="cpu", mesh=m)
            step = make_train_step(cfg, tcfg, m)
            hist = []
            for _ in range(TRAIN_STEPS):
                state, metrics = step(state, batch)
                hist.append([float(full(metrics[k])) for k in ("loss", "grad_norm")])
            got[f"{name}_metrics"] = np.asarray(hist)
            got[f"{name}_params"] = [full(p) for p in leaves(state.params)]
            if m is not None:
                got["placements"] = sorted({str(p.placements) for p in leaves(state.params)})
                got["moment_placed"] = all(a.placements == b.placements
                                           for a, b in zip(leaves(state.params), leaves(state.opt.m)))
        return got

    # (1) the sharded forward and decode, on the reference's weights
    for arch in ("qwen3_14b:smoke", "mamba2_130m:smoke"):
        key = arch.split("_")[0]
        with open(os.path.join(workdir, f"{key}.pkl"), "rb") as f:
            ref_params, tokens = pickle.load(f)
        cfg = configs.get(arch).replace(dtype="float32")
        params = interop.lm_params_from_numpy(ref_params, cfg, device="cpu")
        tok = torch.as_tensor(tokens)
        out[f"{key}_sharded"], out[f"{key}_single"] = forward_both(cfg, params, tok)
        out[f"{key}_decode_sharded"], out[f"{key}_decode_single"] = decode_both(cfg, params, tok)

    # (2) the RecurrentGemma and MoE train steps, sharded and not
    cfg = configs.get("recurrentgemma_2b:smoke").replace(dtype="float32", rglru_backend="pallas")
    tcfg = TrainConfig(seq_len=32, global_batch=8, lr=LR, warmup_steps=0, total_steps=10)
    batch = {"tokens": torch.as_tensor(np.random.default_rng(5).integers(0, cfg.vocab_size, (8, 32)))}
    out["rg"] = train_both(cfg, tcfg, batch)
    cfg = configs.get("olmoe_1b_7b:smoke").replace(dtype="float32")
    out["moe"] = train_both(cfg, tcfg, batch)

    # (3) elastic restore: saved from one device, restored onto the 2x4 mesh
    cfg = configs.get("stablelm_3b:smoke")
    params = lm.init_params(cfg, 0, device="cpu")
    ckpt.save_checkpoint(os.path.join(workdir, "ckpt"), 1, params)
    meta = lm.init_params(cfg, device="meta")
    target = distribute(meta, mesh, param_specs(meta, cfg, mesh))
    back = ckpt.restore_checkpoint(os.path.join(workdir, "ckpt"), 1, target)
    out["restore_equal"] = all(torch.equal(a, b.full_tensor()) for a, b in zip(leaves(params), leaves(back)))
    out["restore_sharded"] = sum(b.to_local().numel() < b.numel() for b in leaves(back))
    out["restore_placed"] = all(a.placements == b.placements for a, b in zip(leaves(target), leaves(back)))
    # and by a placements tree on plain meta targets
    back2 = ckpt.restore_checkpoint(os.path.join(workdir, "ckpt"), 1, meta, mesh=mesh,
                                    placements=param_specs(meta, cfg, mesh))
    out["restore_by_specs_equal"] = all(torch.equal(a, b.full_tensor()) for a, b in zip(leaves(params), leaves(back2)))

    # (4) the sharded executor against mesh=None, spar_sink_mf
    problems = _stream_problems()
    kw = dict(s=8 * s0(128), tol=1e-9, max_iter=3000)
    seeds = list(range(40, 40 + len(problems)))
    sharded = BucketedExecutor(mesh=mesh, metrics=MetricsRegistry()).solve_batch(
        problems, method="spar_sink_mf", seeds=seeds, **kw)
    single = BucketedExecutor(metrics=MetricsRegistry()).solve_batch(problems, method="spar_sink_mf", seeds=seeds, **kw)
    same = []
    for a, b in zip(sharded, single):
        fields = [(a.result.u, b.result.u), (a.result.v, b.result.v), (a.value, b.value), (a.n_iter, b.n_iter),
                  (a.status, b.status), (a.nnz, b.nnz)]
        pa, pb = a.plan(), b.plan()
        fields += [(getattr(pa, f), getattr(pb, f)) for f in ("rows", "cols", "vals")]
        same.append(all(torch.equal(x, y) for x, y in fields))
    out["executor_bitwise"] = same

    if rank == 0:
        with open(os.path.join(workdir, "out.pkl"), "wb") as f:
            pickle.dump(out, f)


if __name__ == "__main__":
    sys.path.insert(0, SRC)
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import launch_ranks

    sys.exit(launch_ranks(_rank_work, MESH[0] * MESH[1], "cpu", sys.argv[1]))


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run every scenario once on the 2x4 gloo mesh; the reference's
    forward on the same weights beside it."""
    import jax

    from repro import configs as jconfigs
    from repro.models import lm as jlm

    work = tmp_path_factory.mktemp("mesh2x4")
    want = {}
    for arch in ("qwen3_14b:smoke", "mamba2_130m:smoke"):
        key = arch.split("_")[0]
        jcfg = jconfigs.get(arch).replace(dtype="float32")
        jp = jax.tree.map(np.asarray, jlm.init_params(jax.random.PRNGKey(0), jcfg))
        tokens = np.random.default_rng(26).integers(0, jcfg.vocab_size, (8, 32))
        want[f"{key}_jax"] = np.asarray(jlm.forward(jp, tokens, jcfg)[0], np.float32)
        with open(work / f"{key}.pkl", "wb") as f:
            pickle.dump((jp, tokens), f)
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), str(work)], env=_env(),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-6000:]
    with open(work / "out.pkl", "rb") as f:
        out = pickle.load(f)
    out.update(want)
    return out


def _forward_matches(ranks, key):
    np.testing.assert_allclose(ranks[f"{key}_sharded"], ranks[f"{key}_single"], **FWD_TOL)
    np.testing.assert_allclose(ranks[f"{key}_sharded"], ranks[f"{key}_jax"], **FWD_TOL)
    np.testing.assert_allclose(ranks[f"{key}_single"], ranks[f"{key}_jax"], **FWD_TOL)


def test_sharded_forward_matches_single_device_and_the_reference(ranks):
    """Same weights, same tokens: the 2x4-sharded qwen3 forward (heads that
    do not divide the model axis replicated before the split) against the
    port's unsharded forward and the JAX package's."""
    _forward_matches(ranks, "qwen3")


def test_sharded_ssm_forward_matches_single_device_and_the_reference(ranks):
    """The same for mamba2_130m:smoke: the SSD's projection, chunk splits
    and chunk cumsum under the mesh."""
    _forward_matches(ranks, "mamba2")


@pytest.mark.parametrize("key", ["qwen3", "mamba2"])
def test_sharded_decode_matches_single_device(ranks, key):
    """DECODE_STEPS decode steps with the state placed by
    `decode_state_specs`: qwen3's K/V pinned with head_dim on the model
    axis (the scores summed over its shards), Mamba-2's state update on
    each rank's shards; every step's logits against one device's."""
    got, want = ranks[f"{key}_decode_sharded"], ranks[f"{key}_decode_single"]
    assert got.shape == want.shape and got.shape[0] == DECODE_STEPS
    np.testing.assert_allclose(got, want, **FWD_TOL)


def _train_matches(run):
    got, want = run["sharded_metrics"], run["single_metrics"]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert want[-1, 0] < want[0, 0]
    for a, b in zip(run["sharded_params"], run["single_params"], strict=True):
        np.testing.assert_allclose(a, b, **PARAM_TOL)
    assert any("Shard" in p for p in run["placements"]), run["placements"]
    assert run["moment_placed"]


def test_sharded_train_step_matches_the_unsharded_step(ranks):
    """Three AdamW steps of recurrentgemma_2b:smoke (the LRU scan through
    `local_map`) on the mesh and on one device: losses and the global
    gradient norm (a full reduction over the shards, not a local one), and
    every parameter after step 3; the moments placed as the parameters."""
    _train_matches(ranks["rg"])


def test_moe_train_step_runs_on_the_mesh(ranks):
    """The same for olmoe_1b_7b:smoke's step (the experts expert-parallel,
    the combine on each rank's sequences)."""
    _train_matches(ranks["moe"])


def test_elastic_restore_across_meshes(ranks):
    """A checkpoint saved from one device restores onto the 2x4 mesh: each
    leaf bitwise the saved array, placed as its target, and sharded."""
    assert ranks["restore_equal"] and ranks["restore_by_specs_equal"]
    assert ranks["restore_placed"]
    assert ranks["restore_sharded"] > 0


def test_sharded_executor_is_bitwise_mesh_none(ranks):
    """``BucketedExecutor(mesh=2x4)`` spreads each bucket over the data ranks
    by problem; every solution is bitwise the unsharded executor's."""
    assert ranks["executor_bitwise"] == [True] * STREAM["count"]


def test_launcher_preemption_drill_on_a_2x4_mesh(tmp_path):
    """The train CLI on ``--mesh 2x4`` (its own 8 gloo ranks): SIGTERM after
    the first logged step => every rank checkpoints the same step and the
    command exits 0; a rerun resumes from it, onto the mesh, and reaches
    the end."""
    from repro_torch.train.checkpoint import latest_step

    def cmd(steps):
        return [sys.executable, "-m", "repro_torch.launch.train", "--arch", "stablelm_3b:smoke",
                "--steps", str(steps), "--seq", "32", "--batch", "8", "--mesh", "2x4", "--device", "cpu",
                "--ckpt-dir", str(tmp_path), "--ckpt-every", "100000"]

    proc = subprocess.Popen(cmd(1_000_000), env=_env(), stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                            text=True)
    lines = []
    for line in proc.stdout:
        lines.append(line)
        if line.startswith("step "):
            proc.send_signal(signal.SIGTERM)
            break
    rest, _ = proc.communicate(timeout=300)
    out = "".join(lines) + rest
    assert proc.returncode == 0, out
    assert "checkpointed at step" in out, out
    saved = latest_step(str(tmp_path))
    assert saved is not None and saved > 0, (saved, out)

    again = subprocess.run(cmd(saved + 2), env=_env(), capture_output=True, text=True, timeout=300)
    assert again.returncode == 0, again.stdout + again.stderr[-4000:]
    assert f"resumed from step {saved}" in again.stdout, again.stdout
    assert f"step {saved + 1:5d}" in again.stdout, again.stdout
    assert latest_step(str(tmp_path)) == saved + 2
