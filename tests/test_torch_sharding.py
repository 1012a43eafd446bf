"""Port parity: the sharding rules, the meshes, ``configs.cells`` and the
dry-run, in one process.

* `param_specs` for every leaf of all ten full-size architectures
  (parameters on ``meta``) against the reference's `param_specs` on
  ``jax.sharding.AbstractMesh`` meshes (2, 4) and (2, 16, 16), spec by
  spec (placements read back by `to_spec`). A port leaf is one layer of a
  reference leaf stacked on leading layer axes; its spec is the
  reference's with those axes dropped. The one exception, ROADMAP C-17:
  the reference's generic fallback sees a stacked 1-D leaf (a norm scale,
  ``lam``, ``A_log``, ``D``, ``dt_bias``) as 2-D, so the stack's size
  passes ``min_size`` and its layer axis (on data) or its width (on model)
  takes a shard; the port's per-layer leaf is below ``min_size`` and
  replicated. `C17_LEAVES` lists those names; OLMoE's
  ``blocks/ln1/scale`` on (2, 4) is checked by name.
* The counterparts of ``tests/test_sharding_rules.py``: the vlm cache's
  batch dim, the SP fallback at batch 1, `constrain` as a no-op, and the
  masked-sum cross entropy of DTensor logits (on a one-rank gloo mesh, so
  the numbers are real) against the gather of plain ones.
* ``cells()`` against the reference's.
* The dry-run on fake process groups: ``olmoe_1b_7b:smoke`` at
  ``decode_32k`` on a (2, 2, 2) pod mesh with collectives, and
  `cost_corrected_cell`'s extrapolation against the direct count.
"""
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

# one intra-op thread a process: the suite runs under six xdist workers
torch.set_num_threads(1)

import torch.distributed as dist
from jax.sharding import AbstractMesh, PartitionSpec
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro import configs as jconfigs
from repro.distributed import sharding as jshd
from repro.models import lm as jlm
from repro_torch import configs
from repro_torch.distributed import (
    batch_specs,
    constrain,
    decode_state_specs,
    distribute,
    leading_axis_specs,
    param_specs,
    to_placements,
    to_spec,
    use_mesh,
)
from repro_torch.distributed.layout import unshard_for_split
from repro_torch.distributed.sharding import _name
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import lm
from repro_torch.tree import leaves_with_paths, tree_map

MESHES = {(2, 4): ("data", "model"), (2, 16, 16): ("pod", "data", "model")}
#: per-layer 1-D leaves whose stacked reference leaf the reference's
#: generic fallback may shard on the layer axis (C-17)
C17_LEAVES = {"scale", "lam", "A_log", "D", "dt_bias"}


def _norm(entry):
    if isinstance(entry, tuple):
        return entry[0] if len(entry) == 1 else entry
    return entry


def abstract_mesh(shape, names):
    """What the rules read of a mesh, its shape and axis names, with no
    process group."""
    return SimpleNamespace(shape=tuple(shape), mesh_dim_names=tuple(names))


def _key(name: str) -> str:
    """A leaf name without its empty parts (a list index, on either side)."""
    return "/".join(k for k in name.split("/") if k)


def _ref_specs(cfg_name, shape):
    jcfg = jconfigs.get(cfg_name)
    jmesh = AbstractMesh(shape, MESHES[shape])
    params = jax.eval_shape(lambda k: jlm.init_params(k, jcfg), jax.random.PRNGKey(0))
    specs = jshd.param_specs(params, jcfg, jmesh)
    flat_p = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_s = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    out = {}
    for (path, leaf), spec in zip(flat_p, flat_s, strict=True):
        name = _key("/".join(str(getattr(p, "key", "")) for p in path))
        full = tuple(_norm(e) for e in spec) + (None,) * (len(leaf.shape) - len(spec))
        out.setdefault(name, set()).add((full, tuple(leaf.shape)))
    return out


@pytest.fixture
def mesh11():
    """A one-rank gloo mesh in this process, torn down after the test."""
    mesh = make_test_mesh(1, 1, device_type="cpu")
    yield mesh
    dist.destroy_process_group()


# --------------------------------------------------------------------------
# specs and placements
# --------------------------------------------------------------------------


def test_spec_and_placements_round_trip():
    mesh = abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    for spec in [(None, None), (("pod", "data"), None, "model"), ("data", "model"), ("model", None, None)]:
        pl = to_placements(spec, mesh)
        assert to_spec(pl, len(spec), mesh) == spec
    assert to_placements((("pod", "data"), None, "model"), mesh) == (Shard(0), Shard(0), Shard(2))
    assert to_placements((None,), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="two dims"):
        to_placements(("data", "data"), mesh)
    with pytest.raises(ValueError, match="lacks"):
        to_placements(("pod",), abstract_mesh((2, 2), ("data", "model")))


@pytest.mark.parametrize("shape", sorted(MESHES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_specs_match_the_reference_leaf_by_leaf(arch, shape):
    """Every leaf of the full-size architecture: the reference's stacked
    spec with its layer axes dropped, but for the C-17 leaves, which the
    reference shards on a layer axis and the port replicates."""
    mesh = abstract_mesh(shape, MESHES[shape])
    cfg = configs.get(arch)
    params = lm.init_params(cfg, device="meta")
    ref = _ref_specs(arch, shape)
    # the placements tree's leaves are tuples: walk it beside the params
    flat = []
    tree_map(lambda leaf, pl: flat.append(pl), params, param_specs(params, cfg, mesh))
    c17 = 0
    for (path, leaf), pl in zip(leaves_with_paths(params), flat, strict=True):
        name = _key(_name(path))
        got = to_spec(pl, leaf.ndim, mesh)
        (want_full, ref_shape), = ref[name]
        lead = len(ref_shape) - leaf.ndim
        assert ref_shape[lead:] == tuple(leaf.shape), name
        want = want_full[lead:]
        if got == want and all(e is None for e in want_full[:lead]):
            continue
        # C-17: a stacked 1-D leaf that the reference's fallback sees as
        # 2-D, large enough to shard (its layer axis, or its width)
        assert leaf.ndim == 1 and lead >= 1 and path[-1] in C17_LEAVES, (name, got, want_full)
        assert any(e is not None for e in want_full), (name, want_full)
        assert got == (None,), (name, got)
        c17 += 1
    # each listed divergence is real where the reference shards it
    if arch == "olmoe_1b_7b" and shape == (2, 4):
        assert ref["blocks/ln1/scale"] == {(("data", "model"), (16, 2048))}
        assert c17 > 0


def test_every_placement_is_legal_on_the_production_meshes():
    """Every shard of every parameter divides evenly (the reference's
    ``shard_shape`` check), on both production meshes."""
    for shape, names in MESHES.items():
        if len(shape) == 2:
            shape = (16, 16)
        mesh = abstract_mesh(shape, names)
        sizes = dict(zip(names, shape))
        for arch in configs.ARCH_IDS:
            cfg = configs.get(arch)
            params = lm.init_params(cfg, device="meta")
            flat = []
            tree_map(lambda leaf, pl: flat.append((leaf, pl)), params, param_specs(params, cfg, mesh))
            for leaf, pl in flat:
                for axis, p in zip(names, pl):
                    if isinstance(p, Shard):
                        assert leaf.shape[p.dim] % sizes[axis] == 0, (arch, leaf.shape, pl)


def test_batch_and_leading_axis_specs():
    mesh = abstract_mesh((2, 2, 4), ("pod", "data", "model"))
    cfg = configs.get("qwen3_14b:smoke")
    b = {"tokens": torch.empty((8, 16), device="meta"), "odd": torch.empty((3, 4), device="meta")}
    specs = batch_specs(cfg, mesh, b)
    assert to_spec(specs["tokens"], 2, mesh) == (("pod", "data"), None)
    assert to_spec(specs["odd"], 2, mesh) == (None, None)
    lead = leading_axis_specs(mesh, {"x": torch.empty((4, 3), device="meta"), "s": 1.0})
    assert to_spec(lead["x"], 2, mesh) == (("pod", "data"), None)
    assert lead["s"] == (Replicate(),) * 3


# --------------------------------------------------------------------------
# the counterparts of tests/test_sharding_rules.py
# --------------------------------------------------------------------------


def test_decode_state_specs_find_batch_dim_vlm():
    """The 6-D vlm cache shards its BATCH dim on data (the reference's C2)."""
    cfg = configs.get("llama32_vision_11b")
    mesh = abstract_mesh((2, 2), ("data", "model"))
    batch = 4 * 2
    state = lm.init_decode_state(cfg, batch, 64, device="meta")
    specs = decode_state_specs(cfg, mesh, state, batch)
    kv_spec = to_spec(specs["kv"].k, 6, mesh)  # (G, P-1, B, S, Hkv, hd)
    assert kv_spec[2] == "data", kv_spec
    assert kv_spec[0] is None and kv_spec[1] is None
    jcfg = jconfigs.get("llama32_vision_11b")
    jstate = jax.eval_shape(lambda: jlm.init_decode_state(jcfg, batch, 64))
    jspec = jshd.decode_state_specs(jcfg, AbstractMesh((2, 2), ("data", "model")), jstate, batch)["kv"].k
    assert kv_spec == tuple(_norm(e) for e in jspec) + (None,) * (6 - len(jspec))


def test_decode_state_specs_sp_fallback_batch1():
    """batch=1 long-context: the sequence axis takes the data shards (SP)."""
    cfg = configs.get("qwen3_14b")
    mesh = abstract_mesh((2, 2), ("data", "model"))
    state = lm.init_decode_state(cfg, 1, 128 * 2, device="meta")
    kv_spec = to_spec(decode_state_specs(cfg, mesh, state, 1)["kv"].k, 5, mesh)  # (L, B, S, Hkv, hd)
    assert kv_spec[1] is None
    assert kv_spec[2] == "data", kv_spec
    assert kv_spec[4] == "model"


def test_constrain_is_noop_without_mesh(mesh11):
    x = torch.ones((4, 8))
    assert constrain(x, ("dp", "tp")) is x
    d = distribute_tensor(x, mesh11, (Replicate(), Replicate()))
    assert constrain(d, ("dp", "tp")) is d  # no active mesh
    with use_mesh(mesh11):
        assert constrain(x, ("dp", "tp")) is x  # a plain tensor
        # a mesh dim of size 1 holds the whole dim: the tags' shards are
        # laid out as Replicate there
        y = constrain(distribute_tensor(x, mesh11, (Shard(1), Replicate())), ("dp", "tp"))
        assert y.placements == (Replicate(), Replicate())
        assert torch.equal(y.full_tensor(), x)


def test_sharded_ce_equals_naive_ce(mesh11):
    """The reference's iota-mask CE, which DTensor logits take, equals the
    gather CE of plain ones."""
    cfg = configs.get("stablelm_3b:smoke").replace(dtype="float32")
    params = lm.init_params(cfg, 0, device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)))
    _, plain = lm.loss_fn(params, {"tokens": tokens}, cfg, z_loss=0.0)
    logits, _ = lm.forward(params, tokens, cfg)
    logits = logits[:, :-1]
    lse = torch.logsumexp(logits, dim=-1)
    naive = float(torch.mean(lse - torch.gather(logits, -1, tokens[:, 1:, None])[..., 0]))
    assert abs(float(plain["ce"]) - naive) < 1e-5
    with use_mesh(mesh11):
        dparams = distribute(params, mesh11, param_specs(params, cfg, mesh11))
        dtok = distribute({"t": tokens}, mesh11, batch_specs(cfg, mesh11, {"t": tokens}))["t"]
        _, sharded = lm.loss_fn(dparams, {"tokens": dtok}, cfg, z_loss=0.0)
    assert isinstance(sharded["ce"], DTensor)
    assert float(sharded["ce"].full_tensor()) == float(plain["ce"])


def test_unshard_for_split_replicates_only_an_uneven_split(mesh11):
    x = distribute_tensor(torch.arange(24.0).reshape(2, 12), mesh11, (Shard(1), Replicate()))
    assert unshard_for_split(x, -1, 3) is x  # 3 heads over a 1-wide axis
    assert unshard_for_split(torch.ones(3), 0, 2) is not None


def test_local_apply_picks_one_layout_from_the_named_axes():
    """`local_apply` on a fake 2x4 group (meta tensors: layouts only): a
    mesh dim takes the first argument's named shard; an axis that does not
    divide is replicated; a summed axis leaves a partial sum; plain tensors
    call the function as it is."""
    import torch.distributed as dist
    from torch.distributed.tensor import Partial
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.distributed.layout import local_apply

    calls = []
    assert local_apply(lambda a: calls.append(a) or a, torch.ones(2), axes=(("b",),), out=("b",)) is not None
    assert len(calls) == 1
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        mesh = make_test_mesh(2, 4, device_type="cpu")
        k = distribute_tensor(torch.empty(8, 16, 4, 32, device="meta"), mesh, (Shard(0), Shard(3)))
        q = distribute_tensor(torch.empty(8, 1, 8, 32, device="meta"), mesh, (Shard(0), Shard(2)))
        axes = (("b", None, "h", "d"), ("b", None, "h", "d"))
        dot = lambda k, q: torch.einsum("bshd,bchd->bhcs", k, q[:, :, :4])  # noqa: E731
        out = local_apply(dot, k, q, axes=axes, out=("b", "h", None, None), sums=("d",))
        assert out.placements == (Shard(0), Partial())  # k leads: head_dim on the model axis, summed
        out = local_apply(dot, q, k, axes=axes, out=("b", "h", None, None), sums=("d",))
        assert out.placements == (Shard(0), Shard(1))  # q leads: the heads, 4 over 4
        k3 = distribute_tensor(torch.empty(8, 16, 3, 32, device="meta"), mesh, (Shard(0), Shard(2)))
        out = local_apply(lambda k: k * 2, k3, axes=(("b", None, "h", None),), out=("b", None, "h", None))
        assert out.placements == (Shard(0), Replicate())  # 3 heads do not divide 4
    finally:
        dist.destroy_process_group()


def test_sharded_init_places_each_entry_as_it_is_drawn(mesh11):
    """``init_params(place=...)`` hands each top-level entry and each layer
    to ``place`` as soon as it is drawn, with the draws unchanged; the
    sharded state's parameters are the unsharded init's."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.train.step import init_train_state
    from repro_torch.tree import leaves

    cfg = configs.get("recurrentgemma_2b:smoke")
    seen = []
    placed = lm.init_params(cfg, 0, device="cpu", place=lambda path, tree: seen.append(path) or tree)
    plain = lm.init_params(cfg, 0, device="cpu")
    top = [("embed",), ("final_norm",)] + ([] if cfg.tie_embeddings else [("unembed",)])
    assert seen == top + [("blocks", i) for i in range(cfg.num_layers)]
    assert all(torch.equal(a, b) for a, b in zip(leaves(placed), leaves(plain), strict=True))
    state = init_train_state(cfg, TrainConfig(), 0, device="cpu", mesh=mesh11)
    assert all(isinstance(a, DTensor) and torch.equal(a.full_tensor(), b)
               for a, b in zip(leaves(state.params), leaves(plain), strict=True))


# --------------------------------------------------------------------------
# cells and the dry-run
# --------------------------------------------------------------------------


def test_cells_are_the_reference():
    assert configs.cells() == jconfigs.cells()
    assert configs.cells(include_long=False) == jconfigs.cells(include_long=False)
    assert len(configs.cells()) == 32


def test_dryrun_reduced_mesh_cell():
    """The dry-run end to end on a fake (2, 2, 2) pod mesh: the MoE smoke
    config at decode_32k, with collectives across the mesh."""
    rec = dryrun.run_cell("olmoe_1b_7b:smoke", "decode_32k", mesh_shape=(2, 2, 2), verbose=False)
    assert rec["collectives"]["count"] > 0
    assert rec["collectives"]["total_bytes"] > 0
    assert rec["devices"] == 8 and rec["mesh"] == [2, 2, 2]
    assert rec["cost"]["flops"] > 0 and rec["memory"]["argument_bytes"] > 0
    assert rec["model_flops_global"] > 0 and rec["bottleneck"] in ("compute", "memory", "collective")
    assert not dist.is_initialized()  # the dry-run tears its fake group down


def test_cost_corrected_cell_matches_the_direct_count(monkeypatch):
    """The port runs every layer, so the reference's 1-/2-unit
    extrapolation is exact for a homogeneous family: FLOPs, collective
    bytes and argument bytes equal the direct count (a 4-layer smoke
    config, so that the extrapolation reaches past its two measured
    points)."""
    cfg = configs.get("stablelm_3b:smoke").replace(num_layers=4)
    monkeypatch.setattr(dryrun.cfg_base, "get", lambda name: cfg)
    direct = dryrun.run_cell("stablelm_3b:smoke", "train_4k", mesh_shape=(2, 2), verbose=False)
    extrap = dryrun.cost_corrected_cell("stablelm_3b:smoke", "train_4k", mesh_shape=(2, 2), verbose=False)
    assert extrap["cost_mode"] == "unroll-extrapolated" and extrap["layer_units"] == 4
    assert extrap["hlo_flops"] == direct["cost"]["flops"]
    assert extrap["collective_bytes"] == direct["collectives"]["total_bytes"]
    assert extrap["hlo_bytes"] == direct["memory"]["argument_bytes"]
