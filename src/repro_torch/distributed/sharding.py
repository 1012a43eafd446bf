"""Sharding rules: DP / FSDP / TP / EP / SP over the production mesh.

The counterpart of the reference's ``repro.distributed.sharding``, on
`torch.distributed`'s `DeviceMesh` and DTensor. Mesh axes:

* single pod : ("data", "model")          — 16 x 16 = 256 devices
* multi-pod  : ("pod", "data", "model")   — 2 x 16 x 16 = 512 devices

Policy (the reference's, unchanged):

* batch (DP) over ("pod", "data") — pure DP across pods,
* params FSDP over "data", TP/EP over "model",
* long-context decode (batch=1) shards the cache/sequence axis over "data"
  (SP) where divisible.

Rules are name-driven with a size-driven generic fallback (the
reference's, with its name substrings: ``"embed"`` also matches
``"unembed"``, and the fallback's ``min_size`` is ``1 << 14``), so every
parameter of every architecture gets a legal spec; dims not divisible by
the axis size stay unsharded.

**Specs and placements.** The rules compute the reference's
``PartitionSpec``: a tuple with one entry a tensor dim, ``None``, a mesh
axis name, or a tuple of names (several mesh axes on one dim, major
first). `to_placements` writes a spec as DTensor placements, one a mesh
dim (``Shard(d)`` where the mesh axis shards tensor dim d, else
``Replicate()``); `to_spec` reads placements back. The public rules
(`param_specs`, `batch_specs`, `leading_axis_specs`,
`decode_state_specs`) return trees of placements; `named` turns one spec
into placements, as the reference's `named` makes a ``NamedSharding``.
The rules read only ``mesh.shape`` and ``mesh.mesh_dim_names``, so any
object with those two serves for spec arithmetic, no process group needed.

**Per-layer leaves.** The reference stacks its layers' parameters on
leading layer axes; the port keeps a list of per-layer leaves. A port
leaf's spec is the reference's stacked spec with the leading layer axes
dropped: every name rule looks at the trailing two or three dims and puts
``None`` on the lead. The one exception (ROADMAP C-17): the reference's
generic fallback sees a stacked 1-D leaf (a norm scale, ``lam``,
``A_log``, ``D``, ``dt_bias``) as 2-D, so the stack passes ``min_size``
and its layer axis (on data, although the reference's comment says a
layer axis is never sharded) or its width (on model) takes a shard; the
port's leaf has no layer axis, is below ``min_size`` and is replicated.

`constrain` is ``with_sharding_constraint`` by logical tags: under
`use_mesh` (the counterpart of ``with mesh:``) it redistributes a DTensor
to the tags' placements; on a plain tensor, with no active mesh, or on a
mesh without ``"model"`` it returns its input.
"""
from __future__ import annotations

import contextlib
import contextvars
import math

from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ModelConfig
from repro_torch.tree import leaves_with_paths, tree_map

__all__ = [
    "active_mesh",
    "batch_specs",
    "constrain",
    "decode_state_specs",
    "distribute",
    "dp_axes",
    "leading_axis_specs",
    "named",
    "param_specs",
    "to_placements",
    "to_spec",
    "tp_axis",
    "use_mesh",
]

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("repro_torch_active_mesh", default=None)


def active_mesh():
    """The mesh installed by `use_mesh` around the current call (None
    outside any mesh: one device)."""
    return _ACTIVE.get()


@contextlib.contextmanager
def use_mesh(mesh):
    """``with use_mesh(mesh):`` makes ``mesh`` the `active_mesh` (the
    reference's ``with mesh:``); ``None`` clears it. Under a mesh, plain
    tensors that meet DTensors in an op (positions, masks, constants) count
    as replicated (DTensor's ``implicit_replication``), as arrays closed
    over by a jitted function do in the reference."""
    token = _ACTIVE.set(mesh)
    try:
        if mesh is None:
            yield mesh
        else:
            with implicit_replication():
                yield mesh
    finally:
        _ACTIVE.reset(token)


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def tp_axis(mesh) -> str:
    return "model"


def _sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _axis_size(mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    sizes = _sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def _divisible(dim: int, mesh, axes) -> bool:
    return dim % _axis_size(mesh, axes) == 0


def to_placements(spec: tuple, mesh) -> tuple:
    """A spec (one entry a tensor dim: None, an axis name or a tuple of
    names) as DTensor placements, one a mesh dim."""
    owner: dict[str, int] = {}
    for d, entry in enumerate(spec):
        for name in (entry,) if isinstance(entry, str) else (entry or ()):
            if name in owner:
                raise ValueError(f"mesh axis {name!r} shards two dims of {spec}")
            owner[name] = d
    unknown = set(owner) - set(mesh.mesh_dim_names)
    if unknown:
        raise ValueError(f"spec {spec} names axes {sorted(unknown)} that the mesh lacks")
    return tuple(Shard(owner[a]) if a in owner else Replicate() for a in mesh.mesh_dim_names)


def to_spec(placements, ndim: int, mesh) -> tuple:
    """Placements read back as a spec of ``ndim`` entries: None, one axis
    name, or a tuple of names in mesh order."""
    per_dim: list[list[str]] = [[] for _ in range(ndim)]
    for name, pl in zip(mesh.mesh_dim_names, placements):
        if isinstance(pl, Shard):
            per_dim[pl.dim % ndim].append(name)
        elif not isinstance(pl, Replicate):
            raise ValueError(f"placement {pl} has no spec")
    return tuple(None if not axes else axes[0] if len(axes) == 1 else tuple(axes) for axes in per_dim)


def named(mesh, spec: tuple) -> tuple:
    """The placements of ``spec`` on ``mesh`` (the reference's
    ``NamedSharding(mesh, spec)``)."""
    return to_placements(spec, mesh)


def _name(path) -> str:
    """The reference's leaf name: its dict keys joined by "/", "" for a
    sequence index or a NamedTuple field."""
    return "/".join(k if isinstance(k, str) and not k.startswith(".") else "" for k in path)


def _map_specs(rule, tree, mesh):
    """A tree of ``tree``'s structure holding each leaf's placements."""
    specs = iter([to_placements(rule(path, leaf), mesh) for path, leaf in leaves_with_paths(tree)])
    return tree_map(lambda _: next(specs), tree)


def _generic_spec(shape, mesh, *, tp: str, fsdp: str, min_size: int = 1 << 14) -> tuple:
    """Shard the largest tp-divisible dim on TP, the largest remaining
    fsdp-divisible dim on FSDP; replicate small tensors."""
    if math.prod(shape) < min_size:
        return (None,) * len(shape)
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    assign: dict[int, object] = {}
    for i in order:
        if _divisible(shape[i], mesh, tp):
            assign[i] = tp
            break
    for i in order:
        if i in assign:
            continue
        if _divisible(shape[i], mesh, fsdp):
            assign[i] = fsdp
            break
    return tuple(assign.get(i) for i in range(len(shape)))


def _param_spec(name: str, shape, cfg: ModelConfig, mesh) -> tuple:
    """The spec of one parameter leaf named ``name`` (the reference's
    "/"-joined keys) of ``shape``: the reference's rules, verbatim."""
    tp = tp_axis(mesh)
    fsdp = "data"
    shape = tuple(shape)
    nd = len(shape)

    def with_lead(spec: tuple, lead: int) -> tuple:
        return (None,) * lead + tuple(spec)

    lead = nd - 2 if nd >= 2 else 0
    if "embed" in name or "unembed" in name:
        v, d = shape[-2], shape[-1]
        if _divisible(v, mesh, tp):
            return (tp, fsdp if _divisible(d, mesh, fsdp) else None)
        return (None, tp if _divisible(d, mesh, tp) else None)
    if any(k in name for k in ("wi", "wg")) and "ffn" in name and cfg.is_moe and nd >= 3:
        # MoE expert weights (..., E, D, F): EP on tp, FSDP on D
        e, d, f = shape[-3], shape[-2], shape[-1]
        spec = (tp if _divisible(e, mesh, tp) else None, fsdp if _divisible(d, mesh, fsdp) else None, None)
        return with_lead(spec, nd - 3)
    if "wo" in name and "ffn" in name and cfg.is_moe and nd >= 3:
        e, f, d = shape[-3], shape[-2], shape[-1]
        spec = (tp if _divisible(e, mesh, tp) else None, fsdp if _divisible(f, mesh, fsdp) else None, None)
        return with_lead(spec, nd - 3)
    if nd >= 2 and any(k in name for k in ("wq", "wk", "wv", "wi", "wg")):
        d_in, d_out = shape[-2], shape[-1]
        spec = (fsdp if _divisible(d_in, mesh, fsdp) else None, tp if _divisible(d_out, mesh, tp) else None)
        return with_lead(spec, lead)
    if nd >= 2 and any(k in name for k in ("wo", "w_out", "out_proj")):
        d_in, d_out = shape[-2], shape[-1]
        spec = (tp if _divisible(d_in, mesh, tp) else None, fsdp if _divisible(d_out, mesh, fsdp) else None)
        return with_lead(spec, lead)
    # generic fallback (ssm in_proj, rglru gates, conv filters, norms, ...)
    lead_axes = max(nd - 2, 0)
    inner = _generic_spec(shape[lead_axes:], mesh, tp=tp, fsdp=fsdp)
    return (None,) * lead_axes + tuple(inner)


def param_specs(abstract_params, cfg: ModelConfig, mesh):
    """Placements tree matching the parameter tree (works on parameters on
    the ``meta`` device: nothing is allocated)."""
    return _map_specs(lambda path, leaf: _param_spec(_name(path), leaf.shape, cfg, mesh), abstract_params, mesh)


def batch_specs(cfg: ModelConfig, mesh, batch_abstract):
    """Shard every batch leaf's leading (batch) dim over the DP axes."""
    dp = dp_axes(mesh)

    def rule(path, leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 0:
            return ()
        if _divisible(shape[0], mesh, dp):
            return (dp,) + (None,) * (len(shape) - 1)
        return (None,) * len(shape)

    return _map_specs(rule, batch_abstract, mesh)


def leading_axis_specs(mesh, tree):
    """Placements tree sharding each leaf's *leading* dim over the DP axes
    where divisible (replicated otherwise): the data-parallel fan-out rule
    for pure batch trees — `repro_torch.batch.BucketedExecutor` spreads the
    batch axis of a batch across the mesh with it."""
    dp = dp_axes(mesh)

    def rule(path, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if len(shape) >= 1 and _divisible(shape[0], mesh, dp):
            return (dp,) + (None,) * (len(shape) - 1)
        return (None,) * len(shape)

    return _map_specs(rule, tree, mesh)


def decode_state_specs(cfg: ModelConfig, mesh, state_abstract, batch: int):
    """Cache placements for serve: batch on DP where divisible, else the
    sequence/window axis on DP (SP — the batch=1 long-context case);
    head_dim on TP where legal.

    The batch dim is located STRUCTURALLY (KV-like leaves are (..., B, S,
    Hkv, hd) => batch at -4; state leaves are (..., B, feat...) => batch is
    the first dim matching ``batch``), as in the reference.
    """
    dp = dp_axes(mesh)
    tp = tp_axis(mesh)

    def rule(path, leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        spec: list = [None] * nd
        kv_like = nd >= 4 and shape[-1] == cfg.head_dim and shape[-2] == cfg.num_kv_heads
        if kv_like:
            b_idx, s_idx = nd - 4, nd - 3
        else:
            b_idx = next((i for i, d in enumerate(shape) if d == batch), None)
            s_idx = None
        if b_idx is not None and _divisible(shape[b_idx], mesh, dp):
            spec[b_idx] = dp
        elif s_idx is not None and _divisible(shape[s_idx], mesh, dp):
            spec[s_idx] = dp  # SP: shard the cache sequence axis instead
        if nd >= 2 and spec[-1] is None and _divisible(shape[-1], mesh, tp) and shape[-1] >= 64:
            spec[-1] = tp
        return tuple(spec)

    return _map_specs(rule, state_abstract, mesh)


def _on_mesh(placements, mesh) -> tuple:
    """``placements`` as laid out: a shard over a mesh dim of size 1 holds
    the whole dim, so it is written ``Replicate()`` (the same layout;
    DTensor refuses some views of a dim "sharded" over one rank, e.g. the
    merge of a batch of 1 into a matrix product's rows)."""
    return tuple(Replicate() if mesh.size(i) == 1 else p for i, p in enumerate(placements))


def distribute(tree, mesh, placements):
    """``tree`` with each tensor leaf laid out on ``mesh`` by the placements
    at the same place of ``placements`` (a tree from the rules above). Every
    rank holds the whole tensor and keeps its own shard, a copy: no
    communication (``distribute_tensor(..., src_data_rank=None)``)."""
    return tree_map(lambda t, pl: distribute_tensor(t, mesh, _on_mesh(pl, mesh), src_data_rank=None),
                    tree, placements)


def constrain(x, dims: tuple):
    """Redistribute a DTensor by *logical* dim tags under the active mesh.

    ``dims`` entries: "dp" (batch axes), "sp" (sequence — takes the dp axes
    iff the "dp"-tagged dim could not be sharded, e.g. batch=1 long-context
    decode), "tp" (model axis), or None. Tags apply only where the dimension
    size is divisible by the axis size. A plain tensor, no active mesh, or a
    mesh without "model" returns ``x``.
    """
    m = active_mesh()
    if m is None or not isinstance(x, DTensor) or "model" not in m.mesh_dim_names:
        return x
    dp = dp_axes(m)
    spec: list = [None] * len(dims)
    dp_placed = False
    for i, (size, tag) in enumerate(zip(x.shape, dims)):
        if tag == "dp" and _divisible(size, m, dp):
            spec[i] = dp
            dp_placed = True
        elif tag == "tp" and _divisible(size, m, "model"):
            spec[i] = "model"
    if not dp_placed:
        for i, (size, tag) in enumerate(zip(x.shape, dims)):
            if tag == "sp" and _divisible(size, m, dp):
                spec[i] = dp
                break
    placements = _on_mesh(to_placements(tuple(spec), x.device_mesh), x.device_mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)
