"""DTensor layouts for the model code: one code path for plain tensors and DTensors.

GSPMD lays out every op of the reference by itself: an uneven split is
replicated, a contraction over a sharded dim leaves partial sums, a scan
gets the layout it needs. DTensor has a rule an op, and some rules are
missing or refuse a layout: the reshape of an uneven shard, the merge of a
sharded inner dim, and, in some versions, ``flip``, ``F.pad`` and einsums
whose operands shard two dims on a mesh of two. The models call the helpers
below where they would otherwise need such a rule. On a plain tensor each
returns its input, or calls its function, as it is, so the models keep one
code path beside `repro_torch.distributed.sharding.constrain`:

* `local_apply` runs a function on each rank's shards, the layout chosen
  from the named axes of its arguments (a small ``shard_map``);
* `unshard_for_split` and `unshard_for_merge` replicate what a reshape
  cannot split or merge; `unshard` replicates given dims;
* `even_layout` replicates uneven shards and reduces partial sums;
* `replicated` and `layout_as` lay a DTensor out whole, or as another.
"""
from __future__ import annotations

import math

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

__all__ = [
    "even_layout",
    "layout_as",
    "local_apply",
    "replicated",
    "unshard",
    "unshard_for_merge",
    "unshard_for_split",
]


def _sharding(x, dims) -> list[int]:
    """The mesh dims that shard one of ``dims`` of the DTensor ``x``."""
    dims = {d % x.ndim for d in dims}
    return [i for i, p in enumerate(x.placements) if isinstance(p, Shard) and p.dim % x.ndim in dims]


def _replicating(x, mesh_dims):
    """``x`` with ``mesh_dims`` redistributed to ``Replicate()``."""
    if not mesh_dims:
        return x
    placements = tuple(Replicate() if i in mesh_dims else p for i, p in enumerate(x.placements))
    return x.redistribute(x.device_mesh, placements)


def local_apply(fn, *args, axes, out, sums=()):
    """``fn(*args)``, on each rank's shards when an argument is a DTensor.

    ``axes`` names the dims of each argument: a tuple with an axis name or
    None a dim, or None for an argument that is not a tensor. ``out``
    names the dims of the output likewise, or is a list of such tuples for
    a function that returns a tuple. ``fn`` must act on each named axis
    slice by slice (a slice of the arguments along it gives that slice of
    the outputs), except on the axes in ``sums``, which it sums over and
    its outputs lack.

    The layout: a mesh dim shards the axis of the first argument (in
    argument order) that it shards along a named dim that every output
    carries or that ``sums`` names; a mesh dim that shards none of those,
    or only partial sums, is replicated. An axis keeps its mesh dims only
    where their product divides every argument's size along it. Every
    argument is redistributed to that layout (a plain tensor counts as
    replicated), ``fn`` runs on the local shards under `local_map`, and
    each output comes back sharded along its named axes and, over the mesh
    dims of a summed axis, as a partial sum. In the backward, the gradient
    of an argument that lacks an axis the layout splits is the sum of the
    parts' gradients (a partial sum over those mesh dims).
    """
    dts = [a for a in args if isinstance(a, DTensor)]
    if not dts:
        return fn(*args)
    mesh = dts[0].device_mesh
    outs = out if isinstance(out, list) else [out]
    allowed = set(sums) | set.intersection(*({n for n in o if n is not None} for o in outs))
    owner: list = [None] * mesh.ndim
    for i in range(mesh.ndim):
        for a, names in zip(args, axes):
            if isinstance(a, DTensor) and isinstance(a.placements[i], Shard):
                name = names[a.placements[i].dim % a.ndim]
                if name in allowed:
                    owner[i] = name
                    break
    for name in set(owner) - {None}:
        count = math.prod(mesh.size(i) for i, o in enumerate(owner) if o == name)
        sizes = {a.shape[d] for a, names in zip(args, axes) if names is not None
                 for d, n in enumerate(names) if n == name}
        if any(s % count for s in sizes):
            owner = [None if o == name else o for o in owner]

    def placements(names, partial=False):
        return [Shard(names.index(o)) if o is not None and o in names
                else Partial() if partial and o in sums else Replicate() for o in owner]

    placed, in_pl, grad_pl = [], [], []
    for a, names in zip(args, axes):
        if names is None:
            placed.append(a)
            in_pl.append(None)
            grad_pl.append(None)
            continue
        pl = placements(names)
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
        placed.append(a if list(a.placements) == pl else a.redistribute(mesh, pl))
        in_pl.append(pl)
        # an argument whole along a mesh dim that splits an axis it lacks
        # (a weight beside a batch shard) gets a gradient from each part:
        # the local gradients are partial sums over that mesh dim
        grad_pl.append([Partial() if o is not None and o not in names else p for o, p in zip(owner, pl)])
    out_pl = [placements(o, partial=True) for o in outs]
    run = local_map(fn, out_placements=tuple(out_pl) if isinstance(out, list) else out_pl[0],
                    in_placements=tuple(in_pl), in_grad_placements=tuple(grad_pl), device_mesh=mesh)
    return run(*placed)


def unshard(x, dims):
    """``x`` with every mesh dim that shards one of ``dims`` (an int or a
    tuple), or holds a partial sum, redistributed to ``Replicate()``."""
    if not isinstance(x, DTensor):
        return x
    dims = (dims,) if isinstance(dims, int) else dims
    partial = [i for i, p in enumerate(x.placements) if not isinstance(p, (Shard, Replicate))]
    return _replicating(x, _sharding(x, dims) + partial)


def unshard_for_split(x, dim: int, parts: int):
    """``x`` made ready for a reshape that splits dim ``dim`` into
    ``(parts, rest)``: a DTensor whose mesh dims shard ``dim`` by a count
    that does not divide ``parts`` has those mesh dims redistributed to
    ``Replicate()`` (what GSPMD does for an uneven split, and DTensor
    refuses to do itself); anything else is returned as it is."""
    if not isinstance(x, DTensor):
        return x
    sharding = _sharding(x, (dim,))
    if parts % math.prod(x.device_mesh.size(i) for i in sharding) == 0:
        return x
    return _replicating(x, sharding)


def unshard_for_merge(x, start: int, stop: int):
    """``x`` made ready for a reshape that merges dims ``start`` to
    ``stop - 1`` into one: a DTensor's mesh dims that shard an inner dim of
    the merge (any but ``start``) are redistributed to ``Replicate()``
    (not every DTensor version can merge a sharded inner dim)."""
    if not isinstance(x, DTensor):
        return x
    return _replicating(x, _sharding(x, range(start + 1, stop)))


def even_layout(x):
    """``x`` with every shard even and every partial sum reduced: a mesh dim
    that shards a tensor dim it does not divide, or holds a partial sum, is
    redistributed to ``Replicate()``. DTensor may pick such layouts itself
    (a reduce-scatter onto an uneven dim), and then refuses to reshape
    them; GSPMD pads instead. Anything but a DTensor is returned as it is."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    counts: dict[int, int] = {}
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard):
            counts[p.dim % x.ndim] = counts.get(p.dim % x.ndim, 1) * mesh.size(i)
    return _replicating(x, [
        i for i, p in enumerate(x.placements)
        if not (isinstance(p, Replicate) or (isinstance(p, Shard) and x.shape[p.dim] % counts[p.dim % x.ndim] == 0))
    ])


def replicated(x):
    """A DTensor laid out whole on every rank; anything else as it is."""
    if not isinstance(x, DTensor):
        return x
    return _replicating(x, [i for i, p in enumerate(x.placements) if not isinstance(p, Replicate)])


def layout_as(x, like):
    """The DTensor ``x`` laid out as the DTensor ``like``; anything else as
    it is."""
    if not isinstance(x, DTensor) or not isinstance(like, DTensor) or x.placements == like.placements:
        return x
    return x.redistribute(like.device_mesh, like.placements)
