"""Guard the port's public surface against drift, on the model of the
reference's ``tools/check_api_surface.py``.

Each guarded module's ``__all__`` resolves, is sorted and holds no
duplicate, and every public name the module binds is declared: in a
package, every name it binds; in a plain module, every name it defines
(the names it imports are another module's). Every name
of the reference's counterpart module has a counterpart of the same name
in the port's, with the reference's parameters but for the deliberate
differences listed here, each with its reason. The solver registry's
method names and the batchable methods equal the reference's, read from
``repro`` in the same test.
"""
import importlib
import inspect
import types

import pytest
import torch

# one intra-op thread a process: the suite runs under six xdist workers
torch.set_num_threads(1)

#: port module -> the reference module it mirrors (``repro`` itself has no
#: ``__all__``; the port's top level is held to ``repro.core``/``.core.api``)
COUNTERPARTS = {
    "repro_torch": None,
    "repro_torch.core": "repro.core",
    "repro_torch.core.api": "repro.core.api",
    "repro_torch.batch": "repro.batch",
    "repro_torch.kernels": "repro.kernels",
    "repro_torch.obs": "repro.obs",
    "repro_torch.robust": "repro.robust",
    "repro_torch.data": "repro.data",
    "repro_torch.models": "repro.models",
    "repro_torch.models.attention": "repro.models.attention",
    "repro_torch.models.ssm": "repro.models.ssm",
    "repro_torch.train": "repro.train",
    "repro_torch.configs": "repro.configs",
    "repro_torch.optim": "repro.optim",
    "repro_torch.launch.serve_ot": "repro.launch.serve_ot",
    "repro_torch.distributed": "repro.distributed",
    "repro_torch.distributed.sharding": "repro.distributed.sharding",
    "repro_torch.launch.mesh": "repro.launch.mesh",
    "repro_torch.launch.specs": "repro.launch.specs",
    "repro_torch.launch.dryrun": "repro.launch.dryrun",
}

#: reference modules without ``__all__``: their public names are the
#: functions they define, read from the source. Importing
#: ``repro.launch.dryrun`` would set 512 host devices for JAX in this
#: process, so its signatures are read from the source too (`_source_params`)
SOURCE_ONLY = {"repro.launch.dryrun"}

#: names the port exports beyond its counterpart, and why
PORT_EXTRAS = {
    # the block-ELL sketch builder is public in the port: the parity tests
    # and chip_smoke.py build, feed and time the sketch apart from the solve
    "repro_torch.core.api": {"build_block_ell_sketch"},
    # the top level takes its other names from repro.core and repro.core.api
    # (DEFAULT_TOL, mix_uniform, get_solver and sampling_probs from the
    # latter); it adds the block-ELL builder and the observability subpackage
    "repro_torch": {"build_block_ell_sketch", "obs"},
    # the reference defines both public and calls them from its lm (the
    # cross cache), but leaves them out of its __all__; the port declares
    # every public function it defines
    "repro_torch.models.attention": {"cross_attention_cached", "cross_kv"},
    # the spans of the port's layers: the finished span and the operator's
    # switch (the module is repro_torch.obs.spans)
    "repro_torch.obs": {"Span", "recording"},
    # the step's gradients without the update: the parity tests and
    # chip_smoke.py hold them against the reference's and across remat
    "repro_torch.train": {"loss_and_grads"},
    # specs as placements: the conversions both ways, the counterpart of
    # `with mesh:`, and the no-communication layout of a tree
    "repro_torch.distributed": {"active_mesh", "constrain", "distribute", "to_placements", "to_spec", "use_mesh"},
    "repro_torch.distributed.sharding": {"distribute", "to_placements", "to_spec", "use_mesh"},
    # the launchers of a local multi-process mesh, and a rank's device
    "repro_torch.launch.mesh": {"launch_ranks", "mesh_device", "run_ranks"},
    # the H100 constants of the roofline terms (the reference's v5e ones are
    # module names its dryrun, which has no __all__, does not declare)
    "repro_torch.launch.dryrun": {"HBM_BW", "NVLINK_BW", "PEAK_FLOPS"},
}

#: public names a guarded module defines but leaves out of its ``__all__``,
#: and why: serve_ot's CLI entry point, which the reference's serve_ot also
#: defines outside its ``__all__`` (tests/test_torch_serve_ot.py pins the
#: port's ``__all__`` to the reference's)
UNDECLARED = {"repro_torch.launch.serve_ot": {"main"}}

#: reference parameter -> the port's parameters in its place, and why
RENAMED = {
    # a JAX PRNG key; the port draws from a torch.Generator (Philox, not
    # threefry), passed as such or as an int seed (the LM's initialisers
    # take either in one parameter)
    "key": {"generator", "seed", "seed_or_generator"},
    "keys": {"generators", "seeds"},
    # the MoE routers' PRNG key: the torch.Generator they draw from
    "rng": {"generator"},
    # the dry-run reads its collectives off the run's dispatch counter, not
    # off the text of a compiled program
    "hlo_text": {"counter"},
}
#: reference parameters the port drops, and why: Pallas's interpret mode and
#: tile sizes mean nothing to a CUDA kernel, whose tiles its source fixes;
#: the port trains on one host, so a checkpoint has no host index
DROPPED = {"interpret", "block_n", "block_m", "block_s", "host"}
#: parameters the port adds, and why
ADDED = {
    # a mesh's device type ("cuda", or "cpu" for the gloo and fake groups),
    # and the dry-run's reduced mesh for the CPU tests
    "device_type", "mesh_shape",
    # the sharded state, step and restore: the mesh, the placements of the
    # leaves of a restore's target, and the init's layout of each entry as
    # it is drawn (so that the whole tree is never on one device)
    "mesh", "placements", "place",
    # a CLI's main takes an argv, so tests and chip_smoke.py call it in-process
    "argv",
    # the device rule: numpy data goes to `device`, None means the card
    "device",
    # precomputed sort orders that the sorted segment reductions reuse
    "layout", "col_layout",
    # block-ELL: the kernels' non-finite flag, and the valid-slot count of
    # each row-block that the solver's K~ v walks
    "bad_index", "row_ptr",
    # the batched scaling loop starts the bucket padding's scalings at 0
    "live",
}


def _public(mod) -> set[str]:
    names = {n for n, v in vars(mod).items() if not n.startswith("_") and not isinstance(v, types.ModuleType)}
    if hasattr(mod, "__path__"):  # a package: what it binds is what it exports
        return names
    return {n for n in names if getattr(vars(mod)[n], "__module__", mod.__name__) == mod.__name__}


@pytest.mark.parametrize("modname", sorted(COUNTERPARTS))
def test_all_resolves_sorted_without_duplicates_and_declares_every_export(modname):
    mod = importlib.import_module(modname)
    declared = list(mod.__all__)
    assert declared, f"{modname}: empty __all__"
    assert len(set(declared)) == len(declared), f"{modname}: duplicate __all__ entries"
    assert declared == sorted(declared), f"{modname}: __all__ is not sorted"
    missing = [n for n in declared if not hasattr(mod, n)]
    assert not missing, f"{modname}: in __all__ but not bound: {missing}"
    undeclared = sorted(_public(mod) - set(declared) - UNDECLARED.get(modname, set()))
    assert not undeclared, f"{modname}: exported but not in __all__: {undeclared}"


def _source_names(refname: str) -> set[str]:
    """The public functions a reference module defines, read from its source."""
    import ast

    spec = importlib.util.find_spec(refname)
    with open(spec.origin) as f:
        tree = ast.parse(f.read())
    return {n.name for n in tree.body if isinstance(n, ast.FunctionDef) and not n.name.startswith("_")}


def _source_params(refname: str) -> dict[str, list[str]]:
    import ast

    spec = importlib.util.find_spec(refname)
    with open(spec.origin) as f:
        tree = ast.parse(f.read())
    out = {}
    for n in tree.body:
        if isinstance(n, ast.FunctionDef) and not n.name.startswith("_"):
            a = n.args
            out[n.name] = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return out


def _ref_names(refname: str) -> set[str]:
    if refname in SOURCE_ONLY:
        return _source_names(refname)
    return set(importlib.import_module(refname).__all__)


@pytest.mark.parametrize("modname", sorted(COUNTERPARTS))
def test_every_reference_name_has_its_counterpart(modname):
    port = importlib.import_module(modname)
    refname = COUNTERPARTS[modname]
    if refname is None:
        ref_names = set(importlib.import_module("repro.core").__all__) | set(
            importlib.import_module("repro.core.api").__all__)
        extras = set(port.__all__) - ref_names
    else:
        ref_names = _ref_names(refname)
        missing = sorted(ref_names - set(port.__all__))
        assert not missing, f"{modname} lacks the reference's {missing}"
        extras = set(port.__all__) - ref_names
    assert extras == PORT_EXTRAS.get(modname, set()), f"{modname}: undeclared extras {sorted(extras)}"


def _params(fn) -> list[str] | None:
    try:
        return list(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        return None


@pytest.mark.parametrize("modname", sorted(m for m, r in COUNTERPARTS.items() if r))
def test_signatures_are_the_reference_but_for_the_listed_differences(modname):
    port = importlib.import_module(modname)
    refname = COUNTERPARTS[modname]
    source = _source_params(refname) if refname in SOURCE_ONLY else None
    ref = None if source is not None else importlib.import_module(refname)
    checked = 0
    for name in sorted(_ref_names(refname)):
        p = getattr(port, name)
        if source is not None:
            rp, pp = source[name], _params(p)
        else:
            r = getattr(ref, name)
            assert inspect.isclass(r) == inspect.isclass(p), f"{modname}.{name}: a class in one package only"
            if inspect.isclass(r) or not callable(r):
                continue
            rp, pp = _params(r), _params(p)
        if rp is None or pp is None:
            continue
        checked += 1
        for param in rp:
            if param in pp or param in DROPPED:
                continue
            assert param in RENAMED and RENAMED[param] & set(pp), f"{modname}.{name} lacks {param!r}"
        renamed = set().union(*(RENAMED[q] for q in rp if q in RENAMED)) if rp else set()
        added = set(pp) - set(rp) - renamed
        assert added <= ADDED, f"{modname}.{name} adds {sorted(added - ADDED)}"
    # the data package's and serve_ot's reference names are all classes or constants
    assert checked > 0 or modname in ("repro_torch.data", "repro_torch.launch.serve_ot")


def test_batched_coo_ops_take_the_reference_parameters_in_order():
    import repro.kernels as jk

    import repro_torch.kernels as tk

    for name in ("batched_coo_matvec", "batched_coo_rmatvec", "batched_coo_logsumexp"):
        ref = list(inspect.signature(getattr(jk, name)).parameters.values())
        port = list(inspect.signature(getattr(tk, name)).parameters.values())
        assert [(q.name, q.kind, q.default) for q in port[: len(ref)]] == [(q.name, q.kind, q.default) for q in ref]
        assert [q.name for q in port[len(ref):]] == ["layout"]


def test_registry_methods_and_batchable_methods_are_the_reference():
    import repro.batch as jb
    import repro.core as jc

    import repro_torch.batch as tb
    import repro_torch.core as tc

    assert tc.available_methods() == jc.available_methods()
    assert tb.batchable_methods() == jb.batchable_methods()
    assert len(tc.available_methods()) == 11
