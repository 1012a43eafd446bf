"""Guard the port's public surface against drift, on the model of the
reference's ``tools/check_api_surface.py``.

Each guarded module's ``__all__`` resolves, is sorted and holds no
duplicate, and every public name the module binds is declared. Every name
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
}

#: names the port exports beyond its counterpart, and why
PORT_EXTRAS = {
    # the block-ELL sketch builder is public in the port: the parity tests
    # and chip_smoke.py build, feed and time the sketch apart from the solve
    "repro_torch.core.api": {"build_block_ell_sketch"},
    # the top level takes its other names from repro.core and repro.core.api
    # (DEFAULT_TOL, mix_uniform, get_solver and sampling_probs from the
    # latter); it adds the block-ELL builder and the observability subpackage
    "repro_torch": {"build_block_ell_sketch", "obs"},
}

#: reference parameter -> the port's parameters in its place, and why
RENAMED = {
    # a JAX PRNG key; the port draws from a torch.Generator (Philox, not
    # threefry), passed as such or as an int seed
    "key": {"generator", "seed"},
    "keys": {"generators", "seeds"},
}
#: reference parameters the port drops, and why: Pallas's interpret mode and
#: tile sizes mean nothing to a CUDA kernel, whose tiles its source fixes
DROPPED = {"interpret", "block_n", "block_m", "block_s"}
#: parameters the port adds, and why
ADDED = {
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
    return {n for n, v in vars(mod).items() if not n.startswith("_") and not isinstance(v, types.ModuleType)}


@pytest.mark.parametrize("modname", sorted(COUNTERPARTS))
def test_all_resolves_sorted_without_duplicates_and_declares_every_export(modname):
    mod = importlib.import_module(modname)
    declared = list(mod.__all__)
    assert declared, f"{modname}: empty __all__"
    assert len(set(declared)) == len(declared), f"{modname}: duplicate __all__ entries"
    assert declared == sorted(declared), f"{modname}: __all__ is not sorted"
    missing = [n for n in declared if not hasattr(mod, n)]
    assert not missing, f"{modname}: in __all__ but not bound: {missing}"
    undeclared = sorted(_public(mod) - set(declared))
    assert not undeclared, f"{modname}: exported but not in __all__: {undeclared}"


@pytest.mark.parametrize("modname", sorted(COUNTERPARTS))
def test_every_reference_name_has_its_counterpart(modname):
    port = importlib.import_module(modname)
    refname = COUNTERPARTS[modname]
    if refname is None:
        ref_names = set(importlib.import_module("repro.core").__all__) | set(
            importlib.import_module("repro.core.api").__all__)
        extras = set(port.__all__) - ref_names
    else:
        ref_names = set(importlib.import_module(refname).__all__)
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
    ref = importlib.import_module(COUNTERPARTS[modname])
    checked = 0
    for name in ref.__all__:
        r, p = getattr(ref, name), getattr(port, name)
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
    assert checked > 0 or modname == "repro_torch.data"


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
