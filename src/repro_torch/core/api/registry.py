"""String-keyed solver registry behind `solve()`.

A solver is a callable ``solver(problem, **opts) -> Solution`` registered
under a name with :func:`register_solver`. Unknown names raise ``KeyError``
listing what is available; unknown or missing options raise ``TypeError``
listing the valid ones.
"""
from __future__ import annotations

import inspect
from typing import Callable

from repro_torch.core.api.problems import OTProblem
from repro_torch.core.api.solution import Solution
from repro_torch.obs import spans

__all__ = ["available_methods", "get_solver", "method_accepts", "register_solver", "solve"]

SolverFn = Callable[..., Solution]

_REGISTRY: dict[str, SolverFn] = {}


def register_solver(name: str) -> Callable[[SolverFn], SolverFn]:
    """Decorator: register ``fn`` as ``solve(..., method=name)``."""

    def deco(fn: SolverFn) -> SolverFn:
        if name in _REGISTRY:
            raise ValueError(f"solver {name!r} already registered")
        _REGISTRY[name] = fn
        return fn

    return deco


def _ensure_builtin_solvers() -> None:
    # importing the module runs its register_solver decorators
    from repro_torch.core.api import solvers  # noqa: F401


def available_methods() -> list[str]:
    _ensure_builtin_solvers()
    return sorted(_REGISTRY)


def get_solver(method: str) -> SolverFn:
    _ensure_builtin_solvers()
    try:
        return _REGISTRY[method]
    except KeyError:
        raise KeyError(
            f"unknown solver method {method!r}; available: {', '.join(sorted(_REGISTRY))}"
        ) from None


def _option_names(fn: SolverFn) -> list[str]:
    return [n for n in inspect.signature(fn).parameters if n != "problem"]


def method_accepts(method: str, option: str) -> bool:
    """Whether a registered method's solver takes ``option`` as a keyword."""
    params = inspect.signature(get_solver(method)).parameters
    return any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()) or option in params


def solve(problem: OTProblem, method: str = "dense", *, robust: bool = False, policy=None, **opts) -> Solution:
    """Solve an `OTProblem`/`UOTProblem` with a registered method.

    Common options: ``tol``, ``max_iter``, ``certify`` (all eleven
    methods) and ``trace`` (all but ``greenkhorn``, ``nys_sink`` and
    ``screenkhorn_lite``); ``log``, ``spar_sink_log`` and
    ``spar_sink_mf(stabilize=True)`` take ``init=(f0, g0)``. The sketching
    methods (``spar_sink_coo``, ``spar_sink_log``, ``spar_sink_mf``,
    ``spar_sink_block_ell``, ``spar_sink_dense``, ``rand_sink``) also take
    ``s`` (expected sketch size), and they and ``nys_sink`` take
    ``generator=`` (a `torch.Generator` on the problem's device) or
    ``seed=``; see `repro_torch.core.api.solvers`.

    The solve records the ``solve`` span (`repro_torch.obs.spans`), with
    the sketching solvers' ``solve.sketch``, the loop's ``sinkhorn.setup``
    and ``sinkhorn.loop``, and ``solve.value`` under it.

    ``robust=True`` runs the same solve under the self-healing escalation
    ladder (`repro_torch.robust.solve_robust`) and returns a
    `repro_torch.robust.RobustSolution`: attempt 0 is this exact solve, so a
    converged first attempt is bitwise the ``robust=False`` one. ``policy``
    (an `repro_torch.robust.EscalationPolicy`) tunes the ladder and implies
    ``robust=True``.
    """
    if robust or policy is not None:
        from repro_torch.robust.ladder import solve_robust  # local: the ladder imports this module

        return solve_robust(problem, method, policy=policy, **opts)
    with spans.span("solve", device=problem.device):
        problem.check_valid()
        fn = get_solver(method)
        params = inspect.signature(fn).parameters
        invalid = sorted(set(opts) - set(params))
        if invalid:
            raise TypeError(
                f"method {method!r} got unexpected option(s) {invalid}; "
                f"valid options: {_option_names(fn)}"
            )
        missing = sorted(
            n for n, p in params.items()
            if n != "problem" and p.default is inspect.Parameter.empty and n not in opts
        )
        if missing:
            raise TypeError(
                f"method {method!r} requires option(s) {missing}; valid options: {_option_names(fn)}"
            )
        return fn(problem, **opts)
