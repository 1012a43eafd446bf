"""The self-healing escalation ladder behind ``solve_robust``.

The port of ``repro.robust.ladder``. After every attempt the ladder
inspects the solve's telemetry (``Solution.status``,
``Solution.overflowed`` and, where the policy asks, the
`repro_torch.obs.Certificate` quality floors) and picks the one
deterministic recovery that the failure mode calls for:

=================  ========================================================
trigger            action (cost)
=================  ========================================================
``degenerate`` /   rescale -> **log-domain sibling** of the method (same
``non_finite``     sketch support for the same random source; one solve)
``overflowed`` or  **re-sketch** from a fresh random source (`_fresh_seed`
low ESS/bound      of the attempt's) and a ``cap_growth``-multiplied cap
``stall``          **eps bump** (``eps * eps_bump``, log-domain method)
                   then **re-tighten** at the original eps with
                   warm-started potentials (two solves)
``max_iter``       **grow budget** (``max_iter * max_iter_growth``),
                   warm-started where the method supports ``init=``
out of rungs       **dense log-domain last resort** below ``dense_guard``
=================  ========================================================

The first attempt runs the caller's exact method and options: with the
default policy, ``robust=True`` adds no work when that attempt converges,
and the returned solution is bitwise the plain ``solve()`` one.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch._device import generator_at
from repro_torch.core.api.problems import OTProblem
from repro_torch.core.api.registry import method_accepts, solve
from repro_torch.core.api.solution import Solution
from repro_torch.core.spar_sink import default_cap
from repro_torch.obs.metrics import MetricsRegistry, default_registry
from repro_torch.robust.policy import Attempt, EscalationPolicy, RobustSolution

__all__ = ["escalate_from", "solve_robust"]

#: scaling-domain method -> (log-domain sibling, extra options). The
#: sibling re-solves the same problem without evaluating exp(-C/eps); for
#: the sketching methods the sampled support is the same for the same
#: random source.
_LOG_SIBLING: dict[str, tuple[str, dict]] = {
    "dense": ("log", {}),
    "greenkhorn": ("log", {}),
    "nys_sink": ("log", {}),
    "screenkhorn_lite": ("log", {}),
    "rand_sink": ("spar_sink_log", {}),
    "spar_sink_coo": ("spar_sink_log", {}),
    "spar_sink_block_ell": ("spar_sink_log", {}),
    "spar_sink_dense": ("log", {}),
    "spar_sink_mf": ("spar_sink_mf", {"stabilize": True}),
}


def _is_sketching(method: str) -> bool:
    """Methods whose randomness a fresh random source can re-draw."""
    return method_accepts(method, "seed") and method_accepts(method, "s")


def _fresh_seed(opts: dict, attempt_index: int) -> int | None:
    """A seed for the re-sketch of attempt ``attempt_index``, mixed from the
    attempt's own source: its ``seed``, or its ``generator``'s initial seed
    (not its state, which the earlier draws advanced). None without either."""
    if opts.get("seed") is not None:
        base = int(opts["seed"])
    elif opts.get("generator") is not None:
        base = int(opts["generator"].initial_seed())
    else:
        return None
    return int(np.random.SeedSequence([base, attempt_index]).generate_state(1, np.uint64)[0] >> 1)


def _supports_init(method: str, opts: dict) -> bool:
    """Can this method warm-start from ``(f, g)`` potentials?"""
    if not method_accepts(method, "init"):
        return False
    if method == "spar_sink_mf" and not opts.get("stabilize"):
        return False
    return True


def _as_bool(x) -> bool:
    return bool(x)


def _float_or_none(x) -> float | None:
    if x is None:
        return None
    try:
        return float(x)
    except (TypeError, ValueError):
        return None


def _diagnose(sol: Solution, policy: EscalationPolicy) -> str | None:
    """Failure kind of one attempt, or None when it is acceptable.

    Kinds: ``overflow`` | ``low_quality`` | ``degenerate`` |
    ``non_finite`` | ``stall`` | ``max_iter``. Order matters: an
    overflowed sketch is biased even when the iteration converged on it.
    A non-finite value is ``non_finite`` whatever the status says (a NaN
    kernel entry of a sketch reads as an empty row to the scaling loop,
    which can then stop ``converged`` on a NaN objective); the reference
    checks the status alone.
    """
    if sol.overflowed is not None and _as_bool(sol.overflowed):
        return "overflow"
    label = sol.status_label  # None for budget-only solvers (greenkhorn)
    if label is not None and label != "converged":
        return label
    if not math.isfinite(float(sol.value)):
        return "non_finite"
    if policy.wants_certificate:
        cert = sol.certificate
        if cert is None:
            return "low_quality"  # policy demands a certificate; none attached
        ess = _float_or_none(getattr(cert, "ess", None))
        if policy.ess_floor > 0 and ess is not None and not ess >= policy.ess_floor:
            return "low_quality"
        if math.isfinite(policy.error_bound_tol):
            eb = _float_or_none(cert.error_bound)
            if eb is None or not eb <= policy.error_bound_tol:
                return "low_quality"
    return None


def _record(
    index: int, method: str, problem: OTProblem, sol: Solution,
    action: str, opts: dict,
) -> Attempt:
    label = sol.status_label
    cert = sol.certificate
    n_iter = int(sol.n_iter)
    cap = opts.get("cap")
    return Attempt(
        index=index,
        method=method,
        action=action,
        eps=float(problem.eps),
        status=label,
        converged=label == "converged",
        n_iter=n_iter,
        matvecs=2 * n_iter,
        value=float(sol.value),
        error_bound=_float_or_none(cert.error_bound) if cert is not None else None,
        overflowed=(
            _as_bool(sol.overflowed) if sol.overflowed is not None else None
        ),
        cap=int(cap) if cap is not None else None,
    )


def _filtered(opts: dict, method: str) -> dict:
    """Options the target method actually accepts (drops e.g. block sizes
    when escalating ``spar_sink_block_ell`` -> ``spar_sink_log``)."""
    out = {k: v for k, v in opts.items() if method_accepts(method, k)}
    out.pop("init", None)  # stale warm starts never cross an action
    return out


def _grown_cap(opts: dict, policy: EscalationPolicy) -> int | None:
    cap = opts.get("cap")
    if cap is None:
        s = opts.get("s")
        if s is None:
            return None
        cap = default_cap(float(s))
    return int(math.ceil(float(cap) * policy.cap_growth))


class _Ladder:
    """Mutable escalation state for one robust solve (host-side only)."""

    def __init__(self, problem: OTProblem, policy: EscalationPolicy):
        self.problem = problem
        self.policy = policy
        self.bumped = False
        self.retightened = False
        self.dense_tried = False

    def next_action(
        self, kind: str | None, on_target: bool,
        method: str, opts: dict, sol: Solution, attempt_index: int,
    ) -> tuple[str, str, dict, OTProblem] | None:
        """The next rung: ``(action, method, opts, problem)`` or None."""
        policy = self.policy
        if not on_target:
            # the previous rung was the eps-bumped stepping stone: if it is
            # acceptable, re-tighten at the original eps, warm-started
            if kind is None:
                self.retightened = True
                opts2 = dict(opts)
                opts2.pop("init", None)
                if _supports_init(method, opts2):
                    opts2["init"] = sol.potentials
                return ("retighten", method, opts2, self.problem)
            # the bump itself failed: fall through and ladder on its kind
        if kind in ("overflow", "low_quality"):
            if _is_sketching(method):
                return self._resketch(method, opts, attempt_index)
            return self._dense_last_resort(opts)
        if kind in ("degenerate", "non_finite"):
            sib = _LOG_SIBLING.get(method)
            if sol.domain != "log" and sib is not None:
                new_method, extra = sib
                opts2 = _filtered(opts, new_method)
                opts2.update(extra)
                return ("log_domain", new_method, opts2, self.problem)
            if _is_sketching(method):
                return self._resketch(method, opts, attempt_index)
            return self._dense_last_resort(opts)
        if kind == "stall":
            if self.bumped:
                # bump + retighten already spent; sparse stall after that
                # means the sketch graph itself pinches — dense log rescue
                return self._dense_last_resort(opts)
            self.bumped = True
            target, extra = method, {}
            if sol.domain != "log" and method in _LOG_SIBLING:
                target, extra = _LOG_SIBLING[method]
            opts2 = _filtered(opts, target)
            opts2.update(extra)
            bumped = dataclasses.replace(
                self.problem, eps=float(self.problem.eps) * policy.eps_bump
            )
            return ("eps_bump", target, opts2, bumped)
        if kind == "max_iter":
            opts2 = dict(opts)
            opts2.pop("init", None)
            grown = int(opts2.get("max_iter", 1000) * policy.max_iter_growth)
            opts2["max_iter"] = grown
            if sol.domain == "log" and _supports_init(method, opts2):
                opts2["init"] = sol.potentials
            return ("grow_budget", method, opts2, self.problem)
        return None

    def _resketch(self, method: str, opts: dict, attempt_index: int):
        opts2 = dict(opts)
        opts2.pop("init", None)
        seed = _fresh_seed(opts2, attempt_index)
        if seed is None:
            return self._dense_last_resort(opts)
        opts2.pop("generator", None)
        opts2["seed"] = seed
        if method_accepts(method, "cap"):
            cap = _grown_cap(opts2, self.policy)
            if cap is not None:
                opts2["cap"] = cap
        return ("resketch", method, opts2, self.problem)

    def _dense_last_resort(self, opts: dict):
        if self.dense_tried or not self.policy.dense_fallback:
            return None
        n, m = self.problem.shape
        if max(n, m) > self.policy.dense_guard:
            return None
        guard = getattr(self.problem.geom, "dense_guard", None)
        if guard is not None and max(n, m) > guard:
            return None  # the geometry itself refuses to densify
        self.dense_tried = True
        return ("dense_log", "log", _filtered(opts, "log"), self.problem)


def escalate_from(
    problem: OTProblem,
    method: str,
    first: Solution,
    *,
    policy: EscalationPolicy | None = None,
    metrics: MetricsRegistry | None = None,
    **opts,
) -> RobustSolution:
    """Run the ladder starting from an already-computed first attempt.

    This is the entry point the batched executor and the server use: they
    solved attempt 0 inside a batched dispatch, and only failed elements
    pay for per-problem escalation. ``solve_robust`` is this plus the
    first solve. The best on-eps attempt is kept throughout — a converged
    first attempt is never downgraded by a worse recovery attempt.

    A ``generator`` in ``opts`` must stand where attempt 0's first draw
    started (the callers pass a `generator_at` copy): each rung that takes
    it draws from a fresh copy at that state, as each rung of the reference
    reuses its immutable key, so the log-domain sibling keeps attempt 0's
    support.
    """
    policy = policy or EscalationPolicy()
    metrics = default_registry if metrics is None else metrics
    source = opts.get("generator")
    start = None if source is None else (source, source.get_state())
    ladder = _Ladder(problem, policy)
    attempts: list[Attempt] = []
    best: tuple[tuple, Solution] | None = None
    cur_method, cur_opts, cur_problem = method, dict(opts), problem
    sol, action = first, "initial"
    while True:
        att = _record(
            len(attempts), cur_method, cur_problem, sol, action, cur_opts
        )
        attempts.append(att)
        kind = _diagnose(sol, policy)
        on_target = float(cur_problem.eps) == float(problem.eps)
        if on_target:
            rank = (att.converged, not bool(att.overflowed))
            if best is None or rank >= best[0]:
                best = (rank, sol)
            if kind is None:
                return RobustSolution(sol, tuple(attempts), recovered=True)
        if len(attempts) >= policy.max_attempts:
            break
        nxt = ladder.next_action(
            kind, on_target, cur_method, cur_opts, sol, len(attempts)
        )
        if nxt is None:
            break
        action, cur_method, cur_opts, cur_problem = nxt
        if policy.wants_certificate and method_accepts(cur_method, "certify"):
            cur_opts.setdefault("certify", True)
        metrics.counter("ot_escalations_total")
        if start is not None and cur_opts.get("generator") is not None:
            cur_opts["generator"] = generator_at(*start)
        sol = solve(cur_problem, method=cur_method, **cur_opts)
    final = best[1] if best is not None else sol
    return RobustSolution(final, tuple(attempts), recovered=False)


def solve_robust(
    problem: OTProblem,
    method: str = "dense",
    *,
    policy: EscalationPolicy | None = None,
    metrics: MetricsRegistry | None = None,
    **opts,
) -> RobustSolution:
    """``solve()`` with the self-healing escalation ladder on top.

    Attempt 0 is exactly ``solve(problem, method=method, **opts)`` — the
    same solver, bitwise-identical tensors — so with the default
    policy ``robust=True`` costs nothing on the happy path. On failure the
    ladder escalates deterministically (module docstring table) up to
    ``policy.max_attempts`` total solves, counting each escalation in
    ``metrics`` (``ot_escalations_total``). Returns a `RobustSolution`;
    check ``.recovered`` (and ``.attempts`` for the full history). Callers
    who need a hard failure instead of a best-effort answer should raise
    on ``recovered=False`` — the serving layer does exactly that.
    """
    policy = policy or EscalationPolicy()
    opts = dict(opts)
    if policy.wants_certificate and method_accepts(method, "certify"):
        opts.setdefault("certify", True)
    source = opts.get("generator")
    start = None if source is None else source.get_state()
    first = solve(problem, method=method, **opts)
    if start is not None:
        opts["generator"] = generator_at(source, start)  # the state attempt 0 drew from
    return escalate_from(
        problem, method, first, policy=policy, metrics=metrics, **opts
    )
