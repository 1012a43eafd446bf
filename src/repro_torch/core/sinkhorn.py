"""Sinkhorn loops for entropic OT (Alg. 1) and UOT (Alg. 2) on torch tensors.

The port of ``repro.core.sinkhorn``. The reference runs each loop inside
``lax.while_loop``; here a Python loop runs the same body on the device and
keeps the ``while`` condition as a device-side ``active`` flag. Once the
flag is false, ``torch.where`` freezes every piece of state, so the loop
reports the reference's ``n_iter`` and ``status`` while the host reads the
flag only every ``check_every`` iterations (one sync per check instead of
one per iteration). A frozen iteration still costs its compute: at most
``check_every - 1`` of them run after the stopping rule fires.

* scaling domain: ``u <- (a / K v)^fe``, ``v <- (b / K^T u)^fe`` with
  ``fe = lam / (lam + eps)`` (``fe = 1`` is balanced OT), stopping on
  ``||du||_1 + ||dv||_1 <= tol``;
* log domain: potentials ``f = eps log u``, ``g = eps log v``, stopping on
  ``max|df| + max|dg| <= tol``.

``trace=True`` (or a ring length) carries a `repro_torch.obs.SolverTrace`
in the loop state, so a frozen iteration writes no record; with the
default ``trace=False`` a loop dispatches exactly the ops it did before
telemetry. The log loops take ``init=(f0, g0)`` to warm-start the
potentials.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch.obs import spans
from repro_torch.obs.trace import SolverTrace, empty_trace, record_iteration, resolve_trace_len

__all__ = [
    "STATUS_CONVERGED",
    "STATUS_DEGENERATE",
    "STATUS_LABELS",
    "STATUS_MAX_ITER",
    "STATUS_NONFINITE",
    "STATUS_STALL",
    "SinkhornResult",
    "entropy",
    "generic_log_loop",
    "generic_scaling_loop",
    "generic_sparse_log_loop",
    "kl_divergence",
    "ot_cost_from_plan",
    "plan_from_potentials",
    "plan_from_scalings",
    "sinkhorn",
    "sinkhorn_log",
    "sinkhorn_uot",
    "sinkhorn_uot_log",
    "uot_cost_from_plan",
]

STATUS_CONVERGED = 0  # stopping rule met (err <= tol)
STATUS_MAX_ITER = 1  # iteration budget exhausted before err <= tol
STATUS_STALL = 2  # stall detection fired
STATUS_NONFINITE = 3  # err or scalings/potentials went NaN / +inf
STATUS_DEGENERATE = 4  # all-zero scalings / all -inf potentials: empty plan

STATUS_LABELS = ("converged", "max_iter", "stall", "non_finite", "degenerate")

#: iterations between two host reads of the loop's ``active`` flag
CHECK_EVERY = 16


def _status_code(bad, degenerate, err, tol, stalled) -> torch.Tensor:
    """The one STATUS_* decision tree:
    non-finite > degenerate > tol-met > stall > max_iter."""
    stalled = torch.as_tensor(stalled, device=err.device)
    return torch.where(
        bad,
        STATUS_NONFINITE,
        torch.where(
            degenerate,
            STATUS_DEGENERATE,
            torch.where(
                err <= tol,
                STATUS_CONVERGED,
                torch.where(stalled, STATUS_STALL, STATUS_MAX_ITER),
            ),
        ),
    ).to(torch.int32)


class SinkhornResult(NamedTuple):
    """``u``/``v`` are scalings (or ``f``/``g`` potentials in the log domain);
    ``n_iter``, ``err`` and ``status`` are 0-d tensors on the same device."""

    u: torch.Tensor
    v: torch.Tensor
    n_iter: torch.Tensor
    err: torch.Tensor
    #: why the loop stopped: one of the ``STATUS_*`` codes
    status: torch.Tensor | None = None
    #: per-iteration ring-buffer telemetry; ``None`` unless ``trace=True``
    trace: SolverTrace | None = None

    @property
    def converged(self) -> torch.Tensor | None:
        return None if self.status is None else self.status == STATUS_CONVERGED


def _l1(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.abs(x))


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """``num/den`` with 0 where ``den == 0`` (empty kernel rows: the atom's
    scaling stays inert)."""
    pos = den > 0
    return torch.where(pos, num / torch.where(pos, den, 1.0), 0.0)


def _masked_log(x: torch.Tensor) -> torch.Tensor:
    """``log x`` with ``-inf`` at ``x <= 0`` (dead atoms)."""
    pos = x > 0
    return torch.log(torch.where(pos, x, 1.0)) + torch.where(pos, 0.0, -math.inf)


def _run(state: dict, active: torch.Tensor, step, max_iter: int) -> tuple[dict, torch.Tensor]:
    """Drive ``step(state) -> (new_state, still_active)`` for at most
    ``max_iter`` iterations. Each new value is taken only where ``active``
    holds, so once the condition fails the state is frozen exactly as the
    reference's ``while_loop`` leaves it.

    Records the ``sinkhorn.loop`` span (`repro_torch.obs.spans`) with the
    iterations launched and the iterations the state took (``t`` at exit,
    read only when the span is)."""
    with spans.span("sinkhorn.loop", device=active.device, batch=1):
        launched = 0
        for it in range(max_iter):
            if it % CHECK_EVERY == 0 and not bool(active):
                break
            new, cond = step(state)
            state = {k: torch.where(active, new[k], state[k]) for k in state}
            active = active & cond
            launched += 1
        spans.annotate(launched=launched, element_iters=state["t"])
    return state, active


def _trace_state(trace: bool | int, dtype, device) -> dict:
    """The ring buffers of a traced loop, as entries of its state."""
    tr = empty_trace(resolve_trace_len(trace), dtype, device=device)
    return dict(trace_err=tr.err, trace_marg=tr.marg, n_matvec=tr.n_matvec)


def _trace_of(s: dict) -> SolverTrace:
    return SolverTrace(s["trace_err"], s["trace_marg"], s["n_matvec"])


def _record(s: dict, err: torch.Tensor, marg: torch.Tensor) -> dict:
    """State entries with iteration ``s["t"]``'s record written."""
    tr = record_iteration(_trace_of(s), s["t"], err, marg)
    return dict(trace_err=tr.err, trace_marg=tr.marg, n_matvec=tr.n_matvec)


def _warm_start(init, like: torch.Tensor) -> torch.Tensor:
    """An ``init`` potential on ``like``'s dtype and device, its non-finite
    entries at 0 (``-inf`` dead-atom pins of an earlier solve must not wedge
    the stopping rule)."""
    x = torch.as_tensor(init, dtype=like.dtype, device=like.device)
    return torch.where(torch.isfinite(x), x, 0.0)


def generic_scaling_loop(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    rmatvec: Callable[[torch.Tensor], torch.Tensor],
    a: torch.Tensor,
    b: torch.Tensor,
    fe: float = 1.0,
    *,
    tol: float = 1e-6,
    max_iter: int = 1000,
    patience: int = 100,
    trace: bool | int = False,
) -> SinkhornResult:
    """Scaling-domain Sinkhorn: the shared engine behind Algorithms 1-4.

    Stops on the paper's rule ``||du||_1 + ||dv||_1 <= tol``, or on stall:
    when the column-marginal violation has not improved by a relative 1e-4
    for ``patience`` iterations (a random sketch whose bipartite graph
    pinches a sub-marginal converges in plan while its scalings drift).
    ``trace`` records each iteration's error and that violation.
    """
    dev = a.device
    # finite "huge" sentinel: keeps the first check truthy while letting
    # isfinite(err) tell a diverged (+inf) error apart
    big = torch.tensor(torch.finfo(a.dtype).max, dtype=a.dtype, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    state = dict(
        u=torch.ones_like(a), v=torch.ones_like(b), t=zero, err=big, best=big, since=zero
    )
    if trace:
        state.update(_trace_state(trace, a.dtype, dev))

    def cond(s):
        return (
            (s["err"] > tol) & torch.isfinite(s["err"])
            & (s["t"] < max_iter) & (s["since"] < patience)
        )

    def step(s):
        u, v = s["u"], s["v"]
        u_new = _safe_div(a, matvec(v)) ** fe
        KTu = rmatvec(u_new)
        v_new = _safe_div(b, KTu) ** fe
        err = _l1(u_new - u) + _l1(v_new - v)
        # stall metric (free): column-marginal violation before the v-update
        marg = _l1(v * KTu - b)
        improved = marg < s["best"] * (1.0 - 1e-4)
        new = dict(
            u=u_new, v=v_new, t=s["t"] + 1, err=err,
            best=torch.minimum(s["best"], marg),
            since=torch.where(improved, 0, s["since"] + 1).to(torch.int32),
        )
        if trace:
            new.update(_record(s, err, marg))
        return new, cond(new)

    s, _ = _run(state, cond(state), step, max_iter)
    u, v, err = s["u"], s["v"], s["err"]
    bad = ~(torch.isfinite(err) & torch.all(torch.isfinite(u)) & torch.all(torch.isfinite(v)))
    degenerate = (torch.max(u) <= 0.0) | (torch.max(v) <= 0.0)
    status = _status_code(bad, degenerate, err, tol, s["since"] >= patience)
    return SinkhornResult(u, v, s["t"], err, status, _trace_of(s) if trace else None)


def _log_domain_status(f, g, err, tol, stalled=False) -> torch.Tensor:
    """Status for potential loops: ``-inf`` potentials are dead atoms
    (legitimate), NaN / ``+inf`` are not; all ``-inf`` on a side is an
    empty plan (degenerate)."""
    bad = (
        torch.isnan(err)
        | torch.any(torch.isnan(f) | (f == math.inf))
        | torch.any(torch.isnan(g) | (g == math.inf))
    )
    degenerate = torch.all(torch.isneginf(f)) | torch.all(torch.isneginf(g))
    return _status_code(bad, degenerate, err, tol, stalled)


def generic_log_loop(
    lse_row: Callable[[torch.Tensor], torch.Tensor],
    lse_col: Callable[[torch.Tensor], torch.Tensor],
    loga: torch.Tensor,
    logb: torch.Tensor,
    eps: float,
    fe: float = 1.0,
    *,
    tol: float = 1e-9,
    max_iter: int = 1000,
    trace: bool | int = False,
    init: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> SinkhornResult:
    """Log-domain Sinkhorn on dual potentials ``f = eps log u``, ``g = eps log v``.

    ``lse_row(g) = logsumexp_j(log K_ij + g_j / eps)`` (shape n),
    ``lse_col(f) = logsumexp_i(log K_ij + f_i / eps)`` (shape m).
    Stops on ``max|f - f_prev| + max|g - g_prev| <= tol``.

    ``init=(f0, g0)`` warm-starts the potentials (re-tightening at a
    smaller ``eps`` from an eps-bumped solve); non-finite entries fall back
    to 0. The stopping rule needs no marginal, so only ``trace`` computes
    the column-marginal violation ``sum|exp(g/eps + lse_col(f_new)) - b|``.
    """
    dev = loga.device
    neg_inf_a = torch.isneginf(loga)
    neg_inf_b = torch.isneginf(logb)
    if init is None:
        f0, g0 = torch.zeros_like(loga), torch.zeros_like(logb)
    else:
        f0, g0 = _warm_start(init[0], loga), _warm_start(init[1], logb)
    state = dict(
        f=f0, g=g0,
        t=torch.zeros((), dtype=torch.int32, device=dev),
        err=torch.tensor(math.inf, dtype=loga.dtype, device=dev),
    )
    if trace:
        state.update(_trace_state(trace, loga.dtype, dev))
        b_lin = torch.exp(logb)

    def cond(s):
        return (s["err"] > tol) & (s["t"] < max_iter)

    def step(s):
        f_new = fe * eps * (loga - lse_row(s["g"]))
        f_new = torch.where(neg_inf_a, -math.inf, f_new)
        lc = lse_col(f_new)
        g_new = fe * eps * (logb - lc)
        g_new = torch.where(neg_inf_b, -math.inf, g_new)
        df = torch.where(neg_inf_a, 0.0, torch.abs(f_new - s["f"]))
        dg = torch.where(neg_inf_b, 0.0, torch.abs(g_new - s["g"]))
        new = dict(f=f_new, g=g_new, t=s["t"] + 1, err=torch.max(df) + torch.max(dg))
        if trace:
            g = s["g"]
            col_marg = torch.where(torch.isneginf(g) | torch.isneginf(lc), 0.0, torch.exp(g / eps + lc))
            new.update(_record(s, new["err"], torch.sum(torch.abs(col_marg - b_lin))))
        return new, cond(new)

    s, _ = _run(state, cond(state), step, max_iter)
    f, g, err = s["f"], s["g"], s["err"]
    return SinkhornResult(f, g, s["t"], err, _log_domain_status(f, g, err, tol), _trace_of(s) if trace else None)


def generic_sparse_log_loop(
    lse_row: Callable[[torch.Tensor], torch.Tensor],
    lse_col: Callable[[torch.Tensor], torch.Tensor],
    loga: torch.Tensor,
    logb: torch.Tensor,
    eps: float,
    fe: float = 1.0,
    *,
    tol: float = 1e-6,
    max_iter: int = 1000,
    patience: int = 100,
    trace: bool | int = False,
    init: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> SinkhornResult:
    """Log-domain Sinkhorn on a sparse (sketched) kernel.

    `generic_log_loop`'s update and stopping rule, plus two conventions for
    random sketches: an atom whose sparse logsumexp is ``-inf`` (no live
    sampled entry) is pinned to ``-inf``, the log image of the scaling
    loop's `_safe_div` zeros; and the scaling loop's stall detection on the
    column-marginal violation, which ``trace`` records. ``init=(f0, g0)``
    warm-starts as in `generic_log_loop`, dead atoms then pinned.
    """
    dev = loga.device
    neg_inf_a = torch.isneginf(loga)
    neg_inf_b = torch.isneginf(logb)
    big = torch.tensor(torch.finfo(loga.dtype).max, dtype=loga.dtype, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    # dead atoms start pinned, so their first 0 -> -inf jump is no error
    if init is None:
        f0 = torch.where(neg_inf_a, -math.inf, torch.zeros_like(loga))
        g0 = torch.where(neg_inf_b, -math.inf, torch.zeros_like(logb))
    else:
        f0 = torch.where(neg_inf_a, -math.inf, _warm_start(init[0], loga))
        g0 = torch.where(neg_inf_b, -math.inf, _warm_start(init[1], logb))
    state = dict(f=f0, g=g0, t=zero, err=big, best=big, since=zero)
    if trace:
        state.update(_trace_state(trace, loga.dtype, dev))
    b_lin = torch.exp(logb)

    def cond(s):
        return (s["err"] > tol) & (s["t"] < max_iter) & (s["since"] < patience)

    def step(s):
        f, g = s["f"], s["g"]
        lr = lse_row(g)
        f_new = fe * eps * (loga - lr)
        f_new = torch.where(neg_inf_a | torch.isneginf(lr), -math.inf, f_new)
        lc = lse_col(f_new)
        g_new = fe * eps * (logb - lc)
        g_new = torch.where(neg_inf_b | torch.isneginf(lc), -math.inf, g_new)
        df = torch.where(torch.isneginf(f_new) & torch.isneginf(f), 0.0, torch.abs(f_new - f))
        dg = torch.where(torch.isneginf(g_new) & torch.isneginf(g), 0.0, torch.abs(g_new - g))
        # stall metric (free): column marginal of the pre-update plan
        col_marg = torch.where(
            torch.isneginf(g) | torch.isneginf(lc), 0.0, torch.exp(g / eps + lc)
        )
        marg = torch.sum(torch.abs(col_marg - b_lin))
        improved = marg < s["best"] * (1.0 - 1e-4)
        new = dict(
            f=f_new, g=g_new, t=s["t"] + 1, err=torch.max(df) + torch.max(dg),
            best=torch.minimum(s["best"], marg),
            since=torch.where(improved, 0, s["since"] + 1).to(torch.int32),
        )
        if trace:
            new.update(_record(s, new["err"], marg))
        return new, cond(new)

    s, _ = _run(state, cond(state), step, max_iter)
    f, g, err = s["f"], s["g"], s["err"]
    status = _log_domain_status(f, g, err, tol, s["since"] >= patience)
    return SinkhornResult(f, g, s["t"], err, status, _trace_of(s) if trace else None)


# --------------------------------------------------------------------------
# Dense-kernel front ends (Algorithms 1 and 2)
# --------------------------------------------------------------------------


def sinkhorn(
    K, a, b, *, tol: float = 1e-6, max_iter: int = 1000, trace: bool | int = False
) -> SinkhornResult:
    """Algorithm 1: SINKHORNOT(K, a, b, tol)."""
    return generic_scaling_loop(
        lambda v: K @ v, lambda u: K.T @ u, a, b, 1.0, tol=tol, max_iter=max_iter, trace=trace
    )


def sinkhorn_uot(
    K, a, b, lam: float, eps: float, *, tol: float = 1e-6, max_iter: int = 1000,
    trace: bool | int = False,
) -> SinkhornResult:
    """Algorithm 2: SINKHORNUOT(K, a, b, lam, eps, tol)."""
    return generic_scaling_loop(
        lambda v: K @ v, lambda u: K.T @ u, a, b, lam / (lam + eps),
        tol=tol, max_iter=max_iter, trace=trace,
    )


def _dense_lse(logK: torch.Tensor, eps: float):
    def lse_row(g):
        return torch.logsumexp(logK + g[None, :] / eps, dim=1)

    def lse_col(f):
        return torch.logsumexp(logK + f[:, None] / eps, dim=0)

    return lse_row, lse_col


def sinkhorn_log(
    logK, a, b, eps: float, *, tol: float = 1e-9, max_iter: int = 1000,
    trace: bool | int = False, init: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> SinkhornResult:
    """Log-domain Algorithm 1; returns potentials ``(f, g)``; ``init=(f0,
    g0)`` warm-starts them (see `generic_log_loop`)."""
    return generic_log_loop(
        *_dense_lse(logK, eps), _masked_log(a), _masked_log(b), eps, 1.0,
        tol=tol, max_iter=max_iter, trace=trace, init=init,
    )


def sinkhorn_uot_log(
    logK, a, b, lam: float, eps: float, *, tol: float = 1e-9, max_iter: int = 1000,
    trace: bool | int = False, init: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> SinkhornResult:
    """Log-domain Algorithm 2; returns potentials ``(f, g)``."""
    return generic_log_loop(
        *_dense_lse(logK, eps), _masked_log(a), _masked_log(b), eps,
        lam / (lam + eps), tol=tol, max_iter=max_iter, trace=trace, init=init,
    )


# --------------------------------------------------------------------------
# Plans and objective values
# --------------------------------------------------------------------------


def plan_from_scalings(u, K, v) -> torch.Tensor:
    """``T = diag(u) K diag(v)`` (paper eq. 3)."""
    return u[:, None] * K * v[None, :]


def plan_from_potentials(f, logK, g, eps: float) -> torch.Tensor:
    logT = logK + f[:, None] / eps + g[None, :] / eps
    return torch.where(torch.isneginf(logT), 0.0, torch.exp(logT))


def entropy(T: torch.Tensor) -> torch.Tensor:
    """``H(T) = -sum T_ij (log T_ij - 1)`` with 0 log 0 = 0."""
    pos = T > 0
    logT = torch.log(torch.where(pos, T, 1.0))
    return -torch.sum(torch.where(pos, T * (logT - 1.0), 0.0))


def kl_divergence(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``KL(x || y) = sum x log(x/y) - x + y`` with 0 log 0 = 0."""
    ratio = torch.log(torch.where(x > 0, x, 1.0)) - torch.log(torch.where(y > 0, y, 1.0))
    return torch.sum(torch.where(x > 0, x * ratio, 0.0) - x + y)


def _transport_cost(T, C) -> torch.Tensor:
    return torch.sum(torch.where(T > 0, T * torch.where(torch.isinf(C), 0.0, C), 0.0))


def ot_cost_from_plan(T, C, eps: float) -> torch.Tensor:
    """Entropic OT objective (paper eq. 6): ``<T, C> - eps H(T)``."""
    return _transport_cost(T, C) - eps * entropy(T)


def uot_cost_from_plan(T, C, a, b, lam: float, eps: float) -> torch.Tensor:
    """Entropic UOT objective (paper eq. 10)."""
    return (
        _transport_cost(T, C)
        + lam * kl_divergence(torch.sum(T, dim=1), a)
        + lam * kl_divergence(torch.sum(T, dim=0), b)
        - eps * entropy(T)
    )
