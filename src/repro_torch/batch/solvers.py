"""Batched solvers: whole-batch tensor programs over a `BatchedProblem`.

The port of ``repro.batch.solvers``. Five registered batched methods mirror
the per-problem registry paths:

* ``dense``         scaling-domain Sinkhorn on the (B, n, m) Gibbs kernels
* ``log``           log-domain Sinkhorn on the (B, n, m) log-kernels
* ``spar_sink_coo`` paper Alg. 3/4 on a fixed-cap batched COO sketch: one
                    ``(B, cap)`` index/value array, one random source a
                    problem, one flat segment-sum pair per iteration
* ``spar_sink_log`` the same sketch carried in log space (``vals`` =
                    logvals), iterated by batched segment-logsumexp on
                    potentials (`sparse_log_potentials`, which the
                    per-problem log-domain sketch solvers run at B = 1)
* ``spar_sink_mf``  matrix-free sketches (B1, the gathered kernel, builds
                    each on the card); ``stabilize=True`` runs it in the
                    log domain (B1's float64 cost-only mode)

The loops are per-element frozen versions of the per-problem loops of
`repro_torch.core.sinkhorn`: one host loop runs until every element has met
its own stopping rule, an ``active`` flag of shape (B,) freezes each
finished element's state through ``torch.where``, and the host reads
``active.any()`` once every ``CHECK_EVERY`` iterations. Each element keeps
the per-problem trajectory: its own ``n_iter``, stall detection and
``status``.

Sketches are drawn per element at the element's true ``(n_i, m_i)``
shape by the per-problem builders, from the same random source, and
stacked (`build_batched_sketch` and its siblings), so the batched draw is
the per-problem one. Each element's slots are padded to a multiple of
`SLOT_ALIGN` with inert entries, so its entries sit at the alignment they
have in its own sketch. The per-element objective, plan entries and
certificate are then computed by the per-problem functions on the
element's own slice.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Sequence

import torch

from repro_torch.batch.problems import BatchedProblem
from repro_torch.core import sparsify
from repro_torch.core.api.solution import _potentials_from_scalings
from repro_torch.core.api.solvers import _sketch_cert
from repro_torch.core.sinkhorn import (
    CHECK_EVERY,
    SinkhornResult,
    _masked_log,
    _safe_div,
    _status_code,
    ot_cost_from_plan,
    uot_cost_from_plan,
)
from repro_torch.core.spar_sink import (
    coo_objective_ot_entries,
    coo_objective_ot_log_entries,
    coo_objective_uot_entries,
    coo_objective_uot_log_entries,
    default_cap,
)
from repro_torch.kernels.ops import (
    batched_coo_matvec,
    batched_coo_rmatvec,
    batched_offsets,
    bind_coo_gather_logsumexp,
)
from repro_torch.obs import spans
from repro_torch.obs.certify import Certificate, dense_certificate
from repro_torch.obs.trace import SolverTrace, empty_trace, record_iteration, resolve_trace_len

__all__ = [
    "BatchedResult",
    "BatchedSketch",
    "batchable_methods",
    "batched_coo_sketch",
    "batched_log_loop",
    "batched_scaling_loop",
    "batched_sparse_log_loop",
    "build_batched_log_sketch",
    "build_batched_mf_log_sketch",
    "build_batched_mf_sketch",
    "build_batched_sketch",
    "get_batched_solver",
    "register_batched_solver",
    "sparse_log_potentials",
]

#: each element's slots in a stacked sketch are padded to a multiple of this
#: many, so that every element's entries start at the same alignment (mod
#: 128 bytes of float64) as in its own sketch, for the segment reductions
SLOT_ALIGN = 16


class BatchedSketch(NamedTuple):
    """B fixed-cap padded-COO sketches as one tensor set (the batched
    `repro_torch.core.sparsify.SparseKernelCOO`; padded slots carry vals 0,
    or ``-inf`` logvals on the log-domain paths).

    ``csort`` is the per-element column-sorted permutation (rows are sorted
    by construction). ``cost_e`` carries the gathered raw costs on the
    matrix-free and log-space paths. ``caps`` are the elements' own
    capacities: element j's sketch is ``[:, :caps[j]]`` of its row, the
    slots past it (and past the common cap) padding."""

    rows: torch.Tensor  # (B, cap) int64, per-element ascending
    cols: torch.Tensor  # (B, cap) int64
    vals: torch.Tensor  # (B, cap)
    nnz: torch.Tensor  # (B,) int64
    csort: torch.Tensor | None = None  # (B, cap) int64
    overflowed: torch.Tensor | None = None  # (B,) bool
    cost_e: torch.Tensor | None = None  # (B, cap) gathered costs
    caps: tuple[int, ...] | None = None

    @property
    def cap(self) -> int:
        return self.rows.shape[1]

    def element_cap(self, j: int) -> int:
        return self.cap if self.caps is None else self.caps[j]


class BatchedResult(NamedTuple):
    """Per-element solver outputs; the sketch fields are ``None`` off the
    sketch paths."""

    u: torch.Tensor  # (B, n) scalings (or potentials f in the log domain)
    v: torch.Tensor  # (B, m)
    n_iter: torch.Tensor  # (B,) int32
    err: torch.Tensor  # (B,)
    value: torch.Tensor  # (B,) entropic objective estimates
    rows: torch.Tensor | None = None  # (B, cap)
    cols: torch.Tensor | None = None  # (B, cap)
    vals: torch.Tensor | None = None  # (B, cap) sketch values (logvals on the log-domain paths)
    nnz: torch.Tensor | None = None  # (B,)
    overflowed: torch.Tensor | None = None  # (B,) bool: the sketch draw was truncated
    status: torch.Tensor | None = None  # (B,) int32 STATUS_* codes
    #: batched ring-buffer telemetry ((B, L) buffers, (B,) counter);
    #: ``None`` unless the solve ran with ``trace=True``
    trace: SolverTrace | None = None
    #: batched quality certificate ((B,) fields); ``None`` unless ``certify=True``
    certificate: Certificate | None = None


# --------------------------------------------------------------------------
# Batched iteration loops (per-element freezing)
# --------------------------------------------------------------------------


def _l1(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.abs(x), dim=-1)


def _run(state: dict, step, max_iter: int, batch: int, device) -> dict:
    """Drive ``step(state, active) -> (new_state, still_active)`` for at most
    ``max_iter`` iterations. Each element takes its new values only while
    its entry of ``active`` holds, so a finished element stays frozen at
    its final state; the host reads ``active.any()`` every `CHECK_EVERY`
    iterations. Records the ``sinkhorn.loop`` span as the per-problem
    driver does, ``element_iters`` summed over the B elements (padding
    duplicates count as elements)."""
    active = torch.ones(batch, dtype=torch.bool, device=device)
    with spans.span("sinkhorn.loop", device=device, batch=batch):
        launched = 0
        for it in range(max_iter):
            if it % CHECK_EVERY == 0 and not bool(active.any()):
                break
            new, cond = step(state, active)
            state = {
                k: torch.where(active.reshape((batch,) + (1,) * (old.ndim - 1)), new[k], old)
                for k, old in state.items()
            }
            active = active & cond
            launched += 1
        spans.annotate(launched=launched, element_iters=state["t"])
    return state


#: exponents that ``x ** e`` with a Python ``e`` computes by a special path
#: (a copy, square, cube, sqrt, rsqrt, reciprocal) and not by pow, on the
#: CPU and on the card
_SPECIAL_EXPONENTS = frozenset({1.0, 2.0, 3.0, 0.5, -0.5, -1.0, -2.0})


def _fe_power(fe: torch.Tensor):
    """``x -> x ** fe`` row by row, as the per-problem loops compute
    ``x ** fe`` with a Python ``fe``: one broadcast pow for every row whose
    exponent takes pow there (pow of a tensor exponent is the same function,
    so each row's bits are its per-problem ones), and one ``x ** val`` for
    each special exponent present (``fe = 1``, balanced OT, leaves ``x`` as
    it is). Two launches an update for UOT rows whatever their exponents."""
    values = set(fe.tolist())
    special = [(val, (fe == val)[:, None]) for val in sorted(values & _SPECIAL_EXPONENTS) if val != 1.0]
    general = None
    if values - _SPECIAL_EXPONENTS:
        rows = torch.ones_like(fe, dtype=torch.bool)
        for val in values & _SPECIAL_EXPONENTS:
            rows &= fe != val
        general = (rows[:, None], torch.where(rows, fe, 1.0)[:, None])

    def power(x: torch.Tensor) -> torch.Tensor:
        out = x
        if general is not None:
            out = torch.where(general[0], torch.pow(x, general[1]), out)
        for val, rows in special:
            out = torch.where(rows, x ** val, out)
        return out

    return power


def _trace_state(trace, dtype, batch: int, device) -> dict:
    tr = empty_trace(resolve_trace_len(trace), dtype, batch=batch, device=device)
    return dict(trace_err=tr.err, trace_marg=tr.marg, n_matvec=tr.n_matvec)


def _trace_of(s: dict) -> SolverTrace:
    return SolverTrace(s["trace_err"], s["trace_marg"], s["n_matvec"])


def _record(s: dict, err, marg, active) -> dict:
    tr = record_iteration(_trace_of(s), s["t"], err, marg, active=active)
    return dict(trace_err=tr.err, trace_marg=tr.marg, n_matvec=tr.n_matvec)


def batched_scaling_loop(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    rmatvec: Callable[[torch.Tensor], torch.Tensor],
    a: torch.Tensor,
    b: torch.Tensor,
    fe: torch.Tensor,
    *,
    tol: float = 1e-6,
    max_iter: int = 1000,
    patience: int = 100,
    trace: bool | int = False,
    live: tuple[torch.Tensor, torch.Tensor] | None = None,
):
    """Scaling-domain Sinkhorn over a batch; ``matvec: (B, m) -> (B, n)``.

    Each element follows the per-problem `generic_scaling_loop` (stopping
    rule, stall detection, non-finite exit) and is frozen once it stops.
    ``live`` (the batch's row and column masks) starts the bucket padding's
    scalings at 0 instead of 1, so that padding adds nothing to the first
    iteration's error and each element's trace is its per-problem one.
    Returns ``(u, v, n_iter, err, status)`` with per-element ``STATUS_*``
    codes; ``trace`` appends a batched `SolverTrace` (frozen elements stop
    recording), and the default ``False`` adds no state and no op."""
    B = a.shape[0]
    dev = a.device
    big = torch.full((B,), torch.finfo(a.dtype).max, dtype=a.dtype, device=dev)
    zero = torch.zeros((B,), dtype=torch.int32, device=dev)
    power = _fe_power(fe)
    u0, v0 = (torch.ones_like(a), torch.ones_like(b)) if live is None else (live[0].to(a.dtype), live[1].to(b.dtype))
    state = dict(u=u0, v=v0, t=zero, err=big, best=big, since=zero)
    if trace:
        state.update(_trace_state(trace, a.dtype, B, dev))

    def step(s, active):
        u, v = s["u"], s["v"]
        u_new = power(_safe_div(a, matvec(v)))
        KTu = rmatvec(u_new)
        v_new = power(_safe_div(b, KTu))
        err = _l1(u_new - u) + _l1(v_new - v)
        marg = _l1(v * KTu - b)
        improved = marg < s["best"] * (1.0 - 1e-4)
        new = dict(
            u=u_new, v=v_new, t=s["t"] + 1, err=err, best=torch.minimum(s["best"], marg),
            since=torch.where(improved, 0, s["since"] + 1).to(torch.int32),
        )
        if trace:
            new.update(_record(s, err, marg, active))
        cond = (err > tol) & torch.isfinite(err) & (new["t"] < max_iter) & (new["since"] < patience)
        return new, cond

    s = _run(state, step, max_iter, B, dev)
    u, v, err = s["u"], s["v"], s["err"]
    bad = ~(torch.isfinite(err) & torch.all(torch.isfinite(u), dim=-1) & torch.all(torch.isfinite(v), dim=-1))
    degenerate = (torch.amax(u, dim=-1) <= 0.0) | (torch.amax(v, dim=-1) <= 0.0)
    out = (u, v, s["t"], err, _status_code(bad, degenerate, err, tol, s["since"] >= patience))
    return out + (_trace_of(s),) if trace else out


def _batched_log_status(f, g, err, tol, stalled=False) -> torch.Tensor:
    """Per-element mirror of `repro_torch.core.sinkhorn._log_domain_status`."""
    bad = (
        torch.isnan(err)
        | torch.any(torch.isnan(f) | (f == math.inf), dim=-1)
        | torch.any(torch.isnan(g) | (g == math.inf), dim=-1)
    )
    degenerate = torch.all(torch.isneginf(f), dim=-1) | torch.all(torch.isneginf(g), dim=-1)
    return _status_code(bad, degenerate, err, tol, stalled)


def batched_log_loop(
    lse_row: Callable[[torch.Tensor], torch.Tensor],
    lse_col: Callable[[torch.Tensor], torch.Tensor],
    loga: torch.Tensor,
    logb: torch.Tensor,
    eps: torch.Tensor,
    fe: torch.Tensor,
    *,
    tol: float = 1e-9,
    max_iter: int = 1000,
    trace: bool | int = False,
):
    """Log-domain Sinkhorn over a batch on potentials, per-element frozen;
    ``lse_row(g): (B, m) -> (B, n)`` and back, ``eps``/``fe`` are (B,).
    Returns ``(f, g, n_iter, err, status)``; ``trace`` appends a batched
    `SolverTrace` (the column-marginal violation is computed only then)."""
    B = loga.shape[0]
    dev = loga.device
    neg_inf_a = torch.isneginf(loga)
    neg_inf_b = torch.isneginf(logb)
    scale = (fe * eps)[:, None]
    eps_col = eps[:, None]
    state = dict(
        f=torch.zeros_like(loga), g=torch.zeros_like(logb), t=torch.zeros((B,), dtype=torch.int32, device=dev),
        err=torch.full((B,), math.inf, dtype=loga.dtype, device=dev),
    )
    if trace:
        state.update(_trace_state(trace, loga.dtype, B, dev))
        b_lin = torch.exp(logb)

    def step(s, active):
        f_new = torch.where(neg_inf_a, -math.inf, scale * (loga - lse_row(s["g"])))
        lc = lse_col(f_new)
        g_new = torch.where(neg_inf_b, -math.inf, scale * (logb - lc))
        df = torch.where(neg_inf_a, 0.0, torch.abs(f_new - s["f"]))
        dg = torch.where(neg_inf_b, 0.0, torch.abs(g_new - s["g"]))
        err = torch.amax(df, dim=-1) + torch.amax(dg, dim=-1)
        new = dict(f=f_new, g=g_new, t=s["t"] + 1, err=err)
        if trace:
            g = s["g"]
            col_marg = torch.where(torch.isneginf(g) | torch.isneginf(lc), 0.0, torch.exp(g / eps_col + lc))
            new.update(_record(s, err, _l1(col_marg - b_lin), active))
        return new, (err > tol) & (new["t"] < max_iter)

    s = _run(state, step, max_iter, B, dev)
    f, g, err = s["f"], s["g"], s["err"]
    out = (f, g, s["t"], err, _batched_log_status(f, g, err, tol))
    return out + (_trace_of(s),) if trace else out


def batched_sparse_log_loop(
    lse_row: Callable[[torch.Tensor], torch.Tensor],
    lse_col: Callable[[torch.Tensor], torch.Tensor],
    loga: torch.Tensor,
    logb: torch.Tensor,
    eps: torch.Tensor,
    fe: torch.Tensor,
    *,
    tol: float = 1e-6,
    max_iter: int = 1000,
    patience: int = 100,
    trace: bool | int = False,
    init: tuple[torch.Tensor, torch.Tensor] | None = None,
):
    """Per-element frozen mirror of
    `repro_torch.core.sinkhorn.generic_sparse_log_loop`: log-domain
    Sinkhorn on B sketched kernels, atoms whose sparse logsumexp is
    ``-inf`` pinned to ``-inf`` (dead rows and inert bucket padding, which
    starts pinned), and the scaling loop's stall detection on the
    column-marginal violation. ``init=(f0, g0)``, both (B, ·), warm-starts
    the potentials (non-finite entries to 0, then dead-atom pinning).
    Returns ``(f, g, n_iter, err, status)``; ``trace`` appends a batched
    `SolverTrace`."""
    B = loga.shape[0]
    dev = loga.device
    neg_inf_a = torch.isneginf(loga)
    neg_inf_b = torch.isneginf(logb)
    if init is None:
        f0, g0 = torch.zeros_like(loga), torch.zeros_like(logb)
    else:
        f0 = torch.as_tensor(init[0], dtype=loga.dtype, device=dev)
        g0 = torch.as_tensor(init[1], dtype=logb.dtype, device=dev)
        f0 = torch.where(torch.isfinite(f0), f0, 0.0)
        g0 = torch.where(torch.isfinite(g0), g0, 0.0)
    f0 = torch.where(neg_inf_a, -math.inf, f0)
    g0 = torch.where(neg_inf_b, -math.inf, g0)
    big = torch.full((B,), torch.finfo(loga.dtype).max, dtype=loga.dtype, device=dev)
    zero = torch.zeros((B,), dtype=torch.int32, device=dev)
    scale = (fe * eps)[:, None]
    eps_col = eps[:, None]
    b_lin = torch.exp(logb)
    state = dict(f=f0, g=g0, t=zero, err=big, best=big, since=zero)
    if trace:
        state.update(_trace_state(trace, loga.dtype, B, dev))

    def step(s, active):
        f, g = s["f"], s["g"]
        lr = lse_row(g)
        f_new = torch.where(neg_inf_a | torch.isneginf(lr), -math.inf, scale * (loga - lr))
        lc = lse_col(f_new)
        g_new = torch.where(neg_inf_b | torch.isneginf(lc), -math.inf, scale * (logb - lc))
        df = torch.where(torch.isneginf(f_new) & torch.isneginf(f), 0.0, torch.abs(f_new - f))
        dg = torch.where(torch.isneginf(g_new) & torch.isneginf(g), 0.0, torch.abs(g_new - g))
        err = torch.amax(df, dim=-1) + torch.amax(dg, dim=-1)
        col_marg = torch.where(torch.isneginf(g) | torch.isneginf(lc), 0.0, torch.exp(g / eps_col + lc))
        marg = _l1(col_marg - b_lin)
        improved = marg < s["best"] * (1.0 - 1e-4)
        new = dict(
            f=f_new, g=g_new, t=s["t"] + 1, err=err, best=torch.minimum(s["best"], marg),
            since=torch.where(improved, 0, s["since"] + 1).to(torch.int32),
        )
        if trace:
            new.update(_record(s, err, marg, active))
        return new, (err > tol) & (new["t"] < max_iter) & (new["since"] < patience)

    s = _run(state, step, max_iter, B, dev)
    f, g, err = s["f"], s["g"], s["err"]
    out = (f, g, s["t"], err, _batched_log_status(f, g, err, tol, s["since"] >= patience))
    return out + (_trace_of(s),) if trace else out


# --------------------------------------------------------------------------
# Per-element pieces
# --------------------------------------------------------------------------


class _Element(NamedTuple):
    """One element's true sizes and parameters, on the host."""

    n: int
    m: int
    eps: float
    lam: float  # inf = balanced


def _elements(bp: BatchedProblem) -> list[_Element]:
    return [
        _Element(n, m, eps, lam)
        for n, m, eps, lam in zip(bp.n_sizes.tolist(), bp.m_sizes.tolist(), bp.eps.tolist(), bp.lam.tolist())
    ]


def _element_result(res, j: int, el: _Element) -> SinkhornResult:
    """Element ``j`` of batched loop outputs, sliced to its true support."""
    u, v, t, err, status = res[:5]
    return SinkhornResult(u[j, : el.n], v[j, : el.m], t[j], err[j], status[j])


def _stack_certificates(certs: list[Certificate]) -> Certificate:
    return Certificate(*(torch.stack(field) for field in zip(*certs)))


def _dense_outputs(bp: BatchedProblem, res, T: torch.Tensor, certify: bool, *, log_domain: bool):
    """Per-element objective (and certificate) of dense plans ``T``, each on
    its true support by the per-problem formulas."""
    values, certs = [], []
    for j, el in enumerate(_elements(bp)):
        T_j, C_j = T[j, : el.n, : el.m], bp.cost[j, : el.n, : el.m]
        a_j, b_j = bp.a[j, : el.n], bp.b[j, : el.m]
        if math.isinf(el.lam):
            value = ot_cost_from_plan(T_j, C_j, el.eps)
        else:
            value = uot_cost_from_plan(T_j, C_j, a_j, b_j, el.lam, el.eps)
        values.append(value)
        if certify:
            r = _element_result(res, j, el)
            f, g = (r.u, r.v) if log_domain else _potentials_from_scalings(r.u, r.v, el.eps)
            certs.append(dense_certificate(plan=T_j, cost=C_j, a=a_j, b=b_j, f=f, g=g, eps=el.eps, lam=el.lam,
                                           value=value))
    return torch.stack(values), (_stack_certificates(certs) if certify else None)


# --------------------------------------------------------------------------
# Batched solver registry
# --------------------------------------------------------------------------

BatchedSolverFn = Callable[..., BatchedResult]

_BATCH_REGISTRY: dict[str, BatchedSolverFn] = {}


def register_batched_solver(name: str) -> Callable[[BatchedSolverFn], BatchedSolverFn]:
    """Decorator: register a batched solver under the per-problem method name."""

    def deco(fn: BatchedSolverFn) -> BatchedSolverFn:
        if name in _BATCH_REGISTRY:
            raise ValueError(f"batched solver {name!r} already registered")
        _BATCH_REGISTRY[name] = fn
        return fn

    return deco


def batchable_methods() -> list[str]:
    """Method names `BucketedExecutor` can dispatch (a subset of
    `repro_torch.core.api.available_methods()`)."""
    return sorted(_BATCH_REGISTRY)


def get_batched_solver(method: str) -> BatchedSolverFn:
    try:
        return _BATCH_REGISTRY[method]
    except KeyError:
        raise KeyError(
            f"method {method!r} has no batched solver; batchable: {', '.join(sorted(_BATCH_REGISTRY))}"
        ) from None


@register_batched_solver("dense")
def batched_solve_dense(
    bp: BatchedProblem,
    generators=None,
    *,
    tol: float = 1e-6,
    max_iter: int = 1000,
    trace: bool | int = False,
    certify: bool = False,
) -> BatchedResult:
    """Scaling-domain Sinkhorn on B dense Gibbs kernels at once."""
    del generators
    K = bp.kernel()
    res = batched_scaling_loop(
        lambda vv: (K @ vv[:, :, None])[:, :, 0],
        lambda uu: (uu[:, None, :] @ K)[:, 0, :],
        bp.a, bp.b, bp.fe, tol=tol, max_iter=max_iter, trace=trace, live=(bp.row_mask(), bp.col_mask()),
    )
    u, v, t, err, status = res[:5]
    T = u[:, :, None] * K * v[:, None, :]
    value, cert = _dense_outputs(bp, res, T, certify, log_domain=False)
    return BatchedResult(u, v, t, err, value, status=status, trace=res[5] if trace else None, certificate=cert)


@register_batched_solver("log")
def batched_solve_log(
    bp: BatchedProblem,
    generators=None,
    *,
    tol: float = 1e-9,
    max_iter: int = 1000,
    trace: bool | int = False,
    certify: bool = False,
) -> BatchedResult:
    """Log-domain Sinkhorn on B log-kernels; returns potentials ``(f, g)``."""
    del generators
    logK = bp.log_kernel()
    eps3 = bp.eps[:, None, None]
    res = batched_log_loop(
        lambda gg: torch.logsumexp(logK + gg[:, None, :] / eps3, dim=2),
        lambda ff: torch.logsumexp(logK + ff[:, :, None] / eps3, dim=1),
        _masked_log(bp.a), _masked_log(bp.b), bp.eps, bp.fe, tol=tol, max_iter=max_iter, trace=trace,
    )
    f, g, t, err, status = res[:5]
    logT = logK + f[:, :, None] / eps3 + g[:, None, :] / eps3
    T = torch.where(torch.isneginf(logT), 0.0, torch.exp(logT))
    value, cert = _dense_outputs(bp, res, T, certify, log_domain=True)
    return BatchedResult(f, g, t, err, value, status=status, trace=res[5] if trace else None, certificate=cert)


# --------------------------------------------------------------------------
# Batched sketches
# --------------------------------------------------------------------------


def _caps(cap, s: float, count: int) -> list[int]:
    """Per-element capacities: ``None`` (`default_cap`), one int for all,
    or one a problem."""
    if cap is None:
        return [default_cap(s)] * count
    if isinstance(cap, int):
        return [cap] * count
    caps = [int(c) for c in cap]
    if len(caps) != count:
        raise ValueError(f"got {len(caps)} caps for {count} problems")
    return caps


def _stack(sketches, costs=None, *, log_space: bool = False) -> BatchedSketch:
    """Stack per-element sketches (and gathered costs), each padded to the
    common width, a multiple of `SLOT_ALIGN`, with inert slots: row ``n-1``
    and column ``m-1`` (where each sketch parks its own padding), value 0
    or ``-inf``, cost ``+inf``; each ``csort`` keeps the extra slots last."""
    caps = tuple(sk.cap for sk in sketches)
    width = -(-max(caps) // SLOT_ALIGN) * SLOT_ALIGN

    def pad(x: torch.Tensor, fill) -> torch.Tensor:
        return x if x.shape[0] == width else torch.cat([x, x.new_full((width - x.shape[0],), fill)])

    dead = -math.inf if log_space else 0.0
    return BatchedSketch(
        rows=torch.stack([pad(sk.rows, sk.n - 1) for sk in sketches]),
        cols=torch.stack([pad(sk.cols, sk.m - 1) for sk in sketches]),
        vals=torch.stack([pad(sk.logvals if log_space else sk.vals, dead) for sk in sketches]),
        nnz=torch.stack([sk.nnz for sk in sketches]),
        csort=torch.stack([
            torch.cat([sk.csort, torch.arange(sk.cap, width, dtype=sk.csort.dtype, device=sk.csort.device)])
            for sk in sketches
        ]),
        overflowed=torch.stack([sk.overflowed for sk in sketches]),
        cost_e=None if costs is None else torch.stack([pad(c, math.inf) for c in costs]),
        caps=caps,
    )


def build_batched_sketch(problems, generators, s: float, cap=None) -> BatchedSketch:
    """Stack per-problem importance sketches (`build_coo_sketch`, each at
    the problem's true support shape from its own generator: bitwise the
    sketch of ``solve(..., method="spar_sink_coo")`` from the same
    generator state). ``cap`` is one capacity or one a problem; padded
    bucket rows and columns have probability 0, so indices need no offset."""
    from repro_torch.core.api.solvers import build_coo_sketch

    caps = _caps(cap, s, len(problems))
    return _stack([build_coo_sketch(p, g, s, cap=c) for p, g, c in zip(problems, generators, caps)])


def build_batched_mf_sketch(problems, generators, s: float, cap=None) -> BatchedSketch:
    """Stack per-problem **matrix-free** sketches (`build_mf_sketch`, B1 on
    the card): each element's geometry is a `PointCloudGeometry`, and the
    gathered raw costs ride along in ``cost_e``, so the batched solve never
    touches an (n, m) cost."""
    from repro_torch.core.api.solvers import build_mf_sketch

    caps = _caps(cap, s, len(problems))
    built = [build_mf_sketch(p, g, s, cap=c) for p, g, c in zip(problems, generators, caps)]
    return _stack([sk for sk, _ in built], [c for _, c in built])


def build_batched_log_sketch(problems, generators, s: float, cap=None) -> BatchedSketch:
    """Stack per-problem **log-space** sketches (`build_coo_log_sketch`):
    ``vals`` carries ``logvals`` (padding ``-inf``) and ``cost_e`` the
    gathered raw costs, so the batched ``spar_sink_log`` solve neither
    exponentiates ``-C/eps`` nor reads a (B, n, m) array."""
    from repro_torch.core.api.solvers import build_coo_log_sketch

    caps = _caps(cap, s, len(problems))
    built = [build_coo_log_sketch(p, g, s, cap=c) for p, g, c in zip(problems, generators, caps)]
    return _stack([sk for sk, _ in built], [c for _, c in built], log_space=True)


def build_batched_mf_log_sketch(problems, generators, s: float, cap=None) -> BatchedSketch:
    """Stack per-problem **matrix-free log-space** sketches
    (`build_mf_log_sketch`, B1's float64 cost-only mode on the card): the
    batched ``spar_sink_mf`` path with ``stabilize=True``."""
    from repro_torch.core.api.solvers import build_mf_log_sketch

    caps = _caps(cap, s, len(problems))
    built = [build_mf_log_sketch(p, g, s, cap=c) for p, g, c in zip(problems, generators, caps)]
    return _stack([sk for sk, _ in built], [c for _, c in built], log_space=True)


def _element_probs(cost, a, b, eps: float, lam: float) -> torch.Tensor:
    """Eq. (9) where balanced, eq. (11) otherwise: the per-element mirror of
    `repro_torch.core.api.solvers.sampling_probs` on a bucket-shaped cost."""
    if math.isinf(lam):
        return sparsify.ot_sampling_probs(a, b)
    logK = torch.where(torch.isinf(cost), -math.inf, -cost / eps)
    return sparsify.uot_sampling_probs(a, b, logK, lam, eps)


def batched_coo_sketch(bp: BatchedProblem, generators: Sequence[torch.Generator], s: float,
                       cap: int | None = None) -> BatchedSketch:
    """Sketches drawn at the **bucket** shape from the batch's own (padded)
    costs, one generator an element. Bitwise `build_batched_sketch`'s draw
    for elements that fill the bucket; a padded element gets an equally
    distributed but different draw (its padding has probability 0)."""
    cap = default_cap(s) if cap is None else cap
    sks = []
    for j, el in enumerate(_elements(bp)):
        cost = bp.cost[j]
        K = torch.where(torch.isinf(cost), 0.0, torch.exp(-cost / el.eps))
        probs = _element_probs(cost, bp.a[j], bp.b[j], el.eps, el.lam)
        sks.append(sparsify.sparsify_coo(generators[j], K, probs, s, cap))
    return _stack(sks)


# --------------------------------------------------------------------------
# Batched sketch solvers
# --------------------------------------------------------------------------


def _element_sketch(sketch: BatchedSketch, j: int, el: _Element, log_space: bool):
    """Element ``j``'s own sketch: its slice of the stacked tensors."""
    c = sketch.element_cap(j)
    cls = sparsify.LogSparseKernelCOO if log_space else sparsify.SparseKernelCOO
    return cls(
        sketch.rows[j, :c], sketch.cols[j, :c], sketch.vals[j, :c], sketch.nnz[j], el.n, el.m,
        csort=sketch.csort[j, :c], overflowed=sketch.overflowed[j],
    )


def _sketch_outputs(bp: BatchedProblem, sketch: BatchedSketch, c_e: torch.Tensor, res, certify: bool,
                    log_space: bool):
    """Per-element O(cap) objective (and certificate): the per-problem
    functions on each element's own sketch slice and scalings."""
    values, certs = [], []
    for j, el in enumerate(_elements(bp)):
        sk = _element_sketch(sketch, j, el, log_space)
        r = _element_result(res, j, el)
        ce = c_e[j, : sketch.element_cap(j)]
        a, b = bp.a[j, : el.n], bp.b[j, : el.m]
        if math.isinf(el.lam):
            fn = coo_objective_ot_log_entries if log_space else coo_objective_ot_entries
            value = fn(sk, ce, r, el.eps)
        else:
            fn = coo_objective_uot_log_entries if log_space else coo_objective_uot_entries
            value = fn(sk, ce, r, a, b, el.lam, el.eps)
        values.append(value)
        if certify:
            certs.append(_sketch_cert(sk, r, value, ce, a, b, el.eps, el.lam, log_domain=log_space))
    return torch.stack(values), (_stack_certificates(certs) if certify else None)


def _batched_sketch_solve(bp: BatchedProblem, sketch: BatchedSketch, c_e: torch.Tensor, tol: float, max_iter: int,
                          trace: bool | int = False, certify: bool = False) -> BatchedResult:
    """Spar-Sink (paper Alg. 3/4) on a batched COO sketch: two flat sorted
    segment sums an iteration (the transpose through ``csort``), their
    layouts computed once; per-element O(cap) objective from the gathered
    costs ``c_e``."""
    _, n, m = bp.shape
    rows, cols, vals, csort = sketch.rows, sketch.cols, sketch.vals, sketch.csort
    row_layout = batched_offsets(rows, n, indices_are_sorted=True)
    cols_sorted, vals_sorted = cols.gather(1, csort), vals.gather(1, csort)
    col_layout = batched_offsets(cols_sorted, m, indices_are_sorted=True)

    def coo_matvec(v):  # (B, m) -> (B, n)
        return batched_coo_matvec(rows, vals, v.gather(1, cols), n=n, layout=row_layout)

    def coo_rmatvec(u):  # (B, n) -> (B, m)
        return batched_coo_rmatvec(cols_sorted, vals_sorted, u.gather(1, rows).gather(1, csort), m=m,
                                   layout=col_layout)

    res = batched_scaling_loop(coo_matvec, coo_rmatvec, bp.a, bp.b, bp.fe, tol=tol, max_iter=max_iter, trace=trace,
                               live=(bp.row_mask(), bp.col_mask()))
    value, cert = _sketch_outputs(bp, sketch, c_e, res, certify, log_space=False)
    return BatchedResult(*res[:4], value, rows, cols, vals, sketch.nnz, sketch.overflowed, res[4],
                         res[5] if trace else None, cert)


@register_batched_solver("spar_sink_coo")
def batched_solve_spar_sink(
    bp: BatchedProblem,
    sketch: BatchedSketch,
    *,
    tol: float = 1e-6,
    max_iter: int = 1000,
    trace: bool | int = False,
    certify: bool = False,
) -> BatchedResult:
    """Spar-Sink on a dense-built batched sketch; the objective's costs are
    gathered from the batched cost matrices."""
    B, n, m = bp.shape
    c_e = bp.cost.reshape(B, n * m).gather(1, sketch.rows * m + sketch.cols)
    return _batched_sketch_solve(bp, sketch, c_e, tol, max_iter, trace, certify)


@register_batched_solver("spar_sink_mf")
def batched_solve_spar_sink_mf(
    bp: BatchedProblem,
    sketch: BatchedSketch,
    *,
    stabilize: bool = False,
    tol: float = 1e-6,
    max_iter: int = 1000,
    trace: bool | int = False,
    certify: bool = False,
) -> BatchedResult:
    """Matrix-free batched Spar-Sink: the sketch (`build_batched_mf_sketch`)
    carries its gathered costs, so ``bp.cost`` may be ``None`` and nothing
    O(n m) exists. ``stabilize=True`` expects a log-space sketch
    (`build_batched_mf_log_sketch`) and runs the log-domain iteration."""
    if sketch.cost_e is None:
        raise ValueError("spar_sink_mf needs a matrix-free sketch with gathered costs; "
                         "build it with build_batched_mf_sketch()")
    if stabilize:
        return _batched_sketch_log_solve(bp, sketch, tol, max_iter, trace, certify)
    return _batched_sketch_solve(bp, sketch, sketch.cost_e, tol, max_iter, trace, certify)


@register_batched_solver("spar_sink_log")
def batched_solve_spar_sink_log(
    bp: BatchedProblem,
    sketch: BatchedSketch,
    *,
    tol: float = 1e-6,
    max_iter: int = 1000,
    trace: bool | int = False,
    certify: bool = False,
) -> BatchedResult:
    """Log-domain batched Spar-Sink on a log-space sketch
    (`build_batched_log_sketch`); ``bp.cost`` is never read."""
    if sketch.cost_e is None:
        raise ValueError("spar_sink_log needs a log-space sketch with gathered costs; "
                         "build it with build_batched_log_sketch()")
    return _batched_sketch_log_solve(bp, sketch, tol, max_iter, trace, certify)


def sparse_log_potentials(
    rows: torch.Tensor,
    cols: torch.Tensor,
    logvals: torch.Tensor,
    csort: torch.Tensor | None,
    loga: torch.Tensor,
    logb: torch.Tensor,
    eps: torch.Tensor,
    fe: torch.Tensor,
    *,
    n: int,
    m: int,
    tol: float,
    max_iter: int,
    trace: bool | int = False,
    init: tuple[torch.Tensor, torch.Tensor] | None = None,
):
    """Log-domain potentials of B sketched problems: the one iteration
    behind the per-problem ``spar_sink_log`` and
    ``spar_sink_mf(stabilize=True)`` solvers (at B = 1) and the batched
    executor. Two gathered segment-logsumexps an iteration
    (`bind_coo_gather_logsumexp`: one kernel launch each on the card), rows
    in the sketch's sorted order and columns over column-ordered copies of
    the values and row ids; the copies, both layouts and their checks are
    made once before the loop (the ``sinkhorn.setup`` span). Returns
    ``(f, g, n_iter, err, status)``, all (B, ·); ``trace`` appends a
    batched `SolverTrace`."""
    with spans.span("sinkhorn.setup", device=rows.device):
        row_offsets = batched_offsets(rows, n, indices_are_sorted=True)[1]
        if csort is None:
            order, col_offsets = batched_offsets(cols, m)
            logvals_c, rows_c = (x.reshape(-1)[order].reshape(x.shape) for x in (logvals, rows))
        else:
            col_offsets = batched_offsets(cols.gather(1, csort), m, indices_are_sorted=True)[1]
            logvals_c, rows_c = logvals.gather(1, csort), rows.gather(1, csort)
        lse_row = bind_coo_gather_logsumexp(row_offsets, logvals, cols, eps)  # (B, m) -> (B, n)
        lse_col = bind_coo_gather_logsumexp(col_offsets, logvals_c, rows_c, eps)  # (B, n) -> (B, m)

    return batched_sparse_log_loop(lse_row, lse_col, loga, logb, eps, fe, tol=tol, max_iter=max_iter,
                                   trace=trace, init=init)


def _batched_sketch_log_solve(bp: BatchedProblem, sketch: BatchedSketch, tol: float, max_iter: int,
                              trace: bool | int = False, certify: bool = False) -> BatchedResult:
    """Log-domain Spar-Sink on a batched sketch whose ``vals`` carry
    ``logvals`` (`sparse_log_potentials`); per-element O(cap) objective."""
    _, n, m = bp.shape
    res = sparse_log_potentials(
        sketch.rows, sketch.cols, sketch.vals, sketch.csort, _masked_log(bp.a), _masked_log(bp.b), bp.eps, bp.fe,
        n=n, m=m, tol=tol, max_iter=max_iter, trace=trace,
    )
    value, cert = _sketch_outputs(bp, sketch, sketch.cost_e, res, certify, log_space=True)
    return BatchedResult(*res[:4], value, sketch.rows, sketch.cols, sketch.vals, sketch.nnz, sketch.overflowed,
                         res[4], res[5] if trace else None, cert)
