"""The plain float64 reference that judges a Spar-Sink estimate.

Plain PyTorch, written from the paper (arXiv:2306.06581, Algorithms 3 and
4, eqs. 7, 9, 10, 11) and independent of the program under test: it
imports nothing of it. It is handed the inputs the benchmark made (points,
masses, eps, lam, s) and the program's public outputs for one estimate
(the kept pairs, the plan's entries on them, the dual potentials, the
value), and works out again everything the program derived:

* the kernel entry ``K_ij / rate_ij`` of every kept pair, in float64, from
  the points, where ``rate_ij = s ra_i rb_j`` is the Poisson rate of the
  eq. (7) draw (times the eq. (11) acceptance for UOT); a kept pair's
  sketched value is an integer multiple of it (its multiplicity), so
  ``sketch_gap`` is how far the program's values lie from the nearest
  multiple;
* ``draw_dev``: whether the multiplicities are a draw of the stated size
  ``s`` from the stated probabilities: the largest |observed - expected| /
  sqrt(expected) over the total and over equal-mass bins of rows and of
  columns;
* ``marginal_gap``: one Sinkhorn half-step on the reference sketch from
  the program's potentials, the mass-weighted means of ``1 - exp(-|f' -
  f| / eps)`` over rows and of the same of ``g`` over columns, summed (0
  at the fixed point, ``|f' - f| / eps`` where that is small, at most 2);
* ``value_gap``: the relative gap between the program's value and the
  value of the reference's own Sinkhorn on the reference sketch, run with
  the program's stopping rules (the scaling domain's ``||du||_1 +
  ||dv||_1 <= tol``, the log domain's ``max|df| + max|dg| <= tol``, and
  both domains' stall rule on the column marginal).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

__all__ = [
    "COSTS",
    "Estimate",
    "Inputs",
    "judge",
    "log_rates",
    "objective",
    "proposal",
    "sinkhorn_log",
    "sinkhorn_scaling",
    "sq_costs",
]

#: the costs this reference computes
COSTS = ("sqeuclidean",)
#: rows, columns, and the bins of the draw check
DRAW_BINS = 32


@dataclass
class Inputs:
    """What the benchmark made for one estimate (float64, on one device)."""

    x: torch.Tensor  # (n, d) support points; the target support is the same set
    a: torch.Tensor  # (n,) source masses
    b: torch.Tensor  # (n,) target masses
    eps: float
    lam: float  # math.inf for balanced OT
    s: float  # the sketch's proposal budget

    @property
    def fe(self) -> float:
        return 1.0 if math.isinf(self.lam) else self.lam / (self.lam + self.eps)


@dataclass
class Estimate:
    """The public outputs of one estimate, as the program returned them."""

    rows: torch.Tensor  # (nnz,) kept pairs
    cols: torch.Tensor
    plan: torch.Tensor  # (nnz,) the plan's entries on them
    f: torch.Tensor  # (n,) dual potentials, -inf on atoms the plan leaves out
    g: torch.Tensor
    value: float
    domain: str  # "scaling" or "log": which stopping rule the value follows
    tol: float
    max_iter: int


def sq_costs(x: torch.Tensor, y: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
             block: int = 1 << 21) -> torch.Tensor:
    """``||x_i - y_j||^2`` at the pairs, in the points' dtype, in blocks."""
    out = torch.empty(rows.shape[0], dtype=x.dtype, device=x.device)
    for k in range(0, rows.shape[0], block):
        diff = x[rows[k:k + block]] - y[cols[k:k + block]]
        out[k:k + block] = torch.sum(diff * diff, dim=1)
    return out


def proposal(inp: Inputs) -> tuple[torch.Tensor, torch.Tensor, float | None]:
    """``(ra, rb, thin)``: eq. (9)'s rank-1 factors for OT; for UOT the
    rank-1 part ``(a_i b_j)^{lam/(2lam+eps)}`` of eq. (11), normalized, and
    the acceptance exponent ``1/(2lam+eps)`` on the cost."""
    if math.isinf(inp.lam):
        ra, rb = torch.sqrt(inp.a), torch.sqrt(inp.b)
        return ra / ra.sum(), rb / rb.sum(), None
    c = inp.lam / (2.0 * inp.lam + inp.eps)
    qa, qb = inp.a ** c, inp.b ** c
    return qa / qa.sum(), qb / qb.sum(), 1.0 / (2.0 * inp.lam + inp.eps)


def log_rates(inp: Inputs, rows, cols, costs) -> torch.Tensor:
    """``log(K_ij / rate_ij)``: the log of one drawn copy's weight."""
    ra, rb, thin = proposal(inp)
    logw = -costs / inp.eps - math.log(inp.s) - torch.log(ra[rows]) - torch.log(rb[cols])
    if thin is not None:
        logw = logw + costs * thin  # the acceptance exp(-C thin) divides the rate
    return logw


def _segment_lse(z: torch.Tensor, seg: torch.Tensor, size: int) -> torch.Tensor:
    """``logsumexp`` of ``z`` over each segment id in ``seg``; -inf where empty."""
    mx = torch.full((size,), -math.inf, dtype=z.dtype, device=z.device)
    mx = mx.scatter_reduce(0, seg, z, reduce="amax", include_self=True)
    safe = torch.where(torch.isfinite(mx), mx, 0.0)
    tot = torch.zeros(size, dtype=z.dtype, device=z.device).index_add_(0, seg, torch.exp(z - safe[seg]))
    return torch.where(tot > 0, safe + torch.log(tot), -math.inf)


def _expected_counts(inp: Inputs, block: int = 512) -> tuple[torch.Tensor, torch.Tensor]:
    """Expected draws of each row and column: ``s ra_i rb_j`` summed (times
    the acceptance ``exp(-C_ij thin)`` for UOT, which needs every pair:
    computed in blocks of rows)."""
    ra, rb, thin = proposal(inp)
    if thin is None:
        return inp.s * ra, inp.s * rb
    x = inp.x
    row = torch.empty_like(ra)
    col = torch.zeros_like(rb)
    for i in range(0, x.shape[0], block):
        c = (x[i:i + block, None, :] - x[None, :, :]).pow(2).sum(-1)
        acc = torch.exp(-c * thin)
        row[i:i + block] = inp.s * ra[i:i + block] * (acc @ rb)
        col += inp.s * rb * (ra[i:i + block] @ acc)
    return row, col


def _bin_dev(observed: torch.Tensor, expected: torch.Tensor, bins: int) -> float:
    """Largest |O - E| / sqrt(E) over ``bins`` consecutive index ranges of
    equal expected count."""
    cum = torch.cumsum(expected, 0)
    edge = torch.clamp((cum / cum[-1] * bins).floor().long(), max=bins - 1)
    o = torch.zeros(bins, dtype=expected.dtype, device=expected.device).index_add_(0, edge, observed)
    e = torch.zeros(bins, dtype=expected.dtype, device=expected.device).index_add_(0, edge, expected)
    keep = e > 0
    return float(torch.max(torch.abs(o[keep] - e[keep]) / torch.sqrt(e[keep])))


class _Stall:
    """The stall rule of both loops: stop once the column-marginal
    violation (before the column update) has not improved by a relative
    1e-4 for ``patience`` iterations."""

    def __init__(self, patience: int = 100):
        self.best, self.since, self.patience = math.inf, 0, patience

    def __call__(self, marg: float) -> bool:
        self.since = 0 if marg < self.best * (1.0 - 1e-4) else self.since + 1
        self.best = min(self.best, marg)
        return self.since >= self.patience


def sinkhorn_scaling(rows, cols, logk, inp: Inputs, tol: float, max_iter: int):
    """Scaling-domain Sinkhorn on the sketch (entries ``exp(logk)``), the
    paper's stopping rule ``||du||_1 + ||dv||_1 <= tol``; returns ``(f, g)``."""
    n = inp.a.shape[0]
    k = torch.exp(logk)
    u, v = torch.ones_like(inp.a), torch.ones_like(inp.b)
    fe = inp.fe

    def div(p, q):
        return torch.where(q > 0, p / torch.where(q > 0, q, 1.0), 0.0)

    stall = _Stall()
    for _ in range(max_iter):
        kv = torch.zeros(n, dtype=k.dtype, device=k.device).index_add_(0, rows, k * v[cols])
        u_new = div(inp.a, kv) ** fe
        ktu = torch.zeros(n, dtype=k.dtype, device=k.device).index_add_(0, cols, k * u_new[rows])
        v_new = div(inp.b, ktu) ** fe
        err = float(torch.sum(torch.abs(u_new - u)) + torch.sum(torch.abs(v_new - v)))
        stalled = stall(float(torch.sum(torch.abs(v * ktu - inp.b))))
        u, v = u_new, v_new
        if not math.isfinite(err) or err <= tol or stalled:
            break
    with torch.no_grad():
        f = torch.where(u > 0, inp.eps * torch.log(torch.where(u > 0, u, 1.0)), -math.inf)
        g = torch.where(v > 0, inp.eps * torch.log(torch.where(v > 0, v, 1.0)), -math.inf)
    return f, g


def sinkhorn_log(rows, cols, logk, inp: Inputs, tol: float, max_iter: int):
    """Log-domain Sinkhorn on the sketch, stopping on ``max|df| + max|dg| <=
    tol``; atoms with no kept pair stay at -inf. Returns ``(f, g)``."""
    n, eps = inp.a.shape[0], inp.eps
    scale = inp.fe * eps
    loga, logb = torch.log(inp.a), torch.log(inp.b)
    f, g = torch.zeros_like(inp.a), torch.zeros_like(inp.b)
    stall = _Stall()
    for _ in range(max_iter):
        lr = _segment_lse(logk + g[cols] / eps, rows, n)
        f_new = torch.where(torch.isneginf(lr), -math.inf, scale * (loga - lr))
        lc = _segment_lse(logk + f_new[rows] / eps, cols, n)
        g_new = torch.where(torch.isneginf(lc), -math.inf, scale * (logb - lc))
        df = torch.where(torch.isneginf(f_new) & torch.isneginf(f), 0.0, torch.abs(f_new - f))
        dg = torch.where(torch.isneginf(g_new) & torch.isneginf(g), 0.0, torch.abs(g_new - g))
        err = float(torch.max(df) + torch.max(dg))
        col = torch.where(torch.isneginf(g) | torch.isneginf(lc), 0.0, torch.exp(g / eps + lc))
        stalled = stall(float(torch.sum(torch.abs(col - inp.b))))
        f, g = f_new, g_new
        if not err > tol or stalled:  # an infinite error goes on, as the program's rule does
            break
    return f, g


def _kl(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Generalized KL: ``sum p log(p/q) - p + q``, 0 log 0 = 0."""
    ratio = torch.log(torch.where(p > 0, p, 1.0)) - torch.log(torch.where(q > 0, q, 1.0))
    return torch.sum(torch.where(p > 0, p * ratio, 0.0) - p + q)


def objective(rows, cols, logk, costs, f, g, inp: Inputs) -> float:
    """``<T,C> - eps H(T)`` (plus ``lam KL(T1|a) + lam KL(T^T 1|b)`` for UOT)
    of the plan ``T_e = exp(logk_e + f_i/eps + g_j/eps)``."""
    eps = inp.eps
    logt = logk + f[rows] / eps + g[cols] / eps
    t = torch.where(torch.isfinite(logt), torch.exp(logt), 0.0)
    ent = torch.where(t > 0, t * (torch.where(t > 0, logt, 0.0) - 1.0), 0.0)
    val = torch.sum(t * costs) + eps * torch.sum(ent)
    if not math.isinf(inp.lam):
        n = inp.a.shape[0]
        row = torch.zeros(n, dtype=t.dtype, device=t.device).index_add_(0, rows, t)
        col = torch.zeros(n, dtype=t.dtype, device=t.device).index_add_(0, cols, t)
        val = val + inp.lam * (_kl(row, inp.a) + _kl(col, inp.b))
    return float(val)


def judge(inp: Inputs, est: Estimate) -> dict[str, float]:
    """The four numbers compared for one estimate (see the module docstring);
    a number that cannot be formed (a kept pair the reference gives no
    weight, a non-finite output) reads ``inf``."""
    n, eps = inp.a.shape[0], inp.eps
    rows, cols = est.rows.long(), est.cols.long()
    shapes_ok = est.f.shape == inp.a.shape and est.g.shape == inp.b.shape
    if (rows.numel() == 0 or not math.isfinite(est.value) or not shapes_ok
            or int(rows.max()) >= n or int(cols.max()) >= n):
        return dict.fromkeys(("sketch_gap", "draw_dev", "marginal_gap", "value_gap"), math.inf)
    costs = sq_costs(inp.x, inp.x, rows, cols)
    logw = log_rates(inp, rows, cols, costs)
    # the program's sketched value of each kept pair, implied by its plan
    # entry and its potentials: T_e = exp(f_i/eps) K~_e exp(g_j/eps)
    with torch.no_grad():
        implied = torch.log(est.plan) - est.f[rows] / eps - est.g[cols] / eps
    # a pair whose plan entry underflowed to 0, or whose row or column the
    # scaling domain gave up (a scaling of 0 or inf), implies no value: it
    # is left out, counted once in the draw, unless it is most of them
    readable = (est.plan > 0) & torch.isfinite(implied)
    ratio = torch.exp(implied - logw)
    mult = torch.round(ratio)
    bad = readable & (~torch.isfinite(ratio) | (mult < 1))
    gap = torch.where(bad, math.inf, torch.abs(ratio / torch.clamp_min(mult, 1.0) - 1.0))
    gap = torch.where(readable, gap, 0.0)
    sketch_gap = float(torch.max(gap)) if float(readable.double().mean()) >= 0.5 else math.inf
    mult = torch.where(readable & ~bad, mult, 1.0)

    exp_rows, exp_cols = _expected_counts(inp)
    obs_rows = torch.zeros(n, dtype=mult.dtype, device=mult.device).index_add_(0, rows, mult)
    obs_cols = torch.zeros(n, dtype=mult.dtype, device=mult.device).index_add_(0, cols, mult)
    total_e = float(exp_rows.sum())
    draw_dev = max(
        abs(float(mult.sum()) - total_e) / math.sqrt(total_e),
        _bin_dev(obs_rows, exp_rows, DRAW_BINS),
        _bin_dev(obs_cols, exp_cols, DRAW_BINS),
    )

    # the reference sketch: the program's pairs and multiplicities, the
    # reference's float64 weights
    logk = torch.log(mult) + logw
    scale = inp.fe * eps
    lr = _segment_lse(logk + est.g[cols] / eps, rows, n)
    lc = _segment_lse(logk + est.f[rows] / eps, cols, n)
    alive_r, alive_c = torch.isfinite(lr), torch.isfinite(lc)
    # |f' - f| / eps mapped to [0, 1) (a row the program left at -inf, or a
    # NaN, reads 1), weighted by the row's mass
    df = -torch.expm1(-torch.nan_to_num(torch.abs(scale * (torch.log(inp.a) - lr) - est.f) / eps, nan=math.inf))
    dg = -torch.expm1(-torch.nan_to_num(torch.abs(scale * (torch.log(inp.b) - lc) - est.g) / eps, nan=math.inf))
    marginal_gap = float(
        torch.sum(torch.where(alive_r, inp.a * df, 0.0)) / torch.sum(torch.where(alive_r, inp.a, 0.0))
        + torch.sum(torch.where(alive_c, inp.b * dg, 0.0)) / torch.sum(torch.where(alive_c, inp.b, 0.0))
    )

    loop = sinkhorn_log if est.domain == "log" else sinkhorn_scaling
    f_ref, g_ref = loop(rows, cols, logk, inp, est.tol, est.max_iter)
    v_ref = objective(rows, cols, logk, costs, f_ref, g_ref, inp)
    value_gap = abs(est.value - v_ref) / max(abs(v_ref), 1e-300)
    return dict(sketch_gap=sketch_gap, draw_dev=draw_dev, marginal_gap=marginal_gap,
                value_gap=value_gap if math.isfinite(value_gap) else math.inf)
