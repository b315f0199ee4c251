"""Relaxed constrained solvers (paper §4.1, Eq. 3/4/5) — the wide lowering.

Port of the accelerator ("wide") lowering of `repro.core.relax`'s grid
engine, batched over rows (tenants). The polytope is

    P = { z̃ ∈ [0,1]^K : Σz̃ (=|≤) N,  Σ c̲_k z̃_k ≤ ρ }.

`lp_topn` maximizes ⟨w, z̃⟩ over P with a parametric Lagrangian: the
optimizer for multiplier λ is the top-N arms by w − λc, cost(λ) is
non-increasing, and mixing the two vertices that straddle the budget hits
it exactly. λ* is located on an exactly representable ladder:

  octave round   λ = 2^0 .. 2^24 as one batch (25 probes a row),
  mantissa rounds GRID_ROUNDS − 1 rounds of GRID_POINTS probes, each
                 refining log2(GRID_POINTS) bits of the mantissa,
  final round    the finest ladder plus λ = 0 and the feasible end, as
                 (G, K) vertex rows in the crossing form; the straddling
                 pair is mixed (`_mix_straddle`).

Every probe is a scalar cost Σc·z(λ) from the `topn_lp` kernel
(`kernels.ops.topn_lp`); for AWC rows each Frank-Wolfe step's gradient and
octave round come fused from the `awc_fw` kernel. On a CPU tensor both go to
their plain PyTorch versions.

  SUC: lp_topn(μ̄)                    (Eq. 4, α = 1)
  AIC: lp_topn(ln μ̄)                 (Eq. 5 log-transform, α = 1)
  AWC: continuous greedy — FW_STEPS Frank-Wolfe steps on the multilinear
       extension with lp_topn as the linear-maximization oracle (Eq. 3).

`solve_batch` solves the SUC and AIC rows of a mixed batch in one equality
call and the AWC rows in one Frank-Wolfe loop.

``engine="bisect"`` selects the reference's other engine, the sequential
λ-doubling (DOUBLE_ITERS) then bisection (BISECT_ITERS) chain with a full
vertex per probe (`_lp_topn_bisect`), in plain torch: it reaches no kernel
in the reference either. ``fw_steps`` sets the AWC Frank-Wolfe step count
(default FW_STEPS). Both are arguments of `lp_topn`, `solve_relaxed` and
`solve_batch`; the port reads no environment variable for them (the
reference's REPRO_LP_ENGINE and REPRO_FW_STEPS). The reference's CPU
lowering (`_grid_tail*`, warm FW, `_solve_ix_unified`) is not ported yet.
`enumerate_actions` and `solve_direct` are numpy.
"""
from __future__ import annotations

import itertools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import rewards as R
from repro_torch.core.ranks import lagrangian_topn_mask, topn_mask
from repro_torch.core.rewards import sum_in_order
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops

FW_STEPS = 8           # continuous-greedy steps (the reference's default)
BISECT_ITERS = 48      # bisect engine: sequential bisection depth
DOUBLE_ITERS = 24      # bisect engine: λ-doubling depth (cap λ at 2^24)
ENGINES = ("grid", "bisect")
DEFAULT_ENGINE = "grid"
LAM_MAX_EXP = 24       # λ is capped at 2^LAM_MAX_EXP
GRID_ROUNDS = 4        # mantissa rounds, including the final one
GRID_POINTS = 64       # λ probes per mantissa round (a power of two)
AWC_IX = R.KIND_INDEX["awc"]
AIC_IX = R.KIND_INDEX["aic"]


def _resolve_engine(engine: Optional[str]) -> str:
    engine = DEFAULT_ENGINE if engine is None else engine
    if engine not in ENGINES:
        raise ValueError(f"unknown LP engine {engine!r}, want one of "
                         f"{ENGINES}")
    return engine


def _resolve_fw(fw_steps: Optional[int]) -> int:
    return FW_STEPS if fw_steps is None else int(fw_steps)


def _mix_straddle(rho, z_lo, c_lo, z_hi, c_hi):
    """Mix the straddling vertices to meet the budget exactly (rows).

    z_lo (B, K) is the infeasible-side vertex, z_hi the feasible one, c_lo /
    c_hi (B,) their probed costs. When even z_hi violates ρ, θ clips to 0
    and z_hi is returned."""
    gap = torch.clamp(c_lo - c_hi, min=1e-12)
    theta = torch.where(c_lo > c_hi, (rho - c_hi) / gap,
                        torch.zeros_like(gap))
    theta = torch.clamp(theta, 0.0, 1.0)[:, None]
    return theta * z_lo + (1 - theta) * z_hi


def _lagrangian_costs(w, c, n, lams, equality: bool):
    """cost(λ) = Σ c·z(λ) for a λ batch per row: lams (B, G) -> (B, G).

    The score rows w − λc are formed by two eager ops (a multiply, then a
    subtract, each rounded once) and reduced by the `topn_lp` kernel."""
    b, g = lams.shape
    k = w.shape[-1]
    scores = w[:, None, :] - lams[:, :, None] * c[:, None, :]
    # contiguous: with one row, reshape keeps the expanded view's 0 stride
    cost = c[:, None, :].expand(b, g, k).reshape(b * g, k).contiguous()
    nn = n[:, None].expand(b, g).reshape(b * g).contiguous()
    out = kops.topn_lp(scores.reshape(b * g, k), cost, nn,
                       equality=equality)
    return out.reshape(b, g)


def _octave_ladder(device) -> torch.Tensor:
    """The exact power-of-two λ ladder 2^0..2^LAM_MAX_EXP."""
    return torch.tensor(2.0 ** np.arange(LAM_MAX_EXP + 1), dtype=torch.float32,
                        device=device)


def _first_true(feas):
    """(index of the first True per row, any True per row); index 0 when
    a row has none, as the reference's argmax."""
    return feas.to(torch.int32).argmax(-1), feas.any(-1)


def _grid_wide(w, c, n, rho, equality: bool):
    """Octave round, then `_grid_wide_from_octave`. Rows: w/c (B, K),
    n (B,) int32, rho (B,) float32."""
    lad = _octave_ladder(w.device).expand(w.shape[0], LAM_MAX_EXP + 1)
    feas = _lagrangian_costs(w, c, n, lad, equality) <= rho[:, None]
    return _grid_wide_from_octave(w, c, n, rho, equality, feas)


def _grid_wide_from_octave(w, c, n, rho, equality: bool, feas):
    """Mantissa rounds and the final mix, given the octave round's
    feasibility rows ``feas`` (B, LAM_MAX_EXP + 1) = cost(2^e) <= ρ.

    Probe λ's are an octave scale 2^e times a dyadic mantissa, so every
    product is exact and any recomputation from λ is bitwise reproducible.
    Straddle updates are positional (first feasible probe); the final
    selection is by value (cheapest feasible λ, costliest infeasible one)."""
    bits = GRID_POINTS.bit_length() - 1
    assert GRID_POINTS == 1 << bits, "GRID_POINTS must be a power of two"
    dev = w.device
    rows = torch.arange(w.shape[0], device=dev)
    geom = _octave_ladder(dev)
    one = torch.ones_like(rho)
    i, any_f = _first_true(feas)
    scale = torch.where(any_f & (i > 0), geom[torch.clamp(i - 1, min=0)],
                        torch.where(any_f, one, geom[-1].expand_as(one)))
    m_lo = torch.where(any_f & (i == 0), 0.0 * one, one)
    m_hi = torch.where(any_f & (i == 0), one,
                       torch.where(any_f, 2.0 * one, one))

    lam_cap = torch.tensor(2.0 ** LAM_MAX_EXP, dtype=torch.float32,
                           device=dev)
    ks = torch.arange(GRID_POINTS, dtype=torch.float32, device=dev)
    for r in range(1, GRID_ROUNDS):
        ms = m_lo[:, None] + ks * (2.0 ** (-bits * r))
        lams = torch.minimum(scale[:, None] * ms, lam_cap)
        feas = _lagrangian_costs(w, c, n, lams, equality) <= rho[:, None]
        i, any_f = _first_true(feas)
        m_hi = torch.where(any_f, ms[rows, i], m_hi)
        m_lo = torch.where(any_f & (i > 0), ms[rows, torch.clamp(i - 1, min=0)],
                           torch.where(any_f, m_lo, ms[:, GRID_POINTS - 1]))

    # final round: λ = 0 and the feasible-side end ride along with the
    # finest ladder, so every possible straddle lies inside one batch
    fine = m_lo[:, None] + ks * (2.0 ** (-bits * GRID_ROUNDS))
    lams = torch.cat([torch.zeros_like(m_lo)[:, None],
                      torch.minimum(scale[:, None] * fine, lam_cap),
                      torch.minimum(scale * m_hi, lam_cap)[:, None]], dim=-1)
    masks = lagrangian_topn_mask(w, c, lams, n, equality)     # (B, G+2, K)
    costs = sum_in_order(masks * c[:, None, :])
    feas = costs <= rho[:, None]
    inf = torch.full_like(lams, torch.inf)
    i_hi = torch.where(feas.any(-1), torch.where(feas, lams, inf).argmin(-1),
                       lams.argmax(-1))
    i_lo = torch.where((~feas).any(-1),
                       torch.where(feas, -inf, lams).argmax(-1), i_hi)
    return _mix_straddle(rho, masks[rows, i_lo], costs[rows, i_lo],
                         masks[rows, i_hi], costs[rows, i_hi])


def _rows(w, c, n, rho):
    """Row tensors in the layout the kernels take."""
    dev = w.device
    return (w.to(torch.float32).contiguous(),
            c.to(device=dev, dtype=torch.float32).contiguous(),
            torch.as_tensor(n, device=dev).to(torch.int32).reshape(-1)
            .expand(w.shape[0]).contiguous(),
            torch.as_tensor(rho, device=dev).to(torch.float32).reshape(-1)
            .expand(w.shape[0]).contiguous())


# ============================================================ bisect engine
def _topn_given_lambda(w, c, n, lam, equality: bool):
    """Vertices z(λ) on rows: the top-n arms by w − λ·c (stable ranks: the
    lower index wins a tie, as `lax.top_k` does); with ``equality`` False
    the arms of score <= 0 drop. lam (B,). The score is one fused
    multiply-add, rounded once, as XLA contracts it."""
    score = (w.double() - lam.double()[:, None] * c.double()).to(
        torch.float32)
    return topn_mask(score, n, equality)


def _lp_topn_bisect(w, c, n, rho, equality: bool):
    """The reference engine on rows: λ doubled until feasible, then
    bisected, carrying the vertices on each side of the breakpoint."""
    zero = torch.zeros_like(rho)
    z0 = _topn_given_lambda(w, c, n, zero, equality)
    cost0 = sum_in_order(c * z0)

    lam = torch.ones_like(rho)
    for _ in range(DOUBLE_ITERS):
        cost = sum_in_order(c * _topn_given_lambda(w, c, n, lam, equality))
        lam = torch.where(cost > rho, lam * 2.0, lam)
    lo, hi = zero, lam
    z_l, z_h = z0, _topn_given_lambda(w, c, n, lam, equality)
    for _ in range(BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        z_m = _topn_given_lambda(w, c, n, mid, equality)
        feas = sum_in_order(c * z_m) <= rho
        lo = torch.where(feas, lo, mid)
        hi = torch.where(feas, mid, hi)
        z_l = torch.where(feas[:, None], z_l, z_m)
        z_h = torch.where(feas[:, None], z_m, z_h)
    z_mix = _mix_straddle(rho, z_l, sum_in_order(c * z_l), z_h,
                          sum_in_order(c * z_h))
    return torch.where((cost0 <= rho)[:, None], z0, z_mix)


# ============================================================== entry points
def lp_topn(w, c, n, rho, equality: bool, engine: Optional[str] = None):
    """max ⟨w,z⟩ s.t. Σz (=|≤) n, ⟨c,z⟩ ≤ ρ, z ∈ [0,1]^K, for rows w/c
    (B, K) with per-row (or shared) n and ρ.

    As in the reference, an unattainable ρ (no vertex on the λ ladder meets
    it) returns the λ-cap vertex, which then violates the budget."""
    if _resolve_engine(engine) == "bisect":
        return _lp_topn_bisect(*_rows(w, c, n, rho), equality)
    return _grid_wide(*_rows(w, c, n, rho), equality)


def lp_topn_dyn(w, c, n, rho, equality: bool, engine: Optional[str] = None):
    """`lp_topn` with per-row (n, ρ): the reference's traced-n form. Every
    port solve already takes n and ρ per row, so this is `lp_topn`."""
    return lp_topn(w, c, n, rho, equality, engine)


def _awc_fw(mu_bar, c_low, n, rho, engine: Optional[str] = None,
            fw_steps: Optional[int] = None):
    """Continuous greedy (Eq. 3) on rows: ``fw_steps`` Frank-Wolfe steps.
    On the grid engine each is one `awc_fw` call (gradient + octave costs)
    and the mantissa rounds of the wide lowering; on the bisect engine the
    gradient and `_lp_topn_bisect`."""
    steps = _resolve_fw(fw_steps)
    mu, c, n, rho = _rows(mu_bar, c_low, n, rho)
    z = torch.zeros_like(mu)
    div = torch.full_like(mu, float(steps))
    if _resolve_engine(engine) == "bisect":
        for _ in range(steps):
            g = R.awc_multilinear_grad(z, mu)
            z = z + _lp_topn_bisect(g, c, n, rho, False) / div
        return z
    lad = _octave_ladder(mu.device).expand(mu.shape[0], LAM_MAX_EXP + 1)
    lad = lad.contiguous()
    for _ in range(steps):
        g, oct_costs = kops.awc_fw(z, mu, c, lad, n)
        v = _grid_wide_from_octave(g, c, n, rho, False,
                                   oct_costs <= rho[:, None])
        z = z + v / div
    return z


def solve_rows(kind: str, mu_bar, c_low, n, rho,
               engine: Optional[str] = None,
               fw_steps: Optional[int] = None):
    """Fractional z̃ rows (B, K) for B instances of one reward model on the
    device of ``mu_bar`` (B, K); n and ρ shared or per row."""
    mu_bar = mu_bar.to(torch.float32)
    if kind == "suc":
        return lp_topn(mu_bar, c_low, n, rho, True, engine)
    if kind == "aic":
        w = R.log_f32(torch.clamp(mu_bar, R.EPS, 1.0))
        return lp_topn(w, c_low, n, rho, True, engine)
    if kind == "awc":
        return _awc_fw(mu_bar, c_low, n, rho, engine, fw_steps)
    raise ValueError(kind)


def solve_relaxed(kind: str, mu_bar, c_low, n: int, rho: float,
                  engine: Optional[str] = None,
                  fw_steps: Optional[int] = None, device="cuda"):
    """Fractional z̃ (K,) for one instance of the given reward model,
    solved on ``device`` (the inputs are moved there)."""
    dev = resolve_device(device)
    mu_bar = torch.as_tensor(mu_bar, dtype=torch.float32).to(dev)[None]
    c_low = torch.as_tensor(c_low, dtype=torch.float32).to(dev)[None]
    return solve_rows(kind, mu_bar, c_low, n, rho, engine, fw_steps)[0]


def kind_rows(kind_ix) -> Tuple[torch.Tensor, torch.Tensor]:
    """(equality rows, AWC rows) of a kind_ix vector, as index tensors."""
    awc = kind_ix == AWC_IX
    return (torch.nonzero(~awc).reshape(-1), torch.nonzero(awc).reshape(-1))


def solve_batch(kind_ix, mu_bar, c_low, n, rho,
                rows: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                engine: Optional[str] = None,
                fw_steps: Optional[int] = None):
    """Batched relaxed solve, one row per tenant with its own kind.

    kind_ix (M,) `rewards.KIND_INDEX`, mu_bar/c_low (M, K), n (M,), rho (M,)
    -> z̃ (M, K). SUC and AIC rows go through one equality solve, AWC rows
    through one Frank-Wolfe loop. ``rows`` may carry `kind_rows(kind_ix)`
    computed once for a fleet whose kinds do not change; ``engine`` and
    ``fw_steps`` are `lp_topn`'s and `_awc_fw`'s."""
    eq_rows, awc_rows = kind_rows(kind_ix) if rows is None else rows
    mu_bar = mu_bar.to(torch.float32)
    out = torch.zeros_like(mu_bar)
    if eq_rows.numel():
        w = torch.where((kind_ix == AIC_IX)[:, None],
                        R.log_f32(torch.clamp(mu_bar, R.EPS, 1.0)), mu_bar)
        out[eq_rows] = lp_topn(w[eq_rows], c_low[eq_rows], n[eq_rows],
                               rho[eq_rows], True, engine)
    if awc_rows.numel():
        out[awc_rows] = _awc_fw(mu_bar[awc_rows], c_low[awc_rows],
                                n[awc_rows], rho[awc_rows], engine, fw_steps)
    return out


# ===================================================================== direct
def enumerate_actions(k: int, n: int, equality: bool) -> np.ndarray:
    """All feasible index sets as a boolean matrix (M, K)."""
    sizes = [n] if equality else range(1, n + 1)
    rows = []
    for sz in sizes:
        for comb in itertools.combinations(range(k), sz):
            row = np.zeros(k, bool)
            row[list(comb)] = True
            rows.append(row)
    return np.asarray(rows)


def solve_direct(kind: str, mu, c, n: int, rho: float,
                 actions: Optional[np.ndarray] = None
                 ) -> Tuple[np.ndarray, float]:
    """C2MAB-V-Direct (paper Eq. 48 / App. E.3): exact enumeration of the
    discrete constrained problem, in numpy. Exponential in K."""
    mu = np.asarray(mu, np.float64)
    c = np.asarray(c, np.float64)
    k = mu.shape[0]
    if actions is None:
        actions = enumerate_actions(k, n, R.equality_constrained(kind))
    cost = actions @ c
    feas = cost <= rho + 1e-12
    if kind == "awc":
        vals = 1.0 - np.prod(1.0 - mu[None, :] * actions, axis=1)
    elif kind == "suc":
        vals = actions @ mu
    else:
        vals = np.exp(actions @ np.log(np.maximum(mu, 1e-12)))
    vals = np.where(feas, vals, -np.inf)
    best = int(np.argmax(vals))
    if not np.isfinite(vals[best]):   # infeasible instance: cheapest action
        best = int(np.argmin(cost))
    return actions[best], float(vals[best])
