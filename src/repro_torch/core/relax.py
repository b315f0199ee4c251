"""Relaxed constrained solvers (paper §4.1, Eq. 3/4/5), batched over rows.

Port of `repro.core.relax`'s grid engine, both of its lowerings, batched
over rows (tenants). The polytope is

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

``lowering="tail"`` selects the reference's CPU lowering of the grid engine
(`_grid_tail`): the same exact ladder walked by bisection, 2 anchor probes
(λ = 0 and the cap), GRID_EXP_ITERS probes of the integer exponent, then
GRID_TAIL_ITERS of the mantissa, each probe one compare and xor per arm
pair against the crossing thresholds t[i,j] = (w_j − w_i)/(c_j − c_i)
(`_probe_factory`). Its AWC Frank-Wolfe steps carry each step's λ bracket
into the next (`_grid_tail_warm`, ``fw_warm=True``, the reference's
FW_WARM) or search cold each step (``fw_warm=False``), and `solve_batch`
solves a mixed batch's first LP of every kind as one probe chain
(`_solve_ix_unified`), with rows bit-identical to the single-kind paths.
It reaches no kernel, in the reference or here: on the card it is plain
torch. The wide lowering stays the default on every device (the card and
the CPU agree bit for bit on each); the reference picks the tail lowering
on the CPU by its backend, the port only by the argument.

``engine="bisect"`` selects the reference's other engine, the sequential
λ-doubling (DOUBLE_ITERS) then bisection (BISECT_ITERS) chain with a full
vertex per probe (`_lp_topn_bisect`), in plain torch: it reaches no kernel
in the reference either; it ignores ``lowering``. ``fw_steps`` sets the AWC
Frank-Wolfe step count (default FW_STEPS). ``engine``, ``lowering``,
``fw_steps`` and ``fw_warm`` are arguments of `lp_topn`, `lp_topn_dyn`,
`solve_relaxed`, `solve_rows` and `solve_batch`; the port reads no
environment variable for them (the reference's REPRO_LP_ENGINE,
REPRO_FW_STEPS and REPRO_FW_WARM). `enumerate_actions` and `solve_direct`
are numpy.
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
FW_WARM = True         # tail lowering: warm-started FW (the reference's)
FW_WARM_ITERS = 3      # tail lowering: bisection probes a warm FW step
BISECT_ITERS = 48      # bisect engine: sequential bisection depth
DOUBLE_ITERS = 24      # bisect engine: λ-doubling depth (cap λ at 2^24)
ENGINES = ("grid", "bisect")
DEFAULT_ENGINE = "grid"
LOWERINGS = ("wide", "tail")
DEFAULT_LOWERING = "wide"
LAM_MAX_EXP = 24       # λ is capped at 2^LAM_MAX_EXP
GRID_ROUNDS = 4        # wide lowering: mantissa rounds, incl. the final one
GRID_POINTS = 64       # wide lowering: λ probes a round (a power of two)
GRID_EXP_ITERS = 5     # tail lowering: integer-exponent bisection depth
GRID_TAIL_ITERS = 18   # tail lowering: mantissa bisection depth
AWC_IX = R.KIND_INDEX["awc"]
AIC_IX = R.KIND_INDEX["aic"]


def _resolve_engine(engine: Optional[str]) -> str:
    engine = DEFAULT_ENGINE if engine is None else engine
    if engine not in ENGINES:
        raise ValueError(f"unknown LP engine {engine!r}, want one of "
                         f"{ENGINES}")
    return engine


def _resolve_lowering(lowering: Optional[str]) -> str:
    lowering = DEFAULT_LOWERING if lowering is None else lowering
    if lowering not in LOWERINGS:
        raise ValueError(f"unknown grid lowering {lowering!r}, want one of "
                         f"{LOWERINGS}")
    return lowering


def _resolve_fw(fw_steps: Optional[int]) -> int:
    return FW_STEPS if fw_steps is None else int(fw_steps)


def _resolve_warm(fw_warm: Optional[bool]) -> bool:
    return FW_WARM if fw_warm is None else bool(fw_warm)


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


# ============================================================ tail lowering
def _probe_factory(c, n, equality):
    """Crossing-threshold probes for rows c (B, K), n (B,): what the cost
    side alone gives is formed once a solve, and ``make(w)`` adds the score
    side for a weight batch w (B, K) (a Frank-Wolfe loop re-makes it for
    each gradient; c never changes).

    ``equality`` is a Python bool (the positivity filter of the inclusive
    matroid applied or not) or a per-row bool tensor (B,), for a mixed
    batch: the filter then applies behind a select, row by row.

    Every pairwise crossing is a threshold t[i,j] = (w_j − w_i)/(c_j − c_i)
    and a probe at λ is beats[i,j] = (λ < t[i,j]) XOR (c_j < c_i): t[j,i]
    equals t[i,j] to the bit (a negation-exact division) with the xor bit
    flipped, so exactly one of each pair beats and the ranks are a
    permutation. Pairs with c_i == c_j are ordered by w, the lower index
    winning an exact tie."""
    k = c.shape[-1]
    idx = torch.arange(k, device=c.device)
    lower = idx[None, :] < idx[:, None]
    dc = c[:, None, :] - c[:, :, None]          # [b, i, j] = c_j − c_i
    dc0 = dc == 0
    d = dc < 0                                  # the direction bit
    eq_static = isinstance(equality, bool)
    need_pos = (not equality) if eq_static else True
    pd, c0 = c < 0, c == 0
    nn = n[:, None, None]
    inf = torch.tensor(torch.inf, device=c.device)

    def make(w):
        dw = w[:, None, :] - w[:, :, None]      # [b, i, j] = w_j − w_i
        tie = (dw > 0) | ((dw == 0) & lower)
        t = torch.where(dc0, torch.where(tie, inf, -inf), dw / dc)
        if need_pos:                            # s_i > 0 <=> λ < w_i / c_i
            p = torch.where(c0, torch.where(w > 0, inf, -inf), w / c)

        def probe(lam):
            """lam (B, G) -> (vertices (B, G, K), costs (B, G))."""
            beats = (lam[:, :, None, None] < t[:, None]) ^ d[:, None]
            mask = (beats.sum(-1) < nn).to(torch.float32)
            if need_pos:
                pos = ((lam[:, :, None] < p[:, None, :])
                       ^ pd[:, None, :]).to(torch.float32)
                if eq_static:
                    mask = mask * pos
                else:
                    mask = mask * torch.where(equality[:, None, None],
                                              torch.ones_like(pos), pos)
            return mask, sum_in_order(mask * c[:, None, :])

        return probe

    return make


def _make_probe(w, c, n, equality):
    """One-shot probe (the cold search)."""
    return _probe_factory(c, n, equality)(w)


def _exp2i(e):
    """Exact 2^e as float32 for int32 e >= -126, from its bits."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


def _take(sel, new, old):
    """The packed-slot update of the bisections: ``new`` (B, 1, ...) where
    ``sel`` (B, 2), else ``old`` (B, 2, ...)."""
    while sel.dim() < old.dim():
        sel = sel[..., None]
    return torch.where(sel, new, old)


def _grid_tail(w, c, n, rho, equality):
    """The reference's CPU lowering on rows: crossing-threshold bisection,
    25 probes a row (2 anchors, GRID_EXP_ITERS exponent and GRID_TAIL_ITERS
    mantissa bisections). Probe λ's are 2^e or 2^e · dyadic m, exact, and
    the vertices ride the bisection with their probed costs, so the mix
    uses exactly what was probed."""
    return _grid_tail_bracket(w, c, n, rho, equality)[0]


def _grid_tail_bracket(w, c, n, rho, equality):
    """`_grid_tail` and its final bracket (λ_lo (B,), λ_hi (B,)), the seed
    a warm Frank-Wolfe step carries. Each bisection keeps a packed pair of
    slots, [infeasible side, feasible side]: a feasible probe replaces
    slot 1, an infeasible one slot 0."""
    dev = w.device
    probe = _make_probe(w, c, n, equality)
    b = w.shape[0]
    slot = torch.tensor([False, True], device=dev)
    anchors = torch.tensor([0.0, 2.0 ** LAM_MAX_EXP], dtype=torch.float32,
                           device=dev)
    zz, cc = probe(anchors.expand(b, 2))
    z0, cost0 = zz[:, 0], cc[:, 0]

    # the exponent e in {0..LAM_MAX_EXP}; e_lo = -1 stands for λ = 0 and
    # e_hi = LAM_MAX_EXP + 1 for the cap
    e = torch.tensor([-1, LAM_MAX_EXP + 1], dtype=torch.int32,
                     device=dev).expand(b, 2)
    for _ in range(GRID_EXP_ITERS):
        mid = torch.div(e[:, 0] + e[:, 1], 2, rounding_mode="floor")
        z_m, c_m = probe(_exp2i(mid)[:, None])
        sel = (c_m <= rho[:, None]) == slot
        e, zz, cc = (_take(sel, mid[:, None], e), _take(sel, z_m, zz),
                     _take(sel, c_m, cc))

    # the mantissa m inside the octave, λ = scale · m exact. e_lo = -1:
    # λ* in (0, 1], scale 1, m in [0, 1]; e_lo = LAM_MAX_EXP (the cap
    # infeasible too): a [1, 1] bracket keeps every probe at the cap
    e_lo = e[:, 0]
    one = torch.ones_like(rho)
    scale = torch.where(e_lo < 0, one, _exp2i(torch.clamp(e_lo, min=0)))
    pair = torch.tensor([[0.0, 1.0], [1.0, 1.0], [1.0, 2.0]],
                        dtype=torch.float32, device=dev)
    m = pair[torch.where(e_lo < 0, 0, torch.where(e_lo >= LAM_MAX_EXP, 1,
                                                  2))]
    for _ in range(GRID_TAIL_ITERS):
        mid = 0.5 * (m[:, 0] + m[:, 1])
        z_m, c_m = probe((scale * mid)[:, None])
        sel = (c_m <= rho[:, None]) == slot
        m, zz, cc = (_take(sel, mid[:, None], m), _take(sel, z_m, zz),
                     _take(sel, c_m, cc))
    z_mix = _mix_straddle(rho, zz[:, 0], cc[:, 0], zz[:, 1], cc[:, 1])
    return (torch.where((cost0 <= rho)[:, None], z0, z_mix),
            scale * m[:, 0], scale * m[:, 1])


def _grid_tail_warm(probe, rho, lam_lo, lam_hi, zi, ci):
    """A warm Frank-Wolfe step's search: the carried bracket [λ_lo, λ_hi]
    revalidated (``zi`` (B, 2, K), ``ci`` (B, 2): the probe at both ends),
    then two escape probes and FW_WARM_ITERS bisections, the same count on
    every row. A row whose carried ends are both feasible re-anchors at
    λ = 0 (which doubles as the feasible-at-0 exit); one whose ends are
    both infeasible tries 4·λ_hi, then the cap; a row still straddling
    bisects throughout, and returns the cold search's answer when its
    bracket still isolates the breakpoint. Returns (z̃ (B, K), λ_lo,
    λ_hi)."""
    dev = rho.device
    cap = torch.full_like(rho, 2.0 ** LAM_MAX_EXP)
    zero = torch.zeros_like(rho)
    slot = torch.tensor([False, True], device=dev)

    lo_feas = ci[:, 0] <= rho         # λ* < λ_lo: both ends feasible
    hi_infeas = ci[:, 1] > rho        # λ* > λ_hi: both ends infeasible
    lam = torch.stack([torch.where(lo_feas, zero,
                                   torch.where(hi_infeas, lam_hi, lam_lo)),
                       torch.where(lo_feas, lam_lo,
                                   torch.where(hi_infeas, cap, lam_hi))], -1)
    # slot 0 the infeasible side, slot 1 the feasible one; a stale slot is
    # overwritten by an escape probe before the bisections
    zz = torch.stack([torch.where(hi_infeas[:, None], zi[:, 1], zi[:, 0]),
                      torch.where(lo_feas[:, None], zi[:, 0], zi[:, 1])], 1)
    cc = torch.stack([torch.where(hi_infeas, ci[:, 1], ci[:, 0]),
                      torch.where(lo_feas, ci[:, 0], ci[:, 1])], -1)

    # escape probe A: λ = 0 (down), min(4·λ_hi, cap) (up), or bisect; a
    # down row commits it to slot 0, and a feasible cost(0) ends the row
    mid = torch.where(lo_feas, zero,
                      torch.where(hi_infeas, torch.minimum(4.0 * lam[:, 0],
                                                           cap),
                                  0.5 * (lam[:, 0] + lam[:, 1])))
    z_m, c_m = probe(mid[:, None])
    feas = c_m[:, 0] <= rho
    done = lo_feas & feas
    z_done = z_m[:, 0]
    sel = torch.where(lo_feas[:, None], ~slot, feas[:, None] == slot)
    lam, zz, cc = (_take(sel, mid[:, None], lam), _take(sel, z_m, zz),
                   _take(sel, c_m, cc))
    up = hi_infeas & ~feas            # still infeasible at min(4·λ_hi, cap)

    # escape probe B: an unresolved up row jumps to the cap (infeasible
    # there too: ρ unattainable, the cap vertex in both slots); the rest
    # bisect
    mid = torch.where(up, cap, 0.5 * (lam[:, 0] + lam[:, 1]))
    z_m, c_m = probe(mid[:, None])
    feas = c_m[:, 0] <= rho
    sel = (feas[:, None] == slot) | (up & ~feas)[:, None]
    lam, zz, cc = (_take(sel, mid[:, None], lam), _take(sel, z_m, zz),
                   _take(sel, c_m, cc))

    for _ in range(FW_WARM_ITERS):
        mid = 0.5 * (lam[:, 0] + lam[:, 1])
        z_m, c_m = probe(mid[:, None])
        sel = (c_m <= rho[:, None]) == slot
        lam, zz, cc = (_take(sel, mid[:, None], lam), _take(sel, z_m, zz),
                       _take(sel, c_m, cc))
    z_mix = _mix_straddle(rho, zz[:, 0], cc[:, 0], zz[:, 1], cc[:, 1])
    return torch.where(done[:, None], z_done, z_mix), lam[:, 0], lam[:, 1]


def _awc_fw_cont(mu, c, n, rho, steps: int, warm: bool, v0, lo, hi):
    """Frank-Wolfe steps 1 .. steps − 1 of the tail lowering, from a first
    step already solved (vertex ``v0``, bracket [lo, hi]): warm, each step
    seeded by the last one's bracket, or cold, each a full search. Shared
    by the single-kind AWC solve and the unified mixed batch."""
    div = torch.full_like(mu, float(steps))
    z = v0 / div
    make = _probe_factory(c, n, False) if warm else None
    for _ in range(1, steps):
        g = R.awc_multilinear_grad(z, mu)
        if warm:
            probe = make(g)
            zi, ci = probe(torch.stack([lo, hi], -1))
            v, lo, hi = _grid_tail_warm(probe, rho, lo, hi, zi, ci)
        else:
            v, lo, hi = _grid_tail_bracket(g, c, n, rho, False)
        z = z + v / div
    return z


def _awc_fw_tail(mu, c, n, rho, steps: int, warm: bool):
    """Continuous greedy on the tail lowering: a cold first step from the
    gradient at z̃ = 0, then `_awc_fw_cont`."""
    g0 = R.awc_multilinear_grad(torch.zeros_like(mu), mu)
    v0, lo, hi = _grid_tail_bracket(g0, c, n, rho, False)
    return _awc_fw_cont(mu, c, n, rho, steps, warm, v0, lo, hi)


def _solve_ix_unified(kind_ix, mu_bar, c_low, n, rho, fw_steps: int,
                      fw_warm: bool):
    """A mixed batch on the tail lowering: the first LP of every row as
    one probe chain. The weight row is the kind's (μ̄ for SUC, ln μ̄ for
    AIC, the gradient at z̃ = 0, i.e. clip(μ̄, 0, 1 − 1e-6), for AWC) and
    the matroid flag rides the probe behind a per-row select; the AWC rows
    then continue their Frank-Wolfe steps. Rows are bit-identical to the
    single-kind paths: log1p(0) and exp(0) are exact, and the select
    computes the equality mask with the same ops."""
    mu, c, n, rho = _rows(mu_bar, c_low, n, rho)
    awc = kind_ix == AWC_IX
    w = torch.where((kind_ix == AIC_IX)[:, None],
                    R.log_f32(torch.clamp(mu, R.EPS, 1.0)), mu)
    g0 = R.awc_multilinear_grad(torch.zeros_like(mu), mu)
    w = torch.where(awc[:, None], g0, w)
    z1, lo, hi = _grid_tail_bracket(w, c, n, rho, ~awc)
    rows = torch.nonzero(awc).reshape(-1)
    if rows.numel():
        z1[rows] = _awc_fw_cont(mu[rows], c[rows], n[rows], rho[rows],
                                fw_steps, fw_warm, z1[rows], lo[rows],
                                hi[rows])
    return z1


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
def lp_topn(w, c, n, rho, equality: bool, engine: Optional[str] = None,
            lowering: Optional[str] = None):
    """max ⟨w,z⟩ s.t. Σz (=|≤) n, ⟨c,z⟩ ≤ ρ, z ∈ [0,1]^K, for rows w/c
    (B, K) with per-row (or shared) n and ρ, on the grid engine's
    ``lowering`` ("wide" by default, or "tail") or the bisect engine.

    As in the reference, an unattainable ρ (no vertex on the λ ladder meets
    it) returns the λ-cap vertex, which then violates the budget."""
    if _resolve_engine(engine) == "bisect":
        return _lp_topn_bisect(*_rows(w, c, n, rho), equality)
    if _resolve_lowering(lowering) == "tail":
        return _grid_tail(*_rows(w, c, n, rho), equality)
    return _grid_wide(*_rows(w, c, n, rho), equality)


def lp_topn_dyn(w, c, n, rho, equality: bool, engine: Optional[str] = None,
                lowering: Optional[str] = None):
    """`lp_topn` with per-row (n, ρ): the reference's traced-n form. Every
    port solve already takes n and ρ per row, so this is `lp_topn`."""
    return lp_topn(w, c, n, rho, equality, engine, lowering)


def _awc_fw(mu_bar, c_low, n, rho, engine: Optional[str] = None,
            fw_steps: Optional[int] = None, lowering: Optional[str] = None,
            fw_warm: Optional[bool] = None):
    """Continuous greedy (Eq. 3) on rows: ``fw_steps`` Frank-Wolfe steps.
    On the wide lowering each is one `awc_fw` call (gradient + octave costs)
    and the mantissa rounds; on the tail lowering a warm (``fw_warm``) or
    cold tail search (`_awc_fw_tail`); on the bisect engine the gradient
    and `_lp_topn_bisect`. ``fw_warm`` acts on the tail lowering only, as
    in the reference."""
    steps = _resolve_fw(fw_steps)
    mu, c, n, rho = _rows(mu_bar, c_low, n, rho)
    z = torch.zeros_like(mu)
    div = torch.full_like(mu, float(steps))
    if _resolve_engine(engine) == "bisect":
        for _ in range(steps):
            g = R.awc_multilinear_grad(z, mu)
            z = z + _lp_topn_bisect(g, c, n, rho, False) / div
        return z
    if _resolve_lowering(lowering) == "tail":
        return _awc_fw_tail(mu, c, n, rho, steps, _resolve_warm(fw_warm))
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
               fw_steps: Optional[int] = None,
               lowering: Optional[str] = None,
               fw_warm: Optional[bool] = None):
    """Fractional z̃ rows (B, K) for B instances of one reward model on the
    device of ``mu_bar`` (B, K); n and ρ shared or per row."""
    mu_bar = mu_bar.to(torch.float32)
    if kind == "suc":
        return lp_topn(mu_bar, c_low, n, rho, True, engine, lowering)
    if kind == "aic":
        w = R.log_f32(torch.clamp(mu_bar, R.EPS, 1.0))
        return lp_topn(w, c_low, n, rho, True, engine, lowering)
    if kind == "awc":
        return _awc_fw(mu_bar, c_low, n, rho, engine, fw_steps, lowering,
                       fw_warm)
    raise ValueError(kind)


def solve_relaxed(kind: str, mu_bar, c_low, n: int, rho: float,
                  engine: Optional[str] = None,
                  fw_steps: Optional[int] = None, device="cuda",
                  lowering: Optional[str] = None,
                  fw_warm: Optional[bool] = None):
    """Fractional z̃ (K,) for one instance of the given reward model,
    solved on ``device`` (the inputs are moved there)."""
    dev = resolve_device(device)
    mu_bar = torch.as_tensor(mu_bar, dtype=torch.float32).to(dev)[None]
    c_low = torch.as_tensor(c_low, dtype=torch.float32).to(dev)[None]
    return solve_rows(kind, mu_bar, c_low, n, rho, engine, fw_steps,
                      lowering, fw_warm)[0]


def kind_rows(kind_ix) -> Tuple[torch.Tensor, torch.Tensor]:
    """(equality rows, AWC rows) of a kind_ix vector, as index tensors."""
    awc = kind_ix == AWC_IX
    return (torch.nonzero(~awc).reshape(-1), torch.nonzero(awc).reshape(-1))


def solve_batch(kind_ix, mu_bar, c_low, n, rho,
                rows: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                engine: Optional[str] = None,
                fw_steps: Optional[int] = None,
                lowering: Optional[str] = None,
                fw_warm: Optional[bool] = None):
    """Batched relaxed solve, one row per tenant with its own kind.

    kind_ix (M,) `rewards.KIND_INDEX`, mu_bar/c_low (M, K), n (M,), rho (M,)
    -> z̃ (M, K). On the wide lowering and the bisect engine the SUC and AIC
    rows go through one equality solve and the AWC rows through one
    Frank-Wolfe loop; ``rows`` may carry `kind_rows(kind_ix)` computed once
    for a fleet whose kinds do not change. On the tail lowering a batch of
    one kind takes that kind's path and a mixed batch `_solve_ix_unified`,
    as the reference's `solve_relaxed_ix` dispatches. ``engine``,
    ``lowering``, ``fw_steps`` and ``fw_warm`` are `lp_topn`'s and
    `_awc_fw`'s."""
    mu_bar = mu_bar.to(torch.float32)
    if (_resolve_engine(engine) == "grid"
            and _resolve_lowering(lowering) == "tail"):
        kinds = torch.unique(kind_ix).tolist()
        if len(kinds) > 1:
            return _solve_ix_unified(kind_ix, mu_bar, c_low, n, rho,
                                     _resolve_fw(fw_steps),
                                     _resolve_warm(fw_warm))
        if kinds:
            return solve_rows(R.KINDS[kinds[0]], mu_bar, c_low, n, rho,
                              engine, fw_steps, lowering, fw_warm)
    eq_rows, awc_rows = kind_rows(kind_ix) if rows is None else rows
    out = torch.zeros_like(mu_bar)
    if eq_rows.numel():
        w = torch.where((kind_ix == AIC_IX)[:, None],
                        R.log_f32(torch.clamp(mu_bar, R.EPS, 1.0)), mu_bar)
        out[eq_rows] = lp_topn(w[eq_rows], c_low[eq_rows], n[eq_rows],
                               rho[eq_rows], True, engine, lowering)
    if awc_rows.numel():
        out[awc_rows] = _awc_fw(mu_bar[awc_rows], c_low[awc_rows],
                                n[awc_rows], rho[awc_rows], engine, fw_steps,
                                lowering, fw_warm)
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
