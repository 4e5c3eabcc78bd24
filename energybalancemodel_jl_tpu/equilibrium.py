"""Steady-state equilibration: drive the year map to a fixed point on device.

No reference analog — the reference reaches seasonal equilibria by
integrating a long, hand-chosen ``dur`` and inspecting the tail (its
hysteresis studies run 30+ years per forcing level,
/root/reference/test/runtests.jl:25-31 and the plot_seasonal workflows).
This driver iterates the compiled one-year map until the annual-mean state
stops moving, which is both cheaper (no guessed horizon, no wasted years)
and better matched to the hardware:

- **The loop runs on device in bounded chunks.** The convergence loop is
  a ``lax.while_loop`` AROUND the jitted year map; the driver strings
  together bounded dispatches of it (the state never leaves the device —
  chunking is bitwise-invariant; ``years_per_dispatch``), so a 1000-year
  equilibration pays a handful of two-scalar host round trips instead of
  one per year, and reports progress and checkpoints between chunks.
- **Ensembles equilibrate in lockstep.** The year function is
  shape-polymorphic over a leading member axis (the batch-native ensemble
  engine's property), so a whole bifurcation scan — including per-member
  forcing offsets via the virtual ``"F"`` parameter — converges as one
  ``(K, nx)`` program; per-member convergence years are tracked on device.
- **Convergence is data-dependent control flow**, which is exactly what
  ``lax.while_loop`` exists for — no unrolling, no host round trips per
  year, ``tol``/``max_years`` are traced operands so retuning them reuses
  the compiled loop.

The residual is the max-norm year-over-year change of the annual-mean
``metric`` fields (NaN presentation values masked): seasonal attractors are
fixed points of the YEAR map, not of the step map, so consecutive annual
means are the right thing to compare.

**Choosing ``tol``** — match it to the model's attractor roughness:

- **MIZ** relaxes cleanly (its ice physics is continuous through the
  Newton solve): ``tol=1e-3`` converges in ~80 years from zero init at
  the canonical parameters.
- **Classic** carries the reference's discrete ``E == 0`` albedo hole
  (/root/reference/src/classic.jl): any run with a seasonal ice edge —
  including strongly warmed ones, the poles still freeze in winter —
  wobbles irregularly at O(0.1) in the edge cells forever, so the year
  map has a fixed point only to that resolution. Measured: from an
  ice-free init at default parameters the residual plateaus near 1e-1
  (max norm) regardless of horizon; use ``tol~0.5`` to detect arrival at
  the attractor, not a tighter value. (The loop itself is exact: at equal
  year counts it matches ``integrate`` to ~1e-12.)
"""
from __future__ import annotations

import dataclasses
import functools
import os
from typing import Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .forcing import Forcing
from .integrate import default_dtype, make_year_fn
from .engine import auto_whole_year, check_whole_year
from .models.base import default_step_config, get_model
from .solutions import Seasonal
from .spacetime import SpaceTime
from .utils.collection import Collection

__all__ = ["equilibrate", "EquilibriumResult", "make_equilibrium_seasonal_fn",
           "stability", "StabilityResult", "continuation",
           "ContinuationResult"]

# Adjoint stall cutoff: the implicit-gradient Picard loop ends once NO
# projected-gradient leaf has produced a finite, strictly smaller increment
# for this many consecutive iterations — each leaf keeps the value at its
# own smallest increment, so plateaued (neutral-mode) and diverging
# (knife-edge) leaves freeze at their best truncated sum while convergent
# leaves have long since met tolerance. See make_equilibrium_seasonal_fn's
# docstring for the measured spectra that motivate this.
_BWD_STALL_ITERS = 30

# Dispatch chunking for the convergence loop (see equilibrate): adaptive
# mode starts at _CHUNK_START simulated years per dispatch and resizes each
# chunk toward _CHUNK_TARGET_S wall seconds — the progress and checkpoint
# cadence — while keeping the per-chunk host round trip (~2 scalar
# fetches) negligible.
_CHUNK_START = 4
_CHUNK_TARGET_S = 15.0


@dataclasses.dataclass
class EquilibriumResult:
    """Result of :func:`equilibrate`.

    ``state`` is the final scan carry (all prognostic fields + solver warm
    starts) — pass it as ``init`` to a later ``equilibrate``/``integrate``
    call to warm-start a continuation. ``seasonal`` holds the final year's
    winter/summer/avg stores. ``years`` is the number of simulated years;
    ``member_years`` (ensembles) is each member's first converged year
    (0 = did not converge). ``resid`` is the final year-over-year residual
    (per member for ensembles); ``converged`` mirrors it against ``tol``.
    """

    state: Collection
    seasonal: Seasonal
    years: int
    resid: Union[float, np.ndarray]
    converged: Union[bool, np.ndarray]
    member_years: Optional[np.ndarray]
    newton_ok: bool
    tol: float

    def __repr__(self):
        if self.member_years is None:
            conv = "converged" if self.converged else "NOT converged"
            return (f"EquilibriumResult({conv} in {self.years} years, "
                    f"resid {float(self.resid):.3e}, tol {self.tol:g})")
        k = int(np.count_nonzero(self.converged))
        return (f"EquilibriumResult({k}/{len(self.member_years)} members "
                f"converged in {self.years} years, max resid "
                f"{float(np.max(self.resid)):.3e}, tol {self.tol:g})")


def _metric_vec(seasonal: Seasonal, metric: Tuple[str, ...]):
    """Stack the annual means of the metric fields along the grid axis —
    NaN presentation values contribute 0 on both years, so regime changes
    at the ice edge register as (value - 0) jumps rather than NaN poison."""
    return jnp.concatenate(
        [jnp.nan_to_num(seasonal.avg[v]) for v in metric], axis=-1
    )


def _fixed_point_fns(year, metric: Tuple[str, ...], dtype,
                     anderson: int = 0, check_every: int = 1):
    """Build the fixed-point convergence loop around a one-year function
    with the standard ``(carry, par, frow) -> (carry, Seasonal, conv, _)``
    signature (shared by :func:`make_year_fn` and :mod:`.ops.year`).

    Returns ``(init, chunk)``: ``init`` runs year 1 and seeds the on-device
    loop state; ``chunk`` advances the state until convergence or year
    ``y_stop`` (a TRACED operand, like ``tol`` — one compilation serves
    every chunk length and tolerance). The driver strings chunks together
    for progress and checkpoints (see equilibrate); the state never leaves
    the device between chunks, so any chunking produces bitwise-identical
    trajectories.

    ``anderson=m > 0`` wraps the Picard iteration in safeguarded Anderson
    acceleration of depth m (see :func:`equilibrate`); the AA buffers ride
    at the END of the loop-state tuple, so positional access to the first
    seven slots is unchanged.

    ``check_every=M > 1`` runs M years per while-loop iteration as one
    inner ``lax.scan`` and evaluates the convergence metric only at block
    boundaries: the residual becomes the metric change over M years, the
    loop may overshoot ``y_stop`` by up to M-1 years, and ``member_years``
    resolves to block boundaries. It is a convergence-semantics knob (see
    :func:`equilibrate`). Mutually exclusive with ``anderson``
    (the AA algebra is per-year)."""
    use_aa = int(anderson) > 0
    m_hist = int(anderson)
    check_every = int(check_every)
    if use_aa and check_every != 1:
        raise ValueError("check_every > 1 does not compose with anderson")

    def flat(carry):
        ks = sorted(carry.keys())
        return jnp.concatenate([carry[k] for k in ks], axis=-1), ks

    def unflat(x, carry_tmpl):
        ks = sorted(carry_tmpl.keys())
        out, i = {}, 0
        for k in ks:
            w = carry_tmpl[k].shape[-1]
            out[k] = x[..., i:i + w]
            i += w
        return Collection(out)

    def init(carry, par, frow):
        carry_n, seasonal, conv, _ = year(carry, par, frow)
        prev = _metric_vec(seasonal, metric)
        resid0 = jnp.full(prev.shape[:-1], jnp.inf, dtype)
        newton = (jnp.min(conv) if conv is not None
                  else jnp.asarray(1.0, dtype))
        myears0 = jnp.zeros(prev.shape[:-1], jnp.int32)
        base = (carry_n, seasonal, prev, jnp.int32(1), resid0, myears0,
                newton)
        if not use_aa:
            return base
        # AA buffers: the m most recent (residual, G-value) pairs of the
        # FLATTENED carry, slot 0 newest; per-member valid-slot counter and
        # previous residual norm for the safeguard. Seed with the year-1
        # pair: x0 = the caller's init carry, G(x0) = carry_n. The carry
        # mixes field scales (energies vs concentrations), so AA works in
        # SCALED coordinates: each leaf's slice of the flat vector is
        # divided by that leaf's global magnitude at year 1 (kept in the
        # state so chunking stays bitwise-invariant).
        x0, ks = flat(carry)
        g0, _ = flat(carry_n)
        # per-member, per-leaf scale (a global max would couple members:
        # ensemble trajectories must match solo runs)
        scale = jnp.concatenate([
            jnp.broadcast_to(
                jnp.maximum(
                    jnp.max(jnp.abs(carry_n[k]), axis=-1, keepdims=True),
                    jnp.asarray(1e-8, dtype),
                ),
                carry_n[k].shape,
            )
            for k in ks
        ], axis=-1)
        r0 = (g0 - x0) / scale
        zeros = jnp.zeros((m_hist,) + r0.shape, r0.dtype)
        Rbuf = zeros.at[0].set(r0)
        Gbuf = zeros.at[0].set(g0 / scale)
        cnt = jnp.ones(r0.shape[:-1], jnp.int32)
        rnorm = jnp.max(jnp.abs(r0), axis=-1)
        return base + ((Rbuf, Gbuf, cnt, rnorm, scale),)

    def aa_next(carry, par, frow, aa):
        """One accelerated step: run the year at the current iterate, then
        combine the last histories (Anderson Type II, difference form,
        regularized per-member normal equations). Safeguard: a member
        whose residual norm grew takes the plain Picard value and restarts
        its history."""
        Rbuf, Gbuf, cnt, rnorm_prev, scale = aa
        x_k, _ = flat(carry)
        x_k = x_k / scale
        carry_g, seasonal, conv, _ = year(carry, par, frow)
        g_k, _ = flat(carry_g)
        g_k = g_k / scale
        r_k = g_k - x_k
        rnorm = jnp.max(jnp.abs(r_k), axis=-1)
        grew = rnorm > rnorm_prev
        cnt = jnp.where(grew, 0, cnt)

        # difference matrices vs the buffered history (invalid slots are
        # masked to zero columns; the Tikhonov term then zeroes their
        # gamma components instead of making the solve singular)
        valid = (jnp.arange(m_hist) < cnt[..., None])  # (..., m)
        vmask = jnp.moveaxis(valid, -1, 0)[..., None]  # (m, ..., 1)
        dR = jnp.where(vmask, r_k - Rbuf, 0.0)
        dG = jnp.where(vmask, g_k - Gbuf, 0.0)
        # full float32 products: the GPU's default would round the
        # operands to TF32
        hi = lax.Precision.HIGHEST
        M = jnp.einsum("i...n,j...n->...ij", dR, dR, precision=hi)
        b = jnp.einsum("i...n,...n->...i", dR, r_k, precision=hi)
        trace = jnp.trace(M, axis1=-2, axis2=-1)
        eps = jnp.maximum(
            trace / m_hist * 1e-6,
            jnp.asarray(np.finfo(np.dtype(dtype)).eps, dtype) ** 2,
        )
        # b as an explicit column: with batch dims, a (..., m) b is
        # otherwise broadcast as a matrix rather than solved as a vector
        gamma = jnp.linalg.solve(
            M + eps[..., None, None] * jnp.eye(m_hist, dtype=M.dtype),
            b[..., None],
        )[..., 0]
        x_aa = g_k - jnp.einsum("i...n,...i->...n", dG, gamma, precision=hi)
        # members with no usable history (fresh restart) step plain Picard
        x_next = jnp.where((cnt > 0)[..., None], x_aa, g_k)

        # shift the newest pair in
        Rbuf = jnp.concatenate([r_k[None], Rbuf[:-1]], axis=0)
        Gbuf = jnp.concatenate([g_k[None], Gbuf[:-1]], axis=0)
        cnt = jnp.minimum(cnt + 1, m_hist)
        carry_next = unflat(x_next * scale, carry)
        # unscaled year-map residual: AA iterates can stop moving at the
        # CENTER of a wobbling attractor while a plain year still moves
        # the state, so convergence must also see ||G(x) - x|| in real
        # units — otherwise "converged" would stop meaning year-over-year
        # stationarity (measured: O(0.3) wobble reported as 1e-7)
        runorm = jnp.max(jnp.abs(r_k * scale), axis=-1)
        return (carry_next, seasonal, conv, runorm,
                (Rbuf, Gbuf, cnt, rnorm, scale))

    def chunk(state, par, frow, tol, y_stop):
        def cond(s):
            y, resid = s[3], s[4]
            return (y < y_stop) & jnp.any(resid > tol)

        def body(s):
            carry, seasonal0, prev, y, _, myears, newton = s[:7]
            if use_aa:
                carry, seasonal, conv, runorm, aa = aa_next(
                    carry, par, frow, s[7])
            elif check_every == 1:
                carry, seasonal, conv, _ = year(carry, par, frow)
            else:
                # M years per while iteration as one inner scan: the
                # seasonal rides the scan carry (overwritten each year),
                # conv accumulates as a running min (None for models
                # without a solver flag — a static property)
                def scan_body(cs, _):
                    c, _s, nw = cs
                    c2, s2, cv, _ = year(c, par, frow)
                    if cv is not None:
                        nw = jnp.minimum(nw, jnp.min(cv))
                    return (c2, s2, nw), None

                (carry, seasonal, newton), _ = lax.scan(
                    scan_body, (carry, seasonal0, newton), None,
                    length=check_every)
                conv = None  # already folded into newton
            cur = _metric_vec(seasonal, metric)
            resid = jnp.max(jnp.abs(cur - prev), axis=-1)
            if use_aa:
                resid = jnp.maximum(resid, runorm)
            y = y + check_every
            myears = jnp.where((resid <= tol) & (myears == 0), y, myears)
            if conv is not None:
                newton = jnp.minimum(newton, jnp.min(conv))
            out = (carry, seasonal, cur, y, resid, myears, newton)
            return out + ((aa,) if use_aa else ())

        return lax.while_loop(cond, body, state)

    return init, chunk


@functools.lru_cache(maxsize=32)
def _loop_fns(model_name: str, st: SpaceTime, cfg, dtype_name: str,
              metric: Tuple[str, ...], anderson: int = 0,
              check_every: int = 1):
    """Jitted (init, chunk) pair for the XLA-graph engine; the year function
    comes from the shared :func:`make_year_fn` cache (same graph
    ``integrate`` runs — equilibria reproduce under the standard driver)."""
    year = make_year_fn(model_name, st, cfg, dtype_name, False)
    init, chunk = _fixed_point_fns(year, metric, jnp.dtype(dtype_name),
                                   anderson, check_every)
    return jax.jit(init), jax.jit(chunk)


@functools.lru_cache(maxsize=32)
def _fused_loop_fns(model_name: str, st: SpaceTime, cfg, dtype_name: str,
                    metric: Tuple[str, ...], single: bool,
                    anderson: int = 0, check_every: int = 1):
    """Jitted (init, chunk) pair with the whole-year engine
    (:mod:`.ops.year`) as the year map. ``single`` lifts an (nx,) run to a
    1-member ensemble inside the jitted init; the driver squeezes the
    fetched results."""
    from .ops.year import classic_year, miz_year

    year_fn = miz_year if model_name == "MIZ" else classic_year

    def year(carry, par, frow):
        carry, seasonal, conv, _ = year_fn(carry, par, frow, st, cfg)
        return carry, seasonal, conv, None

    init, chunk = _fixed_point_fns(year, metric, jnp.dtype(dtype_name),
                                   anderson, check_every)
    if single:
        base_init = init

        def init(carry, par, frow):
            return base_init(
                Collection({k: v[None] for k, v in carry.items()}),
                par, frow,
            )

    return jax.jit(init), jax.jit(chunk)


@functools.lru_cache(maxsize=16)
def _mesh_loop_fns(model_name: str, st: SpaceTime, cfg, dtype_name: str,
                   metric: Tuple[str, ...], mesh, par_key: Tuple,
                   anderson: int = 0, check_every: int = 1):
    """Jitted (init, chunk) pair with the SHARD-MAPPED whole-year engine as
    the year map (parallel.sharding.shard_map_fused_year_fn): each device
    equilibrates its local ensemble shard; the cross-device traffic is the
    convergence reduction (``jnp.any(resid > tol)`` in the loop
    predicate), the Newton loop condition's one-scalar OR and the
    Newton-flag ``pmin``.
    ``par_key`` is the hashable ``(name, is_swept)`` summary of the
    parameter Collection — the shard_map specs depend only on which leaves
    are per-member, so a dummy template reconstructs them."""
    from .parallel.sharding import shard_map_fused_year_fn

    par_tmpl = Collection({
        k: (np.zeros(2) if swept else 0.0) for k, swept in par_key
    })
    sharded = shard_map_fused_year_fn(
        st, mesh, par_tmpl, dtype_name, cfg, model=model_name,
    )

    def year(carry, par, frow):
        carry, seasonal, conv = sharded(carry, par, frow)
        return carry, seasonal, conv, None

    init, chunk = _fixed_point_fns(year, metric, jnp.dtype(dtype_name),
                                   anderson, check_every)
    return jax.jit(init), jax.jit(chunk)


def _carry_delta(a, b):
    """Max-norm distance between two carry pytrees (no presentation NaNs
    live in the carry, so no masking is needed)."""
    return jnp.max(jnp.stack([
        jnp.max(jnp.abs(x - y))
        for x, y in zip(jax.tree_util.tree_leaves(a),
                        jax.tree_util.tree_leaves(b))
    ]))


@functools.lru_cache(maxsize=32)
def make_equilibrium_seasonal_fn(model_name: str, st: SpaceTime, cfg,
                                 dtype_name: str, tol: float = 1e-9,
                                 max_years: int = 500,
                                 bwd_tol: float = 1e-9,
                                 bwd_max_iters: int = 500):
    """Differentiable map ``(par, frow, carry0) -> final-year Seasonal`` at
    the year-map fixed point.

    Reverse mode does NOT unroll the convergence loop (chaotic-trajectory
    gradients explode with horizon, and the loop length is data-dependent);
    it uses the implicit function theorem on the fixed point
    ``s* = Y(s*, par)``:

        ds*/dpar = (I - dY/ds)^-1 dY/dpar

    evaluated matrix-free by Picard iteration ``lam <- sbar + (dY/ds)^T
    lam`` (each step is ONE reverse pass through the year function — the
    same machinery as the Newton solve's own implicit-diff VJP, one level
    up), accumulating the projected gradient ``(dY/dpar)^T lam`` along the
    way.

    Convergence is measured PER LEAF of the projected gradient, never on
    ``lam``'s own update residual — that distinction is load-bearing.
    Measured on the MIZ calibration path at nx=16:

    * the year-map Jacobian at the fixed point carries an exact neutral
      ``|lambda| = 1`` integrator mode (masked-cell ``Ew``/``phi``), so
      ``lam``'s residual plateaus and never meets tolerance even where
      the gradient is perfectly well defined; the mode's pullback is
      nonzero on some cotangent leaves (``frow``, a few params — their
      true equilibrium sensitivities genuinely diverge) and zero on
      others, whose projected increments decay geometrically — so each
      leaf freezes at its own smallest-increment iterate: convergent
      leaves recover the full finite-difference-matching gradient,
      divergent leaves keep a finite best-truncated value;
    * isolated knife-edge parameter values exist where the spectral
      radius exceeds 1 outright (the forward loop itself stalls at an
      ice-edge wobble; power-iteration growth 1.008-4.9 observed) — there
      the Neumann series would overflow to NaN after a few hundred terms,
      but no leaf improves once growth sets in, so the
      ``_BWD_STALL_ITERS`` stall rule exits well before overflow and
      every leaf returns its best truncated sum — exactly the k-year
      truncated-BPTT gradient, finite and descent-useful, so optimizers
      traverse these parameters instead of dying on them.

    ``tol``/``max_years`` here are Python floats baked into the graph (the
    cached function is keyed on them); the fixed point must be solved
    tightly — the IFT bias is O(tol / (1 - contraction rate)).

    Both loops (forward fixed point + backward Picard) live inside ONE
    jitted dispatch — they cannot be host-chunked without breaking the
    custom_vjp structure, so large nx/nt configs should cap
    ``max_years``/``bwd_max_iters`` to bound that dispatch.
    """
    year = make_year_fn(model_name, st, cfg, dtype_name, False)

    def step(carry, par, frow):
        return year(carry, par, frow)[0]

    @jax.custom_vjp
    def fixed_point(par, frow, carry0):
        def cond(s):
            c_prev, c, y = s
            return (y < max_years) & (_carry_delta(c_prev, c) > tol)

        def body(s):
            _, c, y = s
            return (c, step(c, par, frow), y + 1)

        c1 = step(carry0, par, frow)
        _, c_star, _ = lax.while_loop(cond, body, (carry0, c1, jnp.int32(1)))
        return c_star

    def fixed_point_fwd(par, frow, carry0):
        c_star = fixed_point(par, frow, carry0)
        return c_star, (par, frow, c_star)

    def fixed_point_bwd(res, cbar):
        par, frow, c_star = res
        _, vjp = jax.vjp(step, c_star, par, frow)

        # Picard iteration lam <- cbar + J^T lam, but CONVERGENCE IS
        # MEASURED PER LEAF OF THE PROJECTED GRADIENT (pbar, fbar) =
        # vjp(lam)[1:], which each iteration computes anyway — NOT on
        # lam's own update residual. Measured (docstring): the year map
        # has an exact neutral |lambda|=1 integrator mode in masked-cell
        # Ew/phi, so lam's residual plateaus forever, and the mode's
        # pullback is nonzero on SOME cotangent leaves (frow, a few
        # params) while the others decay geometrically to machine
        # precision. Each leaf therefore freezes at its own
        # smallest-increment iterate: convergent leaves refine to the
        # full finite-difference-matching gradient, divergent/neutral
        # leaves keep their best truncated (k-year BPTT) value instead of
        # growing without bound. The loop ends when every param leaf met
        # tolerance or NO leaf has improved for _BWD_STALL_ITERS
        # consecutive iterations (covers plateaus, exponential
        # knife-edge divergence, and non-finite Jacobian applications
        # alike — `improved` demands a finite, strictly smaller
        # increment).
        def leaf_dp(n, p):
            return jnp.max(jnp.abs(n - p))

        def body(s):
            lam, prev, best, min_dp, since, _, i = s
            cvec, pvec, fvec = vjp(lam)
            new_lam = jax.tree_util.tree_map(jnp.add, cbar, cvec)
            proj = (pvec, fvec)
            dp = jax.tree_util.tree_map(leaf_dp, proj, prev)
            improved = jax.tree_util.tree_map(
                lambda d, m: jnp.isfinite(d) & (d < m), dp, min_dp)
            best = jax.tree_util.tree_map(
                lambda im, n, b: jnp.where(im, n, b), improved, proj, best)
            min_dp = jax.tree_util.tree_map(
                lambda im, d, m: jnp.where(im, d, m), improved, dp, min_dp)
            # termination gates on the PARAM part only: fbar rides along
            # with the same per-leaf freezing but cannot stall the loop
            # (its neutral-mode increments never meet tolerance)
            p_done = [
                d <= bwd_tol * (1.0 + jnp.max(jnp.abs(p)))
                for d, p in zip(jax.tree_util.tree_leaves(dp[0]),
                                jax.tree_util.tree_leaves(pvec))
            ]
            all_done = jnp.all(jnp.stack(p_done))
            any_improved = jnp.any(jnp.stack(
                jax.tree_util.tree_leaves(improved)))
            since = jnp.where(any_improved, 0, since + 1)
            stop = all_done | (since >= _BWD_STALL_ITERS)
            return (new_lam, proj, best, min_dp, since, stop, i + 1)

        def cond(s):
            stop, i = s[5], s[6]
            return (i < bwd_max_iters) & ~stop

        zero_proj = (jax.tree_util.tree_map(jnp.zeros_like, par),
                     jnp.zeros_like(frow))
        inf_dp = jax.tree_util.tree_map(
            lambda l: jnp.asarray(jnp.inf, l.dtype), zero_proj)
        _, _, (pbar, fbar), _, _, _, _ = lax.while_loop(
            cond, body, (cbar, zero_proj, zero_proj, inf_dp,
                         jnp.int32(0), jnp.bool_(False), jnp.int32(0)),
        )
        zero_init = jax.tree_util.tree_map(jnp.zeros_like, c_star)
        return (pbar, fbar, zero_init)

    fixed_point.defvjp(fixed_point_fwd, fixed_point_bwd)

    def seasonal_at_equilibrium(par, frow, carry0):
        c_star = fixed_point(par, frow, carry0)
        # one explicit (differentiable) year from the fixed point yields
        # the seasonal diagnostics; gradients flow through this year
        # directly and through c_star via the implicit VJP above
        _, seasonal, _, _ = year(c_star, par, frow)
        return seasonal

    return seasonal_at_equilibrium


def equilibrate(
    model: str,
    st: SpaceTime,
    forcing: Union[Forcing, float],
    par: Collection,
    init: Collection,
    tol: float = 1e-4,
    max_years: int = 1000,
    metric: Sequence[str] = ("E",),
    n_members: Optional[int] = None,
    dtype=None,
    newton_max_iter: int = 30,
    verbose: bool = False,
    engine: str = "auto",
    years_per_dispatch: Optional[int] = None,
    mesh=None,
    anderson: int = 0,
    check_every: int = 1,
    progress: bool = False,
    checkpoint: Optional[str] = None,
    checkpoint_every: int = 1,
    resume: bool = False,
) -> EquilibriumResult:
    """Iterate the year map to a seasonal fixed point on device.

    Converged when every metric field's annual mean changes by at most
    ``tol`` (max norm over the grid) from one year to the next, for every
    member. ``forcing`` must be constant (a :class:`Forcing` built from a
    single value, or a plain float) — equilibria only exist under constant
    forcing; sweep forcing levels across MEMBERS with the virtual ``par``
    key ``"F"`` instead (per-member constant offsets, as in
    ``ensemble_integrate``).

    ``par`` leaves of shape ``(K,)`` make the run an ensemble; ``init`` may
    be per-member ``(K, nx)`` or shared ``(nx,)``. Passing a previous
    result's ``.state`` as ``init`` warm-starts a continuation (the extra
    carry fields it contains beyond the model's init vars are re-derived,
    which costs at most one extra Newton solve).

    ``engine`` selects the year map inside the convergence loop:
    ``'batched'`` is the per-year XLA scan graph (the one
    ``integrate(engine='scan')`` runs), ``'fused'`` the whole-year engine
    (:mod:`.ops.year`, each simulated year one jitted program). ``'auto'``
    picks between them with the policy the drivers share
    (:func:`.engine.auto_whole_year`: ``'fused'`` for MIZ and Classic). The
    two engines agree to the Newton tolerance.

    ``mesh`` (a 1-D ``jax.sharding.Mesh``; requires ``engine='fused'``/
    ``'auto'`` and an ensemble with ``K`` divisible by the mesh size)
    shards the members across devices: each runs the whole-year engine on
    its local shard; the cross-device traffic is the convergence
    reduction in the loop predicate and the Newton loop condition's
    one-scalar OR, which keeps the sharded run on one device's
    arithmetic.

    ``years_per_dispatch`` bounds how many simulated years one device
    dispatch may run. The loop state NEVER leaves the device — chunking is
    bitwise-invariant; between chunks the host fetches two scalars to check
    convergence, draws the progress bar and writes checkpoints. Default
    ``None`` adapts the chunk toward ~15 wall seconds per dispatch.

    ``anderson=m > 0`` turns on safeguarded Anderson acceleration of depth
    ``m`` (typically 3-5) around the year map: each iteration combines the
    last m (residual, value) pairs of the carry — Type-II AA in difference
    form, per-member regularized normal equations, per-leaf scale
    normalization — to extrapolate toward the fixed point, instead of
    waiting out the Picard contraction rate (the slowest year-map
    ``|lambda|``, 0.96-0.99 at typical configs — see :func:`stability`).
    A member whose residual norm grows falls back to the plain year step
    and restarts its history, which keeps the nonsmooth spots (albedo
    discontinuities, Newton masks) from destabilizing the iteration.
    ``years`` then counts accelerated iterations (still one simulated year
    of dynamics each). Convergence under AA is STRICTER than Picard's
    metric: the year-map residual of the full carry (max norm, real
    units) must also meet ``tol`` — AA iterates can stop moving at the
    center of a wobbling attractor while a plain year still moves the
    state, and "converged" must keep meaning year-over-year stationarity
    (so wobble-limited configs — classic's albedo-hole O(0.1) — report
    NOT converged at tight tolerances under AA exactly as they do under
    Picard). On non-hyperbolic maps (the MIZ frozen-cell neutral
    families, :func:`stability`) the equilibria form a MANIFOLD: AA may
    land on a different — measured MORE stationary — point of it than
    forward integration, with field offsets within the neutral freedom
    (E up to O(1) in fully ice-covered cells). Composes with every
    engine and with ``mesh`` (the AA algebra is per-member). Default
    off: plain Picard is the bitwise-reproducible reference behavior.
    When to use it: AA's 2-3x year savings were measured at TIGHT
    tolerances in float64 (1e-6); at loose tolerances near the solver
    noise floor (float32, tol ~5e-2) Picard typically converges FIRST —
    the extrapolation chases noise-scale residuals the plain iteration
    simply walks through (measured: Picard 87 years, AA hit max_years on
    the same K=8 forcing sweep). Reach for
    ``anderson`` on f64 precision runs, not as a default accelerator.

    ``check_every=M`` evaluates convergence only every M simulated years:
    each while-loop iteration runs M years as one inner ``lax.scan``
    and skips M-1 of every M metric/predicate evaluations. Treat this
    as a SEMANTIC knob, not an accelerator: the residual becomes
    the metric change ACROSS an M-year block (a coarser, usually
    stricter year-over-year proxy), ``years``/``member_years`` resolve
    to block boundaries, and the run can overshoot convergence by up to
    M-1 years. Default 1 preserves exact per-year semantics. Not
    combinable with ``anderson``. Trajectories: the block compiles as
    one scan and differs from ``check_every=1`` at FMA-contraction
    rounding (measured ~1e-13 over 13 f64 years — the same class of
    difference the golden-fixture notes document).

    ``progress=True`` draws the package's throttled progress bar, one tick
    per dispatch chunk (simulated years against ``max_years``, residual on
    the info line) — feedback for long equilibrations without touching the
    compiled loop.

    ``checkpoint=`` names a file to checkpoint the convergence loop into
    at chunk boundaries (at most every ``checkpoint_every`` simulated
    years; also once at the end); ``resume=True`` re-enters the loop from
    it. Resume validates a config fingerprint (model, grid, forcing,
    parameters, dtype, engine, metric, anderson, Newton cap — tol and
    max_years deliberately excluded, so a resume may CONTINUE a run at a
    tighter tolerance or longer horizon) and warns + starts fresh on
    mismatch. Picard resumes are bit-exact (the loop state is the carry,
    the last seasonal, and the convergence bookkeeping — all
    checkpointed); ``anderson>0`` resumes reseed the acceleration history
    with one extra simulated year (the safeguarded restart the AA loop
    already performs after residual growth), so the accelerated iterate
    sequence may differ from an uninterrupted run while converging to the
    same tolerance. Checkpoint writes fetch the seasonal store from the
    device — at large K that is the dominant cost, so raise
    ``checkpoint_every`` accordingly.

    ``st.dur`` is ignored — the horizon is ``max_years``; ``st`` only fixes
    the grid and intra-year resolution.
    """
    spec = get_model(model)
    if not isinstance(forcing, Forcing):
        forcing = Forcing(float(forcing))
    if not forcing.constant:
        raise ValueError(
            "equilibrate needs constant forcing (equilibria do not exist "
            "under a ramp); sweep levels across members via par['F']"
        )
    metric = tuple(metric)
    bad = [v for v in metric if v not in spec.solution_vars]
    if bad:
        raise ValueError(
            f"metric vars {bad} not in {spec.name} solution vars "
            f"{spec.solution_vars}"
        )
    if int(anderson) < 0:
        raise ValueError("anderson must be >= 0 (0 = plain Picard)")
    anderson = int(anderson)
    if int(checkpoint_every) < 1:
        raise ValueError("checkpoint_every must be >= 1")
    check_every = int(check_every)
    if check_every < 1:
        raise ValueError("check_every must be >= 1")
    if anderson > 0 and check_every != 1:
        raise ValueError("check_every > 1 does not compose with anderson "
                         "(the acceleration algebra is per-year)")
    if dtype is None:
        dtype = default_dtype()
    dtype = jnp.dtype(dtype)

    par = Collection(par)
    # batched_parameters() product grids mark their member count; honor it
    # so sweep-style par Collections compose with the equilibrium layer —
    # __K__ wins over n_members, the same precedence ensemble_integrate
    # and grid2d use
    K_hint = par.pop("__K__", None)
    par_for_key = Collection(par)  # pre-F-pop snapshot for the resume key
    K = int(K_hint) if K_hint is not None else n_members
    if K is None:
        sizes = {np.shape(v)[0] for v in par.values() if np.ndim(v) > 0}
        sizes |= {np.shape(v)[0] for v in init.values() if np.ndim(v) > 1}
        if len(sizes) > 1:
            raise ValueError("Cannot infer ensemble size; pass n_members")
        K = sizes.pop() if sizes else None
    ensemble = K is not None

    F_off = par.pop("F", None)
    if F_off is not None and not ensemble:
        # scalar F on a single run is just constant forcing
        forcing = Forcing(float(forcing.base) + float(np.asarray(F_off)))
        F_off = None
    if F_off is not None and np.ndim(F_off) == 0:
        F_off = np.full((int(K),), float(F_off))

    cfg = default_step_config(
        dtype.name, newton_max_iter=newton_max_iter, verbose=verbose,
    )
    par_j = Collection({k: jnp.asarray(v, dtype=dtype) for k, v in par.items()})

    if engine == "auto":
        engine = "fused" if auto_whole_year(spec.name) else "batched"
    if engine not in ("batched", "fused"):
        raise ValueError(
            f"unknown engine {engine!r}; expected 'batched', 'fused', or "
            "'auto'"
        )
    if mesh is not None and engine != "fused":
        raise ValueError(
            "mesh= requires engine='fused' (the sharded year map is the "
            "whole-year engine per device)"
        )
    if engine == "fused":
        check_whole_year(spec.name, "engine='batched'")
    if mesh is not None:
        if not ensemble:
            raise ValueError("mesh= needs an ensemble (per-member (K,) "
                             "par leaves or n_members)")
        if int(K) % mesh.size != 0:
            raise ValueError(
                f"ensemble size {K} is not divisible by the mesh size "
                f"{mesh.size}"
            )

    carry = spec.init_carry(init, st, dtype)
    if ensemble:
        carry = Collection({
            k: (v if jnp.ndim(v) > 1 else jnp.broadcast_to(v, (int(K),) + v.shape))
            for k, v in carry.items()
        })

    frow = forcing.table(st)[0]  # (nt,) — constant: every year identical

    if engine == "fused":
        # whole-year engine conventions (ops/year.py): par leaves scalar or
        # (K,), per-member forcing offsets through the virtual "F" leaf,
        # frow stays the shared (nt,) row
        if F_off is not None:
            par_j["F"] = jnp.asarray(np.asarray(F_off), dtype=dtype)
        if mesh is not None:
            par_key = tuple(sorted(
                (k, jnp.ndim(v) > 0) for k, v in par_j.items()
            ))
            init_fn, chunk_fn = _mesh_loop_fns(
                spec.name, st, cfg, dtype.name, metric, mesh, par_key,
                anderson, check_every,
            )
        else:
            init_fn, chunk_fn = _fused_loop_fns(
                spec.name, st, cfg, dtype.name, metric, not ensemble,
                anderson, check_every,
            )
    else:
        if ensemble:
            # trailing broadcast axis so (K,) sweeps meet (K, nx) state
            par_j = Collection({
                k: (v[:, None] if jnp.ndim(v) == 1 else v)
                for k, v in par_j.items()
            })
        if F_off is not None:
            # batch-native layout: time-leading with a trailing broadcast
            # axis, so each step's forcing is a (K, 1) column against
            # (K, nx) state
            frow = frow[:, None, None] + np.asarray(F_off)[None, :, None]
        init_fn, chunk_fn = _loop_fns(spec.name, st, cfg, dtype.name, metric,
                                      anderson, check_every)

    adaptive = years_per_dispatch is None
    chunk_years = _CHUNK_START if adaptive else int(years_per_dispatch)
    if chunk_years < 1:
        raise ValueError("years_per_dispatch must be >= 1")

    frow_j = jnp.asarray(frow, dtype=dtype)
    tol_j = jnp.asarray(tol, dtype)

    ckpt_key = None
    if checkpoint is not None or resume:
        if checkpoint is None:
            raise ValueError("resume=True needs checkpoint=<path>")
        from . import checkpoint as ckpt_mod

        extras = (f"engine={engine}", f"metric={','.join(metric)}",
                  f"aa={anderson}", f"ce={check_every}")
        if mesh is not None:
            extras += (f"mesh={int(mesh.size)}",)
        ckpt_key = ckpt_mod.config_key(
            "equilibrate", spec.name, st, forcing, par_for_key, dtype.name,
            cfg.solver, newton_max_iter, extras=extras,
        )

    state = None
    if resume:
        import warnings as _warnings

        from . import checkpoint as ckpt_mod

        if ckpt_mod.checkpoint_matches(checkpoint, ckpt_key,
                                       kind="EqCheckpoint"):
            (c_np, seas_np, y0, resid_np, my_np, newton_f, _) = (
                ckpt_mod.read_eq_checkpoint(checkpoint)
            )
            carry_dev = Collection(
                {k: jnp.asarray(v, dtype) for k, v in c_np.items()}
            )
            if anderson > 0:
                # the AA buffers are not checkpointed: reseed them with
                # one simulated year (the same restart the safeguard
                # performs after residual growth) — counted in ``years``.
                # init_fn for the single-run fused engine lifts its input
                # to a 1-member batch, but the checkpointed loop carry is
                # already lifted — drop that axis first
                if engine == "fused" and not ensemble:
                    carry_dev = Collection(
                        {k: v[0] for k, v in carry_dev.items()}
                    )
                state = init_fn(carry_dev, par_j, frow_j)
                state = (
                    state[0], state[1], state[2], jnp.int32(int(y0) + 1),
                    state[4], jnp.asarray(my_np, jnp.int32),
                    jnp.minimum(state[6], jnp.asarray(newton_f, dtype)),
                ) + state[7:]
            else:
                # bit-exact splice: the loop state IS (carry, seasonal,
                # metric-of-seasonal, bookkeeping) — no year re-run
                seasonal_dev = Seasonal(*(
                    Collection({k: jnp.asarray(v, dtype)
                                for k, v in c.items()})
                    for c in seas_np
                ))
                state = (
                    carry_dev, seasonal_dev,
                    _metric_vec(seasonal_dev, metric), jnp.int32(int(y0)),
                    jnp.asarray(resid_np, dtype),
                    jnp.asarray(my_np, jnp.int32),
                    jnp.asarray(newton_f, dtype),
                )
        elif os.path.exists(checkpoint):
            _warnings.warn(
                f"Checkpoint {checkpoint} does not match this "
                "equilibration's configuration; starting from init."
            )
    if state is None:
        state = init_fn(carry, par_j, frow_j)

    # Host chunking loop: the state stays on device the whole time (any
    # chunking is bitwise-identical); each dispatch is bounded so progress
    # and checkpoints advance at a steady cadence. Between chunks the host
    # fetches only the
    # year counter and the (K,) residual (one bulk device_get). Adaptive
    # mode (years_per_dispatch=None) starts small and resizes each chunk
    # to ~_CHUNK_TARGET_S wall seconds from the measured years/s.
    import time as _time

    y, resid_h = jax.device_get((state[3], state[4]))
    y = int(y)
    last_ckpt = y

    def _write_ckpt(years_done):
        from . import checkpoint as ckpt_mod

        c, s, rs, my, nw = jax.device_get(
            (state[0], state[1], state[4], state[5], state[6])
        )
        ckpt_mod.write_eq_checkpoint(
            checkpoint, Collection(c), s, years_done, rs, my,
            float(np.min(np.atleast_1d(nw))), ckpt_key,
        )

    prog = None
    if progress and int(max_years) > 0:
        from .utils.progress import Progress

        prog = Progress(
            int(max_years), title="Equilibrating",
            infofeed=lambda r: f"max resid {float(np.max(r)):.3e} "
                               f"(tol {tol:g})",
        )
        prog.update(y, feedargs=(resid_h,))
    while y < max_years and np.any(resid_h > tol):
        y_stop = min(y + chunk_years, int(max_years))
        t0 = _time.perf_counter()
        state = chunk_fn(state, par_j, frow_j, tol_j, jnp.int32(y_stop))
        y_new, resid_h = jax.device_get((state[3], state[4]))  # syncs
        dt = _time.perf_counter() - t0
        ran = int(y_new) - y
        y = int(y_new)
        if ran <= 0:
            break  # no progress is impossible unless already converged
        if prog is not None:
            prog.update(y, feedargs=(resid_h,))
        if adaptive:
            # first chunk's dt includes compile; it only makes the next
            # chunk conservative, and the one after measures pure run rate
            # lower bound 1, not _CHUNK_START: on very slow configs a
            # handful of years can exceed the target, and the chunk must
            # be able to shrink to it
            chunk_years = int(np.clip(
                _CHUNK_TARGET_S * ran / max(dt, 1e-6), 1, 4096,
            ))
        if ckpt_key is not None and y - last_ckpt >= int(checkpoint_every):
            _write_ckpt(y)
            last_ckpt = y
    if ckpt_key is not None and y > last_ckpt:
        _write_ckpt(y)  # final state (resume of a finished run returns it)
    carry, seasonal, _, years, resid, myears, newton = state[:7]
    if prog is not None:
        # close the bar at the ACTUAL simulated years: early convergence
        # must not render max_years/max_years with an inflated rate, and
        # a check_every overshoot (y up to M-1 past max_years) must not
        # leave it permanently open (updates past total are dropped)
        prog.total = max(int(y), 1)
        prog.update(prog.total, feedargs=(resid_h,))
    if anderson > 0:
        # report the last MODEL-EVALUATED state (Gbuf slot 0 = the year
        # map's output at the final evaluated iterate), not the AA
        # extrapolation the loop would iterate next: the extrapolated
        # vector was never run through the model — it can hold bounded
        # fields slightly outside their range (phi beyond [0,1]) and is
        # not the state that seasonal/resid/converged certify
        _, Gbuf, _, _, scale = state[7]
        gflat = Gbuf[0] * scale
        ks = sorted(carry.keys())
        out, i = {}, 0
        for k in ks:
            w = carry[k].shape[-1]
            out[k] = gflat[..., i:i + w]
            i += w
        carry = Collection(out)
    # one bulk fetch (per-leaf np.asarray pays a round trip each); this
    # also synchronizes with the device
    carry, seasonal, years, resid, myears, newton = jax.device_get(
        (carry, seasonal, years, resid, myears, newton)
    )
    if engine == "fused" and not ensemble:
        # the whole-year engine is ensemble-shaped; drop the lifted
        # 1-member axis
        carry = Collection({k: v[0] for k, v in carry.items()})
        seasonal = Seasonal(*(
            Collection({k: v[0] for k, v in c.items()}) for c in seasonal
        ))
        resid, myears = resid[0], myears[0]
    if verbose and not (newton >= 1.0):
        import warnings

        warnings.warn("Solving for T0 failed during equilibration.")

    seasonal = Seasonal(*(Collection({k: np.asarray(v) for k, v in c.items()})
                          for c in seasonal))
    state = Collection({k: np.asarray(v) for k, v in carry.items()})
    if ensemble:
        return EquilibriumResult(
            state=state, seasonal=seasonal, years=int(years),
            resid=np.asarray(resid), converged=np.asarray(resid) <= tol,
            member_years=np.asarray(myears), newton_ok=bool(newton >= 1.0),
            tol=float(tol),
        )
    return EquilibriumResult(
        state=state, seasonal=seasonal, years=int(years),
        resid=float(resid), converged=bool(resid <= tol),
        member_years=None, newton_ok=bool(newton >= 1.0), tol=float(tol),
    )


@dataclasses.dataclass
class StabilityResult:
    """Result of :func:`stability`.

    ``growth`` is the dominant ``|lambda|`` estimate of the year-map
    Jacobian at the linearization state (the last power-iteration Rayleigh
    value); ``history`` holds every iteration's estimate, ITERATION-major:
    ``history[i]`` is iteration ``i`` — shape ``(n_iter,)``, with a
    TRAILING member axis for ensembles (``(n_iter, K)``; member ``k``'s
    trace is ``history[:, k]``) and a trailing mode axis under
    ``n_modes``.
    ``converged`` marks members whose last two estimates agree to
    ``rtol``; ``mode`` is the final unit mode, a Collection shaped like
    the carry — the ADJOINT (left) mode by default (which perturbations
    the slow dynamics respond to), the RIGHT/physical growth pattern
    under ``side="right"`` — inspecting which leaves/cells carry its
    mass identifies the slow/unstable direction.

    ``eigenvalues`` are SIGNED eigenvalue estimates (Rayleigh–Ritz values
    of the final subspace): for ``n_modes=1`` the real Rayleigh quotient
    ``<v, J^T v>`` (scalar, or ``(K,)``); for ``n_modes=m`` the complex
    eigenvalues of the projected ``m x m`` operator, sorted by descending
    modulus (``(m,)``, or ``(K, m)``). Where ``growth`` only reports
    ``|lambda|``, these distinguish HOW a mode acts: a negative real
    eigenvalue flips the mode each year (period-doubling character), a
    complex pair rotates it (oscillatory/Neimark–Sacker character), a
    positive real one grows or decays monotonically (the fold-type
    direction). They inherit ``project``'s operator and are only as
    converged as the subspace itself (trust them where ``converged`` is
    True; with ``n_modes=1`` a complex DOMINANT pair cannot be
    represented — ``history`` then oscillates and the Rayleigh value sits
    below ``growth``; rerun with ``n_modes>=2``). ``None`` on results
    loaded from files written before they were stored.
    """

    growth: Union[float, np.ndarray]
    history: np.ndarray
    converged: Union[bool, np.ndarray]
    mode: Collection
    rtol: float
    n_modes: int = 1
    eigenvalues: Optional[Union[float, complex, np.ndarray]] = None
    # which operator was iterated: "adjoint" (J^T — mode is the left/
    # sensitivity direction) or "right" (J — mode is the physical
    # growth pattern); the spectrum estimates are side-invariant
    side: str = "adjoint"

    def __repr__(self):
        if np.ndim(self.growth) == 0:
            conv = "converged" if self.converged else "NOT converged"
            kind = ("attracting" if self.growth < 1.0 - self.rtol
                    else "non-attracting" if self.growth > 1.0 + self.rtol
                    else "neutral")
            return (f"StabilityResult(|lambda| ~ {float(self.growth):.6g} "
                    f"({kind}), {len(self.history)} iterations, {conv})")
        g = np.asarray(self.growth)
        k = int(np.count_nonzero(self.converged))
        total = int(np.size(np.asarray(self.converged)))
        if self.n_modes > 1 and g.ndim == 1:  # solo, multiple modes
            lams = ", ".join(f"{x:.6g}" for x in g)
            return (f"StabilityResult({self.n_modes} modes, |lambda| ~ "
                    f"[{lams}], {k}/{total} converged)")
        lead = g if g.ndim == 1 else g[..., 0]
        modes = "" if self.n_modes == 1 else f" x {self.n_modes} modes"
        return (f"StabilityResult({lead.shape[0]} members{modes}, "
                f"leading |lambda| in [{float(lead.min()):.6g}, "
                f"{float(lead.max()):.6g}], {k}/{total} converged)")


@functools.lru_cache(maxsize=32)
def _stability_loop_fn(model_name: str, st: SpaceTime, cfg, dtype_name: str,
                       m: int, keys_order: Tuple[str, ...],
                       widths: Tuple[int, ...], project_keys: frozenset,
                       side: str = "adjoint", remat: bool = False):
    """Jitted power/subspace-iteration chunk for :func:`stability`. The
    linearization point (carry), parameters, forcing row, and frozen mask
    enter as ARGUMENTS, not closure constants, so ONE compilation serves
    every level of a continuation path with matching shapes — a per-call
    closure would retrace and recompile the reverse-mode year graph at
    every level (the same closure-churn pattern progress_steps once hit,
    CLAUDE.md)."""
    # remat (ensembles only, mirroring lyapunov): the vjp power
    # iteration then stores only the carry chain — per-step residuals
    # scale with K and a wide-ensemble vjp OOMs at compile otherwise
    # (156 GB at K=1024, measured on the lyapunov twin round 5). Solo
    # runs keep the round-4 graph exactly (a checkpoint annotation
    # perturbs FMA contraction at ~1e-12 between programs).
    year = make_year_fn(model_name, st, cfg, dtype_name, False,
                        remat=remat)
    dtype = jnp.dtype(dtype_name)
    tiny = jnp.asarray(np.finfo(dtype).tiny, dtype)

    def proj(t, frozen):
        if not project_keys:
            return t
        return Collection({
            k: (jnp.where(frozen, 0.0, v) if k in project_keys else v)
            for k, v in t.items()
        })

    def member_norm(t):
        return jnp.sqrt(sum(
            jnp.sum(x * x, axis=-1) for x in jax.tree_util.tree_leaves(t)
        ))

    def normalize(t):
        nrm = jnp.maximum(member_norm(t), tiny)
        return jax.tree_util.tree_map(lambda x: x / nrm[..., None], t), nrm

    def from_mat(x):  # (..., n)[, mode-leading] -> carry-like Collection
        out, i = {}, 0
        for k, w in zip(keys_order, widths):
            out[k] = x[..., i:i + w]
            i += w
        return Collection(out)

    def to_mat(t):  # carry-like Collection -> (..., n); from_mat's inverse
        return jnp.concatenate([t[k] for k in keys_order], axis=-1)

    def ortho(t):
        """Per-member QR orthonormalization of the m-mode block; the
        |diag(R)| entries are the per-iteration growth of each mode."""
        a = jnp.moveaxis(to_mat(t), 0, -1)  # (n, m) solo, (K, n, m)
        q, r = jnp.linalg.qr(a)
        lam = jnp.abs(jnp.diagonal(r, axis1=-2, axis2=-1))
        return from_mat(jnp.moveaxis(q, -1, 0)), lam

    fit = normalize if m == 1 else ortho

    def prep(v, frozen, fallback=None):
        """Project + orthonormalize a start block; degenerate columns
        (non-finite, or projected to ~zero norm) take ``fallback``'s."""
        vp = proj(v, frozen)
        if fallback is not None:
            nrm = member_norm(vp)
            bad = (~jnp.isfinite(nrm)) | (
                nrm < jnp.asarray(np.sqrt(np.finfo(np.dtype(dtype_name)).tiny),
                                  dtype)
            )
            fb = proj(fallback, frozen)
            vp = jax.tree_util.tree_map(
                lambda a, b: jnp.where(bad[..., None], b, a), vp, fb,
            )
        return fit(vp)

    @functools.partial(jax.jit, static_argnums=(5, 6))
    def run(v, carry, par_j, frow_j, frozen, k, want_h):
        # linearize once per dispatch; J^T applications ride the residuals
        _, pb = jax.vjp(lambda c: year(c, par_j, frow_j)[0], carry)

        def pbl(u):
            return pb(u)[0]

        if side == "right":
            # J v by TRANSPOSING the (linear) pullback — exact forward
            # application of the year-map Jacobian without forward-mode,
            # which the Newton solve's custom_vjp cannot provide
            # (machine-precision vs dense jacrev, same cost class as a
            # reverse year); iterates then converge to RIGHT (physical)
            # eigenvectors instead of adjoint ones
            lt = jax.linear_transpose(pbl, carry)

            def base(u):
                return lt(u)[0]
        else:
            base = pbl
        apply = base if m == 1 else jax.vmap(base)

        def it(v, _):
            v, lam = fit(proj(apply(v), frozen))
            return v, lam

        v, lams = lax.scan(it, v, None, length=int(k))
        if not want_h:
            # intermediate chunk of a dispatch-split loop: only the FINAL
            # subspace feeds the Ritz values, so skip the extra reverse
            # year here (it is a jit output — XLA could not DCE it)
            return v, lams, None
        # Rayleigh–Ritz: project the iterated operator (J^T, or J under
        # side="right") onto the final orthonormal block. eig(H) are
        # SIGNED/complex eigenvalue estimates (J and J^T share their
        # spectrum, and |diag R| only ever reports moduli) at the cost
        # of one extra reverse year.
        xv = to_mat(v)
        xw = to_mat(proj(apply(v), frozen))
        if m == 1:
            h = jnp.sum(xv * xw, axis=-1)  # () solo, (K,) ensemble
        else:
            # H[..., i, j] = <v_i, apply(v_j)>; (m, m) solo, (K, m, m)
            h = jnp.einsum("i...n,j...n->...ij", xv, xw,
                           precision=lax.Precision.HIGHEST)
        return v, lams, h

    return run, prep


def stability(
    model: str,
    st: SpaceTime,
    forcing: Union[Forcing, float],
    par: Collection,
    init: Collection,
    n_iter: int = 50,
    n_modes: int = 1,
    rtol: float = 1e-3,
    project: Sequence[str] = (),
    seed: int = 0,
    v0: Optional[Collection] = None,
    dtype=None,
    newton_max_iter: int = 30,
    iters_per_dispatch: Optional[int] = None,
    mesh=None,
    side: str = "adjoint",
) -> StabilityResult:
    """Linear stability of the YEAR map at a state: dominant ``|lambda|``
    of its Jacobian by reverse-mode power iteration.

    No reference analog — the reference probes stability by forward
    integration and eyeballing trajectories. Here the year map is
    differentiable (the Newton solve carries an implicit-diff VJP), so the
    spectral radius of ``dY/dstate`` at any state — usually an
    :func:`equilibrate` result's ``.state`` — comes from iterating the
    TRANSPOSE Jacobian: ``v <- J^T v / ||J^T v||`` (forward-mode is
    unavailable through the solver's ``custom_vjp``, and ``J`` and ``J^T``
    share their singular spectrum, so the growth estimate is identical).
    Each iteration is one reverse pass through the compiled year; the
    whole loop is a ``lax.scan`` on device.

    Reading the number (measured, nx=16-24 f64):

    * classic warm/ice-free equilibrium: ``|lambda| ~ 0.98`` — cleanly
      attracting; icy classic equilibria sit near 0.96.
    * the classic step-instability regime (``dt*M/cw > 1``, nt below
      ~1000) reads 5-50: a non-attracting state detector.
    * healthy MIZ equilibria report ``|lambda| -> 1`` EXACTLY: the year
      map is non-hyperbolic there — fully ice-covered cells carry frozen
      integrator coordinates (``Ew``, then ``phi``) that neither grow nor
      decay. That 1.0 is truthful, but it hides the physical contraction;
      ``project`` names carry leaves whose components are ZEROED, each
      iteration, in cells where the base state is fully ice-covered
      (``phi >= 0.99``) — ``project=("Ew", "phi")`` peels the two frozen
      families so the estimate reflects the observable dynamics. Values
      meaningfully above 1 flag the knife-edge non-attracting
      configurations that stall :func:`equilibrate` (growth 1.008-4.9
      observed at isolated ``A`` values, see
      :func:`make_equilibrium_seasonal_fn`).

    ``n_modes=m > 1`` switches to BLOCK (subspace) iteration: m adjoint
    directions iterated together with a per-iteration QR
    orthonormalization, estimating the m leading ``|lambda|`` — ``growth``
    gains a trailing mode axis and ``mode`` a LEADING one. The extra modes
    separate the physical contraction from the neutral frozen-cell
    families without projecting, and cost one extra backward year per
    mode per iteration. Caveat: ``|diag R|`` settles to the moduli only
    for well-separated (in modulus) eigenvalues; a complex pair shows up
    as a 2-cycle oscillation in ``history`` — average the last two
    iterations there.

    The result also carries SIGNED eigenvalue estimates
    (``.eigenvalues``): one extra reverse year projects ``J^T`` onto the
    final subspace (Rayleigh–Ritz) and the small eigenproblem is solved
    on host — for ``n_modes=1`` the real Rayleigh quotient, for
    ``n_modes=m`` the m complex Ritz values sorted by modulus. Use them
    to tell a monotone (positive real — fold-type) mode from a flipping
    (negative real) or rotating (complex pair, oscillatory) one; a
    dominant complex pair needs ``n_modes>=2`` to be captured at all.

    ``side="right"`` iterates ``J`` itself instead of ``J^T`` — the
    pullback is linear, so ``jax.linear_transpose`` recovers exact
    ``J v`` products (machine precision vs dense ``jacrev``) even though
    forward-mode cannot cross the Newton solve's ``custom_vjp``. The
    spectrum estimates are identical either way; what changes is
    ``mode``: the adjoint (default) mode is the left/SENSITIVITY
    direction (which perturbations the slow dynamics respond to), the
    right mode is the PHYSICAL growth pattern (what a trajectory's
    deviation actually looks like as it grows or decays) — plot it over
    the grid to see the instability's spatial structure.

    ``par`` leaves of shape ``(K,)`` make the run an ensemble exactly as in
    :func:`equilibrate` (the Jacobian is block-diagonal over members, so
    the lockstep iteration estimates every member's radius at once);
    ``init`` is the linearization state — pass ``equilibrate(...).state``
    for equilibria, or any init/carry Collection to probe an arbitrary
    state. ``v0`` warm-starts the iteration from a given Collection (the
    previous level's ``mode`` when scanning a path —
    :meth:`ContinuationResult.stability` does this); shape must match the
    carry, with a leading mode axis under ``n_modes``.
    ``iters_per_dispatch`` bounds how many backward passes one
    device dispatch runs (as in :func:`equilibrate`; each extra dispatch
    re-runs the forward year once). Default: all in
    one dispatch — fine at diagnostic sizes. ``mesh`` (a 1-D
    ``jax.sharding.Mesh``; ensemble only, ``K`` divisible by the mesh
    size) shards the members across devices with ``NamedSharding`` — the
    iteration is block-diagonal over members, so XLA partitions the
    reverse year and the per-member QR with zero hot-loop collectives.

    Runs the differentiable XLA year graph (``integrate(engine='scan')``'s
    — the whole-year engine's fori_loop has no reverse-mode rule); float64
    strongly
    recommended: ~50 composed reverse years in f32 drown small contraction
    rates in rounding noise. Worse than noise, at float32 the frozen-cell
    ``Ew``/``phi`` families can carry SPURIOUS linearization gain — the
    Newton ``custom_vjp`` is near-singular in masked lanes, and f32
    rounding there compounds multiplicatively over the year (measured
    at an nx=16 MIZ wobble level: raw ``|lambda| ~ 20`` where the
    f64 spectrum reads 1.51 and the projected estimate 1.005). On float32
    read the PROJECTED growth (``project=("Ew", "phi")``) as the
    observable-dynamics answer and treat the raw number as an upper
    bound; on float64 raw vs projected cleanly separates physical
    non-attraction (survives projection) from the neutral families.
    """
    spec = get_model(model)
    if not isinstance(forcing, Forcing):
        forcing = Forcing(float(forcing))
    if not forcing.constant:
        raise ValueError(
            "stability needs constant forcing (the year map must be "
            "autonomous); sweep levels across members via par['F']"
        )
    if int(n_iter) < 2:
        raise ValueError("n_iter must be >= 2")
    if dtype is None:
        dtype = default_dtype()
    dtype = jnp.dtype(dtype)

    par = Collection(par)
    par.pop("__K__", None)  # batched_parameters() marker; sizes say it all
    sizes = {np.shape(v)[0] for v in par.values() if np.ndim(v) > 0}
    sizes |= {np.shape(v)[0] for v in init.values() if np.ndim(v) > 1}
    if len(sizes) > 1:
        raise ValueError(f"inconsistent ensemble sizes {sorted(sizes)}")
    K = sizes.pop() if sizes else None
    ensemble = K is not None

    F_off = par.pop("F", None)
    if F_off is not None and not ensemble:
        forcing = Forcing(float(forcing.base) + float(np.asarray(F_off)))
        F_off = None
    if F_off is not None and np.ndim(F_off) == 0:
        F_off = np.full((int(K),), float(F_off))

    cfg = default_step_config(dtype.name, newton_max_iter=newton_max_iter)

    carry = spec.init_carry(init, st, dtype)
    if ensemble:
        carry = Collection({
            k: (v if jnp.ndim(v) > 1
                else jnp.broadcast_to(v, (int(K),) + v.shape))
            for k, v in carry.items()
        })
        par_j = Collection({
            k: (jnp.asarray(v, dtype)[:, None] if np.ndim(v) == 1
                else jnp.asarray(v, dtype))
            for k, v in par.items()
        })
    else:
        par_j = Collection(
            {k: jnp.asarray(v, dtype) for k, v in par.items()}
        )
    frow = forcing.table(st)[0]
    if F_off is not None:
        frow = frow[:, None, None] + np.asarray(F_off)[None, :, None]
    frow_j = jnp.asarray(frow, dtype=dtype)

    bad = [n for n in project if n not in carry]
    if bad:
        raise ValueError(
            f"project names {bad} not in the {spec.name} carry "
            f"{tuple(carry.keys())}"
        )
    if project and "phi" not in carry:
        raise ValueError(
            "project needs a 'phi' carry field to locate fully "
            "ice-covered cells (MIZ only)"
        )
    project = frozenset(project)
    frozen = (carry["phi"] >= 0.99) if project else None

    m = int(n_modes)
    if m < 1:
        raise ValueError("n_modes must be >= 1")
    if side not in ("adjoint", "right"):
        raise ValueError(f"side must be 'adjoint' or 'right', got {side!r}")
    keys_order = tuple(sorted(carry.keys()))
    widths = tuple(int(carry[k].shape[-1]) for k in keys_order)
    if m > sum(widths):
        raise ValueError(
            f"n_modes={m} exceeds the state dimension {sum(widths)}"
        )
    run, prep = _stability_loop_fn(model, st, cfg, dtype.name, m,
                                   keys_order, widths, project, side,
                                   remat=ensemble)

    rng = np.random.default_rng(seed)
    rand = Collection({
        k: jnp.asarray(
            rng.standard_normal(np.shape(v) if m == 1
                                else (m,) + np.shape(v)), dtype)
        for k, v in carry.items()
    })
    if v0 is not None:
        # warm start (e.g. the previous level's mode when scanning a
        # continuation path): converges in a handful of iterations when
        # the dominant mode varies continuously along the path; columns
        # that arrive degenerate (non-finite — the previous level
        # diverged — or projected to ~zero: the old mode's support now
        # lies entirely in frozen cells) fall back to the random draw
        # instead of poisoning or silently zeroing the iteration
        want = {k: ((np.shape(v) if m == 1 else (m,) + np.shape(v)))
                for k, v in carry.items()}
        bad = {k for k in want
               if k not in v0 or tuple(np.shape(v0[k])) != want[k]}
        if bad:
            raise ValueError(
                f"v0 leaves {sorted(bad)} missing or mis-shaped; expected "
                f"{ {k: want[k] for k in sorted(want)} }"
            )
        v0 = Collection({k: jnp.asarray(np.asarray(v0[k]), dtype)
                         for k in want})
        v0, _ = prep(v0, frozen, fallback=rand)
    else:
        v0, _ = prep(rand, frozen, fallback=None)

    if mesh is not None:
        if not ensemble:
            raise ValueError(
                "mesh= needs an ensemble (per-member (K,) par leaves or a "
                "member-batched init)"
            )
        if int(K) % mesh.size != 0:
            raise ValueError(
                f"ensemble size {K} is not divisible by the mesh size "
                f"{mesh.size}"
            )
        from jax.sharding import NamedSharding
        from jax.sharding import PartitionSpec as _P

        ax = mesh.axis_names[0]

        def _shard(x, axis_idx, min_rank):
            # STRUCTURAL member-axis placement: each operand family has a
            # fixed layout here (carry (K, nx), swept par (K, 1), F-offset
            # frow (nt, K, 1), modes (m, K, nx)), so rank alone identifies
            # the member axis — an extent==K test would collide when K
            # matches nt/nx (the known-broken heuristic, CLAUDE.md) and
            # silently shard a non-member axis
            if np.ndim(x) >= min_rank:
                spec = [None] * np.ndim(x)
                spec[axis_idx] = ax
                return jax.device_put(x, NamedSharding(mesh, _P(*spec)))
            return x

        carry = jax.tree_util.tree_map(
            lambda x: _shard(x, 0, 2), carry)      # (K, nx)
        par_j = jax.tree_util.tree_map(
            lambda x: _shard(x, 0, 2), par_j)      # (K, 1) swept leaves
        frow_j = _shard(frow_j, 1, 3)              # (nt, K, 1) F offsets
        if frozen is not None:
            frozen = _shard(frozen, 0, 2)
        v0 = jax.tree_util.tree_map(
            lambda x: _shard(x, 0 if m == 1 else 1, 2 if m == 1 else 3),
            v0,
        )

    chunk = int(n_iter) if iters_per_dispatch is None \
        else max(1, int(iters_per_dispatch))
    v, hist, h = v0, [], None
    done = 0
    while done < int(n_iter):
        k = min(chunk, int(n_iter) - done)
        want_h = done + k >= int(n_iter)  # Ritz block: final chunk only
        v, lams, h = run(v, carry, par_j, frow_j, frozen, k, want_h)
        hist.append(lams)
        done += k
    v, history, H = jax.device_get((v, jnp.concatenate(hist, axis=0), h))
    history = np.asarray(history, dtype=np.float64)
    H = np.asarray(H, dtype=np.float64)
    if m == 1:
        eig = H  # signed Rayleigh quotient, () or (K,)
    else:
        # a divergent linearization state (NaN/inf carry — e.g. one level
        # of a path that never converged, or the classic step-instability
        # regime overflowing) leaves H non-finite; np.linalg.eigvals
        # REFUSES those, and one bad member must not kill the whole
        # batched eigenproblem — emit NaN eigenvalues for bad blocks and
        # let `converged` report the failure, as the m=1 path always has
        blocks = H.reshape((-1, m, m))  # (1|K, m, m)
        flat = np.full((blocks.shape[0], m), np.nan + 0j, np.complex128)
        ok = np.isfinite(blocks).all(axis=(-2, -1))
        if ok.any():
            good = np.linalg.eigvals(blocks[ok])
            order = np.argsort(-np.abs(good), axis=-1)
            flat[ok] = np.take_along_axis(good, order, axis=-1)
        eig = flat.reshape(H.shape[:-1])  # complex, (m,) or (K, m)
    growth = history[-1]
    with np.errstate(invalid="ignore", divide="ignore"):
        converged = (
            np.isfinite(growth)
            & (np.abs(history[-1] - history[-2])
               <= rtol * np.maximum(np.abs(growth), np.finfo(np.float64).tiny))
        )
    mode = Collection({k: np.asarray(x) for k, x in v.items()})
    if ensemble or m > 1:
        return StabilityResult(
            growth=np.asarray(growth), history=history,
            converged=np.asarray(converged), mode=mode, rtol=float(rtol),
            n_modes=m, eigenvalues=np.asarray(eig), side=side,
        )
    return StabilityResult(
        growth=float(growth), history=history, converged=bool(converged),
        mode=mode, rtol=float(rtol), eigenvalues=float(eig), side=side,
    )


def _level_config(vary: str, forcing: Forcing, par: Collection, v: float):
    """(forcing, par) for one continuation level — the ONE place that
    defines how a level value maps onto the model configuration, shared by
    :func:`continuation` and :meth:`ContinuationResult.stability` so the
    trace and its post-hoc analysis cannot drift apart."""
    if vary == "F":
        return Forcing(float(forcing.base) + float(v)), par
    p = Collection(par)
    p[vary] = float(v)
    return forcing, p


@dataclasses.dataclass
class ContinuationResult:
    """Result of :func:`continuation`: one :class:`EquilibriumResult` per
    level, in trace order.

    ``values`` are the swept levels; ``direction`` is +1 on the forward
    leg, -1 on the ``round_trip`` return leg (hysteresis: where the two
    legs disagree at the same value, the model is bistable there).
    ``years``/``converged`` are stacked per-level convenience views; use
    ``mean(var)`` for the hemispheric annual mean of a seasonal field and
    ``ice_area()`` for the bifurcation diagnostic ``2 pi <phi>`` (the same
    one ``plot_bifurcation`` draws; classic runs fall back to ``E < 0``).
    """

    values: np.ndarray
    direction: np.ndarray
    results: list
    vary: str
    spacetime: SpaceTime
    # configuration for post-hoc analysis (stability along the path);
    # None on results loaded from files written before these were stored
    model: Optional[str] = None
    par: Optional[Collection] = None
    forcing: Optional[Forcing] = None

    @property
    def years(self) -> np.ndarray:
        return np.asarray([r.years for r in self.results])

    @property
    def converged(self) -> np.ndarray:
        return np.asarray([np.all(r.converged) for r in self.results])

    def mean(self, var: str = "E", season: str = "avg") -> np.ndarray:
        """Hemispheric mean of a seasonal field per level — shape ``(L,)``
        (``(L, K)`` for ensemble continuations); presentation NaNs
        contribute zero, as in the convergence metric."""
        from .utils.numerics import hemispheric_mean

        rows = [
            np.asarray(hemispheric_mean(
                np.nan_to_num(getattr(r.seasonal, season)[var]),
                self.spacetime.x,
            ))
            for r in self.results
        ]
        return np.asarray(rows) / float(self.spacetime.x[-1]
                                        - self.spacetime.x[0])

    def ice_area(self, season: str = "avg") -> np.ndarray:
        """Ice-covered area ``2 pi <phi>`` per level (classic: from
        ``E < 0``), the standard bifurcation-diagram ordinate — the shared
        :func:`~energybalancemodel_jl_tpu.fold.seasonal_ice_area`
        diagnostic applied per level."""
        from .fold import seasonal_ice_area

        return np.asarray([
            np.asarray(seasonal_ice_area(getattr(r.seasonal, season),
                                         self.spacetime))
            for r in self.results
        ])

    def hysteresis_gap(self, var: Optional[str] = None,
                       season: str = "avg"):
        """Bistability diagnostic of a ``round_trip`` result: the
        absolute difference between the forward and return legs' ice
        area (or ``var``'s hemispheric mean) at every level value BOTH
        legs visited. Returns ``(values, gap)`` — ``gap`` has shape
        ``(L',)`` (``(L', K)`` for ensembles); entries above the
        equilibration tolerance mark the bistable window (measured:
        classic's window is huge, MIZ at default parameters has none —
        gaps < 0.1; examples/bistability_map.py maps the (D, F) plane
        with exactly this)."""
        if not np.any(self.direction < 0):
            raise ValueError(
                "hysteresis_gap needs a round_trip continuation (no "
                "return leg to compare against)")
        field = (self.ice_area(season) if var is None
                 else self.mean(var, season))
        fwd = self.direction > 0
        vals, gaps = [], []
        for i in np.flatnonzero(fwd):
            j = np.flatnonzero(~fwd & (self.values == self.values[i]))
            if j.size:
                vals.append(self.values[i])
                gaps.append(np.abs(field[i] - field[j[0]]))
        return np.asarray(vals), np.asarray(gaps)

    def stability(self, warm_start: bool = True, progress: bool = False,
                  **stability_kwargs):
        """Linear stability at every level of the path: one
        :func:`stability` call per level, linearized at that level's
        equilibrium, each warm-started from the previous level's ``mode``
        (``warm_start=False`` for independent random starts). Returns a
        list of :class:`StabilityResult` in trace order — stack
        ``[r.growth for r in ...]`` against ``values`` to see folds
        coming (growth rises toward 1 as an attractor loses stability).
        ``progress=True`` draws the package progress bar, one tick per
        level. Other keywords (``n_iter``/``n_modes``/``project``/...)
        pass through.
        """
        if self.model is None or self.par is None or self.forcing is None:
            raise ValueError(
                "this ContinuationResult carries no model/par/forcing "
                "(loaded from a file written before they were stored?) — "
                "call ebm.stability per level directly"
            )
        prog = None
        if progress:
            from .utils.progress import Progress

            prog = Progress(
                len(self.results), title=f"Stability ({self.vary})",
                infofeed=lambda v, r: (
                    f"{self.vary}={v:g}: {r!r}" if r is not None else ""
                ),
            )
            prog.update(0, feedargs=(self.values[0], None))
        out, v0 = [], None
        for i, (v, res) in enumerate(zip(self.values, self.results)):
            fc, p = _level_config(self.vary, self.forcing, self.par, v)
            r = stability(self.model, self.spacetime, fc, p, res.state,
                          v0=v0 if warm_start else None,
                          **stability_kwargs)
            out.append(r)
            v0 = r.mode
            if prog is not None:
                prog.update(i + 1, feedargs=(v, r))
        return out

    def __repr__(self):
        k = int(np.count_nonzero(self.converged))
        legs = ("round trip" if np.any(self.direction < 0)
                else "one-way")
        return (f"ContinuationResult({self.vary}: {len(self.results)} "
                f"levels in [{self.values.min():g} .. "
                f"{self.values.max():g}] {legs}, "
                f"{k}/{len(self.results)} converged, "
                f"{int(self.years.sum())} total years)")


def continuation(
    model: str,
    st: SpaceTime,
    values: Sequence[float],
    par: Collection,
    init: Collection,
    vary: str = "F",
    forcing: Union[Forcing, float] = 0.0,
    round_trip: bool = False,
    tol: float = 1e-3,
    max_years: int = 1000,
    progress: bool = False,
    checkpoint: Optional[str] = None,
    resume: bool = False,
    **equilibrate_kwargs,
) -> ContinuationResult:
    """Numerical continuation: equilibrate along a parameter path, each
    level WARM-STARTED from the previous level's converged state.

    The package's native replacement for the reference's hysteresis
    workflow (integrate a multi-decade forcing ramp and read states off
    the trajectory, /root/reference/src/plot.jl:173-225): warm starts keep
    every solve inside the attractor's basin, so each branch is traced
    directly — the warm/cold branch and its fold — without simulating the
    ramp. ``round_trip=True`` appends the reversed path (omitting the
    repeated turning point), tracing BOTH hysteresis branches in one call;
    compare the two legs' :meth:`~ContinuationResult.ice_area` at equal
    values to find the bistable window.

    ``vary="F"`` sweeps the constant forcing level (each entry of
    ``values`` offsets ``forcing``'s base); any other ``vary`` names a
    ``par`` key to set per level. ``progress=True`` draws the package's
    throttled progress bar (one tick per level, level diagnostics on the
    info line) — levels can take minutes each at large configs. All other keywords
    (``engine``/``mesh``/``dtype``/``metric``/...) pass through to
    :func:`equilibrate`; ``par`` leaves of shape ``(K,)`` make each level
    an ensemble equilibration (K members trace the path in lockstep).

    ``checkpoint=`` names a file that records every COMPLETED level;
    ``resume=True`` reloads the completed levels and continues from the
    first unfinished one, warm-started from the last completed state —
    exactly the state an uninterrupted run would have handed it, so the
    remaining levels are computed identically. The config fingerprint
    covers the model, grid, forcing, parameters, path (values +
    directions), tolerance, horizon, and the pass-through equilibrate
    options; a mismatch warns and restarts. (The per-level ``equilibrate``
    loop's own ``checkpoint``/``resume`` is not exposed here — one level
    is the useful granularity for multi-level scans.)
    """
    if not isinstance(forcing, Forcing):
        forcing = Forcing(float(forcing))
    if not forcing.constant:
        raise ValueError("continuation needs a constant base forcing")
    values = list(values)
    if not values:
        raise ValueError("values must be non-empty")
    if vary != "F" and vary not in par:
        raise ValueError(f"vary {vary!r} not in par (and not 'F')")
    path = [(float(v), 1) for v in values]
    if round_trip:
        path += [(float(v), -1) for v in values[-2::-1]]

    par = Collection(par)
    prog = None
    if progress:
        from .utils.progress import Progress

        prog = Progress(
            len(path), title=f"Continuation ({vary})",
            infofeed=lambda v, res: (
                f"{vary}={v:g}: {res!r}" if res is not None else ""
            ),
        )
        prog.update(0, feedargs=(path[0][0], None))

    ckpt_key = None
    if checkpoint is not None or resume:
        if checkpoint is None:
            raise ValueError("resume=True needs checkpoint=<path>")
        import hashlib

        from . import checkpoint as ckpt_mod

        pv = np.asarray([v for v, _ in path], dtype=np.float64)
        pd = np.asarray([d for _, d in path], dtype=np.int8)
        vdig = hashlib.sha1(pv.tobytes() + pd.tobytes()).hexdigest()[:16]
        kw = ",".join(f"{k}={equilibrate_kwargs[k]!r}"
                      for k in sorted(equilibrate_kwargs))
        kdig = hashlib.sha1(kw.encode()).hexdigest()[:16]
        ckpt_key = ckpt_mod.config_key(
            "continuation", model, st, forcing, par,
            str(equilibrate_kwargs.get("dtype", "auto")), "",
            int(equilibrate_kwargs.get("newton_max_iter", 30)),
            extras=(f"vary={vary}", f"path#{len(path)}:{vdig}",
                    f"tol={float(tol)}", f"maxy={int(max_years)}",
                    f"kw={kdig}"),
        )

    state, results, start = init, [], 0
    n_in_file = None  # levels this run trusts in the file (None: recreate)
    if resume:
        import warnings

        from . import checkpoint as ckpt_mod

        try:
            matches = ckpt_mod.checkpoint_matches(checkpoint, ckpt_key,
                                                  kind="ContCheckpoint")
            loaded = (ckpt_mod.read_cont_checkpoint(checkpoint)[0]
                      if matches else None)
        except (OSError, ValueError):  # torn/corrupt file: start fresh
            matches, loaded = False, None
        if matches:
            results = loaded[:len(path)]
            start = n_in_file = len(results)
            if start:
                state = results[-1].state
            if prog is not None and start:
                prog.update(start, feedargs=(path[start - 1][0],
                                             results[-1]))
        elif os.path.exists(checkpoint):
            warnings.warn(
                f"Checkpoint {checkpoint} does not match this "
                "continuation's configuration; starting from the first "
                "level."
            )

    # resumed non-finite tails must not re-warn at (and blame) the first
    # RESUMED level — the divergence happened at an earlier one
    warned_nonfinite = start > 0 and not all(
        np.isfinite(np.asarray(x)).all() for x in state.values()
    )
    for i, (v, _) in enumerate(path[start:], start=start):
        fc, p = _level_config(vary, forcing, par, v)
        res = equilibrate(model, st, fc, p, state, tol=tol,
                          max_years=max_years, **equilibrate_kwargs)
        results.append(res)
        state = res.state
        if ckpt_key is not None:
            from . import checkpoint as ckpt_mod

            ckpt_mod.write_cont_checkpoint(checkpoint, results, ckpt_key,
                                           n_prev=n_in_file)
            n_in_file = len(results)
        if not warned_nonfinite and not all(
            np.isfinite(np.asarray(x)).all() for x in state.values()
        ):
            # once, at the FIRST divergent level: later levels inherit
            # the NaNs by warm start and would misattribute the blame
            warned_nonfinite = True
            import warnings

            warnings.warn(
                f"continuation level {vary}={v:g} produced a non-finite "
                "state; subsequent levels warm-start from it and will "
                "stay non-finite — shrink the level spacing or restart "
                "from a fresh init past this level",
                stacklevel=2,
            )
        if prog is not None:
            prog.update(i + 1, feedargs=(v, res))
    return ContinuationResult(
        values=np.asarray([v for v, _ in path]),
        direction=np.asarray([d for _, d in path], dtype=np.int8),
        results=results, vary=vary, spacetime=st,
        model=model, par=par, forcing=forcing,
    )
