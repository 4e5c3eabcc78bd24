"""Noise-forced integration: noise-induced transitions between attractors.

No reference analog — the reference (EnergyBalanceModel.jl) is fully
deterministic; its hysteresis diagnostics (/root/reference/src/plot.jl:
173-225) find coexisting attractors but say nothing about how robust they
are to weather noise. This module adds the classical stochastic-EBM
question (Benzi/Sutera-style): perturb the radiative forcing with an
Ornstein–Uhlenbeck "weather noise" process and measure how often, and how
fast, trajectories cross the basin boundary (the saddle :func:`ebm.edge`/
:func:`ebm.edge_state` locate deterministically). With a RAMPED forcing
(the reference's own 5-segment :class:`~energybalancemodel_jl_tpu.forcing.
Forcing`, /root/reference/src/infrastructure.jl:208-307) the same driver
measures rate-induced/noise-advanced tipping: each member-year is
classified against two SIGMA-ZERO companion trajectories integrated under
the identical ramp (the evolving on-/off-branch references — the same
idea as :func:`~energybalancemodel_jl_tpu.fold.fold`'s evolving
classifier), so ``first_passage`` reads off how many years EARLIER than
the deterministic run the noise tips each member.

Design: the noise NEVER touches the model step. Each year the driver draws
the OU path ``eta_1..eta_nt`` (per member) and adds it to that year's
forcing row — exactly the channel the virtual per-member ``"F"`` sweep
already uses — then calls the unmodified year function from
:mod:`~energybalancemodel_jl_tpu.integrate`. ``sigma=0`` therefore
reproduces the deterministic trajectory, and every engine invariant
(seasonal accumulators, Newton warm starts) is inherited rather than
re-implemented.

Noise model: per step ``eta' = rho eta + sigma sqrt(1 - rho^2) xi`` with
``rho = exp(-dt / tau)``, ``dt = 1/nt`` years — an OU process with
correlation time ``tau`` (years) and STATIONARY standard deviation
``sigma`` (W/m^2), so the forcing variance is independent of the step
resolution ``nt`` (refining the grid does not change the climate noise).
``tau = 0`` degenerates to iid per-step noise of std ``sigma`` — note its
integrated effect then vanishes as ``nt`` grows; physical weather noise
has ``tau`` of days-to-weeks (0.01–0.05 yr). ``sigma`` may be a ``(K,)``
vector — per-member noise amplitudes, the one-program sigma sweep the
Kramers escape-rate validation uses (``tests/test_stochastic_oracle.py``).

Reproducibility: member ``k``'s draws come from ``fold_in(key(seed), k)``
folded again with the ABSOLUTE year index (``year0 + elapsed``), so the
realization depends only on ``(seed, member, absolute year)`` — splitting
the run into dispatch chunks (``years_per_dispatch``) is bitwise
invariant, and a run can be split ACROSS calls
bit-exactly: ``transitions(..., years=N)`` equals ``transitions(...,
years=M)`` continued by ``transitions(..., years=N-M, year0=M,
init=r.state, eta0=r.eta)`` with the same seed (``TestYear0Resume``).

Engines: one member's noisy year is the same program as the
deterministic one; K members run as a lockstep batch, and ``mesh=`` shards
members across devices (noise keys are
per-member, so sharding cannot change the draws). The scan engine draws
each year's ``(nt, K)`` table with ``jax.random`` and runs the per-year
scan graph; the whole-year engine (``engine='fused'``, :mod:`.ops.year`)
runs the noisy year as one program, drawing the same weather from the
per-member keys inside it and running the OU recurrence inside its step
loop.
"""
from __future__ import annotations

import dataclasses
import functools
import time
import warnings
from typing import Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .forcing import Forcing
from .integrate import default_dtype, make_year_fn
from .engine import auto_whole_year, check_whole_year
from .models.base import default_step_config, get_model
from .spacetime import SpaceTime
from .utils.collection import Collection
from .utils.numerics import hemispheric_mean

__all__ = ["transitions", "TransitionResult"]

# Dispatch chunking (same policy as equilibrate): adaptive mode starts at
# _CHUNK_START years per dispatch and resizes each chunk toward
# _CHUNK_TARGET_S wall seconds, the progress cadence. Unlike equilibrate's
# while_loop the
# chunk length is a STATIC scan length here, so adaptive sizes are
# quantized to powers of two (<= _CHUNK_MAX) to bound recompiles at
# ~log2(_CHUNK_MAX) program variants.
_CHUNK_START = 4
_CHUNK_TARGET_S = 15.0
_CHUNK_MAX = 4096


def _quantize_chunk(target: float) -> int:
    """Largest power of two <= max(target, 1), capped at _CHUNK_MAX."""
    return 1 << int(np.clip(np.floor(np.log2(max(target, 1.0))),
                            0, np.log2(_CHUNK_MAX)))


@dataclasses.dataclass
class TransitionResult:
    """Result of :func:`transitions`.

    ``areas`` is the per-year seasonal ice area of every member, shape
    ``(years, K)``; ``labels`` the per-year classification against the two
    attractor reference areas (0 = nearer ``a``, 1 = nearer ``b``, -1 =
    non-finite year; an exactly equidistant year is labeled as the START
    attractor, so a tie never counts as a first passage).
    ``first_passage`` is each member's first year (1-based) whose label
    differs from the starting attractor's — NaN where no transition
    happened within ``years`` (censored) or the member went non-finite
    first. ``state``/``eta`` are the final carries and OU values — pass
    them as ``init=``/``eta0=`` with ``year0=<years run so far>`` and the
    SAME seed to continue the run bit-exactly, or with a fresh seed to
    extend it with new weather. ``tracked`` holds the per-year hemispheric
    means requested via ``track=``, each ``(years, K)``.

    Constant forcing: ``area_a``/``area_b`` are the static attractor
    reference areas (``(1,)`` or ``(K,)``). Ramped forcing
    (``ramped=True``): they are the PER-YEAR areas of the two sigma-zero
    companion trajectories, shape ``(years,)``, and ``ref_state`` holds
    the companions' final carries (resume material for ``ref_init=``).
    ``degenerate=True`` flags that the two reference areas came within
    ~4x the observed year-to-year area fluctuation somewhere in the run —
    there the nearest-area labels are noise and the escape statistics
    should not be trusted (for ramps this always happens after the
    deterministic run itself tips and the references merge).
    """

    areas: np.ndarray
    labels: np.ndarray
    first_passage: np.ndarray
    finite: np.ndarray
    state: Collection
    eta: np.ndarray
    tracked: Collection
    area_a: np.ndarray
    area_b: np.ndarray
    start: str
    sigma: Union[float, np.ndarray]
    tau: float
    years: int
    season: str
    seed: int
    newton_ok: bool
    year0: int = 0
    engine: str = "scan"
    ramped: bool = False
    degenerate: bool = False
    ref_state: Optional[Tuple[Collection, Collection]] = None
    crossing_step: Optional[np.ndarray] = None
    nt: int = 0

    @property
    def escaped(self) -> np.ndarray:
        """Members that crossed to the other attractor within ``years``."""
        return np.isfinite(self.first_passage)

    def escape_fraction(self) -> float:
        """Fraction of finite members that escaped within ``years``."""
        fin = self.finite
        n = int(np.count_nonzero(fin))
        if n == 0:
            return float("nan")
        return float(np.count_nonzero(self.escaped & fin)) / n

    def first_passage_subyear(self) -> np.ndarray:
        """Sub-annual first-passage times in fractional years (requires
        ``subyear=True``): for each escaped member, the step
        at which the instantaneous ice area crossed the reference
        midpoint on the way to its year-classified passage —
        ``year + (step + 1) / nt``. A recorded step of 0 means the area
        was ALREADY across when the first-passage year began (the
        year-mean classifier lags the instantaneous crossing), so the
        search walks back through consecutive earlier years until it
        finds the year the crossing actually happened (step > 0).
        Where no crossing is recorded in the first-passage year (the
        annual MEAN flipped without an instantaneous midpoint touch —
        possible for gradual transitions), the whole year is kept.
        NaN where censored/non-finite."""
        if self.crossing_step is None:
            raise ValueError(
                "no sub-annual crossing data: run transitions(..., "
                "subyear=True)")
        fp = np.asarray(self.first_passage, dtype=np.float64)
        out = fp.copy()
        for k in range(fp.shape[0]):
            if not np.isfinite(fp[k]):
                continue
            y = int(fp[k]) - 1
            step = self.crossing_step[y, k]
            if step < 0:
                continue  # mean-flip without an instantaneous touch
            # walk back over already-across-at-year-start records to the
            # year the instantaneous crossing actually occurred
            while step == 0 and y > 0 and self.crossing_step[y - 1, k] >= 0:
                y -= 1
                step = self.crossing_step[y, k]
            if step == 0 and y == 0:
                # across at the very start of the RESULT window (an
                # init= override past the midpoint, or a resumed run
                # whose crossing predates year0): no crossing was
                # observed in-window — keep the year-mean passage
                # instead of claiming ~1/nt (review r5)
                continue
            out[k] = y + (step + 1.0) / float(self.nt)
        return out

    def mean_first_passage(self) -> float:
        """Mean first-passage year over ESCAPED members only — biased low
        when many members are censored (never escaped in ``years``); use
        :meth:`escape_rate` for the censoring-aware estimate."""
        fp = self.first_passage[self.escaped & self.finite]
        return float(np.mean(fp)) if fp.size else float("nan")

    def escape_rate(self) -> float:
        """Escapes per member-year, the censoring-aware MLE for an
        exponential escape process: ``n_escaped / total observed years``
        where a censored member contributes all ``years`` and an escaped
        one its first-passage year. Its reciprocal estimates the mean
        residence time even when most members never escaped."""
        fin = self.finite
        esc = self.escaped & fin
        observed = np.where(esc, self.first_passage, float(self.years))
        total = float(np.sum(observed[fin]))
        if total <= 0.0:
            return float("nan")
        return float(np.count_nonzero(esc)) / total

    def __repr__(self):
        K = self.areas.shape[1] if self.areas.ndim == 2 else 0
        n_esc = int(np.count_nonzero(self.escaped & self.finite))
        bad = int(np.count_nonzero(~self.finite))
        extra = f", {bad} non-finite" if bad else ""
        if np.ndim(self.sigma) > 0:
            s = np.asarray(self.sigma, dtype=np.float64)
            sig = f"sigma in [{s.min():g}, {s.max():g}]"
        else:
            sig = f"sigma={float(self.sigma):g}"
        kind = "ramped " if self.ramped else ""
        return (f"TransitionResult({n_esc}/{K} members escaped "
                f"'{self.start}' in {self.years} {kind}years, {sig}"
                f", tau={self.tau:g}{extra})")


def _area_fn(st: SpaceTime, dtype):
    """Seasonal ice area of a (K, nx)-leaved seasonal Collection — shared
    by both engine loop fns so fused and scan classify identically."""
    x = jnp.asarray(st.x, dtype=dtype)

    def area_of(coll):
        if "phi" in coll:
            field = jnp.nan_to_num(coll["phi"])
        else:
            field = (coll["E"] < 0.0).astype(dtype)
        return 2.0 * jnp.pi * hemispheric_mean(field, x)

    return x, area_of


@functools.lru_cache(maxsize=32)
def _transition_loop_fn(model_name: str, st: SpaceTime, cfg, dtype_name: str,
                        season: str, track):
    """Jitted noisy-year chunk (XLA scan engine): ``k`` OU-forced years
    advancing a lockstep ensemble, emitting each year's seasonal ice area
    (and tracked hemispheric means). Carry/par/forcing/noise state are
    ARGUMENTS so one compilation serves every chunk; the noise realization
    is keyed on (member key, ABSOLUTE year), so chunk boundaries cannot
    change the draws. ``frows`` is the chunk's ``(k, nt)`` per-year base
    forcing table (a ramp's rows differ per year; a constant forcing
    repeats one row) and ``f_off`` the ``(K,)`` per-member offset."""
    year = make_year_fn(model_name, st, cfg, dtype_name, False)
    dtype = jnp.dtype(dtype_name)
    nt = st.nt
    x, area_of = _area_fn(st, dtype)

    @functools.partial(jax.jit, static_argnums=(7,))
    def run(carry, eta, keys, par_j, f_off, frows, year0, k, rho, scale):
        def one_year(state, inp):
            yi, frow = inp
            carry, eta = state
            draw = lambda key: jax.random.normal(
                jax.random.fold_in(key, yi), (nt,), dtype)
            xi = jax.vmap(draw)(keys)  # (K, nt)

            def ou(e, z):
                e = rho * e + scale * z
                return e, e

            eta, etas = lax.scan(ou, eta, jnp.swapaxes(xi, 0, 1))
            fyear = (frow[:, None, None] + f_off[None, :, None]) \
                + etas[..., None]  # (nt, K, 1)
            carry, seasonal, conv, _ = year(carry, par_j, fyear)
            if conv is None:
                conv = jnp.ones((), dtype)
            coll = getattr(seasonal, season)
            area = area_of(coll)
            means = tuple(
                hemispheric_mean(jnp.nan_to_num(coll[v]), x) for v in track
            )
            return (carry, eta), (area, means, conv)

        (carry, eta), (areas, means, convs) = lax.scan(
            one_year, (carry, eta),
            (year0 + jnp.arange(k, dtype=jnp.int32), frows))
        return carry, eta, areas, means, jnp.min(convs)

    return run


@functools.lru_cache(maxsize=32)
def _transition_fused_loop_fn(model_name: str, st: SpaceTime, cfg,
                              dtype_name: str, season: str, track,
                              ou_impl: str = "serial",
                              subyear: bool = False,
                              ramp_thr: float = 0.0):
    """Whole-year-engine twin of :func:`_transition_loop_fn`: each scanned
    year runs :mod:`.ops.year` with the year's WHITE-noise draws and the OU
    recurrence in its step loop (``noise_ou=(rho, scale, eta0)``; the year
    hands back the year-end eta row).

    The engine draws the year's white noise from the year-folded
    per-member KEYS (``jax.random.normal``, as the scan engine does).
    ``ou_impl='assoc'`` evaluates the eta path by a log-depth scan
    (tree-regrouped rounding — engine-parity-level, not bitwise, vs
    serial). Draw keying, OU recursion, forcing grouping
    ``(frow + F) + eta``, and the area/track reductions are IDENTICAL to
    the scan engine — same seed, same weather, engine-parity-level same
    trajectories.

    ``ramp_thr`` (+1.0 for ``start='a'``, -1.0 for ``'b'``, 0.0 = static
    rows) makes the ``subyear`` crossing rows EVOLVE in-scan: year ``y``
    runs with the threshold/sign derived from the sigma-zero companion
    lanes' (the LAST two members') year-``y-1`` mean areas — the entering
    (lag-1, causal) midpoint; the caller seeds the first year's rows and
    re-derives them at chunk boundaries with the same dtype arithmetic
    (:func:`_thr_sgn_rows`), so chunking stays bitwise-invariant."""
    from .ops.year import classic_year, miz_year

    year_fn = miz_year if model_name == "MIZ" else classic_year
    dtype = jnp.dtype(dtype_name)
    x, area_of = _area_fn(st, dtype)

    evolving = bool(subyear and ramp_thr != 0.0)

    @functools.partial(jax.jit, static_argnums=(7,))
    def run(carry, eta, keys, par_j, f_off, frows, year0, k, rho, scale,
            cr_thr, cr_sgn):
        par_k = Collection(dict(par_j))
        par_k["F"] = f_off  # (K,) constant per-member offset
        four_pi = jnp.asarray(2.0 * 2.0 * np.pi, dtype)

        def one_year(state, inp):
            yi, frow = inp
            if evolving:
                carry, eta, thr, sgn = state
            else:
                (carry, eta), thr, sgn = state, cr_thr, cr_sgn
            cross = jnp.full(eta.shape, -1.0, dtype)
            yk = jax.vmap(lambda key: jax.random.fold_in(key, yi))(keys)
            out = year_fn(
                carry, par_k, frow, st, cfg, noise_ou=(rho, scale, eta),
                ou_assoc=(ou_impl == "assoc"),
                crossing=(thr, sgn) if subyear else None, noise_keys=yk)
            if subyear:
                carry, seasonal, conv, eta, cross = out
            else:
                carry, seasonal, conv, eta = out
            if conv is None:  # classic has no Newton flag
                conv = jnp.ones((), dtype)
            coll = getattr(seasonal, season)
            area = area_of(coll)
            means = tuple(
                hemispheric_mean(jnp.nan_to_num(coll[v]), x) for v in track
            )
            if evolving:
                # next year's entering threshold: this year's companion
                # (last two lanes, sigma-zero) mean-area midpoint — the
                # same ops, same dtype as the host's _thr_sgn_rows
                a_y, b_y = area[-2], area[-1]
                thr = jnp.full_like(thr, (a_y + b_y) / four_pi)
                sgn = jnp.full_like(
                    sgn, jnp.asarray(ramp_thr, dtype) * jnp.sign(b_y - a_y))
                return (carry, eta, thr, sgn), (area, means, conv, cross)
            return (carry, eta), (area, means, conv, cross)

        state0 = (carry, eta, cr_thr, cr_sgn) if evolving else (carry, eta)
        state, (areas, means, convs, crosses) = lax.scan(
            one_year, state0,
            (year0 + jnp.arange(k, dtype=jnp.int32), frows))
        carry, eta = state[0], state[1]
        return carry, eta, areas, means, jnp.min(convs), crosses

    return run


def _shard_fused_run(base_run, mesh, track):
    """Mesh wrapper of the fused chunk fn: ``shard_map`` over the member
    axis — each device runs the whole-year engine on its local member
    shard; the only collectives are the Newton loop condition's one-scalar
    OR over the mesh (the caller's ``StepConfig.batch_axis``, so every
    shard runs the unsharded trip count) and the final ``pmin`` of the
    Newton flag. Per-member draw keying makes the sharded weather EXACTLY
    the unsharded weather (``TestMeshFused``); trajectories follow the
    same arithmetic (bitwise on the GPU; at round-off on XLA:CPU, which
    compiles the year for the shard's member count). Wrappers are cached
    per (chunk length,
    sharded-leaf signature) so the adaptive chunk ladder reuses its
    ~log2 variants."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    ax = mesh.axis_names[0]
    cache = {}

    def run(carry, eta, keys, par_j, f_off, frows, year0, k, rho, scale,
            cr_thr, cr_sgn):
        mem = P(ax)
        swept = tuple(sorted(n for n, v in par_j.items() if jnp.ndim(v)))
        sig = (k, tuple(sorted(par_j)), swept, int(jnp.ndim(scale)))
        fn = cache.get(sig)
        if fn is None:
            carry_specs = Collection({n: mem for n in carry})
            par_specs = Collection({n: (mem if n in swept else P())
                                    for n in par_j})
            scale_spec = mem if jnp.ndim(scale) else P()

            def local(carry, eta, keys, par_j, f_off, frows, year0, rho,
                      scale, cr_thr, cr_sgn):
                carry, eta, areas, means, conv, crosses = base_run(
                    carry, eta, keys, par_j, f_off, frows, year0, k, rho,
                    scale, cr_thr, cr_sgn)
                return (carry, eta, areas, means,
                        jax.lax.pmin(conv, ax), crosses)

            fn = shard_map(
                local, mesh=mesh,
                in_specs=(carry_specs, mem, mem, par_specs, mem, P(),
                          P(), P(), scale_spec, mem, mem),
                out_specs=(carry_specs, mem, P(None, ax),
                           tuple(P(None, ax) for _ in track), P(),
                           P(None, ax)),
                # the year loop seeds its accumulators with unvarying
                # zeros; per-shard independence is what this wrapper
                # establishes (same as
                # parallel.sharding.shard_map_fused_year_fn)
                check_vma=False,
            )
            cache[sig] = fn
        return fn(carry, eta, keys, par_j, f_off, frows, year0, rho,
                  scale, cr_thr, cr_sgn)

    return run


def _first_passage(labels: np.ndarray, start_label: int):
    """First-passage years from a ``(years, K)`` label history.

    The first year labeled as the OTHER attractor, strictly before any
    non-finite (-1) year, 1-based; NaN where no passage happened. A
    member that went non-finite WITHOUT first escaping is a failed run
    (``finite=False``, excluded from the statistics); non-finiteness
    after a recorded passage does not invalidate the passage.
    """
    years = labels.shape[0]
    other = labels == (1 - start_label)
    bad_y = labels == -1
    # vectorized first-True via argmax; any() guards the all-False
    # argmax-returns-0 trap
    bad_any = bad_y.any(axis=0)
    first_bad = np.where(bad_any, bad_y.argmax(axis=0), years)
    passed = other & (np.arange(years)[:, None] < first_bad[None, :])
    esc_any = passed.any(axis=0)
    fp = np.where(esc_any, passed.argmax(axis=0) + 1.0, np.nan)  # 1-based
    finite = ~(bad_any & ~esc_any)
    return fp, finite


def _ref_area(obj, model, st, par, forcing, season, dtype):
    """Reference ice area of an attractor: from an EquilibriumResult's
    seasonal store directly, else one deterministic year from a state
    Collection (solo ``par`` only — per-member sweeps must pass results,
    whose stores already carry the member axis)."""
    from .fold import seasonal_ice_area

    seasonal = getattr(obj, "seasonal", None)
    if seasonal is None:
        swept = [k for k, v in Collection(par).items() if np.ndim(v) >= 1]
        if swept:
            raise ValueError(
                f"attractor references must be EquilibriumResults when par "
                f"leaves {swept} are per-member (a bare state cannot be "
                f"re-run under a swept par)")
        from .basins import _year_seasonal

        seasonal = _year_seasonal(model, st, forcing, par, Collection(obj),
                                  dtype)
    return np.atleast_1d(np.asarray(
        seasonal_ice_area(getattr(seasonal, season), st), dtype=np.float64))


def _solo_state(obj, name: str) -> Collection:
    """Extract a SOLO state Collection from an equilibrate result or a
    bare state (ramp companion references must be single trajectories)."""
    state = Collection(getattr(obj, "state", obj))
    batched = [k for k, v in state.items() if np.ndim(v) > 1]
    if batched:
        raise ValueError(
            f"ramped transitions need SOLO attractor references; reference "
            f"{name!r} has member-batched state leaves {batched} (pass a "
            f"single-member equilibrate result or one member's state)")
    return state


def _thr_sgn_rows(a_y, b_y, sdir: float, K_run: int, dtype):
    """Host twin of the fused loop's in-scan crossing-row update (ramped
    ``subyear``): threshold = the companions' mean-area midpoint in RAW
    trapezoid units, sign = the direction toward the other attractor.
    Computed with the SAME dtype arithmetic as the traced update so a
    chunk-boundary re-derivation is bitwise what the in-scan carry would
    have held — chunking stays invariant."""
    npdt = np.dtype(jnp.dtype(dtype).name)
    a = np.asarray(a_y, npdt)
    b = np.asarray(b_y, npdt)
    four_pi = np.asarray(2.0 * 2.0 * np.pi, npdt)
    thr = (a + b) / four_pi
    sgn = np.asarray(sdir, npdt) * np.sign(b - a)
    return (jnp.full((K_run,), thr, dtype), jnp.full((K_run,), sgn, dtype))


def _ramp_ref_area0(spec, st: SpaceTime, cfg, par: Collection,
                    state: Collection, season: str, dtype,
                    frow_np: np.ndarray) -> float:
    """Seed reference area for a ramped ``subyear`` run: ONE deterministic
    year from a companion's starting state under the run's first forcing
    row (``frows_all[0]`` — ramp_shift included), through the XLA year
    graph. At engine-parity level this is the in-run companion's year-0
    area, so the first year's threshold is the SAME-year midpoint; later
    years evolve lag-1 in-scan. A resumed segment seeds from
    ``ref_area0=`` instead (the prior segment's last companion areas) for
    a threshold-seamless continuation."""
    from .fold import seasonal_ice_area
    from .integrate import _jitted_year_fn

    carry = spec.init_carry(state, st, dtype)
    par_j = Collection({k: jnp.asarray(v, dtype)
                        for k, v in Collection(par).items()})
    frow = jnp.asarray(frow_np, dtype)
    year = _jitted_year_fn(spec.name, st, cfg, jnp.dtype(dtype).name,
                           False, None)
    _, seasonal, _, _ = year(carry, par_j, frow)
    seasonal = jax.device_get(seasonal)
    return float(np.asarray(
        seasonal_ice_area(getattr(seasonal, season), st)))


def _forcing_rows(forcing: Forcing, st: SpaceTime, year0: int,
                  years: int) -> np.ndarray:
    """(years, nt) float64 base-forcing table for absolute years
    ``year0 .. year0+years-1`` — built from the same ``(i + 0.5) * dt``
    time series as ``Forcing.table`` (infrastructure.jl:130), so row ``y``
    is bitwise-identical to ``forcing.table(st)[year0 + y]`` wherever the
    latter exists; a run outlasting the ramp holds the final level (the
    branch-free where-chain clamps)."""
    nt = st.nt
    if forcing.constant:
        return np.full((years, nt), float(forcing.base), dtype=np.float64)
    T = (np.arange(year0 * nt, (year0 + years) * nt, dtype=np.float64)
         + 0.5) * st.dt
    return np.asarray(forcing(T), dtype=np.float64).reshape(years, nt)


def transitions(
    model: str,
    st: SpaceTime,
    forcing: Union[Forcing, float],
    par: Collection,
    a,
    b,
    sigma,
    tau: float = 0.02,
    years: int = 100,
    K: Optional[int] = None,
    start: str = "a",
    init: Optional[Collection] = None,
    eta0: Optional[np.ndarray] = None,
    year0: int = 0,
    track: Sequence[str] = (),
    season: str = "avg",
    seed: int = 0,
    dtype=None,
    newton_max_iter: int = 30,
    engine: str = "auto",
    ou_impl: str = "serial",
    subyear: bool = False,
    years_per_dispatch: Optional[int] = None,
    ref_init: Optional[tuple] = None,
    ref_area0: Optional[tuple] = None,
    mesh=None,
    progress: bool = False,
) -> TransitionResult:
    """Noise-induced transition statistics between two attractors.

    Runs ``K`` members from the ``start`` attractor (``"a"`` or ``"b"``;
    ``init=`` overrides the actual starting state) under OU weather noise
    of stationary std ``sigma`` (W/m^2, scalar or per-member ``(K,)``)
    and correlation time ``tau`` (years) added to the forcing,
    classifying each member-year's seasonal ice area against the two
    attractors' reference areas. ``a``/``b`` are
    :func:`~energybalancemodel_jl_tpu.equilibrium.equilibrate` results
    (or bare state Collections, re-run for one deterministic year to
    obtain their seasonal stores — solo ``par`` only).

    Constant ``forcing`` poses the autonomous escape problem. A 5-segment
    ramp :class:`~energybalancemodel_jl_tpu.forcing.Forcing` poses the
    RATE-INDUCED tipping problem instead: two sigma-zero companion
    trajectories start from ``a``'s and ``b``'s states under the same
    ramp and serve as per-year evolving classification references, so
    ``first_passage`` measures how much EARLIER than the deterministic
    run the noise tips each member (``examples/rate_induced_tipping.py``).
    Ramped runs need solo ``par`` (no ``(K,)`` leaves) and solo
    references; ``ref_init=(state_a, state_b)`` overrides the companions'
    starting states (resume material from ``TransitionResult.ref_state``).

    ``par`` leaves of shape ``(K,)`` (including the virtual ``"F"``
    forcing offset) sweep parameters across members in lockstep — one
    program measures an escape-rate curve (pass matching K-batched
    ``a``/``b`` results, e.g. from an ensemble ``equilibrate``, so every
    member is classified against its own attractor pair). ``track`` names
    seasonal variables whose hemispheric means are recorded per year
    (cheap: scalars, not fields).

    ``engine``: ``'scan'`` is the per-year XLA scan graph; ``'fused'``
    runs each noisy year as one whole-year program (:mod:`.ops.year`);
    ``'auto'`` picks between them with the policy the drivers share
    (:func:`.engine.auto_whole_year`: ``'fused'`` for MIZ and Classic;
    ``subyear`` needs it). The whole-year engine draws its weather from the per-member
    keys inside the year program. Both engines draw the same weather
    from the same seed; their trajectories agree at
    engine-parity level (f32 step-level chaos — the areas and escape
    statistics match, pointwise state may wander, ``TestFusedEngine``).

    ``subyear=True`` (whole-year engine): every step's instantaneous ice
    area is ALSO reduced and the first step past the per-member midpoint
    of the two reference areas recorded — sub-annual transition timing
    at one ``(K,)`` row per year. Under
    RAMPED forcing the threshold EVOLVES with the sigma-zero
    companions: year ``y`` uses the entering (lag-1, causal) midpoint
    of the companions' year-``y-1`` mean areas, updated in-scan; year0
    seeds from a one-year deterministic pre-run of the companion
    states (same-year midpoint, engine-parity level), or from
    ``ref_area0=(area_a_last, area_b_last)`` on a resumed segment
    (pass the prior ``(result.area_a[-1], result.area_b[-1])`` for a
    threshold-seamless, bit-exact continuation; without it the seam
    year's threshold provenance differs and its crossing step may move
    by a few steps). Ramped ``subyear`` composes with everything but
    ``mesh=`` (the companion lanes live on one shard).
    The crossing DIRECTION derives from ``start``'s reference area (the
    area must move toward the OTHER attractor's) — an ``init=`` override
    already past the midpoint records step 0 every year and the
    refinement falls back to the year-mean passage
    (``TransitionResult.crossing_step``, step index or -1 per
    member-year; :meth:`TransitionResult.first_passage_subyear` refines
    the year-classified passages to fractional years, walking back to
    the year the instantaneous crossing actually happened). The
    instantaneous detector typically LEADS the year-mean classifier by
    years during a slow plunge — that lead is the diagnostic.

    ``ou_impl``: how the whole-year engine evaluates the OU recurrence —
    ``'serial'`` (in-loop, bitwise the same weather as the scan engine,
    the default) or ``'assoc'`` (log-depth scan over the year's draws:
    the same recurrence tree-regrouped, ~1 ulp per term off the serial
    path — engine-parity-level weather). The scan engine is always
    serial; requesting ``'assoc'`` there raises.

    ``years_per_dispatch`` bounds one device dispatch; the DEFAULT
    (``None``) is adaptive: chunks start at {start} years and resize
    toward ~{target:.0f} s of wall time (power-of-two sizes, so at most
    ~{log} program variants compile), the progress cadence. Chunking is
    bitwise-invariant because the noise is keyed on the absolute year.
    ``year0`` offsets the absolute year (draw keys AND ramp rows) — the
    bit-exact split/continue contract (module docstring). ``mesh`` (1-D
    ``jax.sharding.Mesh``) shards members across devices — BOTH engines:
    the scan engine via jit sharding propagation, the whole-year engine
    via ``shard_map`` (each device runs its local member shard, the
    Newton loop condition OR-reduced over the mesh). The draws are
    per-member keyed, so the sharded weather is exactly the unsharded
    weather, and the trajectories follow the same arithmetic (bitwise on
    the GPU, at round-off on XLA:CPU).

    Escape statistics (:class:`TransitionResult`): ``escape_fraction``,
    ``mean_first_passage`` (escaped members only, censoring-biased), and
    the censoring-aware ``escape_rate`` (escapes per member-year).
    Members that go non-finite are excluded from the statistics and
    flagged in ``finite``. If the two reference areas ever come within
    ~4x the observed year-to-year area fluctuation the result is flagged
    ``degenerate`` (nearest-area labels are then noise) and a warning is
    issued.
    """
    spec = get_model(model)
    if not isinstance(forcing, Forcing):
        forcing = Forcing(float(forcing))
    ramped = not forcing.constant
    if start not in ("a", "b"):
        raise ValueError(f"start must be 'a' or 'b', got {start!r}")
    sigma_arr = np.asarray(sigma, dtype=np.float64)
    if sigma_arr.ndim > 1:
        raise ValueError("sigma must be a scalar or a (K,) vector")
    if np.any(sigma_arr < 0.0):
        raise ValueError("sigma must be >= 0")
    tau = float(tau)
    if tau < 0.0:
        raise ValueError("tau must be >= 0")
    years = int(years)
    if years < 1:
        raise ValueError("years must be >= 1")
    year0 = int(year0)
    if year0 < 0:
        raise ValueError("year0 must be >= 0")
    if dtype is None:
        dtype = default_dtype()
    dtype = jnp.dtype(dtype)

    if season not in ("winter", "summer", "avg"):
        raise ValueError(f"season must be winter/summer/avg, got {season!r}")

    par = Collection(par)
    par.pop("__K__", None)
    sizes = {np.shape(v)[0] for v in par.values() if np.ndim(v) > 0}
    if sigma_arr.ndim == 1:
        sizes |= {sigma_arr.shape[0]}
    if init is not None:
        sizes |= {np.shape(v)[0] for v in Collection(init).values()
                  if np.ndim(v) > 1}
    # member count: explicit K, else inferred from swept par/init leaves
    if sizes and K is not None and int(K) not in sizes:
        raise ValueError(
            f"K={K} conflicts with per-member par/init/sigma leaves of "
            f"size {sorted(sizes)}")
    if len(sizes) > 1:
        raise ValueError(f"inconsistent ensemble sizes {sorted(sizes)}")
    K = int(K) if K is not None else (sizes.pop() if sizes else 1)

    if ramped:
        swept = sorted(k for k, v in par.items() if np.ndim(v) > 0)
        if swept:
            raise ValueError(
                f"ramped transitions cannot sweep par leaves {swept} "
                f"across members (the sigma-zero companion references "
                f"would need one deterministic run per member); sweep "
                f"with separate calls, or per-member sigma")
        if ref_init is not None:
            if len(ref_init) != 2:
                raise ValueError("ref_init must be (state_a, state_b)")
            state_a = _solo_state(ref_init[0], "ref_init[0]")
            state_b = _solo_state(ref_init[1], "ref_init[1]")
        else:
            state_a = _solo_state(a, "a")
            state_b = _solo_state(b, "b")
        area_a = area_b = None
    else:
        if ref_init is not None:
            raise ValueError("ref_init= is for ramped forcing only (the "
                             "sigma-zero companion trajectories)")
        area_a = _ref_area(a, model, st, par, forcing, season, dtype)
        area_b = _ref_area(b, model, st, par, forcing, season, dtype)
        for name, arr in (("a", area_a), ("b", area_b)):
            if arr.size not in (1, K):
                raise ValueError(
                    f"attractor {name}'s reference area is {arr.size}-member "
                    f"but the run has K={K}")

    if init is None:
        src = a if start == "a" else b
        init = getattr(src, "state", src)
    init = Collection(init)
    bad = [k for k, v in init.items() if np.ndim(v) > 1
           and np.shape(v)[0] != K]
    if bad:
        raise ValueError(
            f"init leaves {bad} are member-batched with a size other "
            f"than K={K}")

    track = tuple(track)
    bad_track = [v for v in track if v not in spec.solution_vars]
    if bad_track:
        raise ValueError(
            f"track names {bad_track} not in the {spec.name} seasonal "
            f"store {tuple(spec.solution_vars)}")
    cfg = default_step_config(dtype.name, newton_max_iter=newton_max_iter)

    F_off = par.pop("F", None)
    ramp_shift = 0.0
    if F_off is not None and np.ndim(F_off) == 0:
        # scalar offset: fold into the base forcing exactly as integrate's
        # virtual-F path does (float64 host arithmetic); under a ramp the
        # fold lands on the tabulated rows instead
        if forcing.constant:
            forcing = Forcing(float(forcing.base) + float(np.asarray(F_off)))
        else:
            ramp_shift = float(np.asarray(F_off))
        F_off = None

    # ramped runs append two sigma-zero companion members (the evolving
    # classification references) to the lockstep batch
    K_run = K + 2 if ramped else K

    carry = spec.init_carry(init, st, dtype)
    carry = Collection({
        k: (v if jnp.ndim(v) > 1 else jnp.broadcast_to(v, (K,) + v.shape))
        for k, v in carry.items()
    })
    if ramped:
        carry_a = spec.init_carry(state_a, st, dtype)
        carry_b = spec.init_carry(state_b, st, dtype)
        carry = Collection({
            k: jnp.concatenate(
                [carry[k], carry_a[k][None], carry_b[k][None]], axis=0)
            for k in carry
        })

    if engine == "auto":
        engine = "fused" if auto_whole_year(spec.name) else "scan"
    elif engine == "fused":
        check_whole_year(spec.name, "engine='scan'")
    elif engine != "scan":
        raise ValueError(f"engine must be auto|scan|fused, got {engine!r}")
    if ou_impl not in ("serial", "assoc"):
        raise ValueError(f"ou_impl must be serial|assoc, got {ou_impl!r}")
    if engine != "fused" and ou_impl == "assoc":
        raise ValueError(
            "ou_impl='assoc' is a whole-year-engine mode (the scan engine "
            "IS the serial reference weather); use engine='fused'")
    if subyear:
        if ramped and mesh is not None:
            raise ValueError(
                "subyear=True under ramped forcing evolves the crossing "
                "threshold in-scan from the sigma-zero companion lanes' "
                "areas, which live on a single shard — run unsharded, or "
                "drop subyear= and refine with a second unsharded pass")
        if engine != "fused":
            raise ValueError(
                "subyear=True runs inside the whole-year engine; use "
                "engine='fused'")

    if engine == "fused":
        # whole-year form: scalar or (K_run,) leaves, no broadcast axis
        par_run = Collection({
            k: jnp.asarray(v, dtype) for k, v in par.items()})
    else:
        par_run = Collection({
            k: (jnp.asarray(v, dtype)[:, None] if np.ndim(v) == 1
                else jnp.asarray(v, dtype))
            for k, v in par.items()
        })
    if F_off is not None and np.ndim(F_off) == 1:
        f_off = jnp.asarray(np.asarray(F_off, dtype=np.float64), dtype)
    else:
        f_off = jnp.zeros((K,), dtype)
    if ramped:
        f_off = jnp.concatenate([f_off, jnp.zeros((2,), dtype)])

    frows_all = _forcing_rows(forcing, st, year0, years)
    if ramp_shift:
        frows_all = frows_all + ramp_shift

    base_key = jax.random.PRNGKey(int(seed))
    keys = jax.vmap(lambda i: jax.random.fold_in(base_key, i))(
        jnp.arange(K_run, dtype=jnp.uint32))

    if eta0 is None:
        eta = jnp.zeros((K_run,), dtype)
    else:
        eta0 = np.asarray(eta0, dtype=np.float64)
        if eta0.shape not in ((), (K,)):
            raise ValueError(f"eta0 must be scalar or ({K},), got "
                             f"{eta0.shape}")
        eta0 = np.broadcast_to(eta0, (K,))
        if ramped:
            eta0 = np.concatenate([eta0, np.zeros(2)])
        eta = jnp.asarray(eta0, dtype)

    dt = 1.0 / st.nt
    if tau > 0.0:
        rho = float(np.exp(-dt / tau))
        s_fac = float(np.sqrt(max(0.0, 1.0 - rho * rho)))
    else:
        rho, s_fac = 0.0, 1.0
    scale_np = np.broadcast_to(sigma_arr * s_fac, (K,)).astype(np.float64)
    if ramped:
        scale_np = np.concatenate([scale_np, np.zeros(2)])
    if sigma_arr.ndim == 0:
        # solo sigma stays a scalar operand (the round-3 trace) unless the
        # ramp companions need the per-member zero lanes
        scale = jnp.asarray(float(scale_np[0]), dtype) if not ramped \
            else jnp.asarray(scale_np, dtype)
    else:
        scale = jnp.asarray(scale_np, dtype)

    # first-crossing rows: the per-member midpoint of the two reference
    # areas (the year loop compares RAW trapezoid integrals, so
    # divide the 2*pi-scaled areas back) and the crossing direction
    # (+1 = start below the midpoint, area must rise past it). Ramped
    # runs seed year0's rows here (same-year companion areas from a
    # one-year deterministic pre-run, or ref_area0= on resume) and then
    # evolve them lag-1 — in-scan within a chunk, re-derived at chunk
    # boundaries by the bitwise host twin _thr_sgn_rows.
    sdir = 1.0 if start == "a" else -1.0
    if ref_area0 is not None and not (subyear and ramped):
        raise ValueError(
            "ref_area0= seeds the evolving crossing threshold of a "
            "RAMPED subyear=True run (pass the prior segment's "
            "(result.area_a[-1], result.area_b[-1]))")
    if subyear and ramped:
        if ref_area0 is not None:
            if len(ref_area0) != 2:
                raise ValueError("ref_area0 must be (area_a, area_b)")
            a0, b0 = (float(np.asarray(v, np.float64)) for v in ref_area0)
        else:
            a0 = _ramp_ref_area0(spec, st, cfg, par, state_a, season,
                                 dtype, frows_all[0])
            b0 = _ramp_ref_area0(spec, st, cfg, par, state_b, season,
                                 dtype, frows_all[0])
        cr_thr, cr_sgn = _thr_sgn_rows(a0, b0, sdir, K_run, dtype)
    elif subyear:
        a_arr = np.broadcast_to(np.asarray(area_a, np.float64), (K,))
        b_arr = np.broadcast_to(np.asarray(area_b, np.float64), (K,))
        thr_np = (a_arr + b_arr) / (2.0 * 2.0 * np.pi)
        other = b_arr if start == "a" else a_arr
        own = a_arr if start == "a" else b_arr
        sgn_np = np.sign(other - own)
        cr_thr = jnp.asarray(thr_np, dtype)
        cr_sgn = jnp.asarray(sgn_np, dtype)
    else:
        cr_thr = jnp.zeros((K_run,), dtype)
        cr_sgn = jnp.zeros((K_run,), dtype)

    if engine == "fused":
        # under a mesh every shard runs the unsharded Newton trip count
        run_cfg = (cfg if mesh is None else
                   dataclasses.replace(cfg, batch_axis=mesh.axis_names[0]))
        base_run = _transition_fused_loop_fn(
            spec.name, st, run_cfg, dtype.name, season, track, ou_impl,
            subyear, (sdir if (subyear and ramped) else 0.0))
        if mesh is not None:
            base_run = _shard_fused_run(base_run, mesh, track)
        run = base_run
    else:
        scan_run = _transition_loop_fn(spec.name, st, cfg, dtype.name,
                                       season, track)

        def run(carry, eta, keys, par_j, f_off, frows, year0, k, rho,
                scale, _thr, _sgn):
            c, e, a, m, cv = scan_run(carry, eta, keys, par_j, f_off,
                                      frows, year0, k, rho, scale)
            return c, e, a, m, cv, None

    if mesh is not None:
        if K_run % mesh.size != 0:
            raise ValueError(
                f"ensemble size {K_run} is not divisible by the mesh size "
                f"{mesh.size}")
        from jax.sharding import NamedSharding
        from jax.sharding import PartitionSpec as _P

        ax = mesh.axis_names[0]

        def _put(x, axis_idx):
            spec_ = [None] * np.ndim(x)
            spec_[axis_idx] = ax
            return jax.device_put(x, NamedSharding(mesh, _P(*spec_)))

        # STRUCTURAL member-axis placement (rank identifies the axis —
        # an extent==K test would collide when K matches nt/nx, CLAUDE.md)
        carry = jax.tree_util.tree_map(
            lambda v: _put(v, 0) if np.ndim(v) >= 2 else v, carry)
        par_run = jax.tree_util.tree_map(
            lambda v: _put(v, 0) if np.ndim(v) >= 2 else v, par_run)
        f_off = _put(f_off, 0)
        eta = _put(eta, 0)
        keys = _put(keys, 0)
        if np.ndim(scale) == 1:
            scale = _put(scale, 0)

    prog = None
    if progress:
        from .utils.progress import Progress

        sig_txt = (f"{float(np.min(sigma_arr)):g}..{float(np.max(sigma_arr)):g}"
                   if sigma_arr.ndim else f"{float(sigma_arr):g}")
        prog = Progress(years, title=f"Transitions (sigma={sig_txt})",
                        infofeed=lambda msg: msg)

    adaptive = years_per_dispatch is None
    chunk = _CHUNK_START if adaptive else max(1, int(years_per_dispatch))
    areas_h, means_h, cross_h, done = [], [], [], 0
    ok = 1.0
    while done < years:
        k = min(chunk, years - done)
        frows_j = jnp.asarray(frows_all[done:done + k], dtype)
        t0 = time.perf_counter()
        carry, eta, areas, means, conv, crosses = run(
            carry, eta, keys, par_run, f_off, frows_j,
            jnp.asarray(year0 + done, jnp.int32), k, rho, scale,
            cr_thr, cr_sgn)
        areas_h.append(areas)
        means_h.append(means)
        if subyear:
            cross_h.append(crosses)
            if ramped:
                # re-seed the next chunk's entering threshold from this
                # chunk's last companion areas — bitwise what the
                # in-scan carry held (same dtype ops, _thr_sgn_rows)
                last = np.asarray(jax.device_get(areas[-1, -2:]))
                cr_thr, cr_sgn = _thr_sgn_rows(last[0], last[1], sdir,
                                               K_run, dtype)
        ok = min(ok, float(conv))  # device fetch — syncs, so wall = real
        wall = time.perf_counter() - t0
        done += k
        if adaptive:
            # first chunk's wall includes compile; it only makes the next
            # chunk conservative, and the one after measures pure run rate
            chunk = _quantize_chunk(_CHUNK_TARGET_S * k / max(wall, 1e-6))
        if prog is not None:
            prog.update(done, feedargs=(f"{done}/{years} years",))

    carry, eta, areas = jax.device_get(
        (carry, eta, jnp.concatenate(areas_h, axis=0)))
    areas = np.asarray(areas, dtype=np.float64)  # (years, K_run)
    tracked = Collection({
        v: np.concatenate(
            [np.asarray(m[i], dtype=np.float64) for m in means_h], axis=0)
        for i, v in enumerate(track)
    })

    ref_state = None
    if ramped:
        area_a = areas[:, K]      # (years,) evolving on-'a' reference
        area_b = areas[:, K + 1]  # (years,) evolving on-'b' reference
        ref_state = (
            Collection({k: np.asarray(v[K]) for k, v in carry.items()}),
            Collection({k: np.asarray(v[K + 1]) for k, v in carry.items()}),
        )
        areas = areas[:, :K]
        tracked = Collection({k: v[:, :K] for k, v in tracked.items()})

    finite_y = np.isfinite(areas)
    if ramped:
        d_a = np.abs(areas - area_a[:, None])
        d_b = np.abs(areas - area_b[:, None])
    else:
        d_a = np.abs(areas - area_a[None, :]) if area_a.size == K \
            else np.abs(areas - area_a.reshape(1, 1))
        d_b = np.abs(areas - area_b[None, :]) if area_b.size == K \
            else np.abs(areas - area_b.reshape(1, 1))
    # nearest-area labels, ties broken toward the START attractor so an
    # exactly equidistant year (plausible with cell-quantized classic
    # areas) never counts as a first passage (advisor r3)
    if start == "a":
        other = d_b < d_a
        labels = np.where(finite_y, other.astype(np.int8), np.int8(-1))
    else:
        other = d_a < d_b
        labels = np.where(finite_y, np.where(other, 0, 1).astype(np.int8),
                          np.int8(-1))
    labels = labels.astype(np.int8)

    fp, finite = _first_passage(labels, 0 if start == "a" else 1)

    # classification degeneracy guard: when the two reference areas sit
    # within a few times the observed year-to-year area fluctuation,
    # nearest-area labels are coin flips (advisor-flagged MIZ
    # no-hysteresis regime; ramps after the deterministic tip)
    degenerate = False
    if years >= 3:
        gap = np.abs(np.asarray(area_a, dtype=np.float64)
                     - np.asarray(area_b, dtype=np.float64))
        with np.errstate(invalid="ignore"):
            fluct = np.abs(np.diff(areas, axis=0))
            fluct = float(np.nanmedian(fluct)) if np.isfinite(fluct).any() \
                else 0.0
        # <=, not <: identical references (gap 0) are degenerate even
        # when the quantized areas never fluctuate (fluct 0)
        if float(np.nanmin(gap)) <= 4.0 * fluct:
            degenerate = True
            warnings.warn(
                f"transitions: attractor reference areas come within "
                f"{float(np.nanmin(gap)):.3g} of each other while member "
                f"areas fluctuate ~{fluct:.3g} per year — nearest-area "
                f"labels are degenerate there and the escape statistics "
                f"should not be trusted (result.degenerate=True)")

    state = Collection({k: np.asarray(v) for k, v in carry.items()})
    eta_np = np.asarray(eta, dtype=np.float64)
    if ramped:
        state = Collection({k: v[:K] for k, v in state.items()})
        eta_np = eta_np[:K]

    crossing_step = None
    if subyear:
        crossing_step = np.asarray(
            jax.device_get(jnp.concatenate(cross_h, axis=0)),
            dtype=np.float64)
        if ramped:
            crossing_step = crossing_step[:, :K]

    return TransitionResult(
        areas=areas, labels=labels, first_passage=fp, finite=finite,
        state=state, eta=eta_np, tracked=tracked,
        area_a=np.asarray(area_a, dtype=np.float64),
        area_b=np.asarray(area_b, dtype=np.float64),
        start=start,
        sigma=(float(sigma_arr) if sigma_arr.ndim == 0
               else np.asarray(sigma_arr)),
        tau=tau, years=years, season=season, seed=int(seed),
        newton_ok=bool(ok >= 0.5), year0=year0, engine=engine,
        ramped=ramped, degenerate=degenerate, ref_state=ref_state,
        crossing_step=crossing_step, nt=int(st.nt),
    )


transitions.__doc__ = transitions.__doc__.format(
    start=_CHUNK_START, target=_CHUNK_TARGET_S,
    log=int(np.log2(_CHUNK_MAX)) + 1)
