"""Finite-time Lyapunov spectra along trajectories of the year map.

No reference analog — the reference (EnergyBalanceModel.jl) characterizes
predictability by forward integration and eyeballing trajectory spread.
Here the year map is differentiable (the MIZ Newton solve carries an
implicit-diff VJP), so the classical Benettin/QR recipe runs exactly:

    x_{n+1} = Y(x_n),   V <- J(x_n) V,   V = QR,  accumulate log|diag R|

with EXACT Jacobian-vector products — forward-mode cannot cross the Newton
solve's ``custom_vjp``, but the pullback is linear, so
``jax.linear_transpose`` recovers machine-precision ``J v`` (the same
mechanism :func:`~energybalancemodel_jl_tpu.equilibrium.stability` uses
for ``side="right"``). Each year costs one forward year plus ``n_modes``
reverse years, all inside one ``lax.scan`` per dispatch chunk.

Relation to :func:`stability`: at a converged equilibrium the trajectory
is stationary, every year applies the SAME Jacobian, and the exponents
converge to ``log |lambda_i|`` of the year-map spectrum — the two tools
cross-validate (``tests/test_lyapunov.py``). Along a transient or a
wobbling attractor (the classic model's albedo-hole wobble) the exponents
are FINITE-TIME averages over the visited states — the predictability
diagnostic proper. A positive leading exponent is the quantitative form
of the long-horizon gradient explosion documented for unrolled-trajectory
objectives (see ``calibrate``): cotangents grow like ``exp(lambda_1 * T)``.

MIZ caveat (same as stability): fully ice-covered cells carry frozen
integrator coordinates (``Ew``, ``phi``) that neither grow nor decay, so
healthy MIZ attractors report a leading exponent of exactly 0;
``project=("Ew", "phi")`` zeroes those families — per year, against the
CURRENT state's ice mask, which moves with the trajectory — so the
exponents reflect the observable dynamics.

Wide-f32-ensemble caveat (observed at K=1024/8192 on the canonical
grid): a few per-mille of members can sit on clamp
knife-edges where the f32 reverse year yields NaN growths — the NaN
stays ISOLATED to those members (per-member batched QR), their
exponents read NaN, and the rest of the ensemble is unaffected; screen
with ``np.isfinite(result.exponents)``. ``member_chunk=C`` slabs the
ensemble tangent propagation into sequential per-slab vjps (memory =
one slab's remat chain instead of the whole batch's — the lever for
ensembles whose whole-batch chain does not fit in device memory).
"""
from __future__ import annotations

import dataclasses
import functools
import time as _time
from typing import Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .forcing import Forcing
from .integrate import default_dtype, make_year_fn
from .models.base import default_step_config, get_model
from .spacetime import SpaceTime
from .utils.collection import Collection

__all__ = ["lyapunov", "LyapunovResult"]


@dataclasses.dataclass
class LyapunovResult:
    """Result of :func:`lyapunov`.

    ``exponents`` are the finite-time Lyapunov exponents in 1/year —
    mean of ``log |diag R|`` over the counted (post-``transient``) years;
    shape ``(n_modes,)`` for a solo run, ``(K, n_modes)`` for ensembles.
    ``history`` holds every year's instantaneous log growths, INCLUDING
    the transient, shape ``(years, n_modes)`` or ``(years, K, n_modes)``;
    ``running()`` turns it into the cumulative estimates whose flatness is
    the convergence diagnostic. ``sem`` is the standard error of the mean
    over counted years (a stationarity proxy, not a rigorous CI — the
    yearly growths are autocorrelated near bifurcations). ``modes`` is the
    final orthonormal tangent block (mode-leading Collection) — the
    leading column approximates the backward Lyapunov vector. ``state``
    is the trajectory's final carry (resume material).
    """

    exponents: np.ndarray
    history: np.ndarray
    state: Collection
    modes: Collection
    transient: int
    n_modes: int
    years: int

    def running(self) -> np.ndarray:
        """Cumulative post-transient mean after each counted year — the
        convergence plot; same trailing shape as ``exponents`` with a
        leading ``(years - transient,)`` axis."""
        h = self.history[self.transient:]
        n = np.arange(1, h.shape[0] + 1, dtype=np.float64)
        return np.cumsum(h, axis=0) / n.reshape((-1,) + (1,) * (h.ndim - 1))

    @property
    def sem(self) -> np.ndarray:
        """Standard error of the per-year growths over counted years."""
        h = self.history[self.transient:]
        n = max(h.shape[0], 1)
        return np.std(h, axis=0) / np.sqrt(n)

    def __repr__(self):
        lead = np.asarray(self.exponents)[..., 0]
        lam = np.array2string(np.atleast_1d(lead), precision=4)
        return (f"LyapunovResult(lambda_1 = {lam} /yr over "
                f"{self.years - self.transient} counted years "
                f"(+{self.transient} transient), n_modes={self.n_modes})")


@functools.lru_cache(maxsize=32)
def _lyapunov_loop_fn(model_name: str, st: SpaceTime, cfg, dtype_name: str,
                      m: int, keys_order, widths, project_keys,
                      remat: bool = False,
                      member_chunk: Optional[int] = None):
    """Jitted Benettin chunk: advance the trajectory ``k`` years while
    propagating and re-orthonormalizing an m-column tangent block.

    Like :func:`equilibrium._stability_loop_fn` the linearization data
    (carry, parameters, forcing row) are ARGUMENTS so one compilation
    serves every chunk; unlike it the base point MOVES — each scanned year
    linearizes at the current state (the vjp's primal output advances the
    trajectory for free) and the frozen-cell projection mask is recomputed
    from the CURRENT state, since the ice cover moves with the trajectory.

    ``remat=True`` (ensembles): reverse mode through a year stores
    per-step residuals that scale with K — more than device memory holds
    for wide ensembles — so the ensemble chunk
    runs TWO-PHASE: a pure forward scan stacks each year's linearization
    point, then the tangent block propagates over the stored points with
    a ``jax.checkpoint``-wrapped year (memory = the carry chain). Any
    restructure of the reverse graph makes the final state's FMA
    contraction scan-length-sensitive at ~1e-12 (measured — even with
    the forward in its own scan), so SOLO runs keep the exact round-4
    single-vjp graph and its bitwise chunking invariance; ensemble
    chunking invariance is round-off-level in the final state (the
    growth history is bitwise in both).
    """
    year = make_year_fn(model_name, st, cfg, dtype_name, False)
    year_r = make_year_fn(model_name, st, cfg, dtype_name, False,
                          remat=True)
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

    def from_mat(x):
        out, i = {}, 0
        for k, w in zip(keys_order, widths):
            out[k] = x[..., i:i + w]
            i += w
        return Collection(out)

    def to_mat(t):
        return jnp.concatenate([t[k] for k in keys_order], axis=-1)

    if m == 1:
        def fit(t):
            nrm = jnp.maximum(member_norm(t), tiny)
            scaled = jax.tree_util.tree_map(lambda x: x / nrm[..., None], t)
            return scaled, nrm[..., None]  # (1,) / (K, 1) growth column
    else:
        def fit(t):
            a = jnp.moveaxis(to_mat(t), 0, -1)  # (n, m) solo, (K, n, m)
            q, r = jnp.linalg.qr(a)
            lam = jnp.abs(jnp.diagonal(r, axis1=-2, axis2=-1))
            return from_mat(jnp.moveaxis(q, -1, 0)), lam

    def prep(v, frozen):
        return fit(proj(v, frozen))[0]

    if remat:
        @functools.partial(jax.jit, static_argnums=(4,))
        def run(carry, v, par_j, frow_j, k):
            # ensemble TWO-PHASE chunk (see docstring): pure forward scan
            # stacking linearization points, then the remat'd tangent
            # scan. Stacked points cost k x 6 x (K, nx) floats per
            # dispatch — the adaptive chunking keeps k modest.
            def adv(c, _):
                return year(c, par_j, frow_j)[0], c

            carry_end, points = lax.scan(adv, carry, None, length=int(k))

            def tang_block(v, pt, par_b, frow_b):
                _, pb = jax.vjp(lambda c: year_r(c, par_b, frow_b)[0],
                                pt)
                lt = jax.linear_transpose(lambda u: pb(u)[0], pt)
                base = lambda u: lt(u)[0]
                jv = (jax.vmap(base) if m > 1 else base)(v)
                frozen = (pt["phi"] >= 0.99) if project_keys else None
                return fit(proj(jv, frozen))

            if member_chunk is None:
                def tang(v, pt):
                    v, lam = tang_block(v, pt, par_j, frow_j)
                    return v, jnp.log(jnp.maximum(lam, tiny))
            else:
                # member-slabbed tangent year: the map is member-DIAGONAL
                # (members never couple), so per-slab vjps are exact
                # restrictions; lax.map sequentializes the slabs and the
                # remat'd residual chain shrinks to one slab's — the
                # lever that takes ensemble spectra past the ~K=1024
                # whole-batch envelope (9 GB at f32; K=8192 would need
                # 70 GB). Structural rank rules identify the member axis
                # (an extent==K test collides when K matches nt/nx).
                # Numerics contract: a single slab (C == K) is BITWISE
                # the unslabbed graph (measured); multiple slabs differ
                # by FMA-contraction ulps between the sliced and full
                # graphs, which positive finite-time growth amplifies
                # year over year — engine-parity-level per-year growths,
                # statistically identical exponents.
                C = int(member_chunk)

                def tang(v, pt):
                    K_tot = next(iter(pt.values())).shape[0]
                    v_ax = 0 if m == 1 else 1

                    def slab(si):
                        sl = si * C
                        pt_s = jax.tree_util.tree_map(
                            lambda x: lax.dynamic_slice_in_dim(
                                x, sl, C, 0), pt)
                        par_s = jax.tree_util.tree_map(
                            lambda x: (lax.dynamic_slice_in_dim(
                                x, sl, C, 0) if jnp.ndim(x) >= 2 else x),
                            par_j)
                        frow_s = (lax.dynamic_slice_in_dim(
                            frow_j, sl, C, 1) if jnp.ndim(frow_j) >= 3
                            else frow_j)
                        v_s = jax.tree_util.tree_map(
                            lambda x: lax.dynamic_slice_in_dim(
                                x, sl, C, v_ax), v)
                        return tang_block(v_s, pt_s, par_s, frow_s)

                    v_sl, lam_sl = lax.map(
                        slab, jnp.arange(K_tot // C, dtype=jnp.int32))
                    # (S, [m,] C, nx) leaves -> ([m,] K, nx)
                    if m == 1:
                        v = jax.tree_util.tree_map(
                            lambda x: x.reshape((K_tot,) + x.shape[2:]),
                            v_sl)
                    else:
                        v = jax.tree_util.tree_map(
                            lambda x: jnp.moveaxis(x, 0, 1).reshape(
                                (m, K_tot) + x.shape[3:]), v_sl)
                    lam = lam_sl.reshape((K_tot,) + lam_sl.shape[2:])
                    return v, jnp.log(jnp.maximum(lam, tiny))

            v, logs = lax.scan(tang, v, points)
            return carry_end, v, logs
    else:
        @functools.partial(jax.jit, static_argnums=(4,))
        def run(carry, v, par_j, frow_j, k):
            # solo: the exact round-4 graph — the vjp primal advances the
            # trajectory, bitwise chunk-invariant (docstring)
            def one_year(cv, _):
                carry, v = cv
                new_carry, pb = jax.vjp(
                    lambda c: year(c, par_j, frow_j)[0], carry)
                lt = jax.linear_transpose(lambda u: pb(u)[0], carry)
                base = lambda u: lt(u)[0]
                jv = (jax.vmap(base) if m > 1 else base)(v)
                frozen = (carry["phi"] >= 0.99) if project_keys else None
                v, lam = fit(proj(jv, frozen))
                loglam = jnp.log(jnp.maximum(lam, tiny))
                return (new_carry, v), loglam

            (carry, v), logs = lax.scan(one_year, (carry, v), None,
                                        length=int(k))
            return carry, v, logs

    return run, prep


def lyapunov(
    model: str,
    st: SpaceTime,
    forcing: Union[Forcing, float],
    par: Collection,
    init: Collection,
    years: int = 50,
    n_modes: int = 1,
    transient: int = 0,
    project: Sequence[str] = (),
    seed: int = 0,
    v0: Optional[Collection] = None,
    dtype=None,
    newton_max_iter: int = 30,
    years_per_dispatch: Optional[int] = None,
    member_chunk: Optional[int] = None,
    mesh=None,
) -> LyapunovResult:
    """Finite-time Lyapunov exponents of the year map along a trajectory.

    Starts at ``init`` (any init/carry Collection — an
    :func:`~energybalancemodel_jl_tpu.equilibrium.equilibrate` result's
    ``.state`` measures the attractor itself, a perturbed or transient
    state measures finite-time predictability) and runs ``years`` years,
    propagating ``n_modes`` orthonormal tangent directions through the
    exact year-map Jacobian with a QR re-orthonormalization each year
    (Benettin). ``exponents[i]`` is the mean of ``log r_ii`` over the
    years after ``transient`` — at a converged equilibrium it equals
    ``log |lambda_i|`` of :func:`stability`'s spectrum (cross-validated);
    along transients it is the finite-time growth rate in 1/year.

    ``par`` leaves of shape ``(K,)`` (including the virtual ``"F"``
    forcing offset) make the run a lockstep ensemble as everywhere else —
    one program measures every member's spectrum. ``project`` names MIZ
    carry leaves to zero in fully ice-covered cells (mask recomputed from
    the CURRENT state each year); without it healthy MIZ attractors
    truthfully report a leading exponent of 0 (the frozen-cell neutral
    families, see :func:`stability`). ``v0`` seeds the tangent block
    (mode-leading under ``n_modes>1``); default is a seeded random draw.
    ``years_per_dispatch`` bounds the years one device dispatch advances
    (each year costs 1 forward + ``n_modes`` reverse years); the DEFAULT
    (``None``) is adaptive — chunks start at 4 years and resize toward
    ~15 s of wall time (power-of-two sizes). ``mesh`` (a 1-D
    ``jax.sharding.Mesh``; ensemble only, ``K`` divisible by the mesh
    size) shards the members across devices exactly
    as in :func:`stability` — the propagation and per-member QR are
    block-diagonal over members, so XLA partitions them with zero
    hot-loop collectives. float64 strongly recommended for the same
    reasons as :func:`stability` (composed reverse years; f32
    frozen-lane noise).

    Runs the differentiable XLA year graph (the fused Pallas kernels have
    no AD path). Returns a :class:`LyapunovResult`.
    """
    spec = get_model(model)
    if not isinstance(forcing, Forcing):
        forcing = Forcing(float(forcing))
    if not forcing.constant:
        raise ValueError(
            "lyapunov needs constant forcing (an autonomous year map); "
            "sweep levels across members via par['F']"
        )
    years = int(years)
    if years < 1:
        raise ValueError("years must be >= 1")
    transient = int(transient)
    if not 0 <= transient < years:
        raise ValueError("transient must satisfy 0 <= transient < years")
    if dtype is None:
        dtype = default_dtype()
    dtype = jnp.dtype(dtype)

    par = Collection(par)
    par.pop("__K__", None)
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

    m = int(n_modes)
    if m < 1:
        raise ValueError("n_modes must be >= 1")
    keys_order = tuple(sorted(carry.keys()))
    widths = tuple(int(carry[k].shape[-1]) for k in keys_order)
    if m > sum(widths):
        raise ValueError(
            f"n_modes={m} exceeds the state dimension {sum(widths)}"
        )

    if member_chunk is not None:
        member_chunk = int(member_chunk)
        if not ensemble:
            raise ValueError(
                "member_chunk= slabs the ensemble tangent propagation; "
                "it needs (K,) par leaves or a member-batched init")
        K_eff = int(K) // (mesh.size if mesh is not None else 1)
        if K_eff % member_chunk != 0:
            raise ValueError(
                f"member_chunk={member_chunk} must divide the per-device "
                f"member count {K_eff}")
    run, prep = _lyapunov_loop_fn(spec.name, st, cfg, dtype.name, m,
                                  keys_order, widths, project,
                                  remat=ensemble,
                                  member_chunk=member_chunk)

    rng = np.random.default_rng(seed)
    if v0 is None:
        v0 = Collection({
            k: jnp.asarray(
                rng.standard_normal(np.shape(v) if m == 1
                                    else (m,) + np.shape(v)), dtype)
            for k, v in carry.items()
        })
    else:
        want = {k: (np.shape(v) if m == 1 else (m,) + np.shape(v))
                for k, v in carry.items()}
        miss = {k for k in want
                if k not in v0 or tuple(np.shape(v0[k])) != want[k]}
        if miss:
            raise ValueError(
                f"v0 leaves {sorted(miss)} missing or mis-shaped; expected "
                f"{ {k: want[k] for k in sorted(want)} }"
            )
        v0 = Collection({k: jnp.asarray(np.asarray(v0[k]), dtype)
                         for k in want})
    frozen0 = (carry["phi"] >= 0.99) if project else None
    v = prep(v0, frozen0)

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
            # STRUCTURAL member-axis placement (same layout families as
            # stability: carry (K, nx), swept par (K, 1), F-offset frow
            # (nt, K, 1), modes (m, K, nx)) — rank alone identifies the
            # member axis; an extent==K test would collide when K
            # matches nt/nx (CLAUDE.md)
            if np.ndim(x) >= min_rank:
                spec = [None] * np.ndim(x)
                spec[axis_idx] = ax
                return jax.device_put(x, NamedSharding(mesh, _P(*spec)))
            return x

        carry = jax.tree_util.tree_map(lambda x: _shard(x, 0, 2), carry)
        par_j = jax.tree_util.tree_map(lambda x: _shard(x, 0, 2), par_j)
        frow_j = _shard(frow_j, 1, 3)
        v = jax.tree_util.tree_map(
            lambda x: _shard(x, 0 if m == 1 else 1, 2 if m == 1 else 3),
            v,
        )

    # Dispatch chunking (same policy as transitions): the DEFAULT is
    # adaptive — chunks start small and resize toward ~15 s of wall time
    # (power-of-two sizes to bound recompiles), a steady cadence even
    # though each lyapunov year costs (1 + n_modes) simulated years
    # (1 forward + n_modes reverse). Chunking is
    # bitwise-invariant: the loop state (carry, tangent block) stays on
    # device and the per-year work is chunk-independent.
    from .stochastic import _CHUNK_START, _CHUNK_TARGET_S, _quantize_chunk

    adaptive = years_per_dispatch is None
    chunk = _CHUNK_START if adaptive else max(1, int(years_per_dispatch))
    hist, done = [], 0
    while done < years:
        k = min(chunk, years - done)
        t0 = _time.perf_counter()
        carry, v, logs = run(carry, v, par_j, frow_j, k)
        if adaptive:
            # sync so the measured wall time is the real dispatch time
            jax.block_until_ready(logs)
        hist.append(logs)
        done += k
        if adaptive:
            wall = _time.perf_counter() - t0
            chunk = _quantize_chunk(_CHUNK_TARGET_S * k / max(wall, 1e-6))
    carry, v, history = jax.device_get(
        (carry, v, jnp.concatenate(hist, axis=0)))
    history = np.asarray(history, dtype=np.float64)

    exponents = history[transient:].mean(axis=0)
    modes = Collection({k: np.asarray(x) for k, x in v.items()})
    state = Collection({k: np.asarray(x) for k, x in carry.items()})
    return LyapunovResult(
        exponents=np.asarray(exponents), history=history, state=state,
        modes=modes, transient=transient, n_modes=m, years=years,
    )
