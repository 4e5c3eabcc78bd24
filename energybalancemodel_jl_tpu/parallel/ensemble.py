"""On-chip parameter ensembles via ``vmap``.

The reference runs parameter sweeps (bifurcation/hysteresis studies over
D/F/A/B) as sequential ``integrate`` calls; on an accelerator the 180-point
grid is tiny (a few KB of state), so the device-utilization lever is
batching whole ensembles of independent runs into one ``vmap``-ed scan — SURVEY.md §2's
"batch/ensemble parallelism". A parameter Collection may mix scalars (shared)
and ``(K,)`` arrays (swept); the per-run statics (insolation tables, implicit
bands) are traced functions of the parameters, so sweeping any parameter
needs no recompilation.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from jax import lax

from ..forcing import Forcing
from ..integrate import _split_chunks, default_dtype, make_year_fn
from ..engine import auto_whole_year, check_whole_year
from ..models.base import default_step_config, get_model
from ..solutions import Seasonal
from ..spacetime import SpaceTime
from ..utils.collection import Collection

__all__ = ["EnsembleSolutions", "ensemble_integrate", "sweep", "batched_parameters"]


@dataclasses.dataclass
class EnsembleSolutions:
    """Results of an ensemble run: ``seasonal.*.VAR`` has shape
    ``(K, dur, nx)``; ``raw.VAR`` (when collected) is ``(K, nt, nx)`` for the
    final year (``raw_mode='last'``) or ``(K, dur*nt, nx)`` for the whole run
    (``raw_mode='all'``, small ensembles)."""

    spacetime: SpaceTime
    forcing: Forcing
    parameters: Collection  # batched: leaves scalar or (K,)
    n_members: int
    seasonal: Seasonal
    raw: Optional[Collection] = None

    def member(self, i: int) -> Collection:
        """Parameters of member ``i``."""
        return Collection(
            {k: (np.asarray(v)[i] if np.ndim(v) > 0 else v) for k, v in self.parameters.items()}
        )

    @property
    def swept(self) -> Collection:
        """The swept parameters only: name -> (K,) values."""
        return Collection(
            {k: np.asarray(v) for k, v in self.parameters.items() if np.ndim(v) > 0}
        )

    def member_solutions(self, i: int) -> "Solutions":
        """Member ``i``'s results as a single-run :class:`Solutions` view, so
        every single-run API (``plot_raw``/``plot_avg``/``plot_seasonal``,
        ``save``, ``annual_mean``) works per member. Raw storage is the final
        year when collected (``raw_mode='last'``), the full trajectory for
        ``raw_mode='all'`` (``lastonly`` reflects which), empty otherwise."""
        from ..solutions import Solutions

        i = int(i)
        if not -self.n_members <= i < self.n_members:
            raise IndexError(
                f"member {i} out of range for ensemble of {self.n_members}"
            )
        st = self.spacetime
        seasonal = Seasonal(
            *(
                Collection({k: np.asarray(v)[i] for k, v in coll.items()})
                for coll in self.seasonal
            )
        )
        lastonly = True
        if self.raw is not None:
            raw = Collection({k: np.asarray(v)[i] for k, v in self.raw.items()})
            n_steps = next(iter(raw.values())).shape[0]
            # raw_mode='all' members carry the full dur*nt trajectory: a
            # consumer (ebm.save, the reference's load!) derives stored-time
            # semantics from `lastonly`, so it must reflect the actual
            # storage, not the ensemble default (review r2)
            lastonly = n_steps != st.dur * st.nt
            ts = Solutions.stored_times(st, lastonly)
        else:
            raw = Collection(
                {k: np.zeros((0, st.nx)) for k in self.seasonal.avg.keys()}
            )
            ts = np.zeros((0,))
        return Solutions(
            spacetime=st,
            ts=ts,
            forcing=self.forcing,
            parameters=self.member(i),
            initconds=Collection({}),
            lastonly=lastonly,
            debug=None,
            raw=raw,
            seasonal=seasonal,
        )

    def __repr__(self):
        names = ",".join(sorted(self.swept.keys())) or "none"
        if self.raw is None:
            raw = "seasonal only"
        else:
            n_steps = next(iter(self.raw.values())).shape[1]
            full = n_steps == self.spacetime.dur * self.spacetime.nt
            raw = "full raw" if full else "last-year raw"
        return (
            f"EnsembleSolutions(K={self.n_members}, "
            f"{self.spacetime.nx}x{self.spacetime.nt}x{self.spacetime.dur}y, "
            f"swept: {names}, {raw})"
        )


def batched_parameters(base: Collection, sweeps: Dict[str, Sequence[float]]) -> Collection:
    """Product-grid batched parameters: each swept name gets every
    combination; shared parameters stay scalar. Returns a Collection whose
    swept leaves have shape ``(K,)`` with ``K = prod(len(v))``."""
    names = list(sweeps)
    grids = list(itertools.product(*[np.asarray(sweeps[n], dtype=np.float64) for n in names]))
    K = len(grids)
    out = Collection({k: v for k, v in base.items()})
    for j, n in enumerate(names):
        out[n] = np.asarray([g[j] for g in grids], dtype=np.float64)
    out["__K__"] = K  # popped by ensemble_integrate
    return out


def _ensemble_config_key(model, st, forcing, par, dtype, solver, engine, K,
                         newton_max_iter) -> str:
    """Config fingerprint for checkpoint validation (shared builder in
    :mod:`..checkpoint`; swept ``(K,)`` parameter leaves are digested)."""
    from .. import checkpoint as ckpt_mod

    return ckpt_mod.config_key(
        "ens", model, st, forcing, par, np.dtype(dtype).name, solver,
        newton_max_iter, (engine, f"K={int(K)}"),
    )


def _param_axes(par: Collection) -> Collection:
    return Collection({k: (0 if np.ndim(v) > 0 else None) for k, v in par.items()})


@dataclasses.dataclass(frozen=True)
class _AxesKey:
    items: tuple


@functools.lru_cache(maxsize=64)
def _batched_year_fn(model_name, st, cfg, dtype_name, collect_raw, axes_key,
                     donate, f_batched: bool = False):
    """vmapped + jitted year function, cached across ensemble calls.
    ``f_batched`` maps the forcing over members too (per-member F rows)."""
    fn = make_year_fn(model_name, st, cfg, dtype_name, collect_raw)
    axes = Collection(dict(axes_key.items))
    vm = jax.vmap(fn, in_axes=(0, axes, 0 if f_batched else None))
    return jax.jit(vm, donate_argnums=(0,) if donate else ())


# Parameters that shape the shared insolation/coalbedo tables; the
# batch-native engine requires these to be scalars (sweep them with the
# vmap engine).
TABLE_PARAMS = frozenset({"S0", "S1", "S2", "a0", "a2"})


@functools.lru_cache(maxsize=64)
def _native_year_fn(model_name, st, cfg, dtype_name, collect_raw, donate):
    """Batch-native jitted year function: the physics steps are
    shape-polymorphic over a leading ensemble axis (batched parameters enter
    with a trailing broadcast axis), so no ``vmap`` is needed."""
    fn = make_year_fn(model_name, st, cfg, dtype_name, collect_raw)
    return jax.jit(fn, donate_argnums=(0,) if donate else ())


@functools.lru_cache(maxsize=32)
def _fused_year_fns(model_name, st, cfg, dtype_name, mesh, par_key):
    """Jitted whole-year engine ``(carry, par, fyear) -> (carry, Seasonal,
    converged)`` and its multi-year chunk ``(carry, par, f_years) ->
    (carry, stacked Seasonal)``, cached across ensemble calls; with a
    ``mesh`` the year is shard-mapped over it. ``par_key`` is the hashable
    ``(name, is_swept)`` summary of the parameters (the shard_map specs
    depend only on which leaves are per-member)."""
    if mesh is None:
        from ..ops.year import classic_year, miz_year

        year_fn = miz_year if model_name == "MIZ" else classic_year

        @jax.jit
        def year(carry, par, fy):
            c, seas, conv, _ = year_fn(carry, par, fy, st, cfg)
            return c, seas, conv
    else:
        from .sharding import shard_map_fused_year_fn

        par_tmpl = Collection(
            {k: (np.zeros(2) if swept else 0.0) for k, swept in par_key})
        year = shard_map_fused_year_fn(st, mesh, par_tmpl, dtype_name, cfg,
                                       model=model_name)

    @jax.jit
    def chunk(carry, par, f_years):
        def body(c, fy):
            c, seas, _ = year(c, par, fy)
            return c, seas

        return lax.scan(body, carry, f_years)

    return year, chunk


def _check_raw_all_budget(K, st, n_vars: int, itemsize: int,
                          raw_memory_limit: int) -> None:
    """Up-front guard for ``raw_mode='all'``: full per-step trajectories for
    every member (reference sweep semantics,
    /root/reference/src/infrastructure.jl:352-356) are only sane for small
    ensembles — fail fast instead of OOMing deep into a run."""
    est = int(K) * st.dur * st.nt * st.nx * n_vars * itemsize
    if est > raw_memory_limit:
        raise ValueError(
            f"raw_mode='all' would materialize "
            f"K*dur*nt*nx*{n_vars} vars ≈ {est / 2**30:.2f} GiB of raw "
            f"trajectories (limit {raw_memory_limit / 2**30:.2f} GiB); "
            "use raw_mode='last'/'none', shrink the ensemble, or raise "
            "raw_memory_limit"
        )


def _augment_batched(par: Collection) -> Collection:
    """Give (K,)-batched parameter leaves a trailing axis so they broadcast
    against (K, nx) state inside the batch-native step."""
    return Collection(
        {k: (v[:, None] if jnp.ndim(v) == 1 else v) for k, v in par.items()}
    )


def ensemble_integrate(
    model: str,
    st: SpaceTime,
    forcing: Forcing,
    par: Collection,
    init: Collection,
    n_members: Optional[int] = None,
    raw_mode: str = "none",
    raw_memory_limit: int = 2 * 2**30,
    dtype=None,
    solver: str = "pcr",
    newton_max_iter: int = 30,
    donate: bool = True,
    jit_wrapper=None,
    engine: str = "auto",
    mesh=None,
    years_per_dispatch: Optional[int] = None,
    checkpoint: Optional[str] = None,
    checkpoint_every: int = 1,
    resume: bool = False,
    progress: Optional[bool] = None,
) -> EnsembleSolutions:
    """Integrate an ensemble of independent runs in one vmapped scan.

    ``par`` leaves of shape ``(K,)`` are swept across members; scalars are
    shared. ``init`` leaves of shape ``(K, nx)`` are per-member, ``(nx,)``
    shared. ``raw_mode='last'`` additionally collects the final year's raw
    states per member; ``raw_mode='all'`` collects every step of every member
    (reference sweep semantics,
    /root/reference/src/infrastructure.jl:352-356) — intended for small
    ensembles, guarded by ``raw_memory_limit`` (bytes, default 2 GiB) and
    served by the XLA engines. ``jit_wrapper`` lets the sharding layer
    substitute a ``jit`` with in/out shardings (see :mod:`.sharding`).

    ``progress`` shows a per-year progress bar (reference-style, as in
    :func:`~energybalancemodel_jl_tpu.integrate`); default on.

    ``engine='auto'`` (default) picks between the whole-year engine
    ``'fused'`` (:mod:`..ops.year`) and the per-year engines with the policy
    the drivers share (:func:`..engine.auto_whole_year`): ``'fused'`` for
    MIZ and Classic unless the run needs a per-year-engine feature (the
    Thomas solver, a sharding ``jit_wrapper``, ``raw_mode='all'``), then
    ``'batched'`` (or ``'vmap'`` for swept table parameters or a
    ``jit_wrapper``).

    ``checkpoint`` names an HDF5 file written every ``checkpoint_every``
    simulated years (the full ensemble carry + per-year seasonal storage);
    ``resume=True`` continues a matching interrupted run bit-exactly from
    the first unfinished year (same protocol as
    :func:`~energybalancemodel_jl_tpu.integrate`, see :mod:`..checkpoint`).

    ``mesh`` (with ``engine='fused'``/``'auto'``): a 1-D
    ``jax.sharding.Mesh`` — each device runs the whole-year engine on its
    ensemble shard, with the Newton loop condition OR-reduced over the
    mesh so the sharded run follows one device's arithmetic;
    requires ``raw_mode='none'`` and ``K`` divisible by the mesh size.

    ``years_per_dispatch > 1`` (``engine='fused'`` only) batches that many
    consecutive seasonal-only years into one dispatch — a ``lax.scan`` over
    the whole-year engine. Default (``None``): 8 for the fused engine, 1
    for the XLA per-year engines.
    """
    spec = get_model(model)
    if raw_mode not in ("none", "last", "all"):
        raise ValueError(
            f"ensemble raw_mode must be 'none'|'last'|'all', got {raw_mode!r}"
        )
    if dtype is None:
        dtype = default_dtype()
    dtype = jnp.dtype(dtype)
    par = Collection(par)
    K = par.pop("__K__", None) or n_members
    if K is None:
        sizes = {np.shape(v)[0] for v in par.values() if np.ndim(v) > 0}
        sizes |= {np.shape(v)[0] for v in init.values() if np.ndim(v) > 1}
        if len(sizes) != 1:
            raise ValueError("Cannot infer ensemble size; pass n_members")
        K = sizes.pop()
    if raw_mode == "all":
        _check_raw_all_budget(K, st, len(spec.solution_vars),
                              jnp.dtype(dtype).itemsize, raw_memory_limit)
    par_user = Collection(par)  # stored/checkpoint-keyed, incl. virtual "F"
    # virtual sweep parameter "F": a per-member constant added to the climate
    # forcing (the WE15 bifurcation axis, reference plot_seasonal studies) —
    # realized as per-member forcing-table rows, not a physics parameter
    F_off = par.pop("F", None)
    if F_off is not None and np.ndim(F_off) == 0:
        F_off = np.full((int(K),), float(F_off))

    cfg = default_step_config(
        dtype.name, solver=solver, newton_max_iter=newton_max_iter
    )
    par_j = Collection({k: jnp.asarray(v, dtype=dtype) for k, v in par.items()})
    axes = _param_axes(par_j)
    axes_key = _AxesKey(tuple(sorted(axes.items())))

    batched_names = {k for k, v in par_j.items() if jnp.ndim(v) > 0}
    batched_legal = not (batched_names & TABLE_PARAMS)
    if engine == "auto":
        whole = auto_whole_year(
            spec.name,
            per_year_only=(jit_wrapper is not None or solver != "pcr"
                           or raw_mode == "all"),
        )
        if whole:
            engine = "fused"
        else:
            engine = "batched" if (batched_legal and jit_wrapper is None) else "vmap"
    if engine not in ("vmap", "batched", "fused"):
        raise ValueError(
            f"unknown engine {engine!r}; expected 'vmap', 'batched', 'fused', "
            "or 'auto'"
        )
    if mesh is not None and engine != "fused":
        raise ValueError(
            "mesh= requires engine='fused'; use sharded_ensemble_integrate "
            "for the vmap engine"
        )
    if years_per_dispatch is None:
        years_per_dispatch = 8 if engine == "fused" else 1
    if years_per_dispatch > 1 and engine != "fused":
        raise ValueError(
            "years_per_dispatch > 1 requires engine='fused' (the XLA "
            "engines dispatch per year; chunking them would change the "
            "compiled graph and the checkpoint semantics)"
        )
    if engine == "batched" and not batched_legal:
        raise ValueError(
            f"engine='batched' cannot sweep table parameters "
            f"{sorted(batched_names & TABLE_PARAMS)}; use engine='vmap'"
        )
    if engine == "fused":
        # whole-year engine (ops/year.py): the entire nt-step year is one
        # jitted program over the (K, nx) ensemble
        if raw_mode == "all":
            raise ValueError(
                "engine='fused' supports raw_mode 'none'|'last' (it stores "
                "seasonal data only); raw_mode='all' runs on the per-year "
                "engines — use engine='auto'/'batched'/'vmap'"
            )
        check_whole_year(spec.name, "engine='vmap' or 'batched'")
        if jit_wrapper is not None:
            raise ValueError("engine='fused' does not compose with sharding "
                             "jit wrappers; use engine='vmap'")
        par_fused = Collection(par_j)
        if F_off is not None:
            par_fused["F"] = jnp.asarray(F_off, dtype=dtype)
        if mesh is not None:
            if raw_mode != "none":
                raise ValueError(
                    "engine='fused' with a mesh supports raw_mode='none' "
                    "only (seasonal storage); collect raw data unsharded"
                )
            if int(K) % mesh.size != 0:
                raise ValueError(
                    f"ensemble size {K} is not divisible by the mesh size "
                    f"{mesh.size}"
                )
        par_key = tuple(sorted((k, jnp.ndim(v) > 0)
                               for k, v in par_fused.items()))
        fused_year, fused_chunk = _fused_year_fns(
            spec.name, st, cfg, dtype.name, mesh, par_key)

        def run_seasonal_fused(carry, p, fy):
            c, seas, conv = fused_year(carry, par_fused, fy)
            return c, seas, conv, None

    if engine == "fused":
        # seasonal years run in the whole-year engine; a raw-collect year
        # falls back to a per-year engine with the identical carry pytree —
        # batch-native normally, vmap when table parameters are swept (only
        # the vmap engine builds per-member insolation tables)
        if batched_legal:
            par_aug = _augment_batched(par_j)
            native_full = _native_year_fn(
                spec.name, st, cfg, dtype.name, True, donate
            )
            raw_fallback = lambda c, p, fy: native_full(c, par_aug, fy)
        else:
            raw_fallback = _batched_year_fn(
                spec.name, st, cfg, dtype.name, True, axes_key, donate,
                f_batched=F_off is not None,
            )

        def batch(collect_raw):
            if collect_raw:
                return raw_fallback
            return run_seasonal_fused
    elif engine == "batched" and jit_wrapper is None:
        par_j = _augment_batched(par_j)

        def batch(collect_raw):
            return _native_year_fn(
                spec.name, st, cfg, dtype.name, collect_raw, donate
            )
    elif jit_wrapper is not None:
        f_axis = None if F_off is None else 0

        def batch(collect_raw):
            fn = make_year_fn(spec.name, st, cfg, dtype.name, collect_raw)
            return jit_wrapper(jax.vmap(fn, in_axes=(0, axes, f_axis)))
    else:
        def batch(collect_raw):
            return _batched_year_fn(
                spec.name, st, cfg, dtype.name, collect_raw, axes_key, donate,
                f_batched=F_off is not None,
            )

    run_seasonal = batch(False)
    run_full = batch(True)

    fused_years = None
    if engine == "fused" and years_per_dispatch > 1:
        # one dispatch per chunk: a lax.scan of the whole-year engine over
        # years (jit re-specializes per chunk length: at most two arise,
        # the steady size and a remainder)
        def fused_years(carry, f_years):
            return fused_chunk(carry, par_fused, f_years)

    # broadcast initial conditions to (K, nx)
    carry = spec.init_carry(init, st, dtype)
    carry = Collection(
        {
            k: (v if v.ndim == 2 else jnp.broadcast_to(v, (K,) + v.shape))
            for k, v in carry.items()
        }
    )
    f_base = forcing.table(st)
    f_tab = f_base  # (dur, nt)
    if F_off is not None:
        F_off = np.asarray(F_off, dtype=np.float64).reshape(-1)
        if F_off.shape[0] != int(K):
            raise ValueError(
                f"par['F'] must have shape ({K},), got {F_off.shape}"
            )
        f_tab = f_base[None] + F_off[:, None, None]  # (K, dur, nt)

    def fyear_of(year, collect=False):
        if F_off is None:
            return f_tab[year]
        if engine == "fused" and not collect:
            # the whole-year engine applies the per-member offset itself
            # (par['F']); it consumes the shared rows
            return f_base[year]
        fy = f_tab[:, year]  # (K, nt) per-member rows
        if engine == "batched" or (engine == "fused" and collect and batched_legal):
            # batch-native scan consumes time-leading leaves
            return np.swapaxes(fy, 0, 1)[:, :, None]
        return fy

    winter_acc, summer_acc, avg_acc = [], [], []
    start_year = 0
    ckpt_key = ""
    if checkpoint is not None:
        from .. import checkpoint as ckpt_mod

        ckpt_key = _ensemble_config_key(
            spec.name, st, forcing, par_user, dtype, solver, engine, K,
            newton_max_iter,
        )
        carry, start_year, winter_acc, summer_acc, avg_acc = (
            ckpt_mod.resume_state(
                checkpoint, ckpt_key, resume, raw_mode, st.dur,
                lambda v: jnp.asarray(v, dtype=dtype), carry,
            )
        )
        _ckpt_write = ckpt_mod.year_writer(
            checkpoint, ckpt_key,
            lambda: (carry, (winter_acc, summer_acc, avg_acc)),
            split=_split_chunks,
        )

    from ..utils.progress import Progress

    prog = Progress(
        st.dur,
        "Integrating ensemble",
        infofeed=lambda yy: f"year {int(yy)}/{st.dur}, {int(K)} members",
    ) if (progress or progress is None) else None
    if prog is not None and start_year:
        prog.update(start_year, feedargs=(start_year,))

    raw_years = []
    y = start_year
    while y < st.dur:
        collect = raw_mode == "all" or (raw_mode == "last" and y == st.dur - 1)
        if fused_years is not None and not collect:
            last_seasonal = st.dur - (1 if raw_mode == "last" else 0)
            chunk = min(years_per_dispatch, last_seasonal - y)
            if checkpoint is not None:
                every = max(checkpoint_every, 1)
                chunk = min(chunk, (y // every + 1) * every - y)
            if chunk > 1:
                carry, seasons = fused_years(
                    carry, jnp.asarray(f_base[y:y + chunk], dtype=dtype)
                )
                # keep the stacked (chunk, K, nx) arrays whole until the
                # single bulk device_get (see integrate._split_chunks)
                winter_acc.append(("chunk", seasons.winter))
                summer_acc.append(("chunk", seasons.summer))
                avg_acc.append(("chunk", seasons.avg))
                y += chunk
                if prog is not None:
                    prog.update(y, feedargs=(y,))
                if checkpoint is not None and (
                    y % max(checkpoint_every, 1) == 0 or y == st.dur
                ):
                    _ckpt_write(y)
                continue
        fn = run_full if collect else run_seasonal
        carry, seasonal, _conv, ys = fn(carry, par_j, fyear_of(y, collect))
        winter_acc.append(seasonal.winter)
        summer_acc.append(seasonal.summer)
        avg_acc.append(seasonal.avg)
        if checkpoint is not None and (
            (y + 1) % max(checkpoint_every, 1) == 0 or y == st.dur - 1
        ):
            _ckpt_write(y + 1)
        if collect:
            raw_years.append(Collection(dict(ys)))
        y += 1
        if prog is not None:
            prog.update(y, feedargs=(y,))

    # one bulk device->host fetch (per-leaf np.asarray would pay a round-trip
    # per array)
    winter_acc, summer_acc, avg_acc, raw_years = jax.device_get(
        (winter_acc, summer_acc, avg_acc, raw_years)
    )
    raw = None
    if raw_years:
        time_first = engine == "batched" or (engine == "fused" and batched_legal)
        if time_first:
            # batch-native scan stacks time first: (nt, K, nx) -> (K, nt, nx)
            raw_years = [
                Collection({k: np.swapaxes(v, 0, 1) for k, v in c.items()})
                for c in raw_years
            ]
        if len(raw_years) == 1:
            raw = Collection({k: np.asarray(v) for k, v in raw_years[0].items()})
        else:  # raw_mode='all': concatenate years along the time axis
            raw = Collection(
                {
                    k: np.concatenate([np.asarray(c[k]) for c in raw_years], axis=1)
                    for k in raw_years[0].keys()
                }
            )
    winter_acc = _split_chunks(winter_acc)
    summer_acc = _split_chunks(summer_acc)
    avg_acc = _split_chunks(avg_acc)

    def stack(acc):
        # per-year (K, nx) -> (K, dur, nx)
        return Collection(
            {
                k: np.stack([np.asarray(c[k]) for c in acc], axis=1)
                for k in acc[0].keys()
            }
        )

    return EnsembleSolutions(
        spacetime=st,
        forcing=forcing,
        parameters=par_user,
        n_members=int(K),
        seasonal=Seasonal(stack(winter_acc), stack(summer_acc), stack(avg_acc)),
        raw=raw,
    )


def sweep(
    model: str,
    st: SpaceTime,
    forcing: Forcing,
    base_par: Collection,
    sweeps: Dict[str, Sequence[float]],
    init: Collection,
    **kwargs,
) -> EnsembleSolutions:
    """Product-grid parameter sweep (bifurcation/hysteresis driver).

    Example: ``sweep('MIZ', st, ramp, par, {'D': np.linspace(0.4, 0.8, 32)},
    init)`` runs 32 diffusivities as one device ensemble."""
    return ensemble_integrate(
        model, st, forcing, batched_parameters(base_par, sweeps), init, **kwargs
    )
