"""The integrate driver — THE entry point.

Rebuild of ``integrate`` (/root/reference/src/infrastructure.jl:615-636).
The reference's Python-visible hot loop over ``dur*nt`` steps becomes a
jit-compiled ``lax.scan`` over one year of physics, driven by a host loop
over years (progress reporting, storage routing). Per-step work is entirely
on-device; the host sees one dispatch and a few KB of seasonal diagnostics
per simulated year.

Differences from the reference, by design:

- ``verbose`` is accepted by every model (the reference's classic method
  doesn't take it and crashes — SURVEY.md §2 "latent classic-path bug"; fixed
  here, numerics unchanged).
- ``debug`` is a traceable callable ``(vars, par) -> array`` instead of a
  Julia ``Expr``; its value is recorded as solution variable ``"debug"``
  (reference /root/reference/src/infrastructure.jl:358-360).
- ``raw_mode='none'`` extends ``lastonly`` for ensemble/benchmark runs that
  need only seasonal storage.
"""
from __future__ import annotations

import functools
import warnings
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .forcing import Forcing
from .engine import auto_whole_year, check_whole_year
from .models.base import StepConfig, default_step_config, get_model
from .solutions import Seasonal, Solutions
from .spacetime import SpaceTime
from .utils.collection import Collection
from .utils.progress import Progress

__all__ = ["integrate", "make_year_fn", "default_dtype"]


def _split_chunks(acc):
    """Flatten chunked-dispatch entries ``("chunk", Collection of (n, ...))``
    into per-year Collections (host-side, after the bulk fetch)."""
    out = []
    for e in acc:
        if isinstance(e, tuple) and e[0] == "chunk":
            coll = e[1]
            n = len(next(iter(coll.values())))
            out.extend(
                Collection({k: v[j] for k, v in coll.items()}) for j in range(n)
            )
        else:
            out.append(e)
    return out


def default_dtype():
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


# Active sub-year-progress run (``integrate(progress_steps=N)``): the
# in-graph ``jax.debug.callback`` target must be this one module-level
# function — a fresh per-call closure would key a new ``make_year_fn``/
# ``_jitted_year_fn`` cache entry per call, evicting the shared default
# tracings after ~32 tick-mode calls and retaining every dead Progress via
# the cached closures (review r3). Only one tick-mode run is live at a
# time (the bar owns the terminal), so a single slot suffices; it is set
# before the year loop and cleared at the synchronizing result fetch.
_ACTIVE_TICK = {"prog": None, "T": None, "total": 0}


def _tick_dispatch(step):
    p = _ACTIVE_TICK["prog"]
    if p is not None:
        # `step` is the ABSOLUTE step, computed on device (the host loop
        # dispatches ahead of execution — review r2)
        step = int(step)
        p.update(step, feedargs=(
            float(_ACTIVE_TICK["T"][min(step, _ACTIVE_TICK["total"]) - 1]),
        ))


@functools.lru_cache(maxsize=64)
def make_year_fn(
    model_name: str,
    st: SpaceTime,
    cfg: StepConfig,
    dtype_name: str,
    collect_raw: bool,
    debug: Optional[Callable] = None,
    tick_every: int = 0,
    tick_cb: Optional[Callable] = None,
    remat: bool = False,
):
    """Build the pure one-year scan function
    ``(carry, par, fyear) -> (carry, seasonal, converged, raw_or_None)``.

    ``par`` is traced (ensembles vmap over it without recompiling);
    the grid, config, and debug hook are static. Cached so repeated
    ``integrate`` calls and the ensemble layer share tracings.

    ``remat=True`` wraps the physics step in :func:`jax.checkpoint`, so
    REVERSE-MODE consumers (lyapunov tangent propagation, stability's
    vjp power iteration) store only the per-step carry chain instead of
    every step's internal residuals — without it, vjp through a year
    needs ~R x nt x K x nx floats of residuals (R per-step intermediates,
    more than device memory holds for wide ensembles); with it the
    footprint is the carry chain, nt x K x nx x (carry fields) floats.
    Forward-only consumers must leave it False (identical numerics, but
    the annotation can perturb fusion); the recomputation replays the
    identical op sequence, so gradients are unchanged.

    ``tick_every``/``tick_cb``: emit a host progress callback
    (``jax.debug.callback``) every ``tick_every`` in-year steps — sub-year
    progress for slow (f64 parity) runs. Part of the compiled graph, so it
    is strictly opt-in (the default graph is unchanged; see
    ``integrate(progress_steps=...)``).
    """
    spec = get_model(model_name)
    dtype = jnp.dtype(dtype_name)
    w0 = st.winter_inx - 1  # reference tick indices are 1-based (:573-589)
    s0 = st.summer_inx - 1
    ticking = tick_cb is not None and tick_every > 0

    if remat:
        base_step = jax.checkpoint(
            lambda carry, xs, stat, par: spec.step(carry, xs, stat, par,
                                                   cfg))
    else:
        base_step = lambda carry, xs, stat, par: spec.step(carry, xs,
                                                           stat, par, cfg)

    def scan_step(stat, par, carry, xs, idx=None, year_base=None):
        carry, out = base_step(carry, xs, stat, par)
        if debug is not None:
            out = Collection(out)
            out["debug"] = debug(out, par)
        if ticking and idx is not None:
            # the callback receives the ABSOLUTE step, computed on device
            # from the traced year index: the host loop dispatches years
            # asynchronously, so any host-side year counter would race
            # ahead of device execution (review r2)
            lax.cond(
                (idx + 1) % tick_every == 0,
                lambda i: jax.debug.callback(tick_cb, year_base + i + 1),
                lambda i: None,
                idx,
            )
        return carry, out

    if collect_raw:
        # raw mode: materialize every step (nt, ..., nx) and derive the
        # seasonal storage from it. Step 0 is peeled exactly as in the
        # seasonal-only mode below so both modes run the identical op
        # sequence (bitwise-equal carries regardless of storage mode).
        def year_fn(carry, par, fyear, year_idx=None):
            stat = spec.statics(st, par, dtype)
            xs = Collection(spec.step_inputs(stat, jnp.asarray(fyear, dtype=dtype)))
            x0 = jax.tree_util.tree_map(lambda v: v[0], xs)
            xs_rest = jax.tree_util.tree_map(lambda v: v[1:], xs)
            carry, out0 = scan_step(stat, par, carry, x0)
            if ticking:
                year_base = jnp.asarray(year_idx, jnp.int32) * st.nt
                xs_rest = Collection(xs_rest)
                xs_rest["_idx"] = jnp.arange(1, st.nt, dtype=jnp.int32)

                def body(c, x):
                    x = Collection(x)
                    idx = x.pop("_idx")
                    return scan_step(stat, par, c, x, idx, year_base)
            else:
                body = lambda c, x: scan_step(stat, par, c, x)
            carry, ys_rest = lax.scan(body, carry, xs_rest)
            ys = Collection(
                {
                    k: jnp.concatenate([out0[k][None], v], axis=0)
                    for k, v in Collection(ys_rest).items()
                }
            )
            converged = ys.pop("newton_converged", None)
            seasonal = Seasonal(
                winter=Collection({k: v[w0] for k, v in ys.items()}),
                summer=Collection({k: v[s0] for k, v in ys.items()}),
                avg=Collection({k: jnp.mean(v, axis=0) for k, v in ys.items()}),
            )
            return carry, seasonal, converged, ys

        return year_fn

    # seasonal-only mode: the scan emits nothing — annual sums and the
    # winter/summer snapshots accumulate in the carry, so memory traffic is
    # O(nx) per step instead of O(nt*nx) per year (the memory-bandwidth lever
    # that lets thousands of ensemble members fit and fly).
    def year_fn(carry, par, fyear, year_idx=None):
        stat = spec.statics(st, par, dtype)
        xs = Collection(spec.step_inputs(stat, jnp.asarray(fyear, dtype=dtype)))
        year_base = (
            jnp.asarray(year_idx, jnp.int32) * st.nt if ticking else None
        )

        def seasonal_step(state, x):
            c, acc, wint, summ, conv = state
            x = Collection(x)
            idx = x.pop("_idx")
            c, out = scan_step(stat, par, c, x, idx, year_base)
            out = Collection(out)
            step_conv = out.pop("newton_converged", None)
            acc = Collection({k: acc[k] + out[k] for k in acc})
            wint = Collection(
                {k: jnp.where(idx == w0, out[k], wint[k]) for k in wint}
            )
            summ = Collection(
                {k: jnp.where(idx == s0, out[k], summ[k]) for k in summ}
            )
            if step_conv is not None:
                conv = jnp.minimum(conv, step_conv)
            return (c, acc, wint, summ, conv), None

        # Peel step 0 eagerly: its output seeds the accumulators with the
        # right pytree structure (and, under shard_map, the right
        # axis-varyingness — fresh zeros would be rejected as unvarying).
        x0 = jax.tree_util.tree_map(lambda v: v[0], xs)
        carry, out0 = scan_step(stat, par, carry, x0)
        out0 = Collection(out0)
        conv0 = out0.pop("newton_converged", None)
        has_conv = conv0 is not None
        zeros = Collection({k: v * 0 for k, v in out0.items()})
        state0 = (
            carry,
            out0,  # annual sum seeded with step 0
            out0 if w0 == 0 else Collection(zeros),
            out0 if s0 == 0 else Collection(zeros),
            conv0 if has_conv else jnp.asarray(1.0, dtype),
        )
        xs_rest = jax.tree_util.tree_map(lambda v: v[1:], xs)
        xs_rest["_idx"] = jnp.arange(1, st.nt, dtype=jnp.int32)
        (carry, acc, wint, summ, conv), _ = lax.scan(seasonal_step, state0, xs_rest)
        seasonal = Seasonal(
            winter=wint,
            summer=summ,
            avg=Collection({k: v / st.nt for k, v in acc.items()}),
        )
        converged = conv if has_conv else None
        return carry, seasonal, converged, None

    return year_fn


@functools.lru_cache(maxsize=64)
def _jitted_year_fn(model_name, st, cfg, dtype_name, collect_raw, debug,
                    tick_every=0, tick_cb=None):
    """Jitted twin of :func:`make_year_fn`, cached so repeated ``integrate``
    calls reuse compilations. Tick-mode runs pass the module-level
    :func:`_tick_dispatch` as ``tick_cb`` (never a per-call closure), so
    they share cache entries like any other configuration."""
    return jax.jit(make_year_fn(model_name, st, cfg, dtype_name, collect_raw,
                                debug, tick_every, tick_cb))


@functools.lru_cache(maxsize=64)
def _jitted_years_fn(model_name, st, cfg, dtype_name, debug, n_years):
    """``n_years`` seasonal-only years in ONE dispatch: an outer ``lax.scan``
    over the year function. Cuts host->device round-trips from one per year
    to one per chunk."""
    year_fn = make_year_fn(model_name, st, cfg, dtype_name, False, debug)

    def years_fn(carry, par, f_years):
        def body(c, frow):
            c, seasonal, conv, _ = year_fn(c, par, frow)
            if conv is None:
                conv = jnp.ones(())
            return c, (seasonal, conv)

        carry, (seasons, convs) = lax.scan(body, carry, f_years)
        return carry, seasons, convs

    return jax.jit(years_fn)


def _whole_year(model_name):
    from .ops.year import classic_year, miz_year

    return miz_year if model_name == "MIZ" else classic_year


def _lift(carry):
    return Collection({k: v[None] for k, v in carry.items()})


def _squeeze(coll, axis):
    idx = (slice(None),) * axis + (0,)
    return Collection({k: v[idx] for k, v in coll.items()})


@functools.lru_cache(maxsize=64)
def _jitted_fused_years(model_name, st, cfg, dtype_name, n_years):
    """``n_years`` whole-year-engine years in ONE dispatch: a ``lax.scan``
    over :mod:`.ops.year` on the run lifted to a 1-member ensemble."""
    year = _whole_year(model_name)

    def fn(carry, par, f_years):
        def body(c, frow):
            c, seas, conv, _ = year(c, par, frow, st, cfg)
            if conv is None:  # classic has no Newton flag
                conv = jnp.ones(())
            return c, (seas, conv)

        c1, (seasons, convs) = lax.scan(body, _lift(carry), f_years)
        # outputs are (n_years, 1, nx): drop the 1-member axis
        seasonal = Seasonal(*(_squeeze(c, 1) for c in seasons))
        return _squeeze(c1, 0), seasonal, convs

    return jax.jit(fn)


@functools.lru_cache(maxsize=64)
def _jitted_fused_single(model_name, st, cfg, dtype_name):
    """Single-run adapter for the whole-year engine: lift the (nx,) carry to
    a 1-member ensemble, run the year, squeeze back — all inside ONE jit."""
    year = _whole_year(model_name)

    def fn(carry, par, frow):
        c1, seas, conv, _ = year(_lift(carry), par, frow, st, cfg)
        seasonal = Seasonal(*(_squeeze(c, 0) for c in seas))
        return _squeeze(c1, 0), seasonal, conv

    return jax.jit(fn)


def integrate(
    model: str,
    st: SpaceTime,
    forcing: Forcing,
    par: Collection,
    init: Collection,
    lastonly: bool = True,
    debug: Optional[Callable] = None,
    verbose: bool = False,
    dtype=None,
    solver: str = "pcr",
    engine: str = "auto",
    years_per_dispatch: Optional[int] = None,
    raw_mode: Optional[str] = None,
    progress: Optional[bool] = None,
    progress_steps: Optional[int] = None,
    newton_max_iter: int = 30,
    checkpoint: Optional[str] = None,
    checkpoint_every: int = 1,
    resume: bool = False,
    profile_dir: Optional[str] = None,
) -> Solutions:
    """Integrate ``model`` over ``st`` with climate ``forcing``, parameters
    ``par`` and initial conditions ``init``; results in a :class:`Solutions`.

    ``model`` is ``'MIZ'`` or ``'Classic'``. For ``'MIZ'`` the initial
    conditions must contain ``Ei, Ew, h, D, phi``; for ``'Classic'``, ``E``
    and ``Tg`` (reference /root/reference/src/infrastructure.jl:597-613).
    ``lastonly=True`` stores per-step raw data only for the final year.
    ``verbose=True`` warns when the MIZ surface-temperature solve fails to
    converge in a year. ``dtype`` defaults to float64 when x64 is enabled
    (parity config) else float32 (throughput config); ``solver`` selects
    the tridiagonal kernel (``'pcr'`` log-depth parallel, ``'thomas'``
    sequential).

    ``checkpoint`` names an HDF5 file written every ``checkpoint_every``
    simulated years (scan carry + seasonal storage); with ``resume=True`` a
    matching checkpoint continues the run bit-exactly from the first
    unfinished year (see :mod:`.checkpoint`). ``profile_dir`` captures a
    ``jax.profiler`` trace of the run for TensorBoard.

    ``engine='fused'`` runs seasonal-only years through the whole-year
    engine (:mod:`.ops.year`); raw-collected years fall back to the scan.
    Requires ``debug=None``; ``engine='scan'`` is the jitted ``lax.scan``
    path. ``'auto'`` (default) picks between them with the policy the
    drivers share (:func:`.engine.auto_whole_year`): ``'fused'``, or
    ``'scan'`` when the run needs a debug hook, sub-year progress ticks or
    the Thomas solver.

    ``progress_steps=N`` ticks the progress bar every ``N`` in-year steps
    from INSIDE the jitted scan (``jax.debug.callback``) — sub-year feedback
    for slow runs (the f64 parity config spends minutes per year with
    nothing to report otherwise; reference meter updates per step,
    /root/reference/src/utilities.jl:266-279). Opt-in because the callback
    is part of the compiled graph: the default graph — and therefore the
    golden-fixture trajectory — is unchanged. The callback receives the
    absolute step computed ON DEVICE (the host loop dispatches years ahead
    of execution), and in tick mode the in-graph ticks own the bar — it
    tracks real device progress, closed by the synchronizing result fetch.
    Needs the per-year scan graph: ``engine='auto'`` resolves to ``'scan'``
    when ``progress_steps`` is set; an explicit ``engine='fused'`` or
    ``years_per_dispatch > 1`` warns and ignores ``progress_steps``.

    ``years_per_dispatch > 1`` batches that many seasonal-only years into a
    single device dispatch (an outer ``lax.scan`` over years), which saves
    a host round trip per year; progress and checkpoints advance per chunk.
    With ``engine='scan'`` results match the per-year path to compiled-graph
    rounding only (the chunking is part of the checkpoint key); with
    ``engine='fused'`` the scan feeds the carry through the same year
    program, and checkpoints may mix chunkings. Default (``None``): 8 for
    the fused engine, 1 for the scan engine (keeps the parity graph
    unchanged).
    """
    spec = get_model(model)
    if dtype is None:
        dtype = default_dtype()
    dtype = jnp.dtype(dtype)
    missing = [v for v in spec.init_vars if v not in init]
    if missing:
        raise ValueError(f"init for model {spec.name!r} is missing {missing}")
    if raw_mode is None:
        raw_mode = "last" if lastonly else "all"
    if raw_mode not in ("last", "all", "none"):
        raise ValueError(f"raw_mode must be 'last'|'all'|'none', got {raw_mode!r}")
    cfg = default_step_config(
        dtype.name, solver=solver, newton_max_iter=newton_max_iter,
        verbose=verbose,
    )
    if engine == "auto":
        engine = "fused" if auto_whole_year(
            spec.name,
            per_year_only=(debug is not None or solver != "pcr"
                           or progress_steps is not None),
        ) else "scan"
    if years_per_dispatch is None:
        years_per_dispatch = 8 if engine == "fused" else 1

    fused_kernel = None
    if engine == "fused":
        check_whole_year(spec.name, "engine='scan'")
        if debug is not None:
            raise ValueError(
                "engine='fused' does not support the debug hook; use "
                "engine='scan'"
            )
        fused_kernel = _jitted_fused_single(spec.name, st, cfg, dtype.name)
    elif engine != "scan":
        raise ValueError(
            f"unknown engine {engine!r}; expected 'auto', 'scan' or 'fused'"
        )

    tick_every = 0
    if progress_steps is not None and int(progress_steps) > 0:
        if engine != "scan" or years_per_dispatch > 1:
            # ticks ride the per-year scan graph only (the whole-year engine
            # and multi-year chunks have no in-graph callback); warn instead of
            # silently losing the requested feedback
            warnings.warn(
                "progress_steps is ignored: sub-year progress ticks need "
                "engine='scan' with years_per_dispatch=1 "
                f"(got engine={engine!r}, years_per_dispatch={years_per_dispatch})"
            )
        else:
            tick_every = int(progress_steps)

    year_seasonal = _jitted_year_fn(spec.name, st, cfg, dtype.name, False, debug,
                                    tick_every,
                                    _tick_dispatch if tick_every else None)
    year_full = _jitted_year_fn(spec.name, st, cfg, dtype.name, True, debug,
                                tick_every,
                                _tick_dispatch if tick_every else None)

    f_tab = forcing.table(st)
    par_j = Collection({k: jnp.asarray(v, dtype=dtype) for k, v in par.items()})
    carry = spec.init_carry(init, st, dtype)

    raw_chunks = []
    winter_acc, summer_acc, avg_acc = [], [], []
    start_year = 0
    ckpt_key = ""
    if checkpoint is not None:
        from . import checkpoint as ckpt_mod

        extras = []
        if engine != "scan":
            extras.append(engine)
        if years_per_dispatch > 1 and engine != "fused":
            # chunked XLA dispatch compiles a different graph; graph-level
            # rounding amplifies, so a resume must use the same chunking.
            # (The whole-year engine's chunks scan the same year program,
            # so its key leaves the chunking out.)
            extras.append(f"ypd{years_per_dispatch}")
        ckpt_key = ckpt_mod.config_key(
            "", spec.name, st, forcing, par, dtype.name, solver,
            newton_max_iter, extras,
        )
        carry, start_year, winter_acc, summer_acc, avg_acc = (
            ckpt_mod.resume_state(
                checkpoint, ckpt_key, resume, raw_mode, st.dur,
                lambda v: jnp.asarray(v, dtype=dtype), carry,
            )
        )

    if progress is None:
        progress = True
    prog = Progress(
        st.dur * st.nt,
        "Integrating",
        infofeed=lambda t: f"t = {round(t, 2)}",
    ) if progress else None
    if prog is not None:
        prog.update(start_year * st.nt, feedargs=(float(start_year),))
    if tick_every:
        _ACTIVE_TICK.update(prog=prog, T=st.T, total=st.dur * st.nt)

    profiler_cm = None
    if profile_dir is not None:
        profiler_cm = jax.profiler.trace(profile_dir)
        profiler_cm.__enter__()

    if checkpoint is not None:
        from . import checkpoint as ckpt_mod

        _ckpt_write = ckpt_mod.year_writer(
            checkpoint, ckpt_key,
            lambda: (carry, (winter_acc, summer_acc, avg_acc)),
            split=_split_chunks,
        )

    y = start_year
    while y < st.dur:
        collect = raw_mode == "all" or (raw_mode == "last" and y == st.dur - 1)
        # multi-year chunk: batch consecutive seasonal-only years into one
        # dispatch (per-dispatch latency amortization)
        if years_per_dispatch > 1 and not collect:
            last_seasonal = st.dur - (1 if raw_mode == "last" else 0)
            chunk = min(years_per_dispatch, last_seasonal - y)
            if checkpoint is not None:
                every = max(checkpoint_every, 1)
                chunk = min(chunk, (y // every + 1) * every - y)
            if chunk > 1:
                if fused_kernel is not None:
                    years_fn = _jitted_fused_years(
                        spec.name, st, cfg, dtype.name, chunk
                    )
                else:
                    years_fn = _jitted_years_fn(
                        spec.name, st, cfg, dtype.name, debug, chunk
                    )
                carry, seasons, convs = years_fn(carry, par_j, f_tab[y:y + chunk])
                # keep the stacked (chunk, nx) arrays whole until the single
                # bulk device_get: eager per-year slicing would dispatch
                # 3 * nvars * chunk tiny device ops — the latency this
                # feature exists to amortize
                winter_acc.append(("chunk", seasons.winter))
                summer_acc.append(("chunk", seasons.summer))
                avg_acc.append(("chunk", seasons.avg))
                if verbose:
                    conv = np.asarray(convs)
                    if not conv.all():
                        warnings.warn(
                            "Solving for T0 failed in year(s) "
                            f"{[y + 1 + int(i) for i in np.flatnonzero(conv < 1.0)]}."
                        )
                y += chunk
                if checkpoint is not None and (
                    y % max(checkpoint_every, 1) == 0 or y == st.dur
                ):
                    _ckpt_write(y)
                if prog is not None:
                    prog.update(y * st.nt, feedargs=(float(st.T[y * st.nt - 1]),))
                continue
        if fused_kernel is not None and not collect:
            # single run as a 1-member ensemble; raw-collect years take the
            # scan path below. One dispatch per year.
            carry, seasonal, converged = fused_kernel(carry, par_j, f_tab[y])
            ys = None
        else:
            fn = year_full if collect else year_seasonal
            if tick_every:
                carry, seasonal, converged, ys = fn(
                    carry, par_j, f_tab[y], jnp.int32(y)
                )
            else:
                carry, seasonal, converged, ys = fn(carry, par_j, f_tab[y])
        winter_acc.append(seasonal.winter)
        summer_acc.append(seasonal.summer)
        avg_acc.append(seasonal.avg)
        if collect:
            raw_chunks.append(ys)
        if verbose and converged is not None:
            # the flag is a float (1.0 = converged) — boolean reductions have
            # no AD rules, see models/miz.py — so compare, don't invert
            conv = np.asarray(converged)
            if not conv.all():
                warnings.warn(
                    f"Solving for T0 failed at {int(np.count_nonzero(conv < 1.0))} "
                    f"flag(s) of year {y + 1}."
                )
        if checkpoint is not None and (
            (y + 1) % max(checkpoint_every, 1) == 0 or y == st.dur - 1
        ):
            _ckpt_write(y + 1)
        if prog is not None and not tick_every:
            # dispatch-frontier update; in tick mode the in-graph callbacks
            # own the bar (device-ordered, so it never moves backwards)
            prog.update((y + 1) * st.nt, feedargs=(float(st.T[(y + 1) * st.nt - 1]),))
        y += 1

    if profiler_cm is not None:
        profiler_cm.__exit__(None, None, None)

    varnames = list(spec.solution_vars) + (["debug"] if debug is not None else [])
    # ONE bulk device->host fetch for every stored array: per-leaf np.asarray
    # would pay a full round-trip per (nx,) vector (3 stores x 10 vars x dur
    # years)
    raw_chunks, winter_acc, summer_acc, avg_acc = jax.device_get(
        (raw_chunks, winter_acc, summer_acc, avg_acc)
    )
    if tick_every:
        # the bulk fetch above synchronized with the device, so the run is
        # genuinely complete — close the tick-driven bar and release the
        # dispatch slot (no more callbacks can arrive)
        if prog is not None:
            prog.update(st.dur * st.nt, feedargs=(float(st.T[-1]),))
        _ACTIVE_TICK.update(prog=None, T=None, total=0)
    winter_acc = _split_chunks(winter_acc)
    summer_acc = _split_chunks(summer_acc)
    avg_acc = _split_chunks(avg_acc)
    if raw_chunks:
        raw = Collection(
            {
                k: np.concatenate([np.asarray(c[k]) for c in raw_chunks], axis=0)
                for k in varnames
            }
        )
    else:
        raw = Collection({k: np.zeros((0, st.nx)) for k in varnames})

    def stack(acc):
        return Collection(
            {k: np.stack([np.asarray(c[k]) for c in acc], axis=0) for k in varnames}
        )

    seasonal_store = Seasonal(winter=stack(winter_acc), summer=stack(summer_acc), avg=stack(avg_acc))
    ts = Solutions.stored_times(st, raw_mode != "all")
    if raw_mode == "none":
        ts = np.zeros((0,))

    return Solutions(
        spacetime=st,
        ts=ts,
        forcing=forcing,
        parameters=Collection(par),
        initconds=Collection({k: np.asarray(v) for k, v in init.items()}),
        lastonly=lastonly,
        debug=debug,
        raw=raw,
        seasonal=seasonal_store,
    )
