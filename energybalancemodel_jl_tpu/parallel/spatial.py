"""Spatially sharded full-model integration (grid-axis domain decomposition).

For very high-resolution grids (nx >> 1e4; SURVEY.md §5) a single run can be
sharded over the latitude axis: each device owns a contiguous block of grid
cells, the 3-point diffusion stencil exchanges one halo cell per application
(``lax.ppermute``), and the implicit tridiagonal solves (classic ghost layer,
MIZ Newton) run through the distributed SPIKE solver
(:mod:`..ops.spike` — local factorizations + one small ``all_gather``-ed
interface system). Physics code is shared with the single-chip path; only
the neighbor exchange and solver dispatch differ (``StepConfig.spatial_axis``).
"""
from __future__ import annotations

import warnings
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax, shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..forcing import Forcing
from ..integrate import default_dtype
from ..models.base import StepConfig, default_step_config, get_model
from ..solutions import Seasonal, Solutions
from ..spacetime import SpaceTime
from ..utils.collection import Collection
from ..utils.progress import Progress

__all__ = ["spatial_integrate", "grid_mesh"]


def grid_mesh(n_devices: Optional[int] = None, axis: str = "x") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def _stat_specs(stat: Collection, nx: int, axis: str) -> Collection:
    """Partition specs for a statics Collection: leaves whose last axis is
    the grid are sharded over ``axis``; scalars replicate."""
    def spec(v):
        ndim = jnp.ndim(v)
        if ndim >= 1 and jnp.shape(v)[-1] == nx:
            return P(*([None] * (ndim - 1) + [axis]))
        return P()
    return Collection({k: spec(v) for k, v in stat.items()})


def _make_spatial_year_fn(spec, st, cfg: StepConfig, dtype, collect_raw: bool,
                          mesh: Mesh, axis: str, stat_specs: Collection,
                          k_axis: Optional[str] = None,
                          par_specs=None, f_spec=None):
    """shard_map-wrapped one-year scan over a grid-sharded carry.

    Statics are computed outside and passed in sharded; the physics step is
    the shared model code with ``cfg.spatial_axis`` set (halo-exchange
    stencils + SPIKE solves).

    With ``k_axis`` set (2-D mesh, :mod:`.grid2d`), carry leaves are
    ``(K, nx)`` member batches sharded ``P(k_axis, axis)`` — the physics
    steps are shape-polymorphic over the leading member axis (the
    batch-native ensemble engine's property), and every data collective
    inside (halo ``ppermute``, SPIKE ``all_gather``, Newton-norm ``pmax``)
    spans only the grid axis. The one cross-row reduction is the Newton
    loop CONDITION (``cfg.batch_axis``), which keeps the ``while_loop``
    trip count identical on every device — divergent trip counts across
    member rows deadlock runtimes whose collective rendezvous is global
    (observed on the XLA CPU backend), and the unsharded batched engine's
    single ``jnp.any`` over all members has the same trip-count semantics
    anyway.
    """
    w0 = st.winter_inx - 1
    s0 = st.summer_inx - 1

    def local_year(carry, par, fyear, stat):
        xs = Collection(spec.step_inputs(stat, jnp.asarray(fyear, dtype=dtype)))

        def scan_step(c, x):
            return spec.step(c, x, stat, par, cfg)

        x0 = jax.tree_util.tree_map(lambda v: v[0], xs)
        xs_rest = jax.tree_util.tree_map(lambda v: v[1:], xs)
        carry, out0 = scan_step(carry, x0)
        out0 = Collection(out0)
        conv0 = out0.pop("newton_converged", None)
        has_conv = conv0 is not None
        zeros = Collection({k: v * 0 for k, v in out0.items()})

        if collect_raw:
            carry, ys_rest = lax.scan(scan_step, carry, xs_rest)
            ys = Collection(ys_rest)
            conv_rest = ys.pop("newton_converged", None)
            ys = Collection(
                {k: jnp.concatenate([out0[k][None], v], axis=0) for k, v in ys.items()}
            )
            seasonal = Seasonal(
                winter=Collection({k: v[w0] for k, v in ys.items()}),
                summer=Collection({k: v[s0] for k, v in ys.items()}),
                avg=Collection({k: jnp.mean(v, axis=0) for k, v in ys.items()}),
            )
            conv = (
                jnp.minimum(conv0, jnp.min(conv_rest)) if has_conv
                else jnp.asarray(1.0, dtype)
            )
            conv = lax.pmin(conv, conv_axes)  # provably replicated for P()
            return carry, seasonal, conv, ys

        def seasonal_step(state, x):
            c, acc, wint, summ, conv = state
            x = Collection(x)
            idx = x.pop("_idx")
            c, out = spec.step(c, x, stat, par, cfg)
            out = Collection(out)
            step_conv = out.pop("newton_converged", None)
            acc = Collection({k: acc[k] + out[k] for k in acc})
            wint = Collection({k: jnp.where(idx == w0, out[k], wint[k]) for k in wint})
            summ = Collection({k: jnp.where(idx == s0, out[k], summ[k]) for k in summ})
            if step_conv is not None:
                conv = jnp.minimum(conv, step_conv)
            return (c, acc, wint, summ, conv), None

        state0 = (
            carry, out0,
            out0 if w0 == 0 else Collection(zeros),
            out0 if s0 == 0 else Collection(zeros),
            conv0 if has_conv else jnp.asarray(1.0, dtype),
        )
        xs_rest["_idx"] = jnp.arange(1, st.nt, dtype=jnp.int32)
        (carry, acc, wint, summ, conv), _ = lax.scan(seasonal_step, state0, xs_rest)
        seasonal = Seasonal(
            winter=wint, summer=summ,
            avg=Collection({k: v / st.nt for k, v in acc.items()}),
        )
        conv = lax.pmin(conv, conv_axes)  # provably replicated for P()
        return carry, seasonal, conv, None

    conv_axes = axis if k_axis is None else (k_axis, axis)
    state_spec = P(axis) if k_axis is None else P(k_axis, axis)
    raw_spec = P(None, axis) if k_axis is None else P(None, k_axis, axis)
    sm = shard_map(
        local_year,
        mesh=mesh,
        in_specs=(
            state_spec,  # carry leaves (broadcast over the pytree)
            P() if par_specs is None else par_specs,
            P() if f_spec is None else f_spec,  # forcing: shared (nt,) row,
            # or (nt, K, 1) per-member rows for the virtual "F" sweep
            stat_specs,
        ),
        out_specs=(
            state_spec,
            Seasonal(winter=state_spec, summer=state_spec, avg=state_spec),
            P(),  # converged (replicated: Newton norms are pmax-reduced)
            raw_spec if collect_raw else P(),
        ),
    )
    return jax.jit(sm)


def spatial_integrate(
    model: str,
    st: SpaceTime,
    forcing: Forcing,
    par: Collection,
    init: Collection,
    mesh: Optional[Mesh] = None,
    axis: str = "x",
    lastonly: bool = True,
    raw_mode: Optional[str] = None,
    dtype=None,
    verbose: bool = False,
    newton_max_iter: int = 30,
    progress: Optional[bool] = None,
    checkpoint: Optional[str] = None,
    checkpoint_every: int = 1,
    resume: bool = False,
) -> Solutions:
    """Integrate one run with the grid axis sharded over ``mesh``.

    Semantics match :func:`~energybalancemodel_jl_tpu.integrate` (lastonly /
    raw storage, seasonal snapshots, ``verbose`` Newton-non-convergence
    warnings per /root/reference/src/miz.jl:61-63, progress bar, per-year
    checkpoint/resume); parameters must be scalars (spatial decomposition is
    for single high-resolution runs — sweep parameters with the ensemble
    engines instead). The checkpoint key includes the mesh size: SPIKE
    partitioning compiles a different graph per device count, so a resume
    must use the same decomposition.
    """
    spec = get_model(model)
    if mesh is None:
        mesh = grid_mesh(axis=axis)
    if st.nx % mesh.size != 0:
        raise ValueError(f"nx={st.nx} must divide evenly over {mesh.size} devices")
    if dtype is None:
        dtype = default_dtype()
    dtype = jnp.dtype(dtype)
    if raw_mode is None:
        raw_mode = "last" if lastonly else "all"
    if raw_mode not in ("last", "all", "none"):
        raise ValueError(f"raw_mode must be 'last'|'all'|'none', got {raw_mode!r}")

    cfg = default_step_config(
        dtype.name, newton_max_iter=newton_max_iter, verbose=verbose,
        spatial_axis=axis,
    )

    par_j = Collection({k: jnp.asarray(v, dtype=dtype) for k, v in par.items()})
    stat = jax.jit(lambda p: spec.statics(st, p, dtype))(par_j)
    sspecs = _stat_specs(stat, st.nx, axis)
    run_seasonal = _make_spatial_year_fn(spec, st, cfg, dtype, False, mesh, axis, sspecs)
    run_full = _make_spatial_year_fn(spec, st, cfg, dtype, True, mesh, axis, sspecs)

    carry = spec.init_carry(init, st, dtype)
    f_tab = forcing.table(st)

    raw_chunks = []
    winter_acc, summer_acc, avg_acc = [], [], []
    start_year = 0
    ckpt_key = ""
    if checkpoint is not None:
        from .. import checkpoint as ckpt_mod

        # the mesh size rides in the prefix: SPIKE partitioning compiles a
        # different graph per device count, so a resume must match it
        ckpt_key = ckpt_mod.config_key(
            f"spatial{mesh.size}", spec.name, st, forcing, par, dtype.name,
            "pcr", newton_max_iter,
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
        )

    if progress is None:
        progress = True
    prog = Progress(
        st.dur * st.nt,
        "Integrating (spatial)",
        infofeed=lambda t: f"t = {round(t, 2)}",
    ) if progress else None
    if prog is not None:
        prog.update(start_year * st.nt, feedargs=(float(start_year),))

    for y in range(start_year, st.dur):
        collect = raw_mode == "all" or (raw_mode == "last" and y == st.dur - 1)
        fn = run_full if collect else run_seasonal
        carry, seasonal, conv, ys = fn(carry, par_j, f_tab[y], stat)
        winter_acc.append(seasonal.winter)
        summer_acc.append(seasonal.summer)
        avg_acc.append(seasonal.avg)
        if collect:
            raw_chunks.append(ys)
        if verbose:
            # the flag is a float (1.0 = converged), min-reduced over the
            # year and the mesh — mirror integrate's reference-style warning
            if not np.asarray(conv).all():
                warnings.warn(f"Solving for T0 failed in year {y + 1}.")
        if checkpoint is not None and (
            (y + 1) % max(checkpoint_every, 1) == 0 or y == st.dur - 1
        ):
            _ckpt_write(y + 1)
        if prog is not None:
            prog.update((y + 1) * st.nt, feedargs=(float(st.T[(y + 1) * st.nt - 1]),))

    varnames = list(spec.solution_vars)
    # one bulk device->host fetch (see integrate.py: per-leaf np.asarray
    # pays a round-trip per array)
    raw_chunks, winter_acc, summer_acc, avg_acc = jax.device_get(
        (raw_chunks, winter_acc, summer_acc, avg_acc)
    )
    if raw_chunks:
        raw = Collection(
            {k: np.concatenate([np.asarray(c[k]) for c in raw_chunks], axis=0)
             for k in varnames}
        )
    else:
        raw = Collection({k: np.zeros((0, st.nx)) for k in varnames})

    def stack(acc):
        return Collection(
            {k: np.stack([np.asarray(c[k]) for c in acc], axis=0) for k in varnames}
        )

    ts = Solutions.stored_times(st, raw_mode != "all")
    if raw_mode == "none":
        ts = np.zeros((0,))
    return Solutions(
        spacetime=st, ts=ts, forcing=forcing, parameters=Collection(par),
        initconds=Collection({k: np.asarray(v) for k, v in init.items()}),
        lastonly=lastonly, debug=None, raw=raw,
        seasonal=Seasonal(stack(winter_acc), stack(summer_acc), stack(avg_acc)),
    )
