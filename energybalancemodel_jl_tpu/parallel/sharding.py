"""Multi-chip data parallelism over a device mesh.

The reference has no distributed layer (SURVEY.md §2: no MPI/NCCL/threads);
the scaling axis is the *ensemble*: members are independent, so sharding
the leading ensemble axis of the vmapped scan over a 1-D
``jax.sharding.Mesh`` is pure DP — XLA inserts no collectives in the hot
loop, results gather only when the host reads them. A ``shard_map``
training-step variant with a ``psum`` ensemble-mean diagnostic is provided to
exercise explicit collectives (used by the multi-chip dry run).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..integrate import make_year_fn
from ..models.base import StepConfig, default_step_config
from ..utils.collection import Collection
from . import ensemble as ens

__all__ = [
    "ensemble_mesh",
    "sharded_ensemble_integrate",
    "shard_map_year_fn",
    "shard_map_fused_year_fn",
]


def ensemble_mesh(n_devices: Optional[int] = None, axis: str = "ensemble") -> Mesh:
    """A 1-D mesh over (the first ``n_devices``) local devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def sharded_ensemble_integrate(
    model: str,
    st,
    forcing,
    par: Collection,
    init: Collection,
    mesh: Optional[Mesh] = None,
    **kwargs,
):
    """Ensemble integration with members sharded across the mesh.

    Same semantics as :func:`..parallel.ensemble.ensemble_integrate`; the
    batched leading axis (parameters, carry, outputs) is laid out with
    ``NamedSharding(mesh, P('ensemble'))`` so each chip advances its shard of
    the ensemble independently.

    A leaf whose leading axis is NOT divisible by ``mesh.size`` cannot be
    laid out this way and is left replicated — correct, but every device
    then carries (and computes) the full axis. That silent perf footgun is
    surfaced with a ``UserWarning`` naming the leaves; pad the member count
    to a multiple of the mesh size to get real scaling.
    """
    if mesh is None:
        mesh = ensemble_mesh()
    axis = mesh.axis_names[0]
    batched = NamedSharding(mesh, P(axis))
    replicated = []

    def put(label, k, v):
        v = jnp.asarray(v)
        if v.ndim >= 1 and v.shape[0] % mesh.size == 0:
            return jax.device_put(v, batched)
        if v.ndim >= 1 and v.shape[0] > 1:
            replicated.append(f"{label}[{k!r}] leading axis {v.shape[0]}")
        return v

    def jit_wrapper(fn):
        return jax.jit(fn)

    # device_put the batched params/init up front; jit propagates shardings.
    par = Collection({k: put("par", k, v) for k, v in Collection(par).items()})
    init = Collection({
        k: put("init", k, v) if np.ndim(v) > 1 else v
        for k, v in init.items()
    })
    if replicated:
        import warnings

        warnings.warn(
            f"sharded_ensemble_integrate: {'; '.join(replicated)} not "
            f"divisible by mesh size {mesh.size} — these leaves are "
            "REPLICATED on every device (correct but unscaled); pad the "
            "member count to a multiple of the mesh size",
            UserWarning,
            stacklevel=2,
        )
    return ens.ensemble_integrate(
        model, st, forcing, par, init, jit_wrapper=jit_wrapper, **kwargs
    )


def shard_map_year_fn(model_name: str, st, mesh: Mesh, dtype_name: str = "float32",
                      cfg: Optional[StepConfig] = None):
    """Explicit-collective training step: ``shard_map`` over the ensemble
    axis, each shard scanning one year locally, plus a ``psum``-based
    ensemble-mean hemispheric diagnostic (the only cross-chip communication).

    Returns ``fn(carry, par, fyear) -> (carry, global_mean_T)`` where carry
    leaves have a leading ensemble axis divisible by the mesh size.
    """
    from jax import shard_map

    if cfg is None:
        cfg = default_step_config(dtype_name)
    axis = mesh.axis_names[0]
    year_fn = make_year_fn(model_name, st, cfg, dtype_name, False)
    vm = jax.vmap(year_fn, in_axes=(0, 0, None))
    x = jnp.asarray(st.x)

    def local_step(carry, par, fyear):
        carry, seasonal, _conv, _ = vm(carry, par, fyear)
        # hemispheric mean of the annual-average temperature, averaged over
        # the *global* ensemble: local sum + psum over the mesh axis.
        T = seasonal.avg["T"]  # (K_local, nx)
        hm = jnp.sum((T[:, :-1] + T[:, 1:]) * (x[1:] - x[:-1]) / 2.0, axis=-1)
        local_sum = jnp.sum(hm)
        global_mean = jax.lax.psum(local_sum, axis) / jax.lax.psum(
            jnp.asarray(hm.shape[0], hm.dtype), axis
        )
        return carry, global_mean

    spec_b = P(axis)
    smapped = shard_map(
        local_step,
        mesh=mesh,
        in_specs=(spec_b, spec_b, P()),
        out_specs=(spec_b, P()),
    )
    return jax.jit(smapped)


def shard_map_fused_year_fn(st, mesh: Mesh, par: Collection,
                            dtype_name: str = "float32",
                            cfg: Optional[StepConfig] = None,
                            model: str = "MIZ"):
    """Multi-device whole-year step: each device runs the whole-year engine
    (:mod:`..ops.year`) on its local ensemble shard (SURVEY.md §2: the
    ensemble is the scalable axis). The adaptive Newton loop's condition is
    OR-reduced over the mesh (``StepConfig.batch_axis``), so every shard
    runs the unsharded run's iteration count and the sharded ensemble
    follows the same arithmetic as one device — the only collectives are
    that one-scalar reduction per Newton iteration and the ``pmin`` of the
    convergence flag.

    ``par`` fixes which leaves are swept: ``(K,)`` leaves shard over the
    mesh, scalars replicate. Returns ``fn(carry, par, fyear) -> (carry,
    Seasonal, converged)`` with carry leaves ``(K, nx)``, ``K`` divisible
    by the mesh size.
    """
    from jax import shard_map

    from ..models.base import get_model
    from ..ops import year as yr
    from ..solutions import Seasonal

    if cfg is None:
        cfg = default_step_config(dtype_name)
    axis = mesh.axis_names[0]
    cfg = dataclasses.replace(cfg, batch_axis=axis)
    is_miz = model == "MIZ"
    year_fn = yr.miz_year if is_miz else yr.classic_year
    carry_keys = yr.CARRY_KEYS if is_miz else yr.C_CARRY_KEYS

    def local_step(carry, par, fyear):
        carry, seasonal, conv, _ = year_fn(carry, par, fyear, st, cfg)
        if conv is None:
            conv = jnp.ones(())
        return carry, seasonal, jax.lax.pmin(conv, axis)

    spec_b = P(axis)
    par_specs = Collection(
        {k: (spec_b if np.ndim(v) > 0 else P()) for k, v in par.items()}
    )
    carry_specs = Collection({k: spec_b for k in carry_keys})
    seasonal_specs = Collection(
        {k: spec_b for k in get_model(model).solution_vars}
    )
    smapped = shard_map(
        local_step,
        mesh=mesh,
        in_specs=(carry_specs, par_specs, P()),
        out_specs=(
            carry_specs,
            Seasonal(seasonal_specs, seasonal_specs, seasonal_specs),
            P(),
        ),
        # the year loop seeds its accumulators with unvarying zeros;
        # per-shard independence is what this wrapper establishes
        check_vma=False,
    )
    return jax.jit(smapped)
