"""Spatial domain decomposition of the diffusion stencil (halo exchange).

The 3-point meridional stencil (SURVEY.md §3.5) shards over the grid axis:
each device owns a contiguous block of latitudes and exchanges one boundary
cell with each neighbor per application via ``lax.ppermute``. Only worthwhile at very high resolution (nx >> 1e4, SURVEY.md §5); at
the reference's nx = 180 the ensemble axis is the right one — this module
exists to scale the grid axis when a user needs it, and as the framework's
"sequence/spatial parallel" demonstration.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.diffusion import diffusion_bands

__all__ = ["grid_mesh", "sharded_diffusion"]


def grid_mesh(n_devices: Optional[int] = None, axis: str = "x") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def sharded_diffusion(st, mesh: Mesh):
    """Build ``fn(T, D) -> D∇²T`` with ``T`` sharded over the grid axis.

    Each shard applies the local stencil; the two halo cells arrive from the
    ring neighbors via ``ppermute`` (two sends of one float per application —
    latency-bound, fully overlappable with local compute by XLA).
    """
    from jax import shard_map

    axis = mesh.axis_names[0]
    ndev = mesh.size
    if st.nx % ndev != 0:
        raise ValueError(f"nx={st.nx} must divide evenly over {ndev} devices")
    geom = diffusion_bands(st)
    lo = jnp.asarray(geom.lo)
    di = jnp.asarray(geom.di)
    up = jnp.asarray(geom.up)

    def local(T, D, lo_l, di_l, up_l):
        i = jax.lax.axis_index(axis)
        # halo exchange: left neighbor's last cell, right neighbor's first
        fwd = [(j, (j + 1) % ndev) for j in range(ndev)]
        bwd = [(j, (j - 1) % ndev) for j in range(ndev)]
        from_left = jax.lax.ppermute(T[-1:], axis, fwd)  # arrives as left halo
        from_right = jax.lax.ppermute(T[:1], axis, bwd)  # right halo
        Tm1 = jnp.concatenate([from_left, T[:-1]])
        Tp1 = jnp.concatenate([T[1:], from_right])
        # boundary devices: lo[0] = up[-1] = 0 globally, so the wrapped halo
        # values are multiplied by zero — no special-casing needed.
        return D * (lo_l * Tm1 + di_l * T + up_l * Tp1)

    smapped = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis), P(), P(axis), P(axis), P(axis)),
        out_specs=P(axis),
    )

    @jax.jit
    def fn(T, D):
        return smapped(T, jnp.asarray(D, T.dtype), lo, di, up)

    return fn
