"""Ensemble and multi-chip parallelism (new capability; the reference is
single-process/single-thread — SURVEY.md §2 "Parallelism: none").

- :mod:`.ensemble` — ``vmap`` parameter ensembles on one chip.
- :mod:`.sharding` — data parallelism over a ``jax.sharding.Mesh`` (ensemble
  members sharded across devices; no collectives in the hot loop).
- :mod:`.halo` — spatial domain decomposition of the diffusion stencil via
  ``shard_map`` + ``ppermute`` halo exchange (for very high-resolution grids).
- :mod:`.spatial` — grid-sharded single runs (halo exchange + distributed
  SPIKE tridiagonal solves).
- :mod:`.grid2d` — the 2-D composition: ensemble members x grid shards on
  one ``(k, x)`` mesh.
"""
from .ensemble import EnsembleSolutions, ensemble_integrate, sweep
from .grid2d import ensemble_spatial_integrate, grid2d_mesh
from .sharding import ensemble_mesh, sharded_ensemble_integrate
from .spatial import grid_mesh, spatial_integrate

__all__ = [
    "EnsembleSolutions",
    "ensemble_integrate",
    "sweep",
    "ensemble_mesh",
    "sharded_ensemble_integrate",
    "spatial_integrate",
    "grid_mesh",
    "ensemble_spatial_integrate",
    "grid2d_mesh",
]
