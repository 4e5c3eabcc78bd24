"""Model registry — functional analog of the reference's multiple dispatch.

The reference registers physics steppers by defining methods
``Infrastructure.step!(::Val{:Classic}, ...)`` (/root/reference/src/classic.jl:37)
and ``Infrastructure.step!(::Val{:MIZ}, ...)`` (/root/reference/src/miz.jl:150).
Here each model is a :class:`ModelSpec` of pure functions that the integrate
driver composes into a jitted ``lax.scan``:

- ``statics(st, par, dtype)`` — traced per-run precompute (insolation tables,
  stencil bands scaled by traced parameters, scalar combos). Runs *inside*
  jit so parameter ensembles vmap over it with zero recompilation.
- ``init_carry(init, st, dtype)`` — build the scan carry from user initial
  conditions.
- ``step(carry, xs, statics, par, geom, cfg)`` — one physics step:
  ``(carry, xs) -> (carry, outputs)``.
- ``step_inputs(statics, fyear)`` — per-step scan inputs for one year.
- ``solution_vars`` — variables recorded in Solutions storage (reference
  ``solvars``, /root/reference/src/infrastructure.jl:621-624).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

__all__ = [
    "ModelSpec", "StepConfig", "default_step_config",
    "register_model", "get_model", "available_models",
]


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """Numerics knobs for a run (static — part of the jit cache key)."""

    solver: str = "pcr"  # tridiagonal solver: 'pcr' (parallel) | 'thomas'
    newton_max_iter: int = 30
    newton_abstol: float = 1e-8  # reference reltol/abstol (/root/reference/src/miz.jl:58-59)
    newton_reltol: float = 1e-6
    newton_max_step: float = None  # trust-region-style step cap (float32 safeguard)
    verbose: bool = False  # warn on Newton non-convergence (reference :61-63)
    spatial_axis: str = None  # mesh axis name when the grid axis is sharded
    # member-axis mesh name when members are sharded: the Newton loop
    # CONDITION is then OR-reduced over it so every device runs the same
    # trip count (per-member norms/tolerances untouched) — the unsharded
    # run's count, so a sharded ensemble keeps one device's arithmetic;
    # under a 2-D (members x grid) mesh divergent while_loop counts across
    # member rows would also deadlock runtimes whose collective rendezvous
    # is global
    batch_axis: str = None


SOLVERS = ("pcr", "thomas")
# removed solver names -> what replaced them
_REMOVED_SOLVERS = {
    "pallas": "the fixed-iteration Pallas Newton kernel was removed",
    "pcr_fused": "the Pallas PCR kernel was removed",
}


def check_solver(solver: str) -> None:
    """Raise a clear ValueError for a removed or unknown solver name."""
    if solver in _REMOVED_SOLVERS:
        raise ValueError(
            f"solver={solver!r} is no longer available "
            f"({_REMOVED_SOLVERS[solver]}); use solver='pcr' (the default) "
            "or 'thomas'")
    if solver not in SOLVERS:
        raise ValueError(
            f"unknown solver {solver!r}; expected one of {SOLVERS}")


def default_step_config(dtype_name: str, solver: str = "pcr",
                        **overrides) -> StepConfig:
    """The per-dtype Newton tolerances every driver shares.

    float64 (the parity config): tighter than the reference's (1e-8, 1e-6) —
    the trajectory is sensitive at the ice edge, so the root is driven near
    the fp floor to keep solver noise out of the dynamics (warm starts keep
    the extra iterations ~0-1 per step).
    float32: residuals are O(100) W/m^2, so 0.5 absolute is ~eps-limited and
    physically far below any signal of interest; the step cap guards
    low-precision iterates (f64 converges unclipped).
    """
    if dtype_name == "float64":
        tol = dict(newton_abstol=1e-11, newton_reltol=1e-9)
    else:
        tol = dict(newton_abstol=0.5, newton_reltol=1e-4, newton_max_step=50.0)
    check_solver(solver)
    tol.update(overrides)
    return StepConfig(solver=solver, **tol)


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    statics: Callable
    init_carry: Callable
    step: Callable
    step_inputs: Callable
    solution_vars: Tuple[str, ...]
    init_vars: Tuple[str, ...]
    # variables whose stored values are NaN-masked for PRESENTATION in
    # healthy runs (ice-free/ice-covered cells, /root/reference/src/miz.jl:193-194);
    # NaN in any OTHER variable means the run diverged
    presentation_nan_vars: Tuple[str, ...] = ()


_REGISTRY: Dict[str, ModelSpec] = {}


def register_model(spec: ModelSpec) -> ModelSpec:
    _REGISTRY[spec.name] = spec
    return spec


def get_model(name: str) -> ModelSpec:
    """Resolve a model by name.

    ``'MIZ'`` and ``'Classic'`` match the reference's dispatch symbols; for
    ergonomics ``'classic'`` (the spelling used in the reference docstrings,
    /root/reference/src/infrastructure.jl:604) is accepted too.
    """
    key = {"classic": "Classic", "miz": "MIZ"}.get(name, name)
    if key not in _REGISTRY:
        raise ValueError(f"Unknown model {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def available_models():
    return sorted(_REGISTRY)
