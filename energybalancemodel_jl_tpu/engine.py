"""The ``engine='auto'`` policy shared by the four drivers.

Two XLA engine families run a simulated year:

- the per-year scan engines — ``'scan'`` in :func:`..integrate.integrate`
  and :func:`..stochastic.transitions`, ``'batched'``/``'vmap'`` in the
  ensemble drivers — built by :func:`..integrate.make_year_fn`;
- the whole-year engine ``'fused'`` (:mod:`.ops.year`), which adds
  per-member insolation sweeps, per-step noise and crossing records, and
  is the year map the ``mesh=`` paths shard.

:func:`auto_whole_year` decides between them for ``engine='auto'`` the same
way on every backend; there is no platform branch.
"""
from __future__ import annotations

__all__ = ["WHOLE_YEAR_MODELS", "auto_whole_year", "check_whole_year"]

WHOLE_YEAR_MODELS = frozenset({"MIZ", "Classic"})


def check_whole_year(model_name: str, hint: str) -> None:
    """Raise for ``engine='fused'`` on a model without a whole-year engine;
    ``hint`` names the per-year alternative."""
    if model_name not in WHOLE_YEAR_MODELS:
        raise ValueError(
            f"engine='fused' has no whole-year kernel for model "
            f"{model_name!r}; use {hint}")


def auto_whole_year(model_name: str, *, per_year_only: bool = False) -> bool:
    """True when ``engine='auto'`` should run the whole-year engine: for
    every model that has one, unless the run needs a feature only the
    per-year engines have (a debug hook, sub-year progress ticks, the Thomas
    solver, a sharding ``jit_wrapper``, every year's raw steps).

    Measured through the public drivers on one H100 80GB HBM3 (700 W),
    float32, canonical grid, seconds per call, per-year vs whole-year
    (PERF.md "Bring-up"): ``integrate`` 8 years, MIZ 1.40 vs 1.30, Classic
    0.347 vs 0.352; ``sweep`` K=8192 2 years, MIZ 3.79 vs 3.83 (float64 6.73
    vs 6.66), Classic 1.30 vs 1.07; ``equilibrate`` K=1024 3 years 1.31 vs
    1.29; ``transitions`` K=1024 3 years 0.41 vs 0.31. The whole-year engine
    led or stayed within 1.5% there; the MIZ sweep swung 6% either way
    across four calls. The larger gaps are the per-year drivers' own host
    work, since at K=8192 the year programs time within 2% of each other."""
    return model_name in WHOLE_YEAR_MODELS and not per_year_only
