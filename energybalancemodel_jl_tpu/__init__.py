"""energybalancemodel_jl_tpu — an accelerator-native energy-balance-model framework.

A brand-new JAX/XLA framework with the capabilities of
``waylonwh/EnergyBalanceModel.jl`` (mounted read-only at /root/reference):
the classic Wagner–Eisenman 2015 diffusive EBM with sea ice
(:mod:`.models.classic`) and the extended marginal-ice-zone model
(:mod:`.models.miz`), integrated as a jit-compiled ``lax.scan`` with
``vmap`` ensembles and multi-chip data parallelism over a device mesh
(:mod:`.parallel`).

The public API mirrors the reference's export list
(/root/reference/src/EnergyBalanceModel.jl:79-82)::

    import energybalancemodel_jl_tpu as ebm

    st = ebm.SpaceTime.sin(180, 2000, 30)
    forcing = ebm.Forcing(0.0)
    par = ebm.default_parameters("MIZ")
    init = ebm.Collection(
        Ei=np.zeros(st.nx), Ew=np.zeros(st.nx), h=np.zeros(st.nx),
        D=np.zeros(st.nx), phi=np.zeros(st.nx),
    )
    sols = ebm.integrate("MIZ", st, forcing, par, init)
    ebm.save(sols, "./miz_sol.h5")
    ebm.plot_raw(sols)
"""
from __future__ import annotations

import numpy as _np

from .forcing import Forcing
from .integrate import integrate
from .params import classic_paramset, default_parameters, default_parval, miz_paramset
from .solutions import Seasonal, Solutions, annual_mean
from .spacetime import SpaceTime
from .utils import (
    Collection,
    Progress,
    crossmean,
    hemispheric_mean,
    house,
    retrieve,
    safehouse,
    update,
)

# The reference's `Vec` alias (/root/reference/src/infrastructure.jl:13).
Vec = _np.ndarray


def zeros_init(st, model: str = "MIZ") -> Collection:
    """All-zero initial conditions for ``model`` on grid ``st`` — the
    canonical test configuration (/root/reference/test/runtests.jl:25-31)."""
    from .models.base import get_model

    return Collection({v: _np.zeros(st.nx) for v in get_model(model).init_vars})


# IO and plotting are imported lazily-but-eagerly here; they depend only on
# h5py/matplotlib which are part of the baked environment.
from .calibrate import CalibrationResult, calibrate  # noqa: E402
from .equilibrium import (ContinuationResult, EquilibriumResult,  # noqa: E402
                          StabilityResult, continuation, equilibrate,
                          stability)
from .fold import FoldResult, fold  # noqa: E402
from .basins import (BasinResult, EdgeResult, EdgeStateResult,  # noqa: E402
                     basins, blend_states, edge, edge_state, stack_states,
                     unstable_branch)
from .sensitivity import SensitivityResult, sensitivity  # noqa: E402
from .lyapunov import LyapunovResult, lyapunov  # noqa: E402
from .stochastic import TransitionResult, transitions  # noqa: E402
from .io import load, load_into, save, unsafeload, unsafesave  # noqa: E402
from .plot import (  # noqa: E402
    Layout,
    backend,
    plot_avg,
    plot_basins,
    plot_bifurcation,
    plot_continuation,
    plot_edge,
    plot_fold,
    plot_sensitivity,
    plot_lyapunov,
    plot_raw,
    plot_seasonal,
    plot_transitions,
)

__all__ = [
    "Vec",
    "Collection",
    "SpaceTime",
    "Forcing",
    "Solutions",
    "Seasonal",
    "integrate",
    "default_parameters",
    "default_parval",
    "miz_paramset",
    "classic_paramset",
    "annual_mean",
    "crossmean",
    "hemispheric_mean",
    "safehouse",
    "house",
    "retrieve",
    "save",
    "load",
    "load_into",
    "unsafesave",
    "unsafeload",
    "Layout",
    "backend",
    "plot_raw",
    "plot_avg",
    "plot_seasonal",
    "plot_bifurcation",
    "plot_continuation",
    "plot_fold",
    "plot_edge",
    "plot_basins",
    "plot_sensitivity",
    "plot_lyapunov",
    "Progress",
    "update",
    "zeros_init",
    "calibrate",
    "CalibrationResult",
    "equilibrate",
    "continuation",
    "ContinuationResult",
    "stability",
    "StabilityResult",
    "EquilibriumResult",
    "fold",
    "FoldResult",
    "basins",
    "BasinResult",
    "edge",
    "EdgeResult",
    "edge_state",
    "EdgeStateResult",
    "unstable_branch",
    "blend_states",
    "stack_states",
    "sensitivity",
    "SensitivityResult",
    "lyapunov",
    "LyapunovResult",
    "transitions",
    "TransitionResult",
    "plot_transitions",
]

__version__ = "0.1.0"
