"""Basin-of-attraction mapping and basin-boundary (edge) tracking.

No reference analog — the reference explores multistability only through
forcing-ramp hysteresis runs (/root/reference/src/plot.jl:173-225). Here
the INITIAL-CONDITION space is probed directly: :func:`basins`
equilibrates an ensemble of K initial states in lockstep and clusters
the converged states into attractors by their seasonal ice area (the
package's shared diagnostic, :func:`~energybalancemodel_jl_tpu.fold.
seasonal_ice_area`); :func:`edge` bisects the basin BOUNDARY along the
straight line between two states in different basins — the
initial-condition-space companion of :func:`~energybalancemodel_jl_tpu.
fold.fold` (which bisects in parameter space).

The accelerator leverage is the same lockstep-ensemble trick fold uses: members
carry DIFFERENT second parameters (e.g. ``par["D"] = np.linspace(...)``
or per-member forcing via ``par["F"]``), so one ensemble equilibration
probes every member's own blend weight at once — K basin-boundary
locations cost ``steps`` ensemble solves (``engine='auto'``).

Caveat (critical slowing down): trajectories from initial conditions
NEAR the basin boundary linger on the boundary's saddle (the "edge
state") before falling to either attractor, so tight brackets need
larger ``max_years`` — exactly the fold caveat, in state space. A probe
that has not settled is classified by its final state anyway and flagged
in ``probe_converged``; a probe whose state goes NON-FINITE keeps its
bracket that step instead (its masked ice area would read 0 — an
artifact, not a diagnostic), is flagged in ``probe_finite``, and later
probes for that member step off-center so the deterministic divergence
at the held midpoint is not replayed verbatim.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Sequence, Union

import numpy as np

from .equilibrium import EquilibriumResult, StabilityResult, equilibrate
from .fold import seasonal_ice_area
from .forcing import Forcing
from .spacetime import SpaceTime
from .utils.collection import Collection

__all__ = ["basins", "edge", "edge_state", "unstable_branch",
           "blend_states", "stack_states",
           "BasinResult", "EdgeResult", "EdgeStateResult"]


def stack_states(states: Sequence[Collection]) -> Collection:
    """Stack a sequence of (unbatched) state Collections into one
    member-batched Collection with ``(K, ...)`` leaves — the ``inits``
    format :func:`basins` consumes."""
    states = [Collection(s) for s in states]
    if not states:
        raise ValueError("stack_states needs at least one state")
    keys = set(states[0].keys())
    for s in states[1:]:
        if set(s.keys()) != keys:
            raise ValueError(
                f"states carry different variables: {sorted(keys)} vs "
                f"{sorted(s.keys())}")
    return Collection({
        k: np.stack([np.asarray(s[k], dtype=np.float64) for s in states])
        for k in states[0]
    })


def blend_states(a, b, w) -> Collection:
    """Linear interpolation ``(1-w)*a + w*b`` of two state Collections.

    Scalar ``w`` keeps the input shapes. An array ``w`` of shape ``(K,)``
    produces a member-batched Collection: 1-D leaves are treated as
    UNBATCHED per-member fields and lifted to ``(K, nx)``; leaves of
    ``ndim >= 2`` whose leading axis is ``K`` are treated as already
    member-batched (per-member endpoints) and blended along it.
    """
    a, b = Collection(a), Collection(b)
    if set(a.keys()) != set(b.keys()):
        raise ValueError(
            f"endpoint states carry different variables: "
            f"{sorted(a.keys())} vs {sorted(b.keys())}")
    w = np.asarray(w, dtype=np.float64)
    out = Collection()
    for k in a:
        va = np.asarray(a[k], dtype=np.float64)
        vb = np.asarray(b[k], dtype=np.float64)
        va, vb = np.broadcast_arrays(va, vb)
        if w.ndim == 0:
            out[k] = (1.0 - w) * va + w * vb
        elif va.ndim >= 2 and va.shape[0] == w.shape[0]:
            ww = w.reshape((w.shape[0],) + (1,) * (va.ndim - 1))
            out[k] = (1.0 - ww) * va + ww * vb
        else:
            ww = w.reshape(w.shape + (1,) * va.ndim)
            out[k] = (1.0 - ww) * va[None] + ww * vb[None]
    return out


@dataclasses.dataclass
class BasinResult:
    """Result of :func:`basins`.

    ``labels`` assigns each member an attractor index (``-1`` where the
    equilibration did not converge — those members are excluded from the
    clustering); ``centroids`` are the per-attractor mean ice areas in
    ascending order, ``counts`` the member count per attractor. ``areas``
    is every member's own diagnostic value, ``result`` the underlying
    lockstep :class:`EquilibriumResult` (full converged states in
    ``result.state``).
    """

    labels: np.ndarray
    areas: np.ndarray
    centroids: np.ndarray
    counts: np.ndarray
    season: str
    gap: float
    result: EquilibriumResult
    spacetime: SpaceTime
    par: Optional[Collection] = None

    @property
    def n_basins(self) -> int:
        """Number of distinct attractors among the converged members."""
        return len(self.centroids)

    @property
    def fractions(self) -> np.ndarray:
        """Converged-member fraction per attractor (basin sizes under
        the sampling measure of ``inits``)."""
        tot = int(self.counts.sum())
        return self.counts / max(tot, 1)

    def members(self, label: int) -> np.ndarray:
        """Indices of the members that landed in attractor ``label``."""
        return np.flatnonzero(self.labels == label)

    def __repr__(self):
        c = np.array2string(self.centroids, precision=3)
        bad = int(np.count_nonzero(self.labels < 0))
        extra = f", {bad} unconverged" if bad else ""
        return (f"BasinResult({self.n_basins} attractors, areas {c}, "
                f"counts {self.counts.tolist()}{extra})")


def _cluster_1d(values: np.ndarray, gap: float):
    """Gap-threshold clustering of a 1-D diagnostic: sorted values are
    split wherever consecutive members are more than ``gap`` apart.
    Returns (labels ascending by centroid, centroids, counts)."""
    order = np.argsort(values)
    labels = np.empty(len(values), dtype=np.int64)
    cluster = 0
    for i, idx in enumerate(order):
        if i and values[idx] - values[order[i - 1]] > gap:
            cluster += 1
        labels[idx] = cluster
    n = cluster + 1
    centroids = np.array([values[labels == c].mean() for c in range(n)])
    counts = np.array([int(np.count_nonzero(labels == c))
                       for c in range(n)])
    return labels, centroids, counts


_SEASONS = ("winter", "summer", "avg")


def _finite_members(res, K: int) -> np.ndarray:
    """Per-member all-finite flags of an equilibration's state. The ice-
    area diagnostic maps a diverged (NaN) state to area 0 (classic's
    ``E < 0`` indicator compares False, MIZ's ``nan_to_num`` zeroes
    ``phi``), so a NaN probe must never be CLASSIFIED off its area —
    it would deterministically read as the low-area attractor.

    Batchedness comes from the result itself (``member_years`` is set
    exactly for ensemble solves, and ensemble state leaves are fully
    K-batched), NOT from a shape heuristic — an unbatched leaf whose
    leading dim coincidentally equals K must not be misread per-member
    (review r2/r3; cf. the eval_shape-based exact detection in the
    statics specs)."""
    if getattr(res, "member_years", None) is None:
        # solo solve: one whole-state flag
        ok = all(bool(np.isfinite(np.asarray(v)).all())
                 for v in res.state.values())
        return np.full(K, ok)
    ok = np.ones(K, dtype=bool)
    for v in res.state.values():
        arr = np.asarray(v)
        if arr.ndim >= 1 and arr.shape[0] == K:
            ok &= np.isfinite(arr.reshape(K, -1)).all(axis=1)
        else:  # defensively: a shared leaf poisons every member
            ok &= bool(np.isfinite(arr).all())
    return ok


def basins(
    model: str,
    st: SpaceTime,
    par: Collection,
    inits,
    forcing: Union[Forcing, float] = 0.0,
    season: str = "avg",
    gap: float = np.pi / 4,
    tol: float = 1e-2,
    max_years: int = 300,
    **equilibrate_kwargs,
) -> BasinResult:
    """Map which attractor each of K initial states falls to.

    ``inits`` is a member-batched state Collection (``(K, nx)`` leaves)
    or a sequence of unbatched states (stacked via :func:`stack_states`);
    :func:`blend_states` builds interpolation families. All K states
    equilibrate in ONE lockstep ensemble
    (:func:`~energybalancemodel_jl_tpu.equilibrium.equilibrate`), then
    the converged members are
    clustered into attractors by seasonal ice area: sorted areas split
    wherever consecutive members are more than ``gap`` apart (default
    pi/4 — the classic warm/snowball separation is O(pi)). Distinct
    attractors closer than ``gap`` in ice area merge into one cluster —
    shrink ``gap`` or classify ``result.state`` directly if that
    matters. Unconverged members get label ``-1`` and are excluded.

    ``par`` may sweep a parameter across members as usual, but then the
    clustering mixes attractors of DIFFERENT systems — the typical use
    fixes ``par`` and varies only the initial states. Remaining keywords
    pass to ``equilibrate``. Returns a :class:`BasinResult`.
    """
    if season not in _SEASONS:
        raise ValueError(f"season must be one of {_SEASONS}, "
                         f"got {season!r}")
    if isinstance(inits, (list, tuple)):
        inits = stack_states(inits)
    par = Collection(par)
    result = equilibrate(model, st, forcing, par, inits, tol=tol,
                         max_years=max_years, **equilibrate_kwargs)
    areas = np.atleast_1d(np.asarray(
        seasonal_ice_area(getattr(result.seasonal, season), st),
        dtype=np.float64))
    K = areas.shape[0]
    # a non-finite state's area is a masking artifact, not a diagnostic:
    # exclude such members from the clustering like unconverged ones
    conv = (np.broadcast_to(np.atleast_1d(result.converged), (K,))
            & _finite_members(result, K))

    labels = np.full(K, -1, dtype=np.int64)
    if conv.any():
        sub, centroids, counts = _cluster_1d(areas[conv], float(gap))
        labels[conv] = sub
    else:
        centroids = np.empty(0)
        counts = np.empty(0, dtype=np.int64)
    return BasinResult(labels=labels, areas=areas, centroids=centroids,
                       counts=counts, season=season, gap=float(gap),
                       result=result, spacetime=st, par=par)


@dataclasses.dataclass
class EdgeResult:
    """Result of :func:`edge`.

    ``wa``/``wb`` are the final per-member bracket weights (the blend
    falls to ``a``'s attractor at ``wa``, to ``b``'s at ``wb``);
    ``values`` their midpoints — the basin-boundary crossing along the
    ``a → b`` line. ``history`` stacks ``(wa, wb)`` after each step,
    shape ``(steps, 2, K)``.

    A probe can fail two distinct ways, told apart by two per-step
    ``(steps, K)`` masks (review r2):

    - ``probe_finite`` False — the probe state went NON-FINITE. Its
      masked ice area is an artifact, so that step HELD the bracket
      (``in_a`` is meaningless there) and the next step re-probes at a
      nudged off-center weight to escape the diverging blend.
    - ``probe_converged`` False with ``probe_finite`` True — the probe
      ran out of ``max_years`` but its final state was finite; it WAS
      classified by ``in_a`` and the bracket MOVED. Near the boundary
      (critical slowing down, module docstring) this classification can
      be wrong — re-run/resume with a larger ``max_years``.

    ``ok`` flags members whose every probe converged. ``result_a``/
    ``result_b`` are the converged endpoint attractors, ``area_a``/
    ``area_b`` their diagnostics.
    """

    wa: np.ndarray
    wb: np.ndarray
    history: np.ndarray
    in_a: np.ndarray
    probe_converged: np.ndarray
    probe_finite: np.ndarray
    area_a: np.ndarray
    area_b: np.ndarray
    a: Collection
    b: Collection
    result_a: EquilibriumResult
    result_b: EquilibriumResult
    spacetime: SpaceTime
    season: str = "avg"
    par: Optional[Collection] = None

    @property
    def values(self) -> np.ndarray:
        """Per-member boundary-crossing estimates (bracket midpoints)."""
        return 0.5 * (self.wa + self.wb)

    @property
    def width(self) -> np.ndarray:
        """Final bracket widths ``|wb - wa|``."""
        return np.abs(self.wb - self.wa)

    @property
    def ok(self) -> np.ndarray:
        """True per member when every probe along its bisection
        converged."""
        return self.probe_converged.all(axis=0)

    def states(self) -> Collection:
        """The blended states AT the boundary estimates — initial
        conditions on (numerically, astride) the basin boundary, the
        starting point for edge-state (saddle) refinement
        (:meth:`refine`)."""
        return blend_states(self.a, self.b, self.values)

    def refine(self, model: str, forcing=0.0, member: int = 0,
               **kwargs) -> "EdgeStateResult":
        """Refine member ``member``'s boundary crossing into the EDGE
        STATE (the boundary saddle) via :func:`edge_state`.

        Slices that member's final bracket states, scalar parameters
        (``(K,)`` sweep leaves reduce to the member's value, including a
        virtual ``par["F"]``), and attractor reference areas out of this
        result, so the endpoint equilibrations are never re-paid.
        ``model`` and ``forcing`` must repeat the :func:`edge` call's
        (the result does not store them); remaining keywords pass to
        :func:`edge_state`.
        """
        K = len(np.atleast_1d(self.wa))
        m = int(member)
        if not 0 <= m < K:
            raise ValueError(f"member {m} out of range for K={K}")

        def slice_state(s):
            return Collection({
                k: (np.asarray(v)[m] if np.ndim(v) >= 2
                    and np.shape(v)[0] == K else np.asarray(v))
                for k, v in s.items()
            })

        par_m = None
        if self.par is not None:
            par_m = Collection({
                k: (np.asarray(v)[m] if np.ndim(v) == 1
                    and np.shape(v)[0] == K else v)
                for k, v in self.par.items()
            })
        a_m, b_m = slice_state(self.a), slice_state(self.b)
        wa = float(np.atleast_1d(self.wa)[m])
        wb = float(np.atleast_1d(self.wb)[m])
        kwargs.setdefault("season", self.season)
        return edge_state(
            model, self.spacetime, par_m if par_m is not None
            else Collection(), blend_states(a_m, b_m, wa),
            blend_states(a_m, b_m, wb), forcing=forcing,
            refs=(float(np.atleast_1d(self.area_a)[m]),
                  float(np.atleast_1d(self.area_b)[m])), **kwargs)

    def __repr__(self):
        v = np.array2string(self.values, precision=4)
        return (f"EdgeResult(w* = {v}, width {float(self.width.max()):.3g}, "
                f"{int(np.count_nonzero(self.ok))}/{len(self.wa)} members "
                f"fully converged)")


def edge(
    model: str,
    st: SpaceTime,
    par: Collection,
    a,
    b,
    forcing: Union[Forcing, float] = 0.0,
    steps: int = 15,
    season: str = "avg",
    jump_tol: float = np.pi / 2,
    tol: float = 1e-2,
    max_years: int = 300,
    progress: bool = False,
    checkpoint: Optional[str] = None,
    resume: bool = False,
    **equilibrate_kwargs,
) -> EdgeResult:
    """Bisect the basin boundary along the line between states ``a``
    and ``b``, per ensemble member.

    ``a`` and ``b`` are state Collections that must fall to DIFFERENT
    attractors (verified: both endpoint blends are equilibrated first,
    must fully converge, and their seasonal ice areas must separate by
    at least ``jump_tol`` for every member). The bisection then shrinks
    the bracket ``[wa, wb]`` (blend weights, starting from ``[0, 1]``)
    by ``2**-steps``: each probe equilibrates the blended state
    ``(1-w)*a + w*b`` and is classified to whichever endpoint attractor
    its ice area is nearer. Unlike :func:`~energybalancemodel_jl_tpu.
    fold.fold`, the references are STATIC — the two attractors are fixed
    (the parameter does not move), so the endpoint areas classify every
    probe.

    ``par`` leaves of shape ``(K,)`` (or the virtual forcing key
    ``"F"``) sweep a second parameter across members — each member then
    bisects its own boundary, in lockstep, against its own endpoint
    attractors; ``a``/``b`` may be shared (1-D leaves) or per-member
    (``(K, nx)`` leaves, :func:`blend_states` rules). All remaining
    keywords (``engine``/``mesh``/``anderson``/``dtype``/...) pass to
    ``equilibrate``. Returns an :class:`EdgeResult`; ``.states()``
    recovers the near-boundary blends for edge-state work.

    ``checkpoint=`` names a file that records the search after the
    endpoint stage and again after every completed bisection step
    (brackets, histories, the two converged endpoint attractors and
    their reference areas — atomic whole-file writes); ``resume=True``
    reloads it and replays only the remaining steps, bit-exactly
    identical to an uninterrupted run, never re-paying the endpoint
    solves. ``steps`` is deliberately EXCLUDED from the fingerprint, so
    a resume may extend the refinement; everything that changes a
    probe's outcome (model, grid, parameters, forcing, endpoint states,
    tolerances, equilibrate options) is covered, and a mismatch warns
    and restarts — the same contract as :func:`~energybalancemodel_jl_tpu.
    fold.fold`'s checkpoints.
    """
    if not isinstance(forcing, Forcing):
        forcing = Forcing(float(forcing))
    if not forcing.constant:
        raise ValueError("edge needs a constant base forcing")
    if steps < 1:
        raise ValueError("steps must be >= 1")
    if season not in _SEASONS:
        raise ValueError(f"season must be one of {_SEASONS}, "
                         f"got {season!r}")
    par = Collection(par)
    a, b = Collection(a), Collection(b)
    if set(a.keys()) != set(b.keys()):
        raise ValueError(
            f"endpoint states carry different variables: "
            f"{sorted(a.keys())} vs {sorted(b.keys())}")

    K = max(
        max((v.size for v in map(np.asarray, par.values())
             if v.ndim == 1), default=1),
        max((np.asarray(v).shape[0] for c in (a, b) for v in c.values()
             if np.asarray(v).ndim >= 2), default=1),
    )

    def solve(init):
        return equilibrate(model, st, forcing, par, init, tol=tol,
                           max_years=max_years, **equilibrate_kwargs)

    def area_of(res):
        v = seasonal_ice_area(getattr(res.seasonal, season), st)
        return np.broadcast_to(np.atleast_1d(v), (K,)).astype(np.float64)

    ckpt_key = None
    if checkpoint is not None or resume:
        if checkpoint is None:
            raise ValueError("resume=True needs checkpoint=<path>")
        from . import checkpoint as ckpt_mod

        # steps deliberately excluded: a resume may EXTEND the refinement
        ckpt_key = ckpt_mod.search_key(
            "edge", model, st, forcing, par, equilibrate_kwargs,
            extras=(f"a#{ckpt_mod.digest_collection(a)}",
                    f"b#{ckpt_mod.digest_collection(b)}",
                    f"jt={float(jump_tol)}", f"season={season}",
                    f"tol={float(tol)}", f"maxy={int(max_years)}"),
        )

    resumed = None
    if resume:
        from . import checkpoint as ckpt_mod

        resumed = ckpt_mod.try_resume_search(
            checkpoint, ckpt_key, "EdgeCheckpoint",
            ckpt_mod.read_edge_checkpoint)

    s_done = 0
    if resumed is not None:
        result_a, result_b = resumed["result_a"], resumed["result_b"]
        ref_a, ref_b = resumed["area_a"], resumed["area_b"]
        wa = np.asarray(resumed["wa"], dtype=np.float64)
        wb = np.asarray(resumed["wb"], dtype=np.float64)
        s_done = int(resumed["history"].shape[0])
        if s_done >= steps:  # already refined this far: report the slice
            h = resumed["history"][:steps]
            return EdgeResult(
                wa=h[-1, 0], wb=h[-1, 1], history=h,
                in_a=resumed["in_a"][:steps],
                probe_converged=resumed["conv"][:steps],
                probe_finite=resumed["finite"][:steps],
                area_a=ref_a, area_b=ref_b, a=a, b=b,
                result_a=result_a, result_b=result_b,
                spacetime=st, season=season, par=par)

    prog = None
    if progress:
        from .utils.progress import Progress

        if resumed is not None:
            total = steps - s_done
            first = f"resumed after step {s_done}"
        else:
            total = 2 + steps
            first = "equilibrating the a endpoint"
        prog = Progress(total, title="Edge", infofeed=lambda msg: msg)
        prog.update(0, feedargs=(first,))
    done = [0]

    def tick(msg):
        if prog is not None:
            done[0] += 1
            prog.update(done[0], feedargs=(msg,))

    if resumed is None:
        def endpoint(state, name):
            res = solve(state)
            conv = np.broadcast_to(np.atleast_1d(res.converged), (K,))
            if not conv.all():
                bad = np.flatnonzero(~conv)
                raise ValueError(
                    f"endpoint {name} did not converge for members "
                    f"{bad.tolist()} ({res!r}) — the attractor references "
                    f"must be trusted; raise max_years")
            return res

        result_a = endpoint(a, "a")
        tick("a endpoint converged")
        result_b = endpoint(b, "b")
        tick("b endpoint converged")
        ref_a, ref_b = area_of(result_a), area_of(result_b)
        close = np.flatnonzero(np.abs(ref_a - ref_b) < jump_tol)
        if close.size:
            raise ValueError(
                f"states a and b fall to attractors less than "
                f"jump_tol={jump_tol:g} apart in ice area for members "
                f"{close.tolist()} — same basin, or indistinguishable in "
                f"this diagnostic (try another season= or a smaller "
                f"jump_tol)")
        wa = np.zeros(K)
        wb = np.ones(K)

    history = np.empty((steps, 2, K))
    in_a_hist = np.empty((steps, K), dtype=bool)
    conv_hist = np.empty((steps, K), dtype=bool)
    finite_hist = np.empty((steps, K), dtype=bool)
    if s_done:
        history[:s_done] = resumed["history"]
        in_a_hist[:s_done] = resumed["in_a"]
        conv_hist[:s_done] = resumed["conv"]
        finite_hist[:s_done] = resumed["finite"]

    # trailing count of consecutive non-finite probes per member — drives
    # the off-center nudge below; recomputed from the finite history so a
    # resume replays the remaining steps bit-exactly (no extra file state)
    nonfin_streak = np.zeros(K, dtype=np.int64)
    for s in range(s_done):
        nonfin_streak = np.where(finite_hist[s], 0, nonfin_streak + 1)

    # probe weights as a bracket FRACTION: 0.5 normally; after a non-
    # finite probe the same midpoint would diverge identically forever
    # (deterministic solver), so the member's next probes step away from
    # center — any fraction in (0, 1) still shrinks its bracket
    _NUDGE = np.array([0.5, 0.45, 0.55, 0.4, 0.6, 0.35, 0.65, 0.3, 0.7])

    def write_ckpt(n):
        if ckpt_key is None:
            return
        from . import checkpoint as ckpt_mod

        ckpt_mod.write_edge_checkpoint(
            checkpoint, ckpt_key, result_a, result_b, ref_a, ref_b,
            wa, wb, history[:n], in_a_hist[:n], conv_hist[:n],
            finite_hist[:n])

    if resumed is None:
        # record the endpoint stage so an interruption in step 1 does
        # not repeat those solves on resume
        write_ckpt(0)

    for s in range(s_done, steps):
        frac = _NUDGE[np.minimum(nonfin_streak, len(_NUDGE) - 1)]
        mid = wa + frac * (wb - wa)
        probe = solve(blend_states(a, b, mid))
        area = area_of(probe)
        # a diverged (non-finite) probe carries no basin information —
        # its area reads 0 through the NaN masking and would always
        # classify as the low-area attractor; such members keep their
        # bracket this step and are flagged unconverged
        finite = _finite_members(probe, K)
        nonfin_streak = np.where(finite, 0, nonfin_streak + 1)
        in_a = np.abs(area - ref_a) <= np.abs(area - ref_b)
        wa = np.where(in_a & finite, mid, wa)
        wb = np.where(~in_a & finite, mid, wb)
        history[s, 0], history[s, 1] = wa, wb
        in_a_hist[s] = in_a
        finite_hist[s] = finite
        conv_hist[s] = (np.broadcast_to(
            np.atleast_1d(probe.converged), (K,)) & finite)
        write_ckpt(s + 1)
        tick(f"step {s + 1}/{steps}: max width "
             f"{float(np.abs(wb - wa).max()):.4g}")

    return EdgeResult(wa=wa, wb=wb, history=history, in_a=in_a_hist,
                      probe_converged=conv_hist, probe_finite=finite_hist,
                      area_a=ref_a, area_b=ref_b, a=a, b=b,
                      result_a=result_a, result_b=result_b, spacetime=st,
                      season=season, par=par)


@dataclasses.dataclass
class EdgeStateResult:
    """Result of :func:`edge_state` — a refined EDGE STATE (the saddle
    on the basin boundary).

    ``state`` is the refined year-map fixed-point estimate (a full carry
    Collection — pass it to :func:`~energybalancemodel_jl_tpu.equilibrium.
    stability` or as an ``init``); ``area`` its seasonal ice area
    (strictly between the two attractors' areas); ``resid`` the year-map
    stationarity ``||year(state) - state||_inf`` over the carry (a true
    saddle has resid 0 despite being non-attracting; the classic step
    albedo floors this at O(1) — see :func:`edge_state`). ``converged``
    is ``resid <= tol`` and ``polish_nfev`` counts the Gauss-Newton
    polish's residual evaluations (0 when the polish was skipped).

    Per-stage diagnostics (each of length ``stages_run``): ``drift`` is
    the max-abs metric change of the tracked midpoint from the previous
    stage (the tracker's own convergence measure — NaN for stage 0),
    ``tracked_years`` how many years that stage's flight advanced along
    the boundary, and ``separation`` the flown pair's final ice-area
    separation (commitment monitor — small means the pair still
    straddles the boundary tightly).

    ``stability`` (unless disabled) is the year-map spectrum AT the
    refined state via ``side="right"``: a genuine saddle reports
    ``growth > 1`` with ``mode`` the PHYSICAL unstable direction — the
    spatial pattern along which trajectories leave the boundary.
    """

    state: Collection
    area: float
    resid: float
    drift: np.ndarray
    tracked_years: np.ndarray
    separation: np.ndarray
    converged: bool
    stability: Optional[StabilityResult]
    spacetime: SpaceTime
    season: str = "avg"
    par: Optional[Collection] = None
    polish_nfev: int = 0

    @property
    def stages_run(self) -> int:
        return len(self.drift)

    def __repr__(self):
        g = ""
        if self.stability is not None:
            lead = np.asarray(self.stability.growth).reshape(-1)[0]
            g = f", |lambda| ~ {float(lead):.4g}"
        conv = "converged" if self.converged else "NOT converged"
        return (f"EdgeStateResult(area {float(self.area):.4f}, resid "
                f"{float(self.resid):.3g}, {self.stages_run} stages, "
                f"{conv}{g})")


def _member_state(state: Collection, k: int, K: int) -> Collection:
    """Member ``k`` of an ensemble carry: ``(K, ...)`` leaves sliced,
    shared 1-D leaves kept (ensemble carries are fully K-batched, so the
    fallthrough only fires for genuinely shared leaves)."""
    return Collection({
        key: (np.asarray(v)[k] if np.ndim(v) >= 2
              and np.shape(v)[0] == K else np.asarray(v))
        for key, v in state.items()
    })


# Practical envelope of the dense polish: nt * nx * state_dim, ~2x the
# largest measured-practical configuration (MIZ nx=48/nt=1000 = 1.38e7
# units, 7.2 s/Jacobian eval on this host class — see the guard below)
_POLISH_UNIT_CAP = 3e7


def _polish_fixed_point(model: str, st: SpaceTime, forcing: Forcing,
                        par: Collection, state: Collection, dtype,
                        max_nfev: int):
    """Trust-region Gauss-Newton polish of a year-map fixed point.

    Flattens the carry, and minimizes ``||G(x) - x||_2`` with scipy's
    ``least_squares`` (TRF) using the exact reverse-mode Jacobian
    (``jax.jacrev`` through the compiled year — one vmapped reverse year
    per Jacobian evaluation). A trust region is ESSENTIAL here, not a
    nicety: the classic model's step albedo (``aw*(E>0) + ai*(E<0)``,
    /root/reference/src/classic.jl:47) makes the year map piecewise
    smooth with kink surfaces wherever any (cell, step) crosses ``E=0``,
    so a plain Newton step overshoots its linearization radius and
    stalls an order of magnitude high (measured at the nx=8/nt=1000
    saddle: damped Newton stalls at ``||G(x)-x||_inf ~ 8.7``, TRF
    reaches ``~0.7`` — the same class as the albedo-hole attractor
    wobble, which is the model's genuine stationarity floor).

    ``max_nfev=0`` skips the optimization and just evaluates the
    residual at ``state``. Returns ``(state, resid_inf, nfev)`` with
    numpy leaves. Dense: cost scales with the state dimension (fine at
    diagnostic grids; the saddle hunt is not a production-throughput
    path) — guarded by ``_POLISH_UNIT_CAP`` below.
    """
    import jax
    import jax.numpy as jnp

    from .integrate import default_dtype, make_year_fn
    from .models.base import default_step_config, get_model

    spec = get_model(model)
    dtype = jnp.dtype(dtype if dtype is not None else default_dtype())
    par = Collection(par)
    par.pop("__K__", None)
    F_off = par.pop("F", None)
    if F_off is not None:  # scalar virtual-F leaf folds into the forcing
        forcing = Forcing(float(forcing.base) + float(np.asarray(F_off)))
    cfg = default_step_config(dtype.name)
    carry = spec.init_carry(state, st, dtype)
    keys_order = tuple(sorted(carry.keys()))
    widths = tuple(int(carry[k].shape[-1]) for k in keys_order)
    # Scale guard (advisor r3): one dense jacrev Jacobian costs one
    # reverse year per state coordinate — wall time tracks nt*nx*dim
    # (measured on this class of host: MIZ nx=48/nt=1000, dim=288 ->
    # 7.2 s per Jacobian eval, so a 200-nfev TRF polish is already
    # ~25 min; at nx=180/nt=2000, dim=1080, an eval extrapolates to
    # ~3 min and the polish to HOURS, with multi-GB scan activations).
    # Refuse beyond ~2x the measured-practical envelope instead of
    # silently hanging.
    if max_nfev >= 1:
        units = st.nt * st.nx * sum(widths)
        if units > _POLISH_UNIT_CAP:
            raise ValueError(
                f"dense Gauss-Newton polish at nx={st.nx}/nt={st.nt} "
                f"(state dim {sum(widths)}) needs ~{units / 1.9e6:.0f} s "
                f"PER Jacobian evaluation (extrapolated from measured "
                f"nt*nx*dim scaling) and O(max_nfev) of them — beyond "
                f"the practical envelope (nt*nx*dim <= {_POLISH_UNIT_CAP:.0e},"
                f" roughly nx <= 48 at nt=1000 for MIZ). Use a diagnostic "
                f"grid for the saddle hunt, or pass polish=False / "
                f"polish_max_nfev=0 to skip the polish")
    par_j = Collection({k: jnp.asarray(v, dtype) for k, v in par.items()})
    frow_j = jnp.asarray(forcing.table(st)[0], dtype=dtype)
    year = make_year_fn(model, st, cfg, dtype.name, False)

    def from_mat(x):
        out, i = {}, 0
        for k, w in zip(keys_order, widths):
            out[k] = x[..., i:i + w]
            i += w
        return Collection(out)

    def res_fn(x):
        nxt = year(from_mat(x), par_j, frow_j)[0]
        return jnp.concatenate([nxt[k] for k in keys_order], axis=-1) - x

    fj = jax.jit(res_fn)
    x0 = np.concatenate([np.asarray(carry[k], dtype=np.float64)
                         for k in keys_order], axis=-1)
    if max_nfev < 1:
        resid = float(np.max(np.abs(np.asarray(fj(jnp.asarray(x0, dtype))))))
        return from_mat(x0), resid, 0
    from scipy.optimize import least_squares

    jj = jax.jit(jax.jacrev(res_fn))

    def f_np(x):
        return np.asarray(fj(jnp.asarray(x, dtype)), dtype=np.float64)

    def j_np(x):
        return np.asarray(jj(jnp.asarray(x, dtype)), dtype=np.float64)

    # TRF can meet xtol on a kink flat spot well above the true floor;
    # re-running from the stall point RESETS the trust radius, which
    # escapes those (measured: 7.4 -> ~1 over two restarts at the
    # classic nx=8 saddle). Restart while the inf-norm keeps improving.
    x, nfev, resid = np.asarray(x0, dtype=np.float64), 0, np.inf
    while nfev < max_nfev:
        sol = least_squares(f_np, x, jac=j_np, method="trf", xtol=1e-14,
                            ftol=1e-14, gtol=1e-14,
                            max_nfev=int(max_nfev) - nfev)
        nfev += int(sol.nfev)
        new = float(np.max(np.abs(sol.fun)))
        if not new < 0.95 * resid:
            if new < resid:
                x, resid = sol.x, new
            break
        x, resid = sol.x, new
    return from_mat(x), resid, nfev


def edge_state(
    model: str,
    st: SpaceTime,
    par: Collection,
    a,
    b,
    forcing: Union[Forcing, float] = 0.0,
    stages: int = 6,
    probes: int = 14,
    rounds: int = 2,
    flight_years: int = 40,
    flight_chunk: int = 4,
    tol: float = 1.0,
    track_tol: Optional[float] = None,
    polish: bool = True,
    polish_max_nfev: int = 200,
    commit_years: int = 300,
    commit_tol: float = 1e-2,
    season: str = "avg",
    jump_tol: float = np.pi / 2,
    refs=None,
    metric: Optional[Sequence[str]] = None,
    stability_check: bool = True,
    stability_kwargs: Optional[dict] = None,
    progress: bool = False,
    **equilibrate_kwargs,
) -> EdgeStateResult:
    """Converge the EDGE STATE — the saddle on the basin boundary between
    the attractors of states ``a`` and ``b`` — by edge tracking.

    :func:`edge` locates where the boundary crosses the ``a -> b`` line;
    this refines that crossing INTO the boundary's own attractor, the
    saddle whose stable manifold IS the boundary (one unstable direction
    out of it). The classic model's known unstable intermediate branch —
    the partial-ice equilibrium between the warm and snowball states —
    is exactly this object. No reference analog (the reference never
    computes unstable equilibria; its hysteresis runs jump across them,
    /root/reference/src/plot.jl:173-225).

    The tracker alternates two moves, each a LOCKSTEP ensemble
    equilibration:

    1. **Multi-probe bisection** — ``probes`` blends between the current
       bracket pair integrate at once (``commit_years``/``commit_tol``);
       each probe classifies to the nearer attractor reference area, and
       the longest consistent A-prefix / B-suffix tightens the bracket
       by ~``probes + 1`` per round (non-finite probes stay inside the
       bracket). One round costs ONE ensemble solve — the K-ary version
       of :func:`edge`'s bisection.
    2. **Flight** — the bracket pair integrates forward in
       ``flight_chunk``-year hops (up to ``flight_years`` per stage);
       both members stay in their own basins, so the pair brackets the
       boundary the whole way while the boundary's internal dynamics
       contract it toward the saddle. Flying stops when the pair's
       ice-area separation exceeds a quarter of the attractor gap (the
       unstable direction has amplified the bracket width — time to
       re-bisect); if even one hop separates it, the stage re-bisects
       first and retries.

    Tracking alone cannot polish the estimate below the bracket's
    post-flight width (measured at nx=8/nt=1000: the midpoint hovers
    within a few ``E`` units of the saddle but never settles), so the
    stages serve ONE purpose — land inside the saddle's neighborhood.
    All ``stages`` run unless ``track_tol`` is set and the midpoint's
    stage-over-stage drift (max-abs over ``metric``'s leaves; default =
    every carry leaf — the MIZ carry has no ``"E"``) falls
    below it first. The refinement proper is then a trust-region
    Gauss-Newton solve of ``year(x) == x`` (scipy TRF on the flattened
    carry with the exact ``jacrev`` Jacobian, at most
    ``polish_max_nfev`` residual evaluations per start;
    ``polish=False`` skips it and reports the raw final midpoint). The
    trust region matters: the classic step albedo makes the year map
    piecewise smooth, and a plain damped Newton stalls an order of
    magnitude above the TRF floor (see :func:`_polish_fixed_point`).
    Because the kink structure pins different local floors around the
    saddle, EVERY stage's midpoint is a candidate start — polished
    last-first until one meets ``tol``, best kept.

    ``resid`` is the year-map stationarity ``||year(x) - x||_inf`` over
    the carry at the returned state and ``converged = resid <= tol``.
    ``tol`` defaults to 1.0 because the classic model cannot do better:
    its ``E==0`` albedo hole leaves an O(0.1)-O(1) wobble at ice-edge
    cells even on the ATTRACTORS (equilibrate's notes), and the
    measured saddle floor at nx=8/nt=1000 is ~0.7. Smooth models can
    take a much tighter ``tol``. Finally — the point of the exercise —
    the saddle's unstable eigenvalue/mode comes from
    :func:`~energybalancemodel_jl_tpu.equilibrium.stability` with
    ``side="right"`` (``stability_kwargs`` pass through, e.g.
    ``dict(n_iter=60, dtype="float64")``; ``stability_check=False``
    skips it): a genuine codimension-1 saddle reports exactly one
    ``|lambda| > 1`` (measured classic nx=8/nt=1000 F=10: 1.02-1.09
    then ~0.91, area 1.83 strictly between the warm 1.05 and snowball
    5.64 attractors).

    Coarse-grid honesty: on the classic model the boundary's relative
    attractor can be a CHATTERING set of the albedo hole rather than a
    point saddle — the polished state then reads ``|lambda| < 1`` from
    the infinitesimal linearization (which only sees the current kink
    cell) while finite perturbations still escape to both attractors.
    Stability there is SCALE-DEPENDENT; trust the escape behavior (blend
    the state a few percent toward each attractor and integrate — the
    test suite's straddle check), and read the spectrum as meaningful
    only when ``resid`` is small against the local kink spacing. Seeding
    the tracker near a known point saddle (tight endpoints + ``refs=``)
    recovers the clean one-unstable-mode reading.

    Solo only: ``par`` must not carry ``(K,)`` ensemble leaves and
    ``a``/``b`` must be unbatched — refine one member of a lockstep
    :func:`edge` run via :meth:`EdgeResult.refine`, which slices that
    member's bracket, parameters, and attractor references out for this
    function. ``refs=(area_a, area_b)`` supplies known attractor
    reference areas (skipping the endpoint equilibrations); remaining
    keywords pass to every ``equilibrate`` call (``dtype`` also selects
    the polish precision — float64 strongly recommended, as for
    :func:`~energybalancemodel_jl_tpu.equilibrium.stability`).
    """
    if not isinstance(forcing, Forcing):
        forcing = Forcing(float(forcing))
    if not forcing.constant:
        raise ValueError("edge_state needs a constant forcing")
    if season not in _SEASONS:
        raise ValueError(f"season must be one of {_SEASONS}, "
                         f"got {season!r}")
    if probes < 1 or rounds < 1 or stages < 1:
        raise ValueError("stages, probes, and rounds must all be >= 1")
    if flight_chunk < 1 or flight_years < flight_chunk:
        raise ValueError("need flight_years >= flight_chunk >= 1")
    par = Collection(par)
    par.pop("__K__", None)
    if any(np.ndim(v) >= 1 for v in par.values()):
        raise ValueError(
            "edge_state refines ONE member — par must be scalar-leaved; "
            "slice a lockstep edge() run per member via EdgeResult.refine")
    a, b = Collection(a), Collection(b)
    for name, s in (("a", a), ("b", b)):
        if any(np.ndim(v) >= 2 for v in s.values()):
            raise ValueError(
                f"endpoint {name} is member-batched — edge_state refines "
                f"ONE member (EdgeResult.refine slices one out)")

    def solve(init, tol_, years_):
        return equilibrate(model, st, forcing, par, init, tol=tol_,
                           max_years=years_, **equilibrate_kwargs)

    def area_of(res, K):
        v = seasonal_ice_area(getattr(res.seasonal, season), st)
        return np.broadcast_to(np.atleast_1d(v), (K,)).astype(np.float64)

    prog = None
    if progress:
        from .utils.progress import Progress

        prog = Progress(stages, title="EdgeState",
                        infofeed=lambda msg: msg)
        prog.update(0, feedargs=("attractor references",))

    if refs is not None:
        ref_a, ref_b = (float(refs[0]), float(refs[1]))
    else:
        ends = solve(stack_states([a, b]), commit_tol, commit_years)
        conv = np.broadcast_to(np.atleast_1d(ends.converged), (2,))
        fin = _finite_members(ends, 2)
        if not (conv & fin).all():
            raise ValueError(
                f"endpoint equilibration did not converge finitely "
                f"({ends!r}) — the attractor references must be trusted; "
                f"raise commit_years or pass refs=")
        ref_a, ref_b = area_of(ends, 2)
        a = _member_state(ends.state, 0, 2)
        b = _member_state(ends.state, 1, 2)
    gap = abs(ref_a - ref_b)
    if gap < jump_tol:
        raise ValueError(
            f"attractor references {ref_a:.4g} and {ref_b:.4g} are less "
            f"than jump_tol={jump_tol:g} apart in ice area — same basin, "
            f"or indistinguishable in this diagnostic")
    sep_tol = 0.25 * gap

    def bisect_round(xa, xb):
        """One multi-probe round: returns the tightened (xa, xb)."""
        w = np.linspace(0.0, 1.0, probes + 2)[1:-1]
        res = solve(blend_states(xa, xb, w), commit_tol, commit_years)
        areas = area_of(res, probes)
        finite = _finite_members(res, probes)
        in_a = np.abs(areas - ref_a) <= np.abs(areas - ref_b)
        i = 0                      # longest finite A-prefix
        while i < probes and finite[i] and in_a[i]:
            i += 1
        j = probes - 1             # longest finite B-suffix
        while j >= 0 and finite[j] and not in_a[j]:
            j -= 1
        lo = w[i - 1] if i > 0 else 0.0
        hi = w[j + 1] if j < probes - 1 else 1.0
        if not lo < hi:            # fully inconsistent classifications
            lo, hi = 0.0, 1.0
        return blend_states(xa, xb, lo), blend_states(xa, xb, hi)

    # resolve the drift-metric leaves UP FRONT from the endpoint carry —
    # a typo'd metric name must fail before the first (expensive) stage
    # of ensemble bisection + flight equilibrations, not after it
    # (review r3b)
    if metric is None:
        # every carry leaf (model-agnostic: the MIZ carry has no "E")
        drift_keys = tuple(sorted(a.keys()))
    else:
        drift_keys = tuple(metric)
        missing = [v for v in drift_keys if v not in a]
        if missing:
            raise ValueError(
                f"metric leaves {missing} not in the tracked carry "
                f"(available: {sorted(a.keys())})")

    drift_h, years_h, sep_h, mids = [], [], [], []
    mid_prev = None
    xa, xb = a, b
    for s in range(stages):
        for _ in range(rounds):
            xa, xb = bisect_round(xa, xb)

        # flight: hop the bracket pair forward while it still straddles
        # the boundary tightly; one re-bisection retry if the very first
        # hop already separates it (bracket not tight enough yet)
        flown_years = 0
        sep = 0.0
        for retry in range(2):
            fa, fb = xa, xb
            while flown_years < flight_years:
                res = solve(stack_states([fa, fb]), 0.0, flight_chunk)
                if not _finite_members(res, 2).all():
                    break          # keep the last finite pair
                na = _member_state(res.state, 0, 2)
                nb = _member_state(res.state, 1, 2)
                sep = float(np.abs(np.subtract(*area_of(res, 2))))
                if sep > sep_tol:
                    break          # committed past the monitor: re-bisect
                fa, fb = na, nb
                flown_years += flight_chunk
            if flown_years or retry:
                break
            xa, xb = bisect_round(xa, xb)   # too wide to fly: tighten
        xa, xb = fa, fb

        mid = blend_states(xa, xb, 0.5)
        if mid_prev is None:
            drift = np.nan
        else:
            drift = max(
                float(np.max(np.abs(np.asarray(mid[v], dtype=np.float64)
                                    - np.asarray(mid_prev[v],
                                                 dtype=np.float64))))
                for v in drift_keys)
        mid_prev = mid
        mids.append(mid)
        drift_h.append(drift)
        years_h.append(flown_years)
        sep_h.append(sep)
        if prog is not None:
            prog.update(s + 1, feedargs=(
                f"stage {s + 1}: drift {drift:.3g}, "
                f"+{flown_years} yr tracked",))
        if (track_tol is not None and np.isfinite(drift)
                and drift < track_tol):
            break

    # refinement proper: trust-region Gauss-Newton on the year map (or,
    # under polish=False, just measure the last midpoint's stationarity
    # with the same residual). The step-albedo kink structure pins
    # DIFFERENT local ||year(x)-x|| floors around the saddle (measured
    # 0.7 / 1.3 / 7.4 from different stage midpoints at nx=8), so every
    # stage midpoint is a candidate start: polish last-first until one
    # meets tol, keep the best.
    if prog is not None:
        prog.update(len(drift_h), feedargs=("polishing the saddle",))
    state, resid, nfev = None, np.inf, 0
    for cand in mids[::-1]:
        s_, r_, n_ = _polish_fixed_point(
            model, st, forcing, par, cand,
            equilibrate_kwargs.get("dtype"),
            polish_max_nfev if polish else 0)
        nfev += n_
        if r_ < resid:
            state, resid = s_, r_
        if resid <= tol or not polish:
            break
    converged = bool(resid <= tol)

    probe = solve(state, 0.0, 1)
    area = float(area_of(probe, 1)[0])
    if min(abs(area - ref_a), abs(area - ref_b)) < 0.1 * gap:
        warnings.warn(
            f"edge_state's polished state (ice area {area:.4g}) sits on "
            f"an ATTRACTOR (references {ref_a:.4g}/{ref_b:.4g}) — the "
            f"polish slid off the basin boundary; raise stages/probes so "
            f"tracking lands closer to the saddle first")

    stab = None
    if stability_check:
        from .equilibrium import stability

        kw = dict(side="right")
        kw.update(stability_kwargs or {})
        stab = stability(model, st, forcing, par, state, **kw)

    return EdgeStateResult(
        state=state, area=area, resid=resid,
        drift=np.asarray(drift_h), tracked_years=np.asarray(years_h),
        separation=np.asarray(sep_h), converged=converged,
        polish_nfev=nfev, stability=stab, spacetime=st, season=season,
        par=par)


def _year_seasonal(model: str, st: SpaceTime, forcing: Forcing,
                   par: Collection, state: Collection, dtype):
    """One jitted year from ``state``: its Seasonal store (the fixed
    point's seasonal cycle) — shapes match the solo carry, exactly the
    stores :class:`EquilibriumResult` carries."""
    import jax.numpy as jnp

    from .integrate import _jitted_year_fn, default_dtype
    from .models.base import default_step_config, get_model

    spec = get_model(model)
    dtype = jnp.dtype(dtype if dtype is not None else default_dtype())
    par = Collection(par)
    par.pop("__K__", None)
    F_off = par.pop("F", None)
    if F_off is not None:
        forcing = Forcing(float(forcing.base) + float(np.asarray(F_off)))
    cfg = default_step_config(dtype.name)
    carry = spec.init_carry(state, st, dtype)
    par_j = Collection({k: jnp.asarray(v, dtype) for k, v in par.items()})
    frow_j = jnp.asarray(forcing.table(st)[0], dtype=dtype)
    year = _jitted_year_fn(model, st, cfg, dtype.name, False, None)
    _, seasonal, _, _ = year(carry, par_j, frow_j)
    import jax

    return jax.device_get(seasonal)


def unstable_branch(
    model: str,
    st: SpaceTime,
    values,
    par: Collection,
    saddle: Collection,
    vary: str = "F",
    forcing: Union[Forcing, float] = 0.0,
    tol: Optional[float] = None,
    polish_max_nfev: int = 200,
    jump_tol: float = np.pi / 2,
    season: str = "avg",
    dtype=None,
    progress: bool = False,
):
    """Trace the UNSTABLE (saddle) branch of a bifurcation diagram.

    :func:`~energybalancemodel_jl_tpu.equilibrium.continuation` traces
    attracting branches; the middle segment of the hysteresis S-curve —
    the saddle separating them — is exactly what forward integration can
    never settle on (the reference's hysteresis runs jump ACROSS it,
    /root/reference/src/plot.jl:173-225). This driver completes the
    diagram: starting from one converged saddle (``saddle`` — an
    :func:`edge_state` result's ``.state``), each ``values`` level
    re-polishes the year-map fixed point with the trust-region
    Gauss-Newton solve (:func:`edge_state`'s machinery), warm-started
    from the previous level's saddle — the saddle moves continuously
    with the parameter, so the expensive edge-tracking stage is paid
    ONCE, by whoever produced ``saddle``.

    ``vary`` is ``"F"`` (constant forcing offsets) or any ``par`` key;
    ``values`` should start at (or near) the level ``saddle`` was
    computed at and step gently — a step that jumps past a fold (where
    the unstable branch annihilates against an attractor) leaves nothing
    to converge to, and the polish lands on the nearby ATTRACTOR
    instead. Two guards flag that: a level whose residual exceeds
    ``tol`` (default: ``2.5x`` the first level's polished residual —
    the classic albedo-hole floor is O(0.7), MIZ's is tiny), or whose
    ice area jumps more than ``jump_tol`` from the last good level, is
    marked not-converged (and later levels keep being compared against
    the last GOOD area). Solo only — the dense Gauss-Newton polish has
    no lockstep axis (``par`` leaves must be scalars).

    Returns a
    :class:`~energybalancemodel_jl_tpu.equilibrium.ContinuationResult`
    whose levels are the saddles — every path diagnostic works on it
    unchanged: ``ice_area()`` gives the middle branch for the S-curve
    plot, ``plot_continuation`` draws it, ``.stability()`` verifies
    saddleness per level (leading ``|lambda| > 1``; a level that fell
    onto an attractor reads ``< 1``), and ``ebm.save``/``load``
    round-trip it. Each level's ``years`` records the polish's
    residual-evaluation count (there is no time integration here).
    """
    from .equilibrium import ContinuationResult, _level_config

    if not isinstance(forcing, Forcing):
        forcing = Forcing(float(forcing))
    if not forcing.constant:
        raise ValueError("unstable_branch needs a constant base forcing")
    par = Collection(par)
    if vary != "F" and vary not in par:
        raise ValueError(f"vary {vary!r} not in par (and not 'F')")
    swept = [k for k, v in par.items() if np.ndim(v) >= 1]
    if swept:
        raise ValueError(
            f"unstable_branch is solo-only (the dense Gauss-Newton "
            f"polish has no lockstep axis); par leaves {swept} are swept")
    values = np.atleast_1d(np.asarray(values, dtype=np.float64))
    if values.ndim != 1 or values.size < 1:
        raise ValueError("values must be a non-empty 1-D sequence")
    bad_state = [k for k, v in Collection(saddle).items()
                 if np.ndim(v) > 1]
    if bad_state:
        raise ValueError(
            f"saddle leaves {bad_state} are member-batched; pass ONE "
            f"state (e.g. edge_state(...).state)")
    if polish_max_nfev < 1:
        raise ValueError("polish_max_nfev must be >= 1")

    prog = None
    if progress:
        from .utils.progress import Progress

        prog = Progress(values.size, title=f"Unstable branch ({vary})",
                        infofeed=lambda msg: msg)

    state = Collection(saddle)
    results = []
    thr = tol
    last_good_area = None
    for i, v in enumerate(values):
        forcing_v, par_v = _level_config(vary, forcing, par, float(v))
        state, resid, nfev = _polish_fixed_point(
            model, st, forcing_v, par_v, state, dtype, polish_max_nfev)
        seasonal = _year_seasonal(model, st, forcing_v, par_v, state,
                                  dtype)
        area = float(np.asarray(seasonal_ice_area(
            getattr(seasonal, season), st)))
        if thr is None:  # calibrate to the model's stationarity floor
            thr = max(2.5 * resid, 1e-8)
        ok = bool(resid <= thr)
        if last_good_area is not None and ok:
            ok = bool(abs(area - last_good_area) < jump_tol)
        if ok:
            last_good_area = area
        results.append(EquilibriumResult(
            state=Collection({k: np.asarray(x) for k, x in state.items()}),
            seasonal=seasonal, years=int(nfev), resid=float(resid),
            converged=ok, member_years=None, newton_ok=True,
            tol=float(thr)))
        if prog is not None:
            prog.update(i + 1, feedargs=(
                f"{vary}={float(v):g}: resid {resid:.3g}, area "
                f"{area:.3f}" + ("" if ok else " (NOT converged)"),))

    return ContinuationResult(
        values=values, direction=np.ones(values.size, dtype=np.int64),
        results=results, vary=vary, spacetime=st, model=model,
        par=Collection(par), forcing=forcing)
