"""Fold (saddle-node) tracking by lockstep ensemble bisection.

No reference analog — the reference finds where a branch ends by
integrating a slow forcing ramp and eyeballing where the trajectory jumps
(/root/reference/src/plot.jl:173-225, the hysteresis workflow). Here the
fold location is BISECTED: a branch exists at ``hi`` (anchored by one
converged :func:`~energybalancemodel_jl_tpu.equilibrium.equilibrate`) and
is gone at ``lo``; each probe warm-starts from the anchor state and asks
"did the solve stay on the branch, or fall off?". ``steps`` bisection
steps shrink the bracket by ``2**-steps``.

The accelerator leverage is the ensemble axis: members carry DIFFERENT second
parameters (e.g. ``par["D"] = np.linspace(...)``) and different brackets,
so one lockstep equilibration probes every member's own midpoint at once —
K fold locations cost ``steps`` ensemble solves instead of K independent
scans (``engine='auto'``). ``examples/fold_tracking.py`` drives this API.

Caveat (critical slowing down): the relaxation time diverges at a fold,
so ``max_years`` bounds how sharply the fold can be resolved — a probe
that has not settled is classified by its final state anyway. Brackets
much tighter than the relaxation scale need larger ``max_years``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Union

import numpy as np

from .equilibrium import EquilibriumResult, equilibrate
from .forcing import Forcing
from .spacetime import SpaceTime
from .utils.collection import Collection
from .utils.numerics import hemispheric_mean

__all__ = ["fold", "FoldResult", "seasonal_ice_area"]


def seasonal_ice_area(coll, st: SpaceTime) -> np.ndarray:
    """Ice-covered area ``2 pi <field>`` of one seasonal store — ``phi``
    where the model has it (MIZ), else the ``E < 0`` indicator (classic).
    Batched over leading (member) axes; the same diagnostic
    :meth:`ContinuationResult.ice_area` and ``plot_bifurcation`` use."""
    if "phi" in coll:
        field = np.nan_to_num(np.asarray(coll["phi"]))
    else:
        field = (np.asarray(coll["E"]) < 0.0).astype(np.float64)
    return 2.0 * np.pi * np.asarray(hemispheric_mean(field, st.x))


@dataclasses.dataclass
class FoldResult:
    """Result of :func:`fold`.

    ``lo``/``hi`` are the final per-member brackets (the branch survives
    at ``hi``, is lost at ``lo`` — ``hi < lo`` when the surviving side is
    the low end); ``values`` their midpoints, the fold estimates.
    ``history`` stacks the brackets after each step, shape
    ``(steps, 2, K)`` in (lo, hi) order; ``survived`` the per-step probe
    classifications, ``(steps, K)``. ``ok`` flags members whose every
    probe converged — where it is False the corresponding fold estimate
    rests on an unconverged solve (raise ``max_years``). ``anchor`` is
    the converged branch state every probe warm-started from.
    """

    lo: np.ndarray
    hi: np.ndarray
    history: np.ndarray
    survived: np.ndarray
    probe_converged: np.ndarray
    vary: str
    anchor: EquilibriumResult
    spacetime: SpaceTime
    # the parameter Collection the search ran under (member sweeps
    # included) — lets plot_fold label the fold curve against the second
    # parameter post hoc; None on results loaded from older files
    par: Optional[Collection] = None

    @property
    def values(self) -> np.ndarray:
        """Per-member fold estimates (bracket midpoints), shape ``(K,)``."""
        return 0.5 * (self.lo + self.hi)

    @property
    def width(self) -> np.ndarray:
        """Final bracket widths ``|hi - lo|``."""
        return np.abs(self.hi - self.lo)

    @property
    def ok(self) -> np.ndarray:
        """True per member when every probe along its bisection converged."""
        return self.probe_converged.all(axis=0)

    def __repr__(self):
        v = np.array2string(self.values, precision=4)
        return (f"FoldResult({self.vary}* = {v}, width "
                f"{float(self.width.max()):.3g}, "
                f"{int(np.count_nonzero(self.ok))}/{len(self.lo)} members "
                f"fully converged)")


def _as_members(v, K: int, name: str) -> np.ndarray:
    out = np.broadcast_to(np.asarray(v, dtype=np.float64), (K,)).copy()
    if not np.isfinite(out).all():
        raise ValueError(f"{name} must be finite, got {out}")
    return out


def fold(
    model: str,
    st: SpaceTime,
    par: Collection,
    init: Optional[Collection],
    lo,
    hi,
    vary: str = "F",
    forcing: Union[Forcing, float] = 0.0,
    steps: int = 15,
    predicate: Optional[Callable] = None,
    jump_tol: float = np.pi / 2,
    season: str = "avg",
    check_lo: bool = True,
    anchor: Optional[EquilibriumResult] = None,
    tol: float = 1e-2,
    max_years: int = 300,
    progress: bool = False,
    checkpoint: Optional[str] = None,
    resume: bool = False,
    **equilibrate_kwargs,
) -> FoldResult:
    """Locate the fold where a solution branch ends, per ensemble member.

    ``vary`` names the bisected parameter — ``"F"`` (a constant forcing
    offset per member, the virtual ensemble key) or any ``par`` key. The
    branch must exist at ``hi`` and be gone at ``lo``; pass ``hi < lo``
    when the surviving side is the LOW end (e.g. a cold branch lost to
    warming) — the bisection only assumes "survives at ``hi``".

    One anchor equilibration at ``hi`` (from ``init``) must fully
    converge; its state warm-starts every probe. The default classifier
    is NEAREST-NEIGHBOR in ice area against two evolving per-member
    references: "on the branch" starts at the anchor's area, "off the
    branch" at the ``lo`` probe's (the other attractor the solve falls
    to), and each classified probe updates its side's reference — so the
    on-branch reference FOLLOWS the branch as the bracket tightens, and a
    diagnostic that drifts along the branch (ice area grows toward the
    fold) never gets misread as a departure; only the O(1) jump between
    attractors separates the classes. ``jump_tol`` is the minimum
    ice-area separation the two bracket-end states must show (default
    pi/2) — below it the bracket is rejected as not actually straddling
    a fold. Pass ``predicate(probe, anchor) -> (K,) bool`` to classify
    on any other diagnostic instead. ``check_lo`` spends one probe
    verifying the branch is really lost at ``lo`` (catches inverted or
    too-narrow brackets before ``steps`` solves chase a fold that is not
    inside them); the default classifier requires it (that probe seeds
    its off-branch reference).

    ``anchor=`` reuses a previously converged branch state (an
    :class:`EquilibriumResult` — a prior fold's ``.anchor``, or any
    ensemble equilibration) instead of solving one from ``init`` (which
    is then ignored and may be ``None``): refine a bracket by calling
    again with the returned ``lo``/``hi`` and more ``steps``. The
    default classifier then re-probes ``hi`` once (warm-started from the
    anchor) to seed its on-branch reference AT the current bracket —
    the reused anchor may sit far up the branch, and a stale reference
    near the fold would misclassify the whole refinement.

    ``checkpoint=`` names a file that records the search state after the
    anchoring/bracket-verification stage and again after every completed
    bisection step (brackets, per-step histories, the classifier's
    evolving references, and the anchor itself — atomic whole-file
    writes, the state is KBs); ``resume=True`` reloads it and replays
    only the remaining steps, bit-exactly identical to an uninterrupted
    run. ``steps`` is deliberately EXCLUDED from the config fingerprint,
    so a resume may extend the refinement (more steps than the original
    call); everything that changes a probe's outcome (model, grid,
    parameters, forcing, brackets, tolerances, classifier kind,
    equilibrate options) is covered, and a mismatch warns and restarts.
    A custom ``predicate`` cannot be fingerprinted — pass the same one
    when resuming.

    All remaining keywords (``engine``/``mesh``/``dtype``/``anderson``/
    ...) pass through to :func:`equilibrate`. Returns a
    :class:`FoldResult`.
    """
    if not isinstance(forcing, Forcing):
        forcing = Forcing(float(forcing))
    if not forcing.constant:
        raise ValueError("fold needs a constant base forcing")
    par = Collection(par)
    if vary != "F" and vary not in par:
        raise ValueError(f"vary {vary!r} not in par (and not 'F')")
    if vary in par and np.asarray(par[vary]).ndim >= 1:
        raise ValueError(
            f"par[{vary!r}] is member-swept, but the bisection owns the "
            f"{vary!r} axis — sweep the second parameter under a "
            f"different name")
    if steps < 1:
        raise ValueError("steps must be >= 1")

    K = max(int(np.size(lo)), int(np.size(hi)),
            max((v.size for v in map(np.asarray, par.values())
                 if v.ndim == 1), default=1))
    lo = _as_members(lo, K, "lo")
    hi = _as_members(hi, K, "hi")
    if np.any(lo == hi):
        raise ValueError("lo and hi must differ for every member")

    default_classifier = predicate is None
    if default_classifier and not check_lo:
        raise ValueError(
            "the default classifier seeds its off-branch reference from "
            "the lo probe — keep check_lo=True, or pass predicate=")

    def area_of(res):
        a = seasonal_ice_area(getattr(res.seasonal, season), st)
        return np.broadcast_to(np.atleast_1d(a), (K,)).astype(np.float64)

    def solve(values, state):
        p = Collection(par)
        p[vary] = np.asarray(values)
        return equilibrate(model, st, forcing, p, state, tol=tol,
                           max_years=max_years, **equilibrate_kwargs)

    if anchor is None and init is None:
        raise ValueError("fold needs init= (or a reused anchor=)")

    ckpt_key = None
    if checkpoint is not None or resume:
        if checkpoint is None:
            raise ValueError("resume=True needs checkpoint=<path>")
        from . import checkpoint as ckpt_mod

        # steps deliberately excluded: a resume may EXTEND the refinement
        ckpt_key = ckpt_mod.search_key(
            "fold", model, st, forcing, par, equilibrate_kwargs,
            extras=(f"vary={vary}", f"lo#{ckpt_mod.digest_array(lo)}",
                    f"hi#{ckpt_mod.digest_array(hi)}",
                    f"jt={float(jump_tol)}", f"season={season}",
                    f"cl={'default' if default_classifier else 'custom'}",
                    f"chk={bool(check_lo)}", f"tol={float(tol)}",
                    f"maxy={int(max_years)}"),
        )

    resumed = None
    if resume:
        from . import checkpoint as ckpt_mod

        resumed = ckpt_mod.try_resume_search(
            checkpoint, ckpt_key, "FoldCheckpoint",
            ckpt_mod.read_fold_checkpoint)
        if resumed is not None and default_classifier \
                and resumed["ref_on"] is None:
            resumed = None  # refs missing: unusable for this classifier

    s_done = 0
    if resumed is not None:
        # the file holds everything a probe depends on: skip the anchor
        # solve, the hi re-probe, and the lo check entirely
        anchor = resumed["anchor"]
        lo = np.asarray(resumed["lo"], dtype=np.float64)
        hi = np.asarray(resumed["hi"], dtype=np.float64)
        s_done = int(resumed["history"].shape[0])
        if s_done >= steps:  # already refined this far: report the slice
            h = resumed["history"][:steps]
            return FoldResult(
                lo=h[-1, 0], hi=h[-1, 1], history=h,
                survived=resumed["survived"][:steps],
                probe_converged=resumed["conv"][:steps],
                vary=vary, anchor=anchor, spacetime=st, par=par)

    prog = None
    if progress:
        from .utils.progress import Progress

        if resumed is not None:
            total = steps - s_done
            first = f"resumed after step {s_done}"
        else:
            total = (int(anchor is None)
                     + int(anchor is not None and default_classifier)
                     + int(bool(check_lo)) + steps)
            first = ("anchoring the branch at hi"
                     if anchor is None else "anchor reused")
        prog = Progress(
            total, title=f"Fold ({vary})",
            infofeed=lambda msg: msg,
        )
        prog.update(0, feedargs=(first,))
    done = [0]

    def tick(msg):
        if prog is not None:
            done[0] += 1
            prog.update(done[0], feedargs=(msg,))

    ref_on = ref_off = None
    if resumed is not None:
        ref_on, ref_off = resumed["ref_on"], resumed["ref_off"]
    else:
        if anchor is None:
            anchor = solve(hi, init)
            tick_anchor = True
        else:
            a_shape = np.shape(next(iter(anchor.state.values())))
            if len(a_shape) > 1 and a_shape[0] != K:
                raise ValueError(
                    f"reused anchor carries {a_shape[0]} members, the "
                    f"search has {K}")
            tick_anchor = False
        if not np.all(anchor.converged):
            bad = np.flatnonzero(~np.atleast_1d(anchor.converged))
            raise ValueError(
                f"anchor equilibration at hi did not converge for members "
                f"{bad.tolist()} ({anchor!r}) — the branch reference state "
                f"must be trusted; raise max_years or move hi")
        if tick_anchor:
            tick("anchor converged")

        if default_classifier:
            if tick_anchor:
                ref_on = area_of(anchor)
            else:
                # a reused anchor may sit far up the branch (its hi
                # differs from this bracket's): seed the on-branch
                # reference from a probe AT the current hi, or a stale
                # reference near the fold misclassifies every refinement
                # probe (review r7)
                ref_on = area_of(solve(hi, anchor.state))
                tick("hi re-probed for the on-branch reference")
        if check_lo:
            probe = solve(lo, anchor.state)
            if default_classifier:
                ref_off = area_of(probe)
                still = np.flatnonzero(np.abs(ref_off - ref_on) < jump_tol)
                msg = (f"ice-area separation between the hi and lo states "
                       f"is below jump_tol={jump_tol:g} for members "
                       "{m} — either the branch still survives at lo, or "
                       "the two attractors are indistinguishable in ice "
                       "area (pass predicate= for a different diagnostic)")
            else:
                still = np.flatnonzero(
                    np.atleast_1d(predicate(probe, anchor)))
                msg = ("the branch still survives at lo for members {m} — "
                       "the fold is not inside [lo, hi]; widen the "
                       "bracket (or the branch has no fold there)")
            if still.size:
                raise ValueError(msg.format(m=still.tolist()))
            tick("lo verified off-branch")

    def classify(probe):
        nonlocal ref_on, ref_off
        if not default_classifier:
            return np.broadcast_to(
                np.atleast_1d(predicate(probe, anchor)), (K,))
        # nearest-neighbor against the evolving branch references: the
        # on-branch diagnostic drifts continuously with the parameter
        # (O(bracket) per step), while falling off is an O(1) jump — so
        # whichever reference is closer names the attractor, and the
        # winning side's reference follows the probe
        a = area_of(probe)
        survived = np.abs(a - ref_on) < np.abs(a - ref_off)
        ref_on = np.where(survived, a, ref_on)
        ref_off = np.where(~survived, a, ref_off)
        return survived

    history = np.empty((steps, 2, K))
    survived_hist = np.empty((steps, K), dtype=bool)
    conv_hist = np.empty((steps, K), dtype=bool)
    if s_done:
        history[:s_done] = resumed["history"]
        survived_hist[:s_done] = resumed["survived"]
        conv_hist[:s_done] = resumed["conv"]

    def write_ckpt(n):
        if ckpt_key is None:
            return
        from . import checkpoint as ckpt_mod

        ckpt_mod.write_fold_checkpoint(
            checkpoint, ckpt_key, anchor, lo, hi, history[:n],
            survived_hist[:n], conv_hist[:n], ref_on, ref_off)

    if resumed is None:
        # record the anchoring/verification stage so an interruption in
        # step 1 does not repeat those solves on resume
        write_ckpt(0)

    for s in range(s_done, steps):
        mid = 0.5 * (lo + hi)
        probe = solve(mid, anchor.state)
        survived = classify(probe)
        hi = np.where(survived, mid, hi)
        lo = np.where(survived, lo, mid)
        history[s, 0], history[s, 1] = lo, hi
        survived_hist[s] = survived
        conv_hist[s] = np.broadcast_to(
            np.atleast_1d(probe.converged), (K,))
        write_ckpt(s + 1)
        tick(f"step {s + 1}/{steps}: max width "
             f"{float(np.abs(hi - lo).max()):.4g}")

    return FoldResult(lo=lo, hi=hi, history=history,
                      survived=survived_hist, probe_converged=conv_hist,
                      vary=vary, anchor=anchor, spacetime=st, par=par)
