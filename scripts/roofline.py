"""Weighted ALU-op accounting for the fused model steps (roofline input).

A committed, re-runnable operation count: trace one model step (the SAME
``models/*.py step()`` every year engine calls), walk the jaxpr, and
weight the
ALU-visible primitives:

    add/mul/sub/cmp/select/min/max/and/or/neg/abs = 1
    div/sqrt/rsqrt                                = 4
    integer_pow                                   = 2
    data movement (broadcast/reshape/convert/slice/pad/...) = 0

``lax.while_loop`` bodies (the MIZ Newton solve) are counted separately
and multiplied by the EXECUTED iteration count — 6 at the canonical
config (a fixed cap of 6 reproduced the adaptive year bitwise). The
``(K, nx)``-normalized totals are machine-independent; ``--miz-yrday``
turns a measured rate into operations per second.

Usage::

    python scripts/roofline.py                  # both models, canonical
    python scripts/roofline.py --miz-yrday 1.2e9 --classic-yrday 1.99e9
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

import energybalancemodel_jl_tpu as ebm  # noqa: E402
from energybalancemodel_jl_tpu.models import classic, miz  # noqa: E402
from energybalancemodel_jl_tpu.models.base import default_step_config  # noqa: E402
from energybalancemodel_jl_tpu.utils.collection import Collection  # noqa: E402

WEIGHTS = {
    "add": 1, "sub": 1, "mul": 1, "max": 1, "min": 1, "neg": 1, "abs": 1,
    "sign": 1, "floor": 1, "ceil": 1, "round": 1, "not": 1, "and": 1,
    "or": 1, "xor": 1, "eq": 1, "ne": 1, "lt": 1, "le": 1, "gt": 1,
    "ge": 1, "select_n": 1, "clamp": 2, "is_finite": 1, "stop_gradient": 0,
    "div": 4, "sqrt": 4, "rsqrt": 4, "integer_pow": 2, "pow": 8,
    "exp": 8, "log": 8, "cos": 8, "sin": 8, "tanh": 8, "logistic": 8,
    "reduce_max": 1, "reduce_min": 1, "reduce_sum": 1, "reduce_and": 1,
    "reduce_or": 1, "argmax": 1, "argmin": 1, "cumsum": 1, "cumlogsumexp": 8,
}
MOVEMENT = {
    "broadcast_in_dim", "reshape", "convert_element_type", "slice",
    "dynamic_slice", "dynamic_update_slice", "concatenate", "pad",
    "transpose", "squeeze", "rev", "gather", "scatter", "iota", "copy",
    "expand_dims", "pjit", "custom_vjp_call", "custom_jvp_call",
    "custom_vjp_call_jaxpr", "closed_call", "core_call", "remat_call",
    "while", "scan", "cond", "split", "select_and_scatter_add",
}


def _elems(eqn) -> int:
    """Elementwise work size: the largest operand/output element count."""
    sizes = [int(np.prod(v.aval.shape)) for v in eqn.outvars
             if hasattr(v.aval, "shape")]
    sizes += [int(np.prod(v.aval.shape)) for v in eqn.invars
              if hasattr(getattr(v, "aval", None), "shape")]
    return max(sizes) if sizes else 1


def _sub_jaxprs(eqn):
    """(jaxpr, multiplier) pairs for a higher-order primitive."""
    p = eqn.primitive.name
    params = eqn.params
    if p == "while":
        # executed trip counts are runtime facts; the caller supplies the
        # Newton count — cond runs trips+1 times, body trips times
        return [(params["cond_jaxpr"].jaxpr, "while_cond"),
                (params["body_jaxpr"].jaxpr, "while_body")]
    if p == "scan":
        return [(params["jaxpr"].jaxpr, params["length"])]
    if p == "cond":
        # static worst case: the most expensive branch
        return [(b.jaxpr, "branch_max") for b in params["branches"]]
    for key in ("jaxpr", "call_jaxpr", "fun_jaxpr"):
        if key in params:
            j = params[key]
            return [(getattr(j, "jaxpr", j), 1)]
    return []


# movement primitives that lower to real shifts or copies (not free
# relabeling like reshape/convert): counted separately — they occupy
# the vector units without being "ALU work", and for the
# PCR-dominated classic kernel they are a material fraction of the issue
# stream (each jnp.roll in a PCR round is a concatenate of two slices)
SHIFTY = {"concatenate", "slice", "dynamic_slice", "dynamic_update_slice",
          "pad", "rev", "gather", "scatter", "select_and_scatter_add"}


def count_jaxpr(jaxpr, while_iters: int):
    """(weighted ALU ops, shift/copy elems, unknown) of a jaxpr; while
    bodies scaled by while_iters."""
    total = 0.0
    moved = 0.0
    unknown = {}
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        subs = _sub_jaxprs(eqn)
        if subs:
            branch_costs = []
            for sub, mult in subs:
                sub_total, sub_moved, sub_unknown = count_jaxpr(
                    sub, while_iters)
                for k, v in sub_unknown.items():
                    unknown[k] = unknown.get(k, 0) + v
                if mult == "while_body":
                    total += sub_total * while_iters
                    moved += sub_moved * while_iters
                elif mult == "while_cond":
                    total += sub_total * (while_iters + 1)
                    moved += sub_moved * (while_iters + 1)
                elif mult == "branch_max":
                    branch_costs.append((sub_total, sub_moved))
                else:
                    total += sub_total * mult
                    moved += sub_moved * mult
            if branch_costs:
                t, m = max(branch_costs)
                total += t
                moved += m
            continue
        if name in SHIFTY:
            moved += _elems(eqn)
            continue
        if name in MOVEMENT:
            continue
        w = WEIGHTS.get(name)
        if w is None:
            unknown[name] = unknown.get(name, 0) + _elems(eqn)
            continue
        total += w * _elems(eqn)
    return total, moved, unknown


def _miz_step_fn(K, nx, nt):
    st = ebm.SpaceTime.sin(nx, nt, 1)
    par = Collection({k: jnp.asarray(v, jnp.float32)
                      for k, v in ebm.default_parameters("MIZ").items()})
    par["D"] = jnp.broadcast_to(par["D"], (K,))[:, None]
    cfg = default_step_config("float32", solver="pcr")
    stat = miz.statics(st, par, jnp.float32)
    carry = miz.init_carry(ebm.zeros_init(st), st, jnp.float32)
    carry = Collection({k: jnp.broadcast_to(v, (K, nx))
                        for k, v in carry.items()})
    xs = Collection(insol=stat.insol[0], f=jnp.float32(0.0))

    def fn(carry):
        return miz.step(carry, xs, stat, par, cfg)

    return fn, carry


def _classic_step_fn(K, nx, nt):
    st = ebm.SpaceTime.sin(nx, nt, 1)
    par = Collection({k: jnp.asarray(v, jnp.float32)
                      for k, v in ebm.default_parameters("Classic").items()})
    cfg = default_step_config("float32", solver="pcr")
    stat = classic.statics(st, par, jnp.float32)
    E0 = jnp.full((K, nx), 30.0, jnp.float32)
    carry = Collection(E=E0, Tg=E0 / par["cw"])
    xs = Collection(S_i=stat.S[0], S_ip1=stat.S[1], f=jnp.float32(0.0))

    def fn(carry):
        return classic.step(carry, xs, stat, par, cfg)

    return fn, carry


def report(name, fn, carry, K, nx, nt, newton_iters, yrday):
    closed = jax.make_jaxpr(fn)(carry)
    # split the Newton loop out of the total: count with 0 and 1 iteration
    base, mv0, unknown = count_jaxpr(closed.jaxpr, while_iters=0)
    one, mv1, _ = count_jaxpr(closed.jaxpr, while_iters=1)
    per_iter = one - base
    total = base + newton_iters * per_iter
    moved = mv0 + newton_iters * (mv1 - mv0)
    cell = K * nx
    print(f"{name} (K={K}, nx={nx}, nt={nt}, f32, pcr):")
    print(f"  outside any while loop: {base / cell:.0f} weighted ops/cell-step")
    if per_iter:
        print(f"  while (Newton) body:    {per_iter / cell:.0f} "
              f"ops/cell-step per iteration x {newton_iters} executed")
    print(f"  TOTAL:                  {total / cell:.0f} weighted ops/cell-step")
    print(f"  shift/copy traffic:     {moved / cell:.0f} elems/cell-step "
          f"({moved / max(total, 1):.0%} of the weighted-op count — vector-"
          "unit issue slots that are not ALU work)")
    if unknown:
        print(f"  [unweighted primitives: {unknown}]")
    if yrday:
        cellsteps_s = yrday * nt * nx / 86400.0
        ops_s = total / cell * cellsteps_s
        print(f"  at {yrday:.3g} model-yr/day: {cellsteps_s:.3g} cell-steps/s"
              f" -> {ops_s:.3g} weighted ops/s")
    print(flush=True)
    return total / cell


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--K", type=int, default=128)
    ap.add_argument("--nx", type=int, default=180)
    ap.add_argument("--nt", type=int, default=2000)
    ap.add_argument("--newton-iters", type=int, default=6,
                    help="executed Newton iterations (6 = the bitwise-"
                         "pinned canonical count)")
    ap.add_argument("--miz-yrday", type=float, default=None,
                    help="measured MIZ model-yr/day for the ops/s statement")
    ap.add_argument("--classic-yrday", type=float, default=None)
    args = ap.parse_args()

    fn, carry = _miz_step_fn(args.K, args.nx, args.nt)
    report("MIZ step", fn, carry, args.K, args.nx, args.nt,
           args.newton_iters, args.miz_yrday)
    fn, carry = _classic_step_fn(args.K, args.nx, args.nt)
    report("Classic step", fn, carry, args.K, args.nx, args.nt, 0,
           args.classic_yrday)


if __name__ == "__main__":
    main()
