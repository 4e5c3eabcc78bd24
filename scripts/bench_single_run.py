"""Measure the canonical single 30-year MIZ run (the reference's own headline
workload: 511.24 steps/s, 1:57 min — /root/reference/src/EnergyBalanceModel.jl:59-61)
across engines and dispatch chunkings on the attached GPU.

Usage: python scripts/bench_single_run.py [years]
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import energybalancemodel_jl_tpu as ebm  # noqa: E402
from energybalancemodel_jl_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache,
)

enable_compile_cache()

years = int(sys.argv[1]) if len(sys.argv) > 1 else 30
st = ebm.SpaceTime.sin(180, 2000, years)
par = ebm.default_parameters("MIZ")
init = ebm.zeros_init(st)


def run(label, **kw):
    # warm every graph (incl. the chunked dispatch) with an identical run
    ebm.integrate("MIZ", st, ebm.Forcing(0.0), par, init,
                  progress=False, raw_mode="none", **kw)
    t0 = time.time()
    s = ebm.integrate("MIZ", st, ebm.Forcing(0.0), par, init,
                      progress=False, raw_mode="none", **kw)
    el = time.time() - t0
    chk = float(np.nan_to_num(s.seasonal.avg["E"]).sum())
    print(f"{label:34s} {el:7.3f} s  ({years / el * 86400:.3g} model-yr/day)"
          f"  checksum={chk:.6g}", flush=True)
    return el


run("scan, per-year dispatch", engine="scan")
run("scan, ypd=years", engine="scan", years_per_dispatch=years)
run("fused, per-year dispatch", engine="fused")
run("fused, ypd=years", engine="fused", years_per_dispatch=years)
run("fused, ypd=8", engine="fused", years_per_dispatch=8)
