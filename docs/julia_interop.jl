# Julia-side loader: read an HDF5 `Solutions` file written by the JAX
# framework (`energybalancemodel_jl_tpu.save`, see
# energybalancemodel_jl_tpu/io.py) into a genuine EnergyBalanceModel.jl
# `Solutions` object, so results cross the language boundary both ways:
#
#   Julia -> Python : `energybalancemodel_jl_tpu.io_jld2.read_jld2` reads the
#                     reference's JLD2 saves (JLD2 files are HDF5).
#   Python -> Julia : this script reads the framework's plain-HDF5 saves.
#
# Usage (Julia >= 1.10 with EnergyBalanceModel and HDF5 in the project):
#
#     include("julia_interop.jl")
#     sols = load_framework_solutions("run.h5")
#     plot_raw(sols)
#
# Layout contract (energybalancemodel_jl_tpu/io.py `_write_solutions`):
# attrs `__ebm_type__="Solutions"`, `lastonly`; groups `spacetime` (attrs
# nx/nt/dur/grid/urange/winter/summer), `forcing` (attrs base/peak/cool/
# holdyrs/rates/constant), `parameters`, `initconds`, `raw`,
# `seasonal/{winter,summer,avg}`; h5py writes C-order, so a Python
# `(n, nx)` dataset reads as an `(nx, n)` Julia Matrix.
#
# NOTE: this file is reference documentation shipped with the Python
# package; the build image has no Julia, so it is exercised in CI of the
# consuming Julia project, not here.

using EnergyBalanceModel
using HDF5

const EBM = EnergyBalanceModel

function _spacetime(g)::SpaceTime
    a = attrs(g)
    F = a["grid"] == "sin" ? sin : identity
    urange = Tuple(Float64.(a["urange"]))
    SpaceTime{F}(
        urange, Int(a["nx"]), Int(a["nt"]), Int(a["dur"]);
        winter=Float64(a["winter"]), summer=Float64(a["summer"]),
    )
end

function _forcing(g)::Forcing
    a = attrs(g)
    Bool(a["constant"]) && return Forcing(Float64(a["base"]))
    Forcing(
        Float64(a["base"]), Float64(a["peak"]), Float64(a["cool"]),
        Tuple(Int.(a["holdyrs"])), Tuple(Float64.(a["rates"])),
    )
end

_scalar_collection(g) = begin
    coll = Collection{Float64}()
    for k in keys(g)
        setproperty!(coll, Symbol(k), Float64(read(g[k])))
    end
    coll
end

_vec_collection(g) = begin
    coll = Collection{EBM.Vec}()
    for k in keys(g)
        setproperty!(coll, Symbol(k), Vector{Float64}(vec(read(g[k]))))
    end
    coll
end

# (n, nx) Python dataset -> (nx, n) Julia Matrix -> n column vectors
_columns(m::AbstractMatrix) = [Vector{Float64}(m[:, i]) for i in 1:size(m, 2)]
_columns(v::AbstractVector) = Vector{Float64}[]  # empty (0, nx) dataset

"""
    load_framework_solutions(path) -> Solutions

Read a `Solutions` HDF5 file written by the JAX framework.
Raw storage the file does not contain (seasonal-only runs) is left `#undef`,
exactly as a freshly allocated reference `Solutions` would be.
"""
function load_framework_solutions(path::AbstractString)::Solutions
    h5open(path, "r") do f
        @assert read_attribute(f, "__ebm_type__") == "Solutions"
        st = _spacetime(f["spacetime"])
        forcing = _forcing(f["forcing"])
        par = _scalar_collection(f["parameters"])
        init = _vec_collection(f["initconds"])
        vars = Set(Symbol.(keys(f["raw"])))
        sols = Solutions(st, forcing, par, init, vars, Bool(read_attribute(f, "lastonly")))
        for k in keys(f["raw"])
            cols = _columns(read(f["raw"][k]))
            for (i, c) in enumerate(cols)
                getproperty(sols.raw, Symbol(k))[i] = c
            end
        end
        for season in (:winter, :summer, :avg)
            g = f["seasonal"][String(season)]
            store = getproperty(sols.seasonal, season)
            for k in keys(g)
                cols = _columns(read(g[k]))
                for (i, c) in enumerate(cols)
                    getproperty(store, Symbol(k))[i] = c
                end
            end
        end
        sols
    end
end
