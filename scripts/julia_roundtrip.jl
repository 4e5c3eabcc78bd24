# CI-able JLD2 round-trip harness between the reference Julia package and
# the JAX framework (promoted from docs/julia_interop.jl, which keeps
# the plain-HDF5 loader documentation).
#
# The build image has no Julia, so this runs in any environment that has
# Julia >= 1.10 with EnergyBalanceModel and JLD2 in the project
# (tests/test_julia_roundtrip.py invokes it and skips when `julia` is
# absent). Two modes:
#
#   julia scripts/julia_roundtrip.jl write OUT.jld2 [nx nt]
#       Run a small reference MIZ config and `jldsave` the Solutions —
#       a *genuine* JLD2.jl file for the Python reader
#       (`energybalancemodel_jl_tpu.io_jld2.load_jld2_solutions`) to open.
#
#   julia scripts/julia_roundtrip.jl read IN.jld2
#       `JLD2.load_object` a file written by the Python side
#       (`energybalancemodel_jl_tpu.io_jld2.write_jld2`), assert it
#       reconstructs a reference `Solutions`, and print field checksums
#       for the Python harness to compare.

using EnergyBalanceModel
using JLD2

const EBM = EnergyBalanceModel

function writemode(path::AbstractString, nx::Int, nt::Int)
    st = SpaceTime{sin}(nx, nt, 1)
    par = default_parameters(:MIZ)
    init = Collection{EBM.Vec}()
    for var in (:Ei, :Ew, :h, :D, :phi, :T, :Ti, :Tw, :E, :n)
        setproperty!(init, var, zeros(st.nx))
    end
    sols = integrate(:MIZ, st, Forcing(0.0), par, init)
    jldsave(path; sols=sols)
    println("wrote $path")
end

function readmode(path::AbstractString)
    sols = JLD2.load_object(path)
    @assert sols isa Solutions "expected Solutions, got $(typeof(sols))"
    println("type=", typeof(sols))
    println("nx=", sols.spacetime.nx, " nt=", sols.spacetime.nt,
            " dur=", sols.spacetime.dur)
    for var in sort!(collect(propertynames(sols.raw)))
        vecs = getproperty(sols.raw, var)
        s = 0.0
        for i in eachindex(vecs)
            isassigned(vecs, i) || continue
            s += sum(x -> isnan(x) ? 0.0 : x, vecs[i])
        end
        println("checksum raw.", var, "=", s)
    end
    println("OK")
end

function main()
    mode = ARGS[1]
    if mode == "write"
        nx = length(ARGS) >= 3 ? parse(Int, ARGS[3]) : 40
        nt = length(ARGS) >= 4 ? parse(Int, ARGS[4]) : 200
        writemode(ARGS[2], nx, nt)
    elseif mode == "read"
        readmode(ARGS[2])
    else
        error("usage: julia julia_roundtrip.jl write|read PATH")
    end
end

main()
