"""Operator tests: diffusion stencil bands, tridiagonal solvers, Newton."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from energybalancemodel_jl_tpu import SpaceTime, default_parameters
from energybalancemodel_jl_tpu.ops import (
    apply_diffusion,
    diffusion,
    diffusion_bands,
    newton_tridiag,
    pcr_solve,
    thomas_solve,
    tridiag_matvec,
    tridiag_solve,
)

from ref_impl import MIZRef, diffusion_matrix, make_grid


def bands_to_dense(lo, di, up):
    n = len(di)
    A = np.diag(di)
    A += np.diag(lo[1:], -1)
    A += np.diag(up[:-1], 1)
    return A


class TestDiffusion:
    @pytest.mark.parametrize("grid", ["identity", "sin"])
    def test_bands_match_reference_matrix(self, grid):
        st = SpaceTime(40, 100, 1, grid=grid,
                       urange=(0.0, 1.0) if grid == "identity" else (0.0, np.pi / 2))
        geom = diffusion_bands(st)
        dense = bands_to_dense(geom.lo, geom.di, geom.up)
        ref = diffusion_matrix(st.nx, grid, st.x)
        np.testing.assert_allclose(dense, ref, atol=1e-9)

    @pytest.mark.parametrize("grid", ["identity", "sin"])
    def test_apply_matches_matvec(self, grid, rng):
        st = SpaceTime.sin(50, 10, 1) if grid == "sin" else SpaceTime.identity(50, 10, 1)
        geom = diffusion_bands(st)
        T = rng.normal(size=st.nx)
        out = np.asarray(apply_diffusion(jnp.asarray(T), geom, 0.6))
        ref = 0.6 * diffusion_matrix(st.nx, grid, st.x) @ T
        np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-10)

    def test_analytic_polynomial(self):
        # On the uniform grid, d/dx[(1-x^2) dT/dx] for T = x^2 is 2 - 6x^2;
        # the interior stencil is second-order accurate for polynomials.
        st = SpaceTime.identity(400, 10, 1)
        T = st.x**2
        out = np.asarray(diffusion(T, st, {"D": 1.0}))
        expected = 2.0 - 6.0 * st.x**2
        interior = slice(5, -5)
        np.testing.assert_allclose(out[interior], expected[interior], atol=2e-3)

    def test_conservation(self, rng):
        # flux form with zero-flux boundaries conserves area-weighted integral
        # on the uniform grid: sum of D∇²T * dx = 0
        st = SpaceTime.identity(64, 10, 1)
        T = rng.normal(size=st.nx)
        out = np.asarray(diffusion(T, st, {"D": 0.6}))
        assert abs(out.sum()) < 1e-8

    def test_batched_application(self, rng):
        st = SpaceTime.sin(30, 10, 1)
        geom = diffusion_bands(st)
        T = rng.normal(size=(7, st.nx))
        out = np.asarray(apply_diffusion(jnp.asarray(T), geom, 0.6))
        for i in range(7):
            single = np.asarray(apply_diffusion(jnp.asarray(T[i]), geom, 0.6))
            np.testing.assert_allclose(out[i], single, rtol=1e-14)


def random_diag_dominant(rng, n, batch=()):
    lo = rng.normal(size=batch + (n,))
    up = rng.normal(size=batch + (n,))
    lo[..., 0] = 0.0
    up[..., -1] = 0.0
    di = np.abs(lo) + np.abs(up) + 1.0 + rng.uniform(0, 1, size=batch + (n,))
    di *= np.where(rng.uniform(size=batch + (n,)) < 0.5, -1.0, 1.0)
    b = rng.normal(size=batch + (n,))
    return lo, di, up, b


class TestTridiag:
    @pytest.mark.parametrize("method", ["thomas", "pcr"])
    @pytest.mark.parametrize("n", [1, 2, 3, 7, 64, 180])
    def test_matches_dense_solve(self, method, n, rng):
        lo, di, up, b = random_diag_dominant(rng, n)
        x = np.asarray(tridiag_solve(*map(jnp.asarray, (lo, di, up, b)), method=method))
        expected = np.linalg.solve(bands_to_dense(lo, di, up), b)
        np.testing.assert_allclose(x, expected, rtol=1e-9, atol=1e-9)

    @pytest.mark.parametrize("method", ["thomas", "pcr"])
    def test_batched(self, method, rng):
        lo, di, up, b = random_diag_dominant(rng, 50, batch=(6,))
        x = np.asarray(tridiag_solve(*map(jnp.asarray, (lo, di, up, b)), method=method))
        for i in range(6):
            expected = np.linalg.solve(bands_to_dense(lo[i], di[i], up[i]), b[i])
            np.testing.assert_allclose(x[i], expected, rtol=1e-9, atol=1e-9)

    def test_matvec_roundtrip(self, rng):
        lo, di, up, b = random_diag_dominant(rng, 80)
        x = np.asarray(pcr_solve(*map(jnp.asarray, (lo, di, up, b))))
        r = np.asarray(tridiag_matvec(*map(jnp.asarray, (lo, di, up, x))))
        np.testing.assert_allclose(r, b, rtol=1e-9, atol=1e-9)

    def test_vmap_and_jit(self, rng):
        lo, di, up, b = random_diag_dominant(rng, 32, batch=(4,))
        f = jax.jit(jax.vmap(thomas_solve))
        x = np.asarray(f(*map(jnp.asarray, (lo, di, up, b))))
        for i in range(4):
            expected = np.linalg.solve(bands_to_dense(lo[i], di[i], up[i]), b[i])
            np.testing.assert_allclose(x[i], expected, rtol=1e-9)

    def test_float32(self, rng):
        lo, di, up, b = random_diag_dominant(rng, 64)
        args32 = [jnp.asarray(v, dtype=jnp.float32) for v in (lo, di, up, b)]
        x = np.asarray(pcr_solve(*args32))
        expected = np.linalg.solve(bands_to_dense(lo, di, up), b)
        np.testing.assert_allclose(x, expected, rtol=2e-3, atol=2e-3)


class TestNewton:
    def test_solves_miz_t0eq_vs_scipy(self, rng):
        """The framework Newton and SciPy MINPACK must find the same root of
        the MIZ surface-temperature equation."""
        nx = 60
        par = dict(default_parameters("MIZ"))
        ref = MIZRef(nx, 100, "sin", par)
        h = np.abs(rng.normal(0.5, 0.3, nx))
        h[rng.uniform(size=nx) < 0.3] = 0.0
        hp = np.where(h == 0.0, par["hmin"], h)
        Tw = rng.normal(0, 2, nx)
        phi = np.clip(rng.uniform(-0.2, 1.0, nx), 0.0, 1.0)
        t, f = 0.3, 1.0
        from energybalancemodel_jl_tpu.models.base import StepConfig
        from energybalancemodel_jl_tpu.models.miz import solve_T0, statics

        st = SpaceTime.sin(nx, 100, 1)
        stat = statics(st, {k: jnp.float64(v) for k, v in par.items()}, jnp.float64)
        insol = jnp.asarray(ref.insol(t))
        cfg = StepConfig()
        T0, converged, iters = solve_T0(
            jnp.zeros(nx), insol, jnp.asarray(h), jnp.asarray(Tw), jnp.asarray(phi),
            f, stat, {k: jnp.float64(v) for k, v in par.items()}, cfg,
        )
        assert bool(jnp.all(converged))
        T0 = np.asarray(T0)
        # residual is tiny in the *oracle's* residual function
        resid = ref.t0eq(T0, t, hp, Tw, phi, f)
        assert np.max(np.abs(resid)) < 1e-7
        # independent verification: MINPACK polishing from the Newton root
        # confirms it is a root and does not move it
        import scipy.optimize

        sol = scipy.optimize.root(
            ref.t0eq, T0, args=(t, hp, Tw, phi, f), jac=ref.t0jac,
            method="hybr", tol=1e-13,
        )
        assert sol.success
        np.testing.assert_allclose(T0, sol.x, rtol=1e-8, atol=1e-8)

    def test_simple_scalar_system(self):
        # r(x) = x^2 - 4 elementwise (diagonal Jacobian)
        def rb(x):
            return x**2 - 4.0, (jnp.zeros_like(x), 2 * x, jnp.zeros_like(x))

        x, conv, it = newton_tridiag(rb, jnp.full(8, 3.0))
        assert bool(jnp.all(conv))
        np.testing.assert_allclose(np.asarray(x), 2.0, rtol=1e-9)


class TestPCRWidths:
    """PCR at the canonical width in float32, along either axis."""

    def test_float32_batch_at_canonical_width(self, rng):
        K, n = 9, 180
        lo = rng.normal(size=(K, n)); up = rng.normal(size=(K, n))
        lo[:, 0] = 0.0; up[:, -1] = 0.0
        di = np.abs(lo) + np.abs(up) + 1.0 + rng.uniform(0, 1, (K, n))
        b = rng.normal(size=(K, n))
        a32 = lambda v: jnp.asarray(v, jnp.float32)
        out = np.asarray(pcr_solve(a32(lo), a32(di), a32(up), a32(b)))
        for i in range(K):
            expected = np.linalg.solve(bands_to_dense(lo[i], di[i], up[i]),
                                       b[i])
            np.testing.assert_allclose(out[i], expected, rtol=2e-4,
                                       atol=2e-4)

    def test_shift_fills_zeros(self):
        from energybalancemodel_jl_tpu.ops.tridiag import _shift

        v = jnp.arange(1.0, 6.0)[None, :].repeat(2, axis=0)
        np.testing.assert_array_equal(np.asarray(_shift(v, 2))[0],
                                      [0, 0, 1, 2, 3])
        np.testing.assert_array_equal(np.asarray(_shift(v, -1))[1],
                                      [2, 3, 4, 5, 0])
        np.testing.assert_array_equal(np.asarray(_shift(v, 5)),
                                      np.zeros((2, 5)))

    @pytest.mark.parametrize("method", ["pcr_fused", "bogus"])
    def test_unknown_method_raises(self, rng, method):
        lo, di, up, b = random_diag_dominant(rng, 8)
        with pytest.raises(ValueError, match="Unknown tridiagonal solver"):
            tridiag_solve(*map(jnp.asarray, (lo, di, up, b)), method=method)
