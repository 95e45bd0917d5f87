"""Complex hopping (Peierls phases / twisted boundary conditions).

The reference is type-generic over complex matrix elements — ``Continuous =
Union{AbstractFloat,Complex}`` (Models.jl:20), ``conj(s)`` on the second
bond endpoint (Checkerboard.jl:78,116,137), complex ``Bond{T}``
(Models.jl:32-56). This exercises this package's complex surface: the
Hermitian checkerboard tables, mulM / mulMT (≡ M†) / mulMTM (≡ M†M), the
dense expK fast path, and the Hermitian-inner-product CG
(utils/dtypes.fdot) — against independent dense numpy constructions at f64
(conftest enables x64) plus one f32/complex64 smoke test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from elphdynamics_tpu.lattice import Lattice, UnitCell
from elphdynamics_tpu.models import holstein as H
from elphdynamics_tpu.models.adapter import make_model_ops

from tests.dense_reference import dense_M, dense_expK, flatten_field


def _build(L=4, twist=(0.7, 0.3), dense_threshold=4096, dtype=None,
           beta=0.8, dtau=0.1):
    uc = UnitCell.create(2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
    lat = Lattice.create(uc, L)
    return H.build_holstein(
        lat, beta=beta, dtau=dtau,
        t_assignments=[(1.0, 0.0, 0, 0, (1, 0, 0)),
                       (1.0, 0.0, 0, 0, (0, 1, 0))],
        omega=1.0, lam=0.6, mu=0.0, twist=twist,
        dense_threshold=dense_threshold, dtype=dtype)


def test_twist_zero_keeps_real_dtype():
    spec0, p0 = _build(twist=None)
    specz, pz = _build(twist=(0.0, 0.0))
    assert not jnp.iscomplexobj(p0.cosht)
    assert not jnp.iscomplexobj(pz.cosht)
    np.testing.assert_array_equal(np.asarray(p0.sinht), np.asarray(pz.sinht))


@pytest.mark.parametrize("dense", [False, True])
def test_complex_expk_matches_dense_reference_and_is_hermitian(dense):
    spec, p = _build(dense_threshold=4096 if dense else 0)
    ckb = spec.ckb
    cosh_np = np.asarray(p.cosht)
    sinh_np = np.asarray(p.sinht)
    ref = dense_expK(spec.Nsites, ckb.neighbor_table, ckb.groups,
                     cosh_np, sinh_np)
    # nontrivially complex (each bond BLOCK is Hermitian; their ordered
    # product is not — hence the reversed-order fold IS the adjoint)
    assert np.abs(ref.imag).max() > 1e-3

    eye = np.eye(spec.Nsites, dtype=np.complex128)
    got = np.asarray(H.apply_expK(spec, p, jnp.asarray(eye)))
    # apply_expK acts on columns: got[:, j] = expK @ e_j ⇒ got == expK
    np.testing.assert_allclose(got, ref, atol=1e-12)
    gotT = np.asarray(H.apply_expK_T(spec, p, jnp.asarray(eye)))
    np.testing.assert_allclose(gotT, ref.conj().T, atol=1e-12)

    if not dense:
        # the inverse fold really inverts (c² − |s|² = 1 per block)
        from elphdynamics_tpu.ops.checkerboard import ckb_inverse_mul
        vin = jnp.asarray(
            np.random.default_rng(0).standard_normal((spec.Nsites, 3))
            + 1j * np.random.default_rng(1).standard_normal((spec.Nsites, 3)))
        back = ckb_inverse_mul(ckb, p.cosht, p.sinht,
                               H.apply_expK(spec, p, vin))
        np.testing.assert_allclose(np.asarray(back), np.asarray(vin),
                                   atol=1e-12)


def test_complex_mulM_and_adjoint_match_dense():
    spec, p = _build()
    rng = np.random.default_rng(2)
    x = 0.4 * rng.standard_normal((spec.Nsites, spec.Ltau))
    env = np.asarray(H.expnV(spec, p, jnp.asarray(x)))

    expK = dense_expK(spec.Nsites, spec.ckb.neighbor_table, spec.ckb.groups,
                      np.asarray(p.cosht), np.asarray(p.sinht))
    B = [expK @ np.diag(env[:, tau]) for tau in range(spec.Ltau)]
    Mref = dense_M(B)

    v = rng.standard_normal((spec.Nsites, spec.Ltau)) \
        + 1j * rng.standard_normal((spec.Nsites, spec.Ltau))
    got = np.asarray(H.mulM(spec, p, jnp.asarray(env), jnp.asarray(v)))
    np.testing.assert_allclose(flatten_field(got), Mref @ flatten_field(v),
                               atol=1e-12)
    # mulMT is the ADJOINT M† on the complex path
    gotT = np.asarray(H.mulMT(spec, p, jnp.asarray(env), jnp.asarray(v)))
    np.testing.assert_allclose(flatten_field(gotT),
                               Mref.conj().T @ flatten_field(v), atol=1e-12)
    # M†M agrees and is Hermitian positive definite in the Re⟨·,·⟩ sense
    gotN = np.asarray(H.mulMTM(spec, p, jnp.asarray(env), jnp.asarray(v)))
    np.testing.assert_allclose(
        flatten_field(gotN), Mref.conj().T @ (Mref @ flatten_field(v)),
        atol=1e-11)


def test_complex_cg_solves_hermitian_normal_equations():
    from elphdynamics_tpu.dynamics.solve import SolverConfig, solve_minv, solve_oinv

    spec, p = _build()
    ops = make_model_ops(spec)
    rng = np.random.default_rng(3)
    x = 0.4 * rng.standard_normal((spec.Nsites, spec.Ltau))
    env = ops.derived(p, jnp.asarray(x))
    rhs = jnp.asarray(rng.standard_normal((2, spec.Nsites, spec.Ltau))
                      + 1j * rng.standard_normal((2, spec.Nsites, spec.Ltau)))
    scfg = SolverConfig(tol=1e-9, maxiter=3000)
    res = solve_oinv(ops, p, env, rhs, scfg, None)
    assert int(res.flag.max()) == 0
    r = ops.mulMTM(p, env, res.x) - rhs
    rel = float(jnp.sqrt(jnp.sum(jnp.abs(r) ** 2))
                / jnp.sqrt(jnp.sum(jnp.abs(rhs) ** 2)))
    assert rel < 1e-8, rel

    res2 = solve_minv(ops, p, env, rhs, scfg, None)
    assert int(res2.flag.max()) == 0
    r2 = ops.mulM(p, env, res2.x) - rhs
    rel2 = float(jnp.sqrt(jnp.sum(jnp.abs(r2) ** 2))
                 / jnp.sqrt(jnp.sum(jnp.abs(rhs) ** 2)))
    assert rel2 < 1e-8, rel2


def test_complex_f32_smoke():
    """complex64 path: dense-mode operators + CG to f32-appropriate tol."""
    from elphdynamics_tpu.dynamics.solve import SolverConfig, solve_oinv

    spec, p = _build(dtype=jnp.float32)
    assert p.cosht.dtype == jnp.complex64
    ops = make_model_ops(spec)
    rng = np.random.default_rng(4)
    x = jnp.asarray(0.4 * rng.standard_normal((spec.Nsites, spec.Ltau)),
                    jnp.float32)
    env = ops.derived(p, x)
    rhs = jnp.asarray((rng.standard_normal((2, spec.Nsites, spec.Ltau))
                       + 1j * rng.standard_normal(
                           (2, spec.Nsites, spec.Ltau))), jnp.complex64)
    res = solve_oinv(ops, p, env, rhs, SolverConfig(tol=1e-4, maxiter=2000),
                     None)
    assert int(res.flag.max()) == 0
    assert float(res.residual.max()) < 3e-2  # sqrt-tol verification ball


# ---------------------------------------------------------------------------
# round 4+: the complex path through the DYNAMICS stack (HMC / Langevin).
# The complex pseudofermion packs the two real spin fields as Re/Im
# (utils.dtypes.pseudofermion_noise): at zero twist the algorithm must
# reproduce the real two-spin action and forces EXACTLY (analytically equal;
# numerically to solver tolerance).
# ---------------------------------------------------------------------------

def _forced_complex(L=4, lam=0.6, beta=0.8, dtau=0.1):
    """Same model twice: real dtype, and complex dtype at ZERO twist
    (complex t values force the dtype; the matrices are numerically real)."""
    uc = UnitCell.create(2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
    lat = Lattice.create(uc, L)
    kw = dict(beta=beta, dtau=dtau, omega=1.0, lam=lam, mu=-0.1)
    ta_r = [(1.0, 0.0, 0, 0, (1, 0, 0)), (1.0, 0.0, 0, 0, (0, 1, 0))]
    ta_c = [(1.0 + 0.0j, 0.0, 0, 0, (1, 0, 0)),
            (1.0 + 0.0j, 0.0, 0, 0, (0, 1, 0))]
    spec_r, p_r = H.build_holstein(lat, t_assignments=ta_r, **kw)
    spec_c, p_c = H.build_holstein(lat, t_assignments=ta_c, **kw)
    return (spec_r, p_r), (spec_c, p_c)


def test_complex_packed_action_and_forces_match_real_two_spin():
    """S and dS/dx from the packed complex pseudofermion φ = Mᵀ(R↑+iR↓)
    equal the two-spin real values at zero twist (f64, tight tol)."""
    from elphdynamics_tpu.dynamics.solve import SolverConfig, solve_oinv
    from elphdynamics_tpu.models.adapter import make_model_ops
    from elphdynamics_tpu.utils.dtypes import fdot

    (spec_r, p_r), (spec_c, p_c) = _forced_complex()
    ops_r = make_model_ops(spec_r)
    ops_c = make_model_ops(spec_c)
    rng = np.random.default_rng(7)
    x = jnp.asarray(0.4 * rng.standard_normal((spec_r.Nsites, spec_r.Ltau)))
    R = jnp.asarray(rng.standard_normal((2, spec_r.Nsites, spec_r.Ltau)))
    scfg = SolverConfig(tol=1e-12, maxiter=5000)

    def pipeline(ops, p, Rs):
        derived = ops.derived(p, x)
        MtR = ops.mulMT(p, derived, Rs)
        Lam = ops.calc_Lambda(p, x)
        phi = ops.mulLambdaInv(Lam, MtR)
        Lphi = ops.mulLambda(Lam, phi)
        z = solve_oinv(ops, p, derived, Lphi, scfg, None).x
        S = fdot(Lphi, z, axis=(0, -2, -1)) / 2
        Mz = ops.mulM(p, derived, z)
        dmdx = ops.muldMdx(p, derived, x, Mz, z)
        dSf = -jnp.sum(dmdx, axis=0)
        dSf = dSf + jnp.sum(ops.muldLambdadx(p, x, Lam, phi, z), axis=0)
        return S, dSf

    S_r, F_r = pipeline(ops_r, p_r, R)
    S_c, F_c = pipeline(ops_c, p_c, (R[0] + 1j * R[1])[None])
    assert not jnp.iscomplexobj(S_c) and not jnp.iscomplexobj(F_c)
    np.testing.assert_allclose(float(S_c), float(S_r), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(F_c), np.asarray(F_r), atol=1e-8)


def test_hmc_on_twisted_lattice_accepts_and_conserves():
    """Full HMC updates on a genuinely twisted 4×4 Holstein lattice: real
    phonon field, flag-free solves, near-unit acceptance at small dt (f64,
    unpreconditioned CG)."""
    from elphdynamics_tpu.dynamics.hmc import HMCConfig, HMCState, make_hmc_step
    from elphdynamics_tpu.dynamics.init_phonons import init_phonons_half_filled
    from elphdynamics_tpu.models.adapter import make_model_ops
    from elphdynamics_tpu.ops.fourier_accel import build_mass

    uc = UnitCell.create(2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
    lat = Lattice.create(uc, 4)
    spec, p = H.build_holstein(lat, beta=2.0, dtau=0.1, omega=1.0, lam=0.6,
                               mu=-0.1, twist=(0.7, 0.3))
    assert jnp.iscomplexobj(p.cosht)
    ops = make_model_ops(spec)
    mass = build_mass(np.asarray(p.omega), spec.dtau, spec.Ltau,
                      [dict(omega_min=0.0, omega_max=10.0, mass=1.0)])
    cfg = HMCConfig(dt=0.05, trajectory_time=0.5, Nb=4, tol=1e-8, maxiter=4000)
    step = jax.jit(make_hmc_step(ops, mass, cfg))
    key = jax.random.PRNGKey(3)
    x, key = init_phonons_half_filled(ops, p, key)
    st = HMCState(x=x, v=jnp.zeros_like(x))
    n_acc, dHs = 0, []
    for _ in range(6):
        st, stats, key = step(p, st, key)
        assert int(stats.flag) == 0
        assert not jnp.iscomplexobj(st.x)
        n_acc += int(stats.accepted)
        dHs.append(abs(float(stats.delta_H)))
    assert n_acc >= 5, (n_acc, dHs)
    assert max(dHs) < 0.5, dHs


def test_twist_2pi_is_gauge_equivalent_to_zero():
    """A 2π twist is a pure gauge: det M identical (the framework samples
    gauge-invariant weights, so EVERY observable of the run coincides)."""
    uc = UnitCell.create(2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
    lat = Lattice.create(uc, 4)
    kw = dict(beta=0.8, dtau=0.1, omega=1.0, lam=0.6, mu=0.0)
    spec0, p0 = H.build_holstein(lat, **kw)
    spec2, p2 = H.build_holstein(lat, twist=(2 * np.pi, 0.0), **kw)
    rng = np.random.default_rng(5)
    x = 0.4 * rng.standard_normal((spec0.Nsites, spec0.Ltau))

    def dense_logdet(spec, p):
        env = np.asarray(H.expnV(spec, p, jnp.asarray(x)))
        expK = dense_expK(spec.Nsites, spec.ckb.neighbor_table,
                          spec.ckb.groups, np.asarray(p.cosht),
                          np.asarray(p.sinht))
        M = dense_M([expK @ np.diag(env[:, t]) for t in range(spec.Ltau)])
        sign, logabs = np.linalg.slogdet(M)
        return sign, logabs

    s0, l0 = dense_logdet(spec0, p0)
    s2, l2 = dense_logdet(spec2, p2)
    np.testing.assert_allclose(l2, l0, rtol=1e-10)
    np.testing.assert_allclose(s2, complex(s0), atol=1e-9)


def test_langevin_on_twisted_lattice_runs():
    """Langevin force on the complex path: real forces from the circular
    complex trace probe (E[gg†] = I), flag-free solves."""
    from elphdynamics_tpu.dynamics.langevin import make_langevin_step
    from elphdynamics_tpu.dynamics.solve import SolverConfig
    from elphdynamics_tpu.models.adapter import make_model_ops
    from elphdynamics_tpu.ops.fourier_accel import build_Q

    uc = UnitCell.create(2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
    lat = Lattice.create(uc, 4)
    spec, p = H.build_holstein(lat, beta=1.0, dtau=0.1, omega=1.0, lam=0.6,
                               mu=0.0, twist=(0.5, 0.9))
    ops = make_model_ops(spec)
    Q = build_Q(np.asarray(p.omega), spec.dtau, spec.Ltau,
                [dict(omega_min=0.0, omega_max=10.0, mass=0.0)])
    step = jax.jit(make_langevin_step(ops, Q, 1e-3, "rk",
                                      SolverConfig(tol=1e-8, maxiter=4000)))
    key = jax.random.PRNGKey(1)
    rng = np.random.default_rng(2)
    x = jnp.asarray(0.3 * rng.standard_normal((spec.Nsites, spec.Ltau)))
    for _ in range(3):
        x, stats, key = step(p, x, key)
        assert int(stats.flag) == 0
        assert not jnp.iscomplexobj(x)


def test_special_updates_on_twisted_lattice():
    """Reflection update under complex hopping: the exact-S₀ φ refresh packs
    the spins into one complex field; moves accept/reject with real S."""
    from elphdynamics_tpu.dynamics.special_updates import (
        SpecialUpdateConfig, make_reflection_update)
    from elphdynamics_tpu.models.adapter import make_model_ops

    uc = UnitCell.create(2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
    lat = Lattice.create(uc, 4)
    spec, p = H.build_holstein(lat, beta=1.0, dtau=0.1, omega=1.0, lam=0.6,
                               mu=0.0, twist=(0.7, 0.3))
    ops = make_model_ops(spec)
    upd = jax.jit(make_reflection_update(
        ops, SpecialUpdateConfig(freq=1, n_moves=2, tol=1e-9, maxiter=4000)))
    key = jax.random.PRNGKey(11)
    rng = np.random.default_rng(4)
    x = jnp.asarray(0.3 * rng.standard_normal((spec.Nsites, spec.Ltau)))
    x2, n_acc, key = upd(p, x, key)
    assert not jnp.iscomplexobj(x2)
    assert x2.shape == x.shape


# ---------------------------------------------------------------------------
# SSH complex hopping (VERDICT r4 item 5): the reference's type surface is
# generic over complex matrix elements for BOTH models (Models.jl:20,
# SSHModels.jl parameterized over T2); this package threads the Peierls
# phases through the time-dependent per-(τ,bond) checkerboard tables and
# the muldMdx group fold (the phonon is real — only the bare amplitude
# carries a phase).
# ---------------------------------------------------------------------------

from elphdynamics_tpu.models import ssh as S
from tests.dense_reference import dense_M as _dense_M_blocks


def _build_ssh(L=4, Ltau=8, alpha=0.4, alpha2=0.1, mu=-0.2, twist=(0.7,),
               seed=0):
    uc = UnitCell.create(1, 1, [[1.0]], [[0.0]])
    lat = Lattice.create(uc, L)
    spec, params = S.build_ssh(
        lat, beta=Ltau * 0.1, dtau=0.1,
        hoppings=[dict(t=1.0, omega=1.0, alpha=alpha, alpha2=alpha2,
                       o1=0, o2=0, dL=(1, 0, 0), name="ph")],
        mu_assignments=[(mu, 0.0, None)],
        twist=twist,
        rng=np.random.default_rng(seed),
    )
    rng = np.random.default_rng(seed + 1)
    x = jnp.asarray(0.3 * rng.standard_normal((spec.Nph, spec.Ltau)))
    return spec, params, S.tie_fields(spec, x)


def _dense_ssh_M(spec, params, x):
    from tests.dense_reference import dense_expK as _dense_expK

    coeffs = S.ckb_coeffs(spec, params, x)
    cB = np.asarray(coeffs[0])
    sB = np.asarray(coeffs[1])
    emu = np.asarray(S.exp_mu(spec, params))[:, 0]
    Bs = [
        _dense_expK(spec.Nsites, spec.ckb.neighbor_table, spec.ckb.groups,
                    cB[:, tau], sB[:, tau]) @ np.diag(emu)
        for tau in range(spec.Ltau)
    ]
    return _dense_M_blocks(Bs)


def test_ssh_twist_zero_keeps_real():
    s0, p0, _ = _build_ssh(twist=None)
    sz, pz, _ = _build_ssh(twist=(0.0,))
    assert p0.t_phase is None and pz.t_phase is None
    from elphdynamics_tpu.utils.dtypes import params_are_complex
    assert not params_are_complex(p0)
    st, pt, _ = _build_ssh()
    assert params_are_complex(pt)
    assert not jnp.iscomplexobj(pt.t)  # magnitude stays real


def test_ssh_complex_mulM_and_adjoint_match_dense():
    spec, params, x = _build_ssh()
    coeffs = S.ckb_coeffs(spec, params, x)
    assert jnp.iscomplexobj(coeffs.sinh)
    M = _dense_ssh_M(spec, params, x)
    assert np.abs(M.imag).max() > 1e-3
    rng = np.random.default_rng(7)
    v = rng.standard_normal((spec.Nsites, spec.Ltau)) \
        + 1j * rng.standard_normal((spec.Nsites, spec.Ltau))
    got = np.asarray(S.mulM(spec, params, coeffs, jnp.asarray(v))).reshape(-1)
    np.testing.assert_allclose(got, M @ v.reshape(-1), atol=1e-12)
    # the "transpose" fold is the ADJOINT M† on the complex path
    gotT = np.asarray(S.mulMT(spec, params, coeffs, jnp.asarray(v))).reshape(-1)
    np.testing.assert_allclose(gotT, M.conj().T @ v.reshape(-1), atol=1e-12)
    # M†M is Hermitian positive definite under the real Hermitian product
    got2 = np.asarray(S.mulMTM(spec, params, coeffs, jnp.asarray(v))).reshape(-1)
    np.testing.assert_allclose(got2, (M.conj().T @ M) @ v.reshape(-1),
                               atol=1e-11)


def test_ssh_complex_muldMdx_matches_autodiff():
    """d/dx Re(u†·M(x)·v) for fixed complex u, v — the contraction whose
    Re-placement the pseudofermion force uses (α₂ = 0 where the reference's
    dK/dx convention is exact, as in the real-path autodiff test)."""
    spec, params, x = _build_ssh(alpha2=0.0)
    rng = np.random.default_rng(10)
    u = jnp.asarray(rng.standard_normal((spec.Nsites, spec.Ltau))
                    + 1j * rng.standard_normal((spec.Nsites, spec.Ltau)))
    v = jnp.asarray(rng.standard_normal((spec.Nsites, spec.Ltau))
                    + 1j * rng.standard_normal((spec.Nsites, spec.Ltau)))
    coeffs = S.ckb_coeffs(spec, params, x)
    got = np.asarray(S.muldMdx(spec, params, coeffs, x, u, v))
    assert not np.iscomplexobj(got)

    def f(xx):
        cc = S.ckb_coeffs(spec, params, xx)
        return jnp.real(jnp.sum(jnp.conj(u) * S.mulM(spec, params, cc, v)))

    want = np.asarray(jax.grad(f)(x))
    np.testing.assert_allclose(got, want, atol=1e-10)


@pytest.mark.slow
def test_ssh_twisted_hmc_accepts_and_conserves():
    """Full HMC updates on the twisted SSH chain: complex KPM
    preconditioner, TRS pseudofermion packing, adjoint solves — finite,
    accepting, small |ΔH|."""
    from elphdynamics_tpu.dynamics.hmc import HMCConfig, HMCState, make_hmc_step
    from elphdynamics_tpu.dynamics.init_phonons import init_phonons_half_filled
    from elphdynamics_tpu.models.adapter import make_model_ops
    from elphdynamics_tpu.ops import kpm
    from elphdynamics_tpu.ops.fourier_accel import build_mass

    spec, params, x0 = _build_ssh(Ltau=10, alpha=0.3, alpha2=0.0)
    ops = make_model_ops(spec)
    mass = build_mass(np.asarray(params.omega), spec.dtau, spec.Ltau,
                      [dict(omega_min=0.0, omega_max=10.0, mass=0.5)])
    cfg = HMCConfig(dt=0.05, trajectory_time=0.25, Nb=4, tol=1e-7,
                    maxiter=2000, construct_guess=True, guess_order=3)
    precond = kpm.make_symmetric_precond(ops, kpm.KPMConfig(max_order=8))
    key = jax.random.PRNGKey(0)
    x, _ = init_phonons_half_filled(ops, params, key)
    st = HMCState(x=x, v=jnp.zeros_like(x))
    step = jax.jit(make_hmc_step(ops, mass, cfg, precond))
    n_acc = 0
    dhs = []
    for _ in range(6):
        st, stats, key = step(params, st, key)
        assert int(stats.flag) == 0
        n_acc += int(stats.accepted)
        dhs.append(abs(float(stats.delta_H)))
    assert np.all(np.isfinite(np.asarray(st.x)))
    assert n_acc >= 5, (n_acc, dhs)
    assert np.median(dhs) < 0.1, dhs
