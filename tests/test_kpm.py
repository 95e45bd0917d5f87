import jax
import jax.numpy as jnp
import numpy as np
import pytest

from elphdynamics_tpu import solvers
from elphdynamics_tpu.lattice import Lattice, UnitCell
from elphdynamics_tpu.models import holstein as H
from elphdynamics_tpu.models.adapter import make_model_ops
from elphdynamics_tpu.ops import kpm
from elphdynamics_tpu.ops.timefreqfft import omega_to_tau, tau_to_omega
from dense_reference import dense_expK, dense_M


def make_model(L=4, beta=2.0, lam=0.6, seed=0, x_scale=0.3):
    uc = UnitCell.create(2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
    lat = Lattice.create(uc, L)
    spec, params = H.build_holstein(
        lat, beta=beta, dtau=0.1,
        t_assignments=[(1.0, 0.0, 0, 0, (1, 0, 0)), (1.0, 0.0, 0, 0, (0, 1, 0))],
        omega=1.0, lam=lam, mu=-lam ** 2,
    )
    rng = np.random.default_rng(seed)
    x = jnp.asarray(x_scale * rng.standard_normal((spec.Nph, spec.Ltau)))
    return make_model_ops(spec), params, x


def test_tau_omega_roundtrip():
    rng = np.random.default_rng(0)
    v = jnp.asarray(rng.standard_normal((5, 7, 12)))
    w = tau_to_omega(v)
    back = omega_to_tau(w)
    assert np.allclose(back, v, atol=1e-12)


def test_kpm_exact_for_time_independent_field():
    """With x ≡ 0 the averaged operator Ā equals every B(τ), so the KPM
    block-diagonal inverse is exact: apply_left ≈ M⁻¹ at high order."""
    ops, params, _ = make_model(x_scale=0.0)
    x = jnp.zeros((ops.Nph, ops.Ltau))
    st = kpm.setup(ops, params, x, kpm.KPMConfig(max_order=96, c1=8.0, c2=8.0),
                   jax.random.PRNGKey(0))
    assert bool(st.active)
    env = H.expnV(ops.spec, params, x)
    expK = dense_expK(ops.Nsites, ops.spec.ckb.neighbor_table, ops.spec.ckb.groups,
                      np.asarray(params.cosht), np.asarray(params.sinht))
    M = dense_M([expK @ np.diag(np.asarray(env)[:, t]) for t in range(ops.Ltau)])
    rng = np.random.default_rng(1)
    v = rng.standard_normal((ops.Nsites, ops.Ltau))
    got = np.asarray(kpm.apply_left(ops, st, jnp.asarray(v))).reshape(-1)
    want = np.linalg.solve(M, v.reshape(-1))
    assert np.max(np.abs(got - want)) < 1e-4, np.max(np.abs(got - want))


def test_kpm_symmetric_reduces_cg_iterations():
    ops, params, x = make_model()
    env = ops.derived(params, x)
    st = kpm.setup(ops, params, x, kpm.KPMConfig(), jax.random.PRNGKey(0))
    assert bool(st.active)
    rng = np.random.default_rng(2)
    b = jnp.asarray(rng.standard_normal((ops.Nsites, ops.Ltau)))
    rhs = ops.mulMT(params, env, b)
    A = lambda v: ops.mulMTM(params, env, v)
    plain = solvers.cg(A, rhs, tol=1e-8, maxiter=4000)
    pre = solvers.cg(A, rhs, apply_P=lambda v: kpm.apply_symmetric(ops, st, v),
                     tol=1e-8, maxiter=4000)
    # solutions agree
    assert np.allclose(np.asarray(plain.x), np.asarray(pre.x), atol=1e-4)
    # and the preconditioner meaningfully cuts iterations
    assert int(pre.iters) < int(plain.iters), (int(pre.iters), int(plain.iters))
    assert int(pre.iters) <= int(plain.iters) * 0.7, (int(pre.iters), int(plain.iters))


def test_kpm_spin_batched():
    ops, params, x = make_model()
    st = kpm.setup(ops, params, x, kpm.KPMConfig(), jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    v = jnp.asarray(rng.standard_normal((2, ops.Nsites, ops.Ltau)))
    out = np.asarray(kpm.apply_symmetric(ops, st, v))
    for s in range(2):
        ref = np.asarray(kpm.apply_symmetric(ops, st, v[s]))
        assert np.allclose(out[s], ref, atol=1e-12)


@pytest.mark.slow
def test_exact_lowfreq_blocks_match_dense_inverse():
    """KPMConfig.exact_lowfreq (beyond-reference hybrid): with ALL
    frequencies exact and a τ-constant field, the symmetric apply IS
    (MᵀM)⁻¹ — validated against the dense inverse. With only the lowest k
    exact, CG must converge in (far) fewer iterations than pure Chebyshev
    at the same order on an ill-conditioned long-τ problem."""
    from elphdynamics_tpu.dynamics.solve import SolverConfig, solve_oinv

    ops, params, _ = make_model(L=4, beta=3.0, x_scale=0.0)
    x = jnp.zeros((ops.Nph, ops.Ltau))
    Lw = (ops.Ltau + 1) // 2

    # all frequencies exact → exact inverse for a τ-constant field
    st = kpm.setup(ops, params, x,
                   kpm.KPMConfig(max_order=8, exact_lowfreq=Lw),
                   jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    v = jnp.asarray(rng.standard_normal((ops.Nsites, ops.Ltau)))
    got = np.asarray(kpm.apply_symmetric(ops, st, v))

    env = ops.derived(params, x)
    NL = ops.Nsites * ops.Ltau
    eye = np.eye(NL)
    cols = ops.mulMT(params, env, ops.mulM(
        params, env, jnp.asarray(eye.reshape(NL, ops.Nsites, ops.Ltau))))
    MtM = np.asarray(cols).reshape(NL, NL).T
    want = np.linalg.solve(MtM, np.asarray(v).reshape(-1)).reshape(v.shape)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)

    # partial: k lowest exact beats pure Chebyshev on a long-τ problem
    ops2, params2, x2 = make_model(L=4, beta=6.0, lam=1.0, x_scale=0.3)
    scfg = SolverConfig(tol=1e-6, maxiter=1000)
    b = jnp.asarray(rng.standard_normal((2, ops2.Nsites, ops2.Ltau)))

    def iters_with(cfg):
        stp = kpm.setup(ops2, params2, x2, cfg, jax.random.PRNGKey(1))
        from elphdynamics_tpu.dynamics import solve as S
        env2 = ops2.derived(params2, x2)
        res = solve_oinv(ops2, params2, env2, b, scfg,
                         S.PrecondApplies(
                             symmetric=lambda w: kpm.apply_symmetric(
                                 ops2, stp, w, cfg),
                             left=None, right=None))
        return int(np.max(np.asarray(res.iters))), int(np.max(np.asarray(res.flag)))

    it_plain, fl1 = iters_with(kpm.KPMConfig(max_order=6))
    it_hyb, fl2 = iters_with(kpm.KPMConfig(max_order=6, exact_lowfreq=8))
    assert fl1 == 0 and fl2 == 0
    assert it_hyb < it_plain, (it_hyb, it_plain)


# ---------------------------------------------------------------------------
# complex hopping (Peierls phases / twisted BC): the preconditioner builds a
# full-spectrum complex pipeline (ops/kpm.py:_apply_complex) because complex
# CG fields have no conjugate symmetry to fold onto the half spectrum
# ---------------------------------------------------------------------------


def make_twisted_model(L=4, beta=2.0, lam=0.6, seed=0, x_scale=0.3,
                       twist=(0.7, 0.3), dense_threshold=4096):
    uc = UnitCell.create(2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
    lat = Lattice.create(uc, L)
    spec, params = H.build_holstein(
        lat, beta=beta, dtau=0.1,
        t_assignments=[(1.0, 0.0, 0, 0, (1, 0, 0)), (1.0, 0.0, 0, 0, (0, 1, 0))],
        omega=1.0, lam=lam, mu=-lam ** 2, twist=twist,
        dense_threshold=dense_threshold)
    rng = np.random.default_rng(seed)
    x = jnp.asarray(x_scale * rng.standard_normal((spec.Nph, spec.Ltau)))
    return make_model_ops(spec), params, x


def _crandn(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.mark.parametrize("dense", [True, False])
def test_kpm_complex_left_matches_dense_polynomial(dense):
    """apply_left on a twisted model must equal the per-ω Chebyshev
    polynomial of the dense averaged operator, built independently in numpy
    from the state's own (coeff, λavg, λmag) — an exact plumbing check of
    the full-spectrum complex pipeline on both the dense-expK and
    checkerboard-fold operator paths."""
    ops, params, x = make_twisted_model(dense_threshold=4096 if dense else 0)
    st = kpm.setup(ops, params, x, kpm.KPMConfig(max_order=24),
                   jax.random.PRNGKey(0))
    N, Ltau = ops.Nsites, ops.Ltau
    assert st.coeff.shape[1] == Ltau  # FULL spectrum for complex states
    A = kpm.dense_Abar(ops, st)
    assert np.abs(A.imag).max() > 1e-6
    Ap = (A - float(st.lam_avg) * np.eye(N)) / float(st.lam_mag)
    coeff = np.asarray(st.coeff)                      # [M, Ltau]

    rng = np.random.default_rng(1)
    v = _crandn(rng, (N, Ltau))
    u = np.asarray(tau_to_omega(jnp.asarray(v)))      # [N, Ltau]
    # per-ω recurrence: y(ω) = Σ_m c_m(ω)·T_m(Ap)·u(ω)
    t_nm1, t_n = u, Ap @ u
    y = coeff[0][None, :] * u + coeff[1][None, :] * t_n
    for m in range(2, coeff.shape[0]):
        t_nm1, t_n = t_n, 2.0 * (Ap @ t_n) - t_nm1
        y = y + coeff[m][None, :] * t_n
    want = np.asarray(omega_to_tau(jnp.asarray(y), real=False))

    got = np.asarray(kpm.apply_left(ops, st, jnp.asarray(v)))
    np.testing.assert_allclose(got, want, atol=1e-10)


def test_kpm_complex_exact_for_time_independent_field():
    """With x ≡ 0 every B(τ) equals Ā, so the block-diagonal KPM inverse is
    exact: apply_left ≈ M⁻¹ of the dense twisted fermion matrix."""
    ops, params, _ = make_twisted_model(x_scale=0.0)
    x = jnp.zeros((ops.Nph, ops.Ltau))
    st = kpm.setup(ops, params, x, kpm.KPMConfig(max_order=96, c1=8.0, c2=8.0),
                   jax.random.PRNGKey(0))
    assert bool(st.active)
    env = H.expnV(ops.spec, params, x)
    expK = dense_expK(ops.Nsites, ops.spec.ckb.neighbor_table,
                      ops.spec.ckb.groups,
                      np.asarray(params.cosht), np.asarray(params.sinht))
    M = dense_M([expK @ np.diag(np.asarray(env)[:, t])
                 for t in range(ops.Ltau)])
    rng = np.random.default_rng(1)
    v = _crandn(rng, (ops.Nsites, ops.Ltau))
    got = np.asarray(kpm.apply_left(ops, st, jnp.asarray(v))).reshape(-1)
    want = np.linalg.solve(M, v.reshape(-1))
    assert np.max(np.abs(got - want)) < 1e-4, np.max(np.abs(got - want))


def test_kpm_complex_symmetric_reduces_cg_iterations():
    """Twisted-model M†M CG with the complex symmetric preconditioner must
    reach the same solution in meaningfully fewer iterations — this is the
    path the driver now takes for twisted runs (simulation.py, previously an
    unpreconditioned fallback)."""
    ops, params, x = make_twisted_model()
    env = ops.derived(params, x)
    st = kpm.setup(ops, params, x, kpm.KPMConfig(), jax.random.PRNGKey(0))
    assert bool(st.active)
    rng = np.random.default_rng(2)
    b = jnp.asarray(_crandn(rng, (ops.Nsites, ops.Ltau)))
    rhs = ops.mulMT(params, env, b)
    A = lambda v: ops.mulMTM(params, env, v)
    plain = solvers.cg(A, rhs, tol=1e-8, maxiter=4000)
    pre = solvers.cg(A, rhs, apply_P=lambda v: kpm.apply_symmetric(ops, st, v),
                     tol=1e-8, maxiter=4000)
    assert np.allclose(np.asarray(plain.x), np.asarray(pre.x), atol=1e-4)
    assert int(pre.iters) <= int(plain.iters) * 0.7, \
        (int(pre.iters), int(plain.iters))


def test_kpm_complex_applies_are_mutually_adjoint_and_symmetric_is_psd():
    """apply_right must be the ⟨·,·⟩-adjoint of apply_left (M⁻ᴴ vs M⁻¹ roles
    for BiCGStab/GMRES), and apply_symmetric must be Hermitian PSD — the
    property that keeps CG under the real-embedding inner product
    (utils/dtypes.fdot) a genuine SPD-preconditioned CG."""
    ops, params, x = make_twisted_model()
    st = kpm.setup(ops, params, x, kpm.KPMConfig(), jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    u = jnp.asarray(_crandn(rng, (ops.Nsites, ops.Ltau)))
    w = jnp.asarray(_crandn(rng, (ops.Nsites, ops.Ltau)))
    Lu = np.asarray(kpm.apply_left(ops, st, u))
    Rw = np.asarray(kpm.apply_right(ops, st, w))
    # ⟨w, L u⟩ = ⟨R w, u⟩  (R = L†)
    lhs = np.vdot(np.asarray(w), Lu)
    rhs = np.vdot(Rw, np.asarray(u))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-10, atol=1e-10)
    # symmetric apply: Hermitian, positive on a random vector
    Su = np.asarray(kpm.apply_symmetric(ops, st, u))
    Sw = np.asarray(kpm.apply_symmetric(ops, st, w))
    np.testing.assert_allclose(np.vdot(np.asarray(w), Su),
                               np.conj(np.vdot(np.asarray(u), Sw)),
                               rtol=1e-10, atol=1e-10)
    quad = np.vdot(np.asarray(u), Su)
    assert abs(quad.imag) < 1e-10 * abs(quad.real)
    assert quad.real > 0.0


def test_dense_abar_gate_routing():
    """The Ā densification gate is a size rule alone: dense up to
    _DENSE_ABAR_MAX_SITES sites for real and complex hopping alike, the
    group fold above it, on every backend."""
    cap = kpm._DENSE_ABAR_MAX_SITES
    for n in (64, 2048, cap):
        assert kpm._dense_abar_gate(n)
    assert not kpm._dense_abar_gate(cap + 1)
    assert not kpm._dense_abar_gate(4 * cap)
