"""Does the deep-β slow subspace survive ONE leapfrog step? (CPU/f64 dense
ground truth, 4×4 β=16.)

The persistent-deflation post-mortem (BASELINE.md §deep-β route 3) showed
the slow modes of P⁻¹MᵀM rotate beyond usefulness over one FULL HMC update
(Nt=20 leapfrog steps). This study measures the rotation at leapfrog-step
granularity — the regime a *within-trajectory* recycled-deflation scheme
would live in: harvest a basis during the solve at step t, deflate the
solve at step t+1.

Protocol:
1. Equilibrate Holstein 4×4 β=16 (study_deep_beta harness, f32), then
   capture the leapfrog path x₀ … x_Nt of one real trajectory by running
   `make_hmc_step` with Nt=k prefixes under a FIXED key (the trajectory is
   deterministic given (x₀, v₀, φ), so Nt=k yields exactly step k's field).
2. For lags Δ ∈ {1, 2, 5, 10, 20}: densify A=MᵀM and the KPM P⁻¹ at x_t
   and x_{t+Δ} (f64), take the exact lowest-k generalized eigenvectors
   W_t of (A_t, P_t), and compare PCG iterations at x_{t+Δ} under
   no deflation / stale-W_t init-projection / oracle-W_{t+Δ}.

Decision rule: if stale-by-one-step W recovers most of the oracle saving,
within-trajectory recycling is viable and the remaining problem is cheap
basis harvesting (eigCG-style accumulation across the trajectory's ~20
sequential solves on a nearly-constant operator).

Run from the repo root:
    python scripts/study_traj_recycle.py [beta] [L] [k]
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"  # a host study: counts, not times

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from elphdynamics_tpu.dynamics.hmc import HMCConfig, HMCState, make_hmc_step
from elphdynamics_tpu.dynamics.init_phonons import init_phonons_half_filled
from elphdynamics_tpu.lattice import Lattice, UnitCell
from elphdynamics_tpu.models.adapter import make_model_ops
from elphdynamics_tpu.models.holstein import build_holstein
from elphdynamics_tpu.ops import kpm
from elphdynamics_tpu.ops.fourier_accel import build_mass


def build(L, beta):
    uc = UnitCell.create(2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
    lat = Lattice.create(uc, L)
    spec, params = build_holstein(
        lat, beta=beta, dtau=0.1,
        t_assignments=[(1.0, 0.0, 0, 0, (1, 0, 0)),
                       (1.0, 0.0, 0, 0, (0, 1, 0))],
        omega=1.0, lam=1.0, mu=0.0)
    ops = make_model_ops(spec)
    mass = build_mass(np.asarray(params.omega), spec.dtau, spec.Ltau,
                      [dict(omega_min=0.0, omega_max=10.0, mass=0.5)])
    return ops, params, mass


def leapfrog_path(ops, params, mass, beta, L, n_equil=10, capture=True):
    """x at every leapfrog step of one real trajectory (Nt-prefix trick).
    ``capture=False`` returns just the equilibrated field (path of 1)."""
    cfg0 = HMCConfig(dt=0.05, trajectory_time=1.0, Nb=4, tol=1e-5,
                     maxiter=2000, construct_guess=True, guess_order=3)
    precond = kpm.make_symmetric_precond(ops, kpm.KPMConfig(max_order=8))
    key = jax.random.PRNGKey(0)
    x, _ = init_phonons_half_filled(ops, params, key)
    st = HMCState(x=x, v=jnp.zeros_like(x))
    step = jax.jit(make_hmc_step(ops, mass, cfg0, precond))
    for _ in range(n_equil):
        st, stats, key = step(params, st, key)
    print(f"equilibrated: iters {int(stats.iters)} acc "
          f"{int(stats.accepted)}", flush=True)

    path = [np.asarray(st.x, np.float64)]
    if not capture:
        return path
    Nt = cfg0.Nt
    traj_key = key  # FIXED key: every prefix run sees the same v0 / phi
    for k in range(1, Nt + 1):
        cfg_k = cfg0._replace(trajectory_time=cfg0.dt * k)
        stk = jax.jit(make_hmc_step(ops, mass, cfg_k, precond))
        st_k, stats_k, _ = stk(params, st, traj_key)
        if not bool(stats_k.accepted):
            print(f"  prefix Nt={k}: REJECTED (flag {int(stats_k.flag)}) — "
                  "path truncated here", flush=True)
            break
        path.append(np.asarray(st_k.x, np.float64))
    print(f"captured {len(path)} leapfrog-path fields "
          f"(|dx| per step ≈ {np.linalg.norm(path[1]-path[0]):.3f})",
          flush=True)
    return path


def dense_AP(ops, params, x64):
    N, Lt = ops.Nsites, ops.Ltau
    NL = N * Lt
    x = jnp.asarray(x64)
    derived = ops.derived(params, x)
    kcfg = kpm.KPMConfig(max_order=8)
    st = kpm.setup(ops, params, x, kcfg, jax.random.PRNGKey(1))
    eye = jnp.eye(NL).reshape(NL, N, Lt)
    A = np.asarray(jax.jit(
        lambda e: ops.mulMTM(params, derived, e))(eye)).reshape(NL, NL).T
    Pinv = np.asarray(jax.jit(
        lambda e: kpm.apply_symmetric(ops, st, e, kcfg))(eye)).reshape(NL, NL).T
    A = 0.5 * (A + A.T)
    Pinv = 0.5 * (Pinv + Pinv.T)
    return A, Pinv


def pcg(A, Pinv, b, tol=1e-5, maxiter=3000, x0=None):
    x = np.zeros_like(b) if x0 is None else x0.copy()
    r = b - A @ x
    nb = np.linalg.norm(b)
    z = Pinv @ r
    p = z.copy()
    rz = r @ z
    for j in range(maxiter):
        Ap = A @ p
        al = rz / (p @ Ap)
        x += al * p
        r -= al * Ap
        if np.linalg.norm(r) / nb < tol:
            return x, j + 1
        z = Pinv @ r
        rz_new = r @ z
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x, maxiter


def lowest_gen_eigs(A, Pinv, k):
    import scipy.linalg as sla
    P = np.linalg.inv(Pinv)
    P = 0.5 * (P + P.T)
    w, V = sla.eigh(A, P, subset_by_index=[0, k - 1])
    return w, V


def deflated_iters(A, Pinv, b, W):
    G = W.T @ A @ W
    x0 = W @ np.linalg.solve(G, W.T @ b)
    _, it = pcg(A, Pinv, b, x0=x0)
    return it


def main():
    beta = float(sys.argv[1]) if len(sys.argv) > 1 else 16.0
    L = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    k = int(sys.argv[3]) if len(sys.argv) > 3 else 32

    jax.config.update("jax_enable_x64", True)
    ops, params, mass = build(L, beta)
    path = leapfrog_path(ops, params, mass, beta, L)

    rng = np.random.default_rng(0)
    NL = ops.Nsites * ops.Ltau
    b = rng.standard_normal(NL)

    t0 = 0
    A0, Pinv0 = dense_AP(ops, params, path[t0])
    w0, W0 = lowest_gen_eigs(A0, Pinv0, k)
    print(f"\nlowest gen-eigs at x_t: {np.array2string(w0[:8], precision=4)}")
    _, it_plain0 = pcg(A0, Pinv0, b)
    it_orac0 = deflated_iters(A0, Pinv0, b, W0)
    print(f"at x_t      : plain {it_plain0:4d}  oracle-W {it_orac0:4d}")

    print(f"\n{'lag':>4} {'plain':>6} {'stale-W_t':>10} {'oracle':>7} "
          f"{'recovered':>10}")
    for lag in (1, 2, 5, 10, len(path) - 1):
        if lag < 1 or t0 + lag >= len(path):
            continue
        A1, Pinv1 = dense_AP(ops, params, path[t0 + lag])
        _, it_plain = pcg(A1, Pinv1, b)
        it_stale = deflated_iters(A1, Pinv1, b, W0)
        _, W1 = lowest_gen_eigs(A1, Pinv1, k)
        it_orac = deflated_iters(A1, Pinv1, b, W1)
        denom = max(it_plain - it_orac, 1)
        rec = (it_plain - it_stale) / denom
        print(f"{lag:>4} {it_plain:>6} {it_stale:>10} {it_orac:>7} "
              f"{rec:>9.0%}", flush=True)


if __name__ == "__main__":
    main()
