"""Hasenbusch mass-preconditioning feasibility at deep β — dense f64 study.

The split (hep-lat/0506011, adapted): M̂ = M + ρI, and
    det(MᵀM) = det(M̂ᵀM̂) · det(M̂⁻ᵀ MᵀM M̂⁻¹),
two pseudofermions: φ₁ (operator M̂ᵀM̂, solved often, should be CHEAP) and
φ₂ (operator M̂·(MᵀM)⁻¹·M̂ᵀ, solved rarely on an outer timescale, force
∝ ρ). Why a tiny ρ should gap this M: M = I + Γ with Γ the one-step
propagation, so M + ρI = (1+ρ)(I + Γ/(1+ρ)) — the monodromy loop damps
by (1+ρ)^Lτ, pushing the near-(−1) loop eigenvalues (the deep-β slow
modes) away from the antiperiodicity pole; (1+ρ)^Lτ ≈ 2 needs only
ρ ≈ ln2/Lτ.

Measured here (4×4 β=16 equilibrated field):
  1. σmin(M̂) and κ(M̂ᵀM̂) vs ρ — the gapping claim;
  2. KPM-PCG iterations for M̂ᵀM̂ solves vs ρ, using the UNMODIFIED
     O-preconditioner — the cheap-frequent-solve claim;
  3. ‖F₂‖/‖F₁‖ force-magnitude ratio vs ρ — the outer-timescale claim
     (F₂-fermion part = (φ₂−Mz)ᵀ(∂M/∂x)z with φ₂−Mz = −ρM⁻ᵀφ₂).

Run from the repo root: python scripts/study_hasenbusch.py [beta] [L]
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"  # a host study: counts, not times
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from study_traj_recycle import build, dense_AP, leapfrog_path, pcg


def main():
    beta = float(sys.argv[1]) if len(sys.argv) > 1 else 16.0
    L = int(sys.argv[2]) if len(sys.argv) > 2 else 4

    jax.config.update("jax_enable_x64", True)
    ops, params, mass = build(L, beta)
    x = leapfrog_path(ops, params, mass, beta, L, n_equil=10,
                      capture=False)[0]
    N, Lt = ops.Nsites, ops.Ltau
    NL = N * Lt
    xj = jnp.asarray(x)
    derived = ops.derived(params, xj)

    eye = jnp.eye(NL).reshape(NL, N, Lt)
    M = np.asarray(jax.jit(
        lambda e: ops.mulM(params, derived, e))(eye)).reshape(NL, NL).T
    A, Pinv = dense_AP(ops, params, x)   # A = MᵀM, Pinv = KPM for A

    sv = np.linalg.svd(M, compute_uv=False)
    print(f"M: sigma_min {sv[-1]:.4e} sigma_max {sv[0]:.4e} "
          f"kappa(MtM) {(sv[0]/sv[-1])**2:.3e}", flush=True)

    rng = np.random.default_rng(0)
    b = rng.standard_normal(NL)
    _, it0 = pcg(A, Pinv, b)
    print(f"O-solve (KPM PCG): {it0} iters\n", flush=True)

    def report(tag, build_Mh, rhos):
        print(f"\n--- {tag}")
        print(f"{'rho':>8} {'smin(Mh)':>9} {'kappa_h':>9} "
              f"{'iters_h':>7} {'|F2|/|F1|':>9}")
        for rho in rhos:
            Mh = build_Mh(rho)
            Ah = Mh.T @ Mh
            svh = np.linalg.svd(Mh, compute_uv=False)
            _, ith = pcg(Ah, Pinv, b)
            R = rng.standard_normal(NL)
            phi2 = np.linalg.solve(Mh.T, M.T @ R)
            z2 = np.linalg.solve(M.T @ M, Mh.T @ phi2)
            u2 = phi2 - M @ z2
            f2 = np.linalg.norm(u2) * np.linalg.norm(z2)
            phi1 = Mh.T @ R
            z1 = np.linalg.solve(Ah, phi1)
            f1 = np.linalg.norm(Mh @ z1) * np.linalg.norm(z1)
            print(f"{rho:>8.4f} {svh[-1]:>9.2e} {(svh[0]/svh[-1])**2:>9.2e} "
                  f"{ith:>7} {f2/f1:>9.4f}", flush=True)

    # μ-shifted auxiliary operator: M̂ = M(μ−ρ) — damps the monodromy by
    # e^{-βρ} exactly and detunes the Fermi surface (matrix-free in the
    # framework: params.mu − ρ)
    def mh_mu(rho):
        p2 = params._replace(mu=params.mu - rho)
        d2 = ops.derived(p2, xj)
        return np.asarray(jax.jit(
            lambda e: ops.mulM(p2, d2, e))(eye)).reshape(NL, NL).T

    report("mu-shift  M(mu - rho)", mh_mu, (0.02, 0.05, 0.1, 0.2, 0.4))
    report("mu-shift  M(mu + rho)",
           lambda r: mh_mu(-r), (0.05, 0.1, 0.2))

    I = np.eye(NL)
    Minv = np.linalg.inv(M)
    print(f"\n--- scalar shift M + rho*I")
    print(f"{'rho':>8} {'(1+rho)^Lt':>10} {'smin(Mh)':>9} {'kappa_h':>9} "
          f"{'iters_h':>7} {'|F2|/|F1|':>9}")
    for rho in (0.0005, 0.001, 0.002, 0.005, 0.01, 0.02, 0.05):
        Mh = M + rho * I
        Ah = Mh.T @ Mh
        svh = np.linalg.svd(Mh, compute_uv=False)
        _, ith = pcg(Ah, Pinv, b)
        # force-magnitude proxy at a refreshed phi2 = Mh^-T M^T R:
        R = rng.standard_normal(NL)
        phi2 = np.linalg.solve(Mh.T, M.T @ R)
        z2 = np.linalg.solve(M.T @ M, Mh.T @ phi2)
        u2 = phi2 - M @ z2           # = -rho * M^-T phi2 (identity check)
        chk = np.linalg.norm(u2 + rho * (Minv.T @ phi2)) / np.linalg.norm(u2)
        # |F| proxy: |u|*|z| products entering u^T dM z (dM is O(dtau) local)
        f2 = np.linalg.norm(u2) * np.linalg.norm(z2)
        phi1 = Mh.T @ R
        z1 = np.linalg.solve(Ah, phi1)
        f1 = np.linalg.norm(Mh @ z1) * np.linalg.norm(z1)
        print(f"{rho:>8.4f} {(1+rho)**Lt:>10.2f} {svh[-1]:>9.2e} "
              f"{(svh[0]/svh[-1])**2:>9.2e} {ith:>7} {f2/f1:>9.4f}"
              f"   (u2 identity err {chk:.1e})", flush=True)


if __name__ == "__main__":
    main()
