"""τ-coarse-grid correction for deep-β PCG — dense f64 ground truth.

The deep-β collapse (BASELINE.md §deep-β) is conditioning-limited: the
τ-averaged frequency-DIAGONAL KPM preconditioner cannot represent the
frequency COUPLING of the near-null modes. Those modes are slow in τ
(lowest Matsubara content), which suggests the classic two-level cure: a
Galerkin coarse correction over a τ-smooth coarse space,

    P⁻¹_two-level · r = P⁻¹_KPM · r + R (RᵀAR)⁻¹ Rᵀ · r,

with R the per-site aggregation of c consecutive τ slices. Unlike the
rotating-eigenbasis deflation (measured dead, §deep-β route 3 and
scripts/study_traj_recycle.py), R is FIELD-INDEPENDENT — only the small
Galerkin matrix RᵀAR is rebuilt per solve, and A = MᵀM is block-
TRIDIAGONAL in τ, so RᵀAR assembles from the N×N τ-blocks directly (no
matvecs) and its block-Cholesky is stable (SPD — the route-4 e^{4β}
substitution blow-up does not apply).

This study measures, on the dense equilibrated 4×4 β=16 operator:
  1. PCG iterations with KPM only / +τ-coarse at c ∈ {4, 8, 16, 20};
  2. the same with a plain (non-KPM) diagonal smoother, separating "the
     coarse space captures the slow modes" from KPM interplay;
  3. how well the coarse space spans the exact slow generalized
     eigenvectors (principal angles) — the capacity bound.

Run from the repo root:
    python scripts/study_tau_coarse.py [beta] [L]
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"  # a host study: counts, not times

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from study_traj_recycle import build, dense_AP, leapfrog_path, lowest_gen_eigs, pcg


def tau_restriction(N, Lt, c, dtype=np.float64):
    """[NL, N·Lt/c] per-site aggregation of c consecutive τ slices (1/√c)."""
    nc = Lt // c
    R = np.zeros((N, Lt, N, nc), dtype)
    for j in range(nc):
        R[:, j * c:(j + 1) * c, :, j] = np.eye(N, dtype=dtype)[:, None, :] / np.sqrt(c)
    return R.reshape(N * Lt, N * nc)


def pcg_coarse(A, Pinv, b, W, tol=1e-5, maxiter=3000):
    G = W.T @ A @ W
    Gi = np.linalg.inv(G)

    def prec(r):
        return Pinv @ r + W @ (Gi @ (W.T @ r))

    x = np.zeros_like(b)
    r = b.copy()
    nb = np.linalg.norm(b)
    z = prec(r)
    p = z.copy()
    rz = r @ z
    for j in range(maxiter):
        Ap = A @ p
        al = rz / (p @ Ap)
        x += al * p
        r -= al * Ap
        if np.linalg.norm(r) / nb < tol:
            return x, j + 1
        z = prec(r)
        rz_new = r @ z
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x, maxiter


def main():
    beta = float(sys.argv[1]) if len(sys.argv) > 1 else 16.0
    L = int(sys.argv[2]) if len(sys.argv) > 2 else 4

    jax.config.update("jax_enable_x64", True)
    ops, params, mass = build(L, beta)
    # one equilibrated field is enough (leapfrog_path equilibrates first)
    path = leapfrog_path(ops, params, mass, beta, L, n_equil=10, capture=False)
    x = path[0]
    N, Lt = ops.Nsites, ops.Ltau
    NL = N * Lt
    A, Pinv = dense_AP(ops, params, x)

    rng = np.random.default_rng(0)
    b = rng.standard_normal(NL)

    _, it_plain = pcg(A, Pinv, b)
    print(f"KPM only: {it_plain} iters", flush=True)

    w, V = lowest_gen_eigs(A, Pinv, 32)
    print(f"lowest gen-eigs: {np.array2string(w[:8], precision=4)}", flush=True)

    for c in (20, 16, 8, 4):
        if Lt % c:
            continue
        W = tau_restriction(N, Lt, c)
        # capacity: residual of the exact slow eigvecs after projection on W
        Q, _ = np.linalg.qr(W)
        Vs = V[:, :16] / np.linalg.norm(V[:, :16], axis=0)
        miss = np.linalg.norm(Vs - Q @ (Q.T @ Vs), axis=0)
        _, it = pcg_coarse(A, Pinv, b, W)
        print(f"c={c:>3} (coarse dim {NL//c:>5}): {it:4d} iters   "
              f"slow-mode projection miss (16 lowest): "
              f"{np.array2string(miss[:8], precision=2)}", flush=True)


if __name__ == "__main__":
    main()
