"""Adaptive two-level NEAR-NULL coarse space for deep-β PCG — dense f64
ground truth (DD-αAMG-style aggregation, arXiv:1303.1377 pattern).

Every one-level cure and every FIELD-INDEPENDENT or τ-SMOOTH coarse space is
measured dead at deep β (BASELINE.md §deep-β routes 1-6): the slow modes of
P⁻¹MᵀM are *propagated* single-particle states z(τ+1) ≈ −B_τ·z(τ) — they
rotate with the phonon field and carry per-τ roughness, so no once-per-update
eigenbasis (route 3) and no τ-smooth aggregate (route 5) can hold them.

The remaining classical construction is the lattice-QCD one: build the coarse
space from the CURRENT operator by *chopping smoothed test vectors*.

  1. Draw k random vectors, smooth them with a few KPM-PCG inverse-iteration
     passes — the smoothing concentrates them on the slow subspace.
  2. Chop each test vector over aggregates = (spatial block) × (τ-chunk),
     keeping FULL τ resolution (c=1) as the capacity diagnostic demands:
     a propagated state z restricted to slice τ is z(τ) ∈ span{w_i(τ)}
     whenever the k test vectors mix the ≤k relevant slow modes invertibly —
     τ-resolved chopping converts k GLOBAL test vectors into a space that
     contains every propagated state in their span, per slice, including its
     per-τ roughness.  This is exactly what the τ-smooth aggregates of
     study_tau_coarse.py (1/√c constant interpolation) could not do.
  3. Galerkin coarse matrix G = WᵀAW (A = MᵀM is block-tridiagonal in τ, so
     G is block-tridiagonal + antiperiodic corner over τ — assembled without
     matvecs in production), solved exactly; two-level preconditioner
     P⁻¹ = P⁻¹_KPM + W G⁻¹ Wᵀ (additive, same combination as the τ-coarse
     study for comparability).

This study measures, on the dense equilibrated Holstein operator:
  A. capacity — projection miss of the 16 lowest exact generalized
     eigenvectors on the chopped space, vs the τ-smooth baseline;
  B. PCG iterations with the two-level preconditioner across
     k × (block size) × (τ-chunk);
  C. smoothing cost sensitivity — how few smoothing iterations suffice;
  D. the DRIFT test that killed deflation: test vectors harvested at x_t,
     Galerkin matrix rebuilt (as production would) at x_{t+1 update} — does
     the chopped SPAN survive one full HMC update?

Run from the repo root:
    python scripts/study_near_null.py [beta] [L]
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"  # a host study: counts, not times

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

import numpy as np

from study_tau_coarse import pcg_coarse, tau_restriction
from study_traj_recycle import build, dense_AP, leapfrog_path, lowest_gen_eigs, pcg


def smooth_test_vectors(A, Pinv, k, passes=2, iters=10, seed=1):
    """k near-null test vectors: inverse iteration w ← A⁻¹w by a few
    FIXED-ITERATION KPM-PCG passes (exactly what the device implementation
    runs — batched CG with maxiter=iters, tol=0)."""
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((A.shape[0], k))
    for _ in range(passes):
        for i in range(k):
            w, _ = pcg(A, Pinv, W[:, i], tol=0.0, maxiter=iters)
            W[:, i] = w / np.linalg.norm(w)
    return W


def chop(Wt, N, Lt, L, bs, c):
    """Aggregate-chopped orthonormal coarse basis.

    Wt: [N·Lt, k] test vectors. Aggregates = (bs×bs spatial block) ×
    (c consecutive τ slices). Returns dense [N·Lt, k·nblocks·(Lt//c)]
    with orthonormal columns (QR per aggregate)."""
    k = Wt.shape[1]
    nb = L // bs
    nblocks = nb * nb
    nt = Lt // c
    x = np.arange(N) % L
    y = np.arange(N) // L
    block_id = (y // bs) * nb + (x // bs)  # [N]
    cols = []
    V = Wt.reshape(N, Lt, k)
    for b in range(nblocks):
        mask = block_id == b
        for j in range(nt):
            seg = np.zeros((N, Lt, k))
            seg[mask, j * c:(j + 1) * c, :] = V[mask, j * c:(j + 1) * c, :]
            seg = seg.reshape(N * Lt, k)
            q, r = np.linalg.qr(seg)
            # drop numerically dependent columns
            keep = np.abs(np.diag(r)) > 1e-10 * np.abs(r).max()
            cols.append(q[:, keep])
    return np.concatenate(cols, axis=1)


def capacity(Wc, V16):
    """Projection miss of the 16 lowest generalized eigvecs on span(Wc)."""
    Q, _ = np.linalg.qr(Wc)
    Vs = V16 / np.linalg.norm(V16, axis=0)
    return np.linalg.norm(Vs - Q @ (Q.T @ Vs), axis=0)


def pcg_coarse_frozen(A, Pinv, b, W, Gi, tol=1e-5, maxiter=3000):
    """Two-level PCG with a PRE-FACTORED coarse matrix (possibly stale):
    what the per-update-setup production protocol actually runs."""
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


def refresh_vectors(A, Pinv, W0, iters=5):
    """One cheap smoothing pass of existing test vectors at the CURRENT
    operator (the mid-update refresh candidate)."""
    W = W0.copy()
    for i in range(W.shape[1]):
        w, _ = pcg(A, Pinv, W[:, i], tol=0.0, maxiter=iters)
        W[:, i] = w / np.linalg.norm(w)
    return W


def stage_E(ops, params, mass, beta, L, k=8, c=4):
    """Production-protocol economics: W (and G) built once at x₀, used for
    solves along the REAL leapfrog trajectory; optional cheap refresh."""
    N, Lt = ops.Nsites, ops.Ltau
    path = leapfrog_path(ops, params, mass, beta, L, n_equil=10, capture=True)
    rng = np.random.default_rng(3)
    b = rng.standard_normal(N * Lt)

    A0, Pinv0 = dense_AP(ops, params, path[0])
    Wt0 = smooth_test_vectors(A0, Pinv0, k)
    W = chop(Wt0, N, Lt, L, L, c)
    G0i = np.linalg.inv(W.T @ A0 @ W)
    print(f"\n=== E: production protocol (k={k} bs={L} c={c}, "
          f"dim {W.shape[1]}; setup ~{2 * 10 * k} smoothing iters/update) ===",
          flush=True)
    steps = [s for s in (0, 5, 10, 15, 20) if s < len(path)]
    for s in steps:
        As, Ps = dense_AP(ops, params, path[s])
        _, it_plain = pcg(As, Ps, b)
        _, it_frozen = pcg_coarse_frozen(As, Ps, b, W, G0i)
        _, it_rebuilt = pcg_coarse(As, Ps, b, W)
        Wt_f = smooth_test_vectors(As, Ps, k)
        _, it_fresh = pcg_coarse(As, Ps, b, chop(Wt_f, N, Lt, L, L, c))
        Wr = chop(refresh_vectors(As, Ps, Wt0, iters=5), N, Lt, L, L, c)
        _, it_refresh = pcg_coarse(As, Ps, b, Wr)
        print(f"step {s:2d}: plain {it_plain:4d}  frozen-WG {it_frozen:4d}  "
              f"stale-W/rebuilt-G {it_rebuilt:4d}  refresh5 {it_refresh:4d} "
              f"(+{5 * k} setup iters)  fresh-W {it_fresh:4d}", flush=True)


def pcg_harvest(A, Pinv, b, tol=1e-5, maxiter=3000, keep=8):
    """PCG that snapshots its own slow-mode-rich byproducts: the running
    iterate x_j at a geometric spread of iterations (errors/partial sums
    are dominated by the slow modes the solver fights longest). Returns
    (x, iters, snapshots [n, keep])."""
    x = np.zeros_like(b)
    r = b.copy()
    nb = np.linalg.norm(b)
    z = Pinv @ r
    p = z.copy()
    rz = r @ z
    snaps = []
    for j in range(maxiter):
        Ap = A @ p
        al = rz / (p @ Ap)
        x += al * p
        r -= al * Ap
        # geometric snapshot schedule: iterates at j = 2, 4, 8, 16, ...
        if (j + 1) & j == 0 and j > 0:
            snaps.append(x.copy())
        if np.linalg.norm(r) / nb < tol:
            break
        z = Pinv @ r
        rz_new = r @ z
        p = z + (rz_new / rz) * p
        rz = rz_new
    snaps.append(x.copy())
    W = np.stack(snaps[-keep:], axis=1)
    return x, j + 1, W / np.linalg.norm(W, axis=0, keepdims=True)


def stage_F(ops, params, mass, beta, L, k=8, c=4):
    """FREE harvesting: do CG's own iterate snapshots (zero extra matvecs)
    give a coarse space competitive with dedicated smoothing? Measured at
    the equilibrated field and along the trajectory (snapshots from a
    step-s solve, used at step s — the production cadence)."""
    N, Lt = ops.Nsites, ops.Ltau
    path = leapfrog_path(ops, params, mass, beta, L, n_equil=10, capture=True)
    rng = np.random.default_rng(7)
    b = rng.standard_normal(N * Lt)
    b2 = rng.standard_normal(N * Lt)

    print(f"\n=== F: free harvest from CG iterates (k={k} bs={L} c={c}) ===",
          flush=True)
    for s in (0, 10, 20):
        if s >= len(path):
            continue
        As, Ps = dense_AP(ops, params, path[s])
        _, it_plain = pcg(As, Ps, b2)
        # harvest from ONE ordinary solve at this field (rhs = b)
        _, it_h, Wt = pcg_harvest(As, Ps, b, keep=k)
        Wc = chop(Wt, N, Lt, L, L, c)
        _, it_free = pcg_coarse(As, Ps, b2, Wc)
        # dedicated smoothing baseline (2x10 extra iters/vector)
        Wt_s = smooth_test_vectors(As, Ps, k)
        _, it_smooth = pcg_coarse(As, Ps, b2, chop(Wt_s, N, Lt, L, L, c))
        print(f"step {s:2d}: plain {it_plain:4d}  free-harvest {it_free:4d} "
              f"(snapshots of a {it_h}-iter solve)  "
              f"dedicated-smooth {it_smooth:4d}", flush=True)


def main():
    beta = float(sys.argv[1]) if len(sys.argv) > 1 else 16.0
    L = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    if len(sys.argv) > 3 and sys.argv[3] == "E":
        jax.config.update("jax_enable_x64", True)
        ops, params, mass = build(L, beta)
        stage_E(ops, params, mass, beta, L)
        return
    if len(sys.argv) > 3 and sys.argv[3] == "F":
        jax.config.update("jax_enable_x64", True)
        ops, params, mass = build(L, beta)
        stage_F(ops, params, mass, beta, L)
        return

    jax.config.update("jax_enable_x64", True)
    ops, params, mass = build(L, beta)
    # two consecutive equilibrated fields, one full HMC update apart,
    # for the drift test (leapfrog_path with capture returns the within-
    # trajectory path; here we want update-granularity states)
    path10 = leapfrog_path(ops, params, mass, beta, L, n_equil=10,
                           capture=False)
    path11 = leapfrog_path(ops, params, mass, beta, L, n_equil=11,
                           capture=False)
    x_t, x_t1 = path10[0], path11[0]

    N, Lt = ops.Nsites, ops.Ltau
    NL = N * Lt
    A, Pinv = dense_AP(ops, params, x_t)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(NL)

    _, it_plain = pcg(A, Pinv, b)
    print(f"KPM only: {it_plain} iters", flush=True)
    w16, V16 = lowest_gen_eigs(A, Pinv, 16)
    print(f"lowest gen-eigs: {np.array2string(w16[:8], precision=4)}",
          flush=True)

    # τ-smooth baseline (study_tau_coarse best cell) for direct comparison
    Wsm = tau_restriction(N, Lt, 4)
    _, it_sm = pcg_coarse(A, Pinv, b, Wsm)
    miss_sm = capacity(Wsm, V16)
    print(f"τ-smooth c=4 baseline (dim {Wsm.shape[1]}): {it_sm} iters, "
          f"miss {np.array2string(miss_sm[:8], precision=2)}", flush=True)

    print("\n=== B: chopped near-null spaces (smoothing: 2 passes × 10 PCG "
          "iters) ===", flush=True)
    results = {}
    for k in (2, 4, 8):
        Wt = smooth_test_vectors(A, Pinv, k)
        for bs in (L, L // 2):
            for c in (1, 4):
                Wc = chop(Wt, N, Lt, L, bs, c)
                if Wc.shape[1] >= NL // 2:
                    continue  # coarse space degenerating toward full space
                miss = capacity(Wc, V16)
                _, it = pcg_coarse(A, Pinv, b, Wc)
                results[(k, bs, c)] = (it, Wc.shape[1])
                print(f"k={k} bs={bs} c={c:>2} (dim {Wc.shape[1]:>5}): "
                      f"{it:4d} iters   miss(8 lowest) "
                      f"{np.array2string(miss[:8], precision=2)}", flush=True)

    print("\n=== C: smoothing cost sensitivity (k=4, bs=L, c=1) ===",
          flush=True)
    for passes, iters in ((1, 5), (1, 10), (2, 10), (3, 20)):
        Wt = smooth_test_vectors(A, Pinv, 4, passes=passes, iters=iters)
        Wc = chop(Wt, N, Lt, L, L, 1)
        _, it = pcg_coarse(A, Pinv, b, Wc)
        print(f"passes={passes} iters={iters} (total {passes * iters} "
              f"PCG iters/vector): {it:4d} iters", flush=True)

    print("\n=== D: drift across ONE FULL HMC UPDATE (the deflation "
          "killer) ===", flush=True)
    A1, Pinv1 = dense_AP(ops, params, x_t1)
    _, it_plain1 = pcg(A1, Pinv1, b)
    k = 4
    Wt_stale = smooth_test_vectors(A, Pinv, k)      # harvested at x_t
    Wt_fresh = smooth_test_vectors(A1, Pinv1, k)    # harvested at x_{t+1}
    _, V16_1 = lowest_gen_eigs(A1, Pinv1, 16)
    for bs, c in ((L, 1), (L // 2, 1)):
        Wc_stale = chop(Wt_stale, N, Lt, L, bs, c)
        Wc_fresh = chop(Wt_fresh, N, Lt, L, bs, c)
        # production rebuilds the Galerkin matrix per solve — pcg_coarse
        # does exactly that (G = WᵀA₁W on the stale span)
        _, it_stale = pcg_coarse(A1, Pinv1, b, Wc_stale)
        _, it_fresh = pcg_coarse(A1, Pinv1, b, Wc_fresh)
        miss_stale = capacity(Wc_stale, V16_1)
        denom = max(it_plain1 - it_fresh, 1)
        rec = (it_plain1 - it_stale) / denom
        print(f"bs={bs} c={c}: plain {it_plain1:4d}  stale-span {it_stale:4d}"
              f"  fresh-span {it_fresh:4d}  recovered {rec:.0%}   "
              f"stale miss {np.array2string(miss_stale[:4], precision=2)}",
              flush=True)


if __name__ == "__main__":
    main()
