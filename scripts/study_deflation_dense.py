"""CPU/f64 ground truth for deflated KPM-CG at deep beta (4x4, beta=16).

Needs an equilibrated field dump at /tmp/x_4x4_b16.npz — produce it on the
GPU with:  python scripts/study_deep_beta.py 16 4  (or any equilibration
that saves np.savez(path, x=field)).

Densifies MtM and the symmetric KPM P^-1, computes the exact lowest-k
generalized eigenvectors of the (MtM, P) pencil, then measures PCG
iterations under: plain PCG; init-deflated (x0 projection) with exact W;
per-iteration coarse correction; f32-truncated W; harvested-Krylov W
(standard and (A,P)-pencil RR from stored CG products — zero extra
operator applies); and thick-restart accumulation across solves.

Findings recorded in BASELINE.md §deep-β: exact 32-mode deflation cuts
88 → 20 iters (f32 W included, init-only projection suffices), but bases
harvested from tol=1e-5 solves converge only the few lowest modes
(plateau ~70/86) — the soft small-eigenvalue tail needs eigCG-class
incremental accumulation to be captured cheaply.
"""
import os
os.environ["JAX_PLATFORMS"] = "cpu"
import sys
sys.path.insert(0, "/root/repo")
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp

from elphdynamics_tpu.lattice import Lattice, UnitCell
from elphdynamics_tpu.models.holstein import build_holstein
from elphdynamics_tpu.models.adapter import make_model_ops
from elphdynamics_tpu.ops import kpm

L, beta = 4, 16.0
x_host = np.load("/tmp/x_4x4_b16.npz")["x"].astype(np.float64)
uc = UnitCell.create(2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
lat = Lattice.create(uc, L)
spec, params = build_holstein(
    lat, beta=beta, dtau=0.1,
    t_assignments=[(1.0, 0.0, 0, 0, (1, 0, 0)), (1.0, 0.0, 0, 0, (0, 1, 0))],
    omega=1.0, lam=1.0, mu=0.0)
ops = make_model_ops(spec)
N, Lt = ops.Nsites, ops.Ltau
NL = N * Lt
x = jnp.asarray(x_host)
derived = ops.derived(params, x)
kcfg = kpm.KPMConfig(max_order=8)
st = kpm.setup(ops, params, x, kcfg, jax.random.PRNGKey(1))
print("kpm active:", bool(st.active))

eye = jnp.eye(NL).reshape(NL, N, Lt)
A = np.asarray(jax.jit(lambda e: ops.mulMTM(params, derived, e))(eye)).reshape(NL, NL).T
Pinv = np.asarray(jax.jit(lambda e: kpm.apply_symmetric(ops, st, e, kcfg))(eye)).reshape(NL, NL).T
A = 0.5 * (A + A.T)
sym_err = np.max(np.abs(Pinv - Pinv.T)) / np.max(np.abs(Pinv))
print(f"NL={NL}; Pinv asymmetry: {sym_err:.2e}")
Pinv = 0.5 * (Pinv + Pinv.T)

import scipy.linalg as sla
# eigvals of Pinv A = generalized (A, P) with P = inv(Pinv)
P = np.linalg.inv(Pinv)
P = 0.5 * (P + P.T)
kmax = 64
w, V = sla.eigh(A, P, subset_by_index=[0, kmax - 1])
print("exact lowest gen-eigs:", np.array2string(w[:12], precision=5))
wall, _ = sla.eigh(A, P, subset_by_index=[NL - 1, NL - 1], eigvals_only=False)
print("largest:", wall[-1])

rng = np.random.default_rng(0)
b = rng.standard_normal(NL)


def pcg(A, Pinv_apply, b, tol=1e-5, maxiter=3000, x0=None, coarse=None):
    x = np.zeros_like(b) if x0 is None else x0.copy()
    r = b - A @ x
    nb = np.linalg.norm(b)

    def prec(r):
        z = Pinv_apply(r)
        if coarse is not None:
            Wc, Gc = coarse
            z = z + Wc @ np.linalg.solve(Gc, Wc.T @ r)
        return z

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


Pinv_ap = lambda r: Pinv @ r
_, it_plain = pcg(A, Pinv_ap, b)
print(f"plain PCG: {it_plain} iters")

for k in (16, 32, 64):
    W = V[:, :k]                       # P-orthonormal gen eigvecs
    G = W.T @ A @ W
    # init deflation
    x0 = W @ np.linalg.solve(G, W.T @ b)
    _, it_init = pcg(A, Pinv_ap, b, x0=x0)
    # projected/coarse correction every iteration
    _, it_proj = pcg(A, Pinv_ap, b, coarse=(W, G))
    _, it_both = pcg(A, Pinv_ap, b, x0=x0, coarse=(W, G))
    # f32-truncated W (f32 production storage)
    Wf = W.astype(np.float32).astype(np.float64)
    Gf = Wf.T @ A @ Wf
    x0f = Wf @ np.linalg.solve(Gf, Wf.T @ b)
    _, it_f32 = pcg(A, Pinv_ap, b, x0=x0f, coarse=(Wf, Gf))
    print(f"k={k:>2}: init={it_init} proj={it_proj} both={it_both} "
          f"f32W both={it_f32}")


# ---------------------------------------------------------------------------
# Harvested-Krylov deflation: store p_j, Ap_j from ONE plain PCG solve,
# Rayleigh-Ritz with Gram-SVD cleanup, deflate the next solve. f32 storage.
# ---------------------------------------------------------------------------
def pcg_store(A, Pinv_apply, b, tol=1e-5, maxiter=3000):
    x = np.zeros_like(b)
    r = b.copy()
    nb = np.linalg.norm(b)
    z = Pinv_apply(r)
    p = z.copy()
    rz = r @ z
    Ps, APs = [], []
    for j in range(maxiter):
        Ap = A @ p
        Ps.append(p.astype(np.float32))
        APs.append(Ap.astype(np.float32))
        al = rz / (p @ Ap)
        x += al * p
        r -= al * Ap
        if np.linalg.norm(r) / nb < tol:
            return x, j + 1, np.array(Ps), np.array(APs)
        z = Pinv_apply(r)
        rz_new = r @ z
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x, maxiter, np.array(Ps), np.array(APs)


def harvest_W(Ps, APs, k, drop=1e-6):
    """RR of A on span(Ps) using only stored products (f32 in, f64 algebra)."""
    P64 = Ps.astype(np.float64)          # [m, NL]
    AP64 = APs.astype(np.float64)
    S = P64 @ P64.T                      # [m, m]
    G = P64 @ AP64.T
    G = 0.5 * (G + G.T)
    # whiten: S = Q L Q^T, keep L > drop*max
    lam, Q = np.linalg.eigh(S)
    keep = lam > drop * lam[-1]
    T = Q[:, keep] / np.sqrt(lam[keep])  # [m, m']
    H = T.T @ G @ T
    H = 0.5 * (H + H.T)
    theta, Y = np.linalg.eigh(H)
    comb = T @ Y[:, :k]                  # [m, k]
    W = (comb.T @ P64)                   # [k, NL]
    AW = (comb.T @ AP64)
    Gk = W @ AW.T
    Gk = 0.5 * (Gk + Gk.T)
    return W.T, AW.T, Gk, theta[:k]


print("\n--- harvested-Krylov deflation (zero extra applies) ---")
x_sol, m_it, Ps, APs = pcg_store(A, Pinv_ap, b)
print(f"first solve: {m_it} iters, stored {len(Ps)} directions "
      f"({Ps.nbytes / 1e6:.1f} MB f32)")
b2 = rng.standard_normal(NL)            # an independent RHS, same operator
for k in (16, 32, 48):
    W, AW, Gk, theta = harvest_W(Ps, APs, k)
    x0 = W @ np.linalg.solve(Gk, W.T @ b2)
    _, it_d = pcg(A, Pinv_ap, b2, x0=x0)
    _, it_p = pcg(A, Pinv_ap, b2)
    print(f"k={k:>2}: harvested-deflated={it_d} vs plain={it_p}; "
          f"theta[0:4]={np.array2string(theta[:4], precision=4)}")

# drifted operator (trajectory-like): x shifts, W stays
x2h = x_host + 0.05 * rng.standard_normal(x_host.shape)
x2 = jnp.asarray(x2h)
der2 = ops.derived(params, x2)
A2 = np.asarray(jax.jit(lambda e: ops.mulMTM(params, der2, e))(eye)).reshape(NL, NL).T
A2 = 0.5 * (A2 + A2.T)
st2 = kpm.refresh(ops, st, params, x2)
Pinv2 = np.asarray(jax.jit(lambda e: kpm.apply_symmetric(ops, st2, e, kcfg))(eye)).reshape(NL, NL).T
Pinv2 = 0.5 * (Pinv2 + Pinv2.T)
P2_ap = lambda r: Pinv2 @ r
W, AW, Gk, _ = harvest_W(Ps, APs, 32)
G2 = W.T @ (A2 @ W)                     # refreshed A-products on drifted op
G2 = 0.5 * (G2 + G2.T)
x0 = W @ np.linalg.solve(G2, W.T @ b2)
_, it_d2 = pcg(A2, P2_ap, b2, x0=x0)
_, it_p2 = pcg(A2, P2_ap, b2)
# stale G (no refresh): reuse Gk from the original operator
x0s = W @ np.linalg.solve(Gk, W.T @ b2)
_, it_ds = pcg(A2, P2_ap, b2, x0=x0s)
print(f"drifted op: plain={it_p2} defl(fresh G)={it_d2} defl(stale G)={it_ds}")


# ---------------------------------------------------------------------------
# (A,P)-pencil harvest: store z_j (preconditioned residuals) and r_j;
# Z^T P Z = Z^T R (since P z = r) and A Z from the Ap recurrence. Then
# incremental accumulation across solves (the deployment shape).
# ---------------------------------------------------------------------------
def pcg_store_zr(A, Pinv_apply, b, tol=1e-5, maxiter=3000, x0=None,
                 defl=None):
    x = np.zeros_like(b) if x0 is None else x0.copy()
    if defl is not None:
        W, AW = defl
        G = W.T @ AW
        G = 0.5 * (G + G.T)
        r0 = b - A @ x
        x = x + W @ np.linalg.solve(G, W.T @ r0)
    r = b - A @ x
    nb = np.linalg.norm(b)
    z = Pinv_apply(r)
    p = z.copy()
    rz = r @ z
    Zs, Rs, AZs = [], [], []
    Ap_prev = None
    beta = 0.0
    for j in range(maxiter):
        Ap = A @ p
        # z_j = p_j - beta_j p_{j-1} -> A z_j = Ap_j - beta_j Ap_{j-1}
        Az = Ap if Ap_prev is None else Ap - beta * Ap_prev
        Zs.append(z.astype(np.float32))
        Rs.append(r.astype(np.float32))
        AZs.append(Az.astype(np.float32))
        al = rz / (p @ Ap)
        x += al * p
        r -= al * Ap
        if np.linalg.norm(r) / nb < tol:
            return x, j + 1, np.array(Zs), np.array(Rs), np.array(AZs)
        z = Pinv_apply(r)
        rz_new = r @ z
        beta = rz_new / rz
        Ap_prev = Ap
        p = z + beta * p
        rz = rz_new
    return x, maxiter, np.array(Zs), np.array(Rs), np.array(AZs)


def harvest_pencil(Zs, Rs, AZs, k, drop=1e-5):
    Z = Zs.astype(np.float64)
    S = Z @ Rs.astype(np.float64).T      # Z^T P Z
    S = 0.5 * (S + S.T)
    G = Z @ AZs.astype(np.float64).T
    G = 0.5 * (G + G.T)
    lam, Q = np.linalg.eigh(S)
    keep = lam > drop * np.max(np.abs(lam))
    T = Q[:, keep] / np.sqrt(lam[keep])
    H = T.T @ G @ T
    H = 0.5 * (H + H.T)
    theta, Y = np.linalg.eigh(H)
    kk = min(k, H.shape[0])
    comb = T @ Y[:, :kk]
    W = (comb.T @ Z).T                   # [NL, kk]
    AW = (comb.T @ AZs.astype(np.float64)).T
    return W, AW, theta[:kk]


print("\n--- (A,P)-pencil harvest, single solve ---")
_, m_it, Zs, Rs, AZs = pcg_store_zr(A, Pinv_ap, b)
for k in (16, 32):
    W, AW, theta = harvest_pencil(Zs, Rs, AZs, k)
    x0 = W @ np.linalg.solve(0.5 * (W.T @ AW + AW.T @ W), W.T @ b2)
    _, it_d = pcg(A, Pinv_ap, b2, x0=x0)
    print(f"k={k}: deflated={it_d} vs plain=86; "
          f"theta[:4]={np.array2string(theta[:4], precision=4)}")

print("\n--- incremental across solves (cap k=32) ---")
defl = None
for s in range(8):
    bs = rng.standard_normal(NL)
    _, its, Zs, Rs, AZs = pcg_store_zr(A, Pinv_ap, bs, defl=defl)
    if defl is None:
        Zc, Rc, AZc = Zs, Rs, AZs
    else:
        W, AW = defl
        # previous W re-enters the pool: P·W columns unknown, but W came
        # from Z-combinations so carry its own (W, PW≈?) — use (W, AW) with
        # PW tracked via the same combination of Rs... simplest: keep pool
        # of raw triples
        Zc = np.concatenate([Zc, Zs])[-160:]
        Rc = np.concatenate([Rc, Rs])[-160:]
        AZc = np.concatenate([AZc, AZs])[-160:]
    W, AW, theta = harvest_pencil(Zc, Rc, AZc, 32)
    defl = (W, AW)
    print(f"solve {s}: iters={its} pool={len(Zc)} "
          f"theta0={theta[0]:.5f}")


# ---------------------------------------------------------------------------
# Proper thick-restart accumulation: carry (W, AW, PW) triples; PW comes
# free from the residual identity P z_j = r_j. Pool = locked W + new solve's
# Z triple; RR in the (A,P) pencil on the pool; subspace angles vs exact.
# ---------------------------------------------------------------------------
def rr_pool(Vs, PVs, AVs, k, drop=1e-5):
    V = Vs.astype(np.float64)
    PV = PVs.astype(np.float64)
    AV = AVs.astype(np.float64)
    S = V @ PV.T
    S = 0.5 * (S + S.T)
    G = V @ AV.T
    G = 0.5 * (G + G.T)
    lam, Q = np.linalg.eigh(S)
    keep = lam > drop * np.max(np.abs(lam))
    T = Q[:, keep] / np.sqrt(lam[keep])
    H = T.T @ G @ T
    H = 0.5 * (H + H.T)
    theta, Y = np.linalg.eigh(H)
    kk = min(k, H.shape[0])
    comb = T @ Y[:, :kk]                 # [m, kk]
    return ((comb.T @ V), (comb.T @ PV), (comb.T @ AV), theta[:kk])


print("\n--- thick-restart accumulation (lock W, PW, AW; k=32) ---", flush=True)
Wl = PWl = AWl = None
Vx = V  # exact gen eigvecs [NL, 64]
for s in range(20):
    bs = rng.standard_normal(NL)
    defl = None if Wl is None else (Wl.T, AWl.T)
    _, its, Zs, Rs, AZs = pcg_store_zr(A, Pinv_ap, bs, defl=defl)
    if Wl is None:
        pool = (Zs, Rs, AZs)
    else:
        pool = (np.concatenate([Wl, Zs.astype(np.float64)]),
                np.concatenate([PWl, Rs.astype(np.float64)]),
                np.concatenate([AWl, AZs.astype(np.float64)]))
    Wl, PWl, AWl, theta = rr_pool(*pool, 32)
    # principal angle of exact lowest-8 subspace vs span(Wl)
    Qw, _ = np.linalg.qr(Wl.T)
    sv = np.linalg.svd(Qw.T @ np.linalg.qr(Vx[:, :8])[0], compute_uv=False)
    ang = np.degrees(np.arccos(np.clip(sv[-1], 0, 1)))
    print(f"solve {s:>2}: iters={its:>3} theta0={theta[0]:.5f} "
          f"max-angle(exact8, W)={ang:5.1f} deg", flush=True)
