"""Adaptive two-level near-null preconditioner for the deep-β regime.

P⁻¹ = P⁻¹_KPM + W·G⁻¹·Wᵀ over a τ-chunk-chopped near-null space: k test
vectors, inverse-iteration smoothed with the KPM-preconditioned CG (or
cheaply re-smoothed from the previous state at refresh), are restricted to
τ-chunks of ``c`` slices and per-chunk orthonormalized. The chopped space
holds the PROPAGATED slow modes z(τ+1) ≈ −B_τ·z(τ) — τ-rough and
field-dependent — that every field-independent, τ-smooth, or
once-per-update coarse space measurably cannot (BASELINE.md §deep-β
routes 1–6; dense ground truth `scripts/study_near_null.py` stages A–F:
fresh chopped spaces cut 117 → 43 PCG iterations at 4×4 β=16 where the
best τ-smooth space manages 77, and a 5-iteration re-smoothing restores
near-fresh quality anywhere along the HMC trajectory).

The Galerkin matrix is assembled EXACTLY from two colored fermion-matrix
applies: G = (MW)ᵀ(MW), and M spreads one τ slice, so chunks of c ≥ 2
slices at the same chunk-parity have disjoint images — two ``mulM`` calls
on parity-masked column sums recover every M·W column. G is
block-tridiagonal over chunks with the antiperiodic corner, assembled
dense and explicitly inverted by a Jacobi-scaled Newton–Schulz sweep
(pure matmuls — cholesky/triangular solves are row-sequential) once per
(re)build, so the per-CG-iteration coarse solve is a single matmul.

Reference bar being surpassed: KPMPreconditioners.jl:426-481 is the
reference's only answer to deep-β conditioning and fails in this regime
identically (its κ-abort exists for that reason). This module is beyond
reference scope — the lattice-QCD adaptive-aggregation pattern
(DD-αAMG, arXiv:1303.1377) re-derived for the τ-propagated slow modes
of MᵀM, with the aggregation in imaginary time instead of space.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from elphdynamics_tpu.ops import kpm

# every Gram/inverse/projection contraction runs at HIGHEST: the default
# bf16 dot_general precision corrupts near-null Gram matrices exactly as it
# corrupted the block-CG shared Grams (BASELINE.md §block CG, the bf16-Gram
# defect) — measured on-chip as flags/NaN dH in the first A/B
_PREC = jax.lax.Precision.HIGHEST


@dataclass(frozen=True)
class NearNullConfig:
    """Two-level knobs ([solver.nearnull] in the TOML)."""

    k: int = 16             # test vectors (capacity scales with k: at 8×8
                            # β=16 f64, k=8/16/32 cut a 219-iter solve to
                            # 149/92/42 — /tmp-study + BASELINE.md route 7)
    c: int = 4              # τ slices per chunk (aggregate)
    setup_iters: int = 10   # smoothing CG iterations per pass at setup
    setup_passes: int = 2
    refresh_iters: int = 3  # re-smoothing iterations per refresh
    # per-solve refresh mode: "smooth" re-smooths T at the current field and
    # re-assembles G (the dense study's full-recovery lever); "assemble"
    # keeps T stale but rebuilds G at the current operator; "freeze" keeps
    # the whole setup-time state (stage-E frozen-WG decay)
    refresh_mode: str = "smooth"
    reg: float = 1e-6       # relative jitter on chunk Grams and G
    seed: int = 777

    def __hash__(self):
        return hash((self.k, self.c, self.setup_iters, self.setup_passes,
                     self.refresh_iters, self.refresh_mode, self.reg,
                     self.seed))


class NearNullState(NamedTuple):
    T: jnp.ndarray     # [k, N, Lτ] smoothed test vectors (unit norm)
    C: jnp.ndarray     # [nt, k, k] per-chunk whitening: B_J = T|_J · C_J
    Ginv: jnp.ndarray  # [D, D], D = nt·k — inverse Galerkin (MW)ᵀ(MW)


def _chunk_counts(Ltau: int, cfg: NearNullConfig):
    c = cfg.c
    if Ltau % c or (Ltau // c) % 2 or Ltau // c < 3:
        # choose the closest viable chunk size: Lτ divisible, even chunk
        # count ≥ 4 (2-colorability incl. the wrap, distinct off-bands)
        cands = [cc for cc in range(1, Ltau // 4 + 1)
                 if Ltau % cc == 0 and (Ltau // cc) % 2 == 0
                 and Ltau // cc >= 4]
        if not cands:
            raise ValueError(f"no viable nearnull chunk size for Lτau={Ltau}")
        c = min(cands, key=lambda cc: abs(cc - cfg.c))
    return c, Ltau // c


def _smooth(ops, params, derived, kst, kcfg, T, iters):
    """Inverse-iteration smoothing: T ← normalize(A⁻¹T) by a fixed-length
    KPM-preconditioned CG (exactly the production solver)."""
    from elphdynamics_tpu import solvers

    res = solvers.cg(
        lambda v: ops.mulMTM(params, derived, v), T,
        apply_P=lambda v: kpm.apply_symmetric(ops, kst, v, kcfg),
        tol=0.0, maxiter=iters)
    W = res.x
    nrm = jnp.sqrt(jnp.sum(W * W, axis=(-2, -1), keepdims=True))
    return W / jnp.maximum(nrm, 1e-30)


def _build(ops, params, derived, T, cfg: NearNullConfig,
           X_prev=None) -> NearNullState:
    """Per-chunk orthonormalization + exact colored Galerkin assembly.
    ``X_prev`` warm-starts the Newton–Schulz inverse from the previous
    refresh's Ginv (the field drifts little between solves)."""
    N, Lt = ops.Nsites, ops.Ltau
    k = cfg.k
    c, nt = _chunk_counts(Lt, cfg)
    dtype = T.dtype

    # --- per-chunk whitening
    Tc = T.reshape(k, N, nt, c)
    S = jnp.einsum("knts,lnts->tkl", Tc, Tc, precision=_PREC)
    scale = jnp.mean(jnp.trace(S, axis1=-2, axis2=-1)) / k
    S = S + (cfg.reg * scale) * jnp.eye(k, dtype=dtype)
    Ls = jnp.linalg.cholesky(S)
    Linv = jax.scipy.linalg.solve_triangular(
        Ls, jnp.broadcast_to(jnp.eye(k, dtype=dtype), (nt, k, k)), lower=True)
    C = jnp.swapaxes(Linv, -1, -2)                      # C_J = L_J⁻ᵀ

    # --- colored M·W columns (chunk-parity coloring; M spreads one slice)
    Ct = jnp.repeat(C, c, axis=0)                       # [Lt, k, k]
    W_all = jnp.einsum("mnL,Lmi->inL", T, Ct, precision=_PREC)           # [k(col i), N, Lt]
    parity = (jnp.arange(Lt) // c) % 2
    V = jnp.stack([W_all * (parity == 0), W_all * (parity == 1)])  # [2,k,N,Lt]
    Y = ops.mulM(params, derived, V)                    # [2, k, N, Lt]

    # --- per-chunk image patches (slices Jc .. Jc+c, wrap at the corner)
    Jq = np.arange(nt) % 2
    tau_idx = (np.arange(nt)[:, None] * c + np.arange(c + 1)[None, :]) % Lt
    Yq = Y[Jq]                                          # [nt, k, N, Lt]
    idx = jnp.broadcast_to(jnp.asarray(tau_idx)[:, None, None, :],
                           (nt, k, N, c + 1))
    P = jnp.take_along_axis(Yq, idx, axis=-1)           # [nt, k, N, c+1]

    # --- block-tridiagonal bands of G = (MW)ᵀ(MW)
    Gd = jnp.einsum("Jins,Jjns->Jij", P, P, precision=_PREC)             # diag blocks
    Pn = jnp.roll(P, -1, axis=0)
    Go = jnp.einsum("Jin,Jjn->Jij", P[..., -1], Pn[..., 0],
                    precision=_PREC)  # J → J+1

    JJ = jnp.arange(nt)
    Z = jnp.zeros((nt, nt, k, k), dtype=dtype)
    Z = Z.at[JJ, JJ].set(Gd)
    Z = Z.at[JJ, (JJ + 1) % nt].add(Go)
    Z = Z.at[(JJ + 1) % nt, JJ].add(jnp.swapaxes(Go, -1, -2))
    D = nt * k
    G = jnp.transpose(Z, (0, 2, 1, 3)).reshape(D, D)
    Ginv = _spd_inverse(G, cfg, X_prev=X_prev)
    return NearNullState(T=T, C=C, Ginv=Ginv)


def _spd_inverse(G, cfg: NearNullConfig, X_prev=None):
    """Jacobi-scaled Newton–Schulz SPD inverse — pure matmuls
    (cholesky/triangular solves are row-sequential). Cold start: 20
    sweeps (converges modes down to λ̃ ~ 1e-5 of the scaled spectrum).
    Warm start from the previous refresh's inverse: 6 sweeps with a
    contraction safeguard — NS diverges iff ||I − X₀G̃|| ≥ 1, so one extra matmul checks the row-sum bound and
    falls back to the cold initializer on the (rare) oversized field move.
    The jitter bounds the scaled condition number so f32 stays safe even
    when a stale basis leaves near-dead directions in G."""
    D = G.shape[-1]
    dtype = G.dtype
    eye = jnp.eye(D, dtype=dtype)
    d = jnp.clip(jnp.diagonal(G, axis1=-2, axis2=-1), 1e-30, None)
    s = jax.lax.rsqrt(d)
    Gs = G * s[..., :, None] * s[..., None, :] + cfg.reg * eye
    # ||G̃||₂ ≤ max row sum; X₀ = I/bound guarantees NS convergence
    bound = jnp.max(jnp.sum(jnp.abs(Gs), axis=-1), axis=-1)
    X_cold = eye / bound[..., None, None]
    if X_prev is None:
        X = X_cold
        iters = 20
    else:
        # map the previous UNSCALED inverse into the new scaling
        X0 = X_prev / (s[..., :, None] * s[..., None, :])
        R = eye - jnp.matmul(X0, Gs, precision=_PREC)
        rho = jnp.max(jnp.sum(jnp.abs(R), axis=-1), axis=-1)
        X = jnp.where((rho < 0.9)[..., None, None], X0, X_cold)
        iters = 6
    for _ in range(iters):
        GX = jnp.matmul(Gs, X, precision=_PREC)
        X = jnp.matmul(X, 2.0 * eye - GX, precision=_PREC)
        X = 0.5 * (X + jnp.swapaxes(X, -1, -2))
    return X * s[..., :, None] * s[..., None, :]


def apply_correction(ops, nn: NearNullState, r, cfg: NearNullConfig):
    """W·G⁻¹·Wᵀ·r — the additive coarse correction (einsum + one matmul)."""
    N, Lt = ops.Nsites, ops.Ltau
    k = cfg.k
    c, nt = _chunk_counts(Lt, cfg)
    rc = r.reshape(r.shape[:-2] + (N, nt, c))
    Tc = nn.T.reshape(k, N, nt, c)
    raw = jnp.einsum("mnts,...nts->...tm", Tc, rc, precision=_PREC)          # Tᵀ|chunk · r
    u = jnp.einsum("tmi,...tm->...ti", nn.C, raw, precision=_PREC)           # whiten
    y = jnp.einsum("DE,...E->...D", nn.Ginv,
                   u.reshape(u.shape[:-2] + (nt * k,)), precision=_PREC)
    yt = y.reshape(y.shape[:-1] + (nt, k))
    w = jnp.einsum("tmi,...ti->...tm", nn.C, yt, precision=_PREC)            # un-whiten
    out = jnp.einsum("mnts,...tm->...nts", Tc, w, precision=_PREC)
    return out.reshape(r.shape)


def make_nearnull_precond(ops, kcfg: kpm.KPMConfig, ncfg: NearNullConfig,
                          seed: int = 1234):
    """Two-level :class:`~elphdynamics_tpu.ops.kpm.Preconditioner`:
    state = (KPMState, NearNullState). Setup smooths fresh test vectors and
    assembles G at the update's starting field; the per-solve refresh
    re-smooths them at the CURRENT field (``refresh_iters`` CG iterations —
    the lever the dense drift study shows restores near-fresh quality
    anywhere along the trajectory) and re-assembles/refactors G."""
    key = jax.random.PRNGKey(seed)
    tkey = jax.random.PRNGKey(ncfg.seed)

    def _tv_seed(dtype):
        return jax.random.normal(tkey, (ncfg.k, ops.Nsites, ops.Ltau), dtype)

    def setup(params, x):
        kst = kpm.setup(ops, params, x, kcfg, key)
        derived = ops.derived(params, x)
        T = _tv_seed(x.dtype)
        for _ in range(ncfg.setup_passes):
            T = _smooth(ops, params, derived, kst, kcfg, T, ncfg.setup_iters)
        return (kst, _build(ops, params, derived, T, ncfg))

    def refresh(st, params, x):
        kst = kpm.refresh(ops, st[0], params, x)
        if ncfg.refresh_mode == "freeze":
            return (kst, st[1])
        derived = ops.derived(params, x)
        T = st[1].T
        if ncfg.refresh_mode == "smooth" and ncfg.refresh_iters > 0:
            T = _smooth(ops, params, derived, kst, kcfg, T, ncfg.refresh_iters)
        return (kst, _build(ops, params, derived, T, ncfg,
                            X_prev=st[1].Ginv))

    def symmetric(st, v):
        return (kpm.apply_symmetric(ops, st[0], v, kcfg)
                + apply_correction(ops, st[1], v, ncfg))

    return kpm.Preconditioner(setup=setup, refresh=refresh, symmetric=symmetric)
