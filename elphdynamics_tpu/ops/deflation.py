"""Incremental Krylov-subspace deflation for the deep-β regime.

**Beyond reference parity — kept as a measured negative result, off by
default.** The reference shares the deep-β failure mode this module
targets: once the averaged-operator approximation behind the KPM
preconditioner breaks down (KPMPreconditioners.jl:280-318 — its validity
window assumes the τ-averaged block-diagonal captures the spectrum), a
tail of low eigenmodes of ``P⁻¹·MᵀM`` survives the preconditioner and CG
grinds through them every solve (measured: 160 iters/solve at Holstein
8×8 β=16 vs 10 at β=4 — BASELINE.md β-table).
``scripts/study_deflation_dense.py`` (CPU/f64 ground truth, 4×4 β=16)
showed exact 32-mode deflation cuts 88 → 20 iterations and that an f32
basis and *init-only* projection suffice — on a FIXED operator. On the
real sampler the slow-mode subspace rotates with the phonon field on the
scale of one trajectory, so the once-per-update basis is stale by the
time it is used: the on-chip A/B (`scripts/bench_deflation.py`, 8×8
β=16) measures 133 iters plain vs 250+ deflated. See BASELINE.md
§deep-β for the full study. The machinery below is correct (unit-tested
on static spectra) and the projection is always tolerance-safe — every
solve still converges to tol and HMC acceptance is unchanged — but the
default (`k = 0`) is the measured optimum for every production config.

Design (no per-iteration cost, no small eigenproblems in the
hot loop):

* The deflation basis ``W`` ([k, Nsites, Lτ], Euclidean-orthonormal,
  field dtype) persists across HMC/Langevin updates in the sampler state
  and is improved once per update by a degree-``filter_degree`` Chebyshev
  band-stop filter ``W ← p(P⁻¹A)·W`` with ``p = T_d`` mapped onto
  ``[cutoff·λmax, λmax]`` (λmax from a warm-started power iteration).
  Inside the band |p| ≤ 1 while below it p grows like
  ``cosh(d·acosh((b+a−2λ)/(b−a)))`` — ~50× per refresh at d=8 — so each
  update rotates ``span(W)`` hard toward the small-λ tail of broken modes
  CG is slow on (Chebyshev-filtered subspace iteration). A plain power
  filter ``(I − P⁻¹A/λmax)^s`` does NOT work here: the measured
  KPM-preconditioned deep-β spectrum has λmax ≈ 8 with the bulk at λ≈1,
  so its per-step bulk damping is only ≈0.88 and the basis never
  concentrates (flat A/B, BASELINE.md §deep-β). Filter applies are
  [k, N, Lτ]-batched operator calls — matmul-shaped work, unlike k
  sequential matvecs.
* Per solve, CG applies the **init-projection**
  ``x0 += W·(WᵀAW)⁻¹·Wᵀr0``, ``r0 -= AW·(WᵀAW)⁻¹·Wᵀr0`` using the
  ``AW`` and the Cholesky factor of ``WᵀAW`` stored at refresh — two
  [k, N·Lτ] contractions and one k×k triangular solve, **zero** extra
  operator applications (solvers.py:cg reuses its own r0).

The projection is the A-orthogonal projector onto span(W): it strictly
reduces the A-norm error for any basis, so a not-yet-converged W can only
help less, never destabilize the solve (the verification + retry ladder
of solve_checked still backstops everything).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from elphdynamics_tpu.utils.dtypes import fdot


class DeflationConfig(NamedTuple):
    """[solver.deflation] knobs (beyond-reference; no TOML analog upstream)."""

    k: int = 32              # deflation-basis size
    filter_degree: int = 8   # Chebyshev filter degree per refresh
    power_iters: int = 4     # λmax(P⁻¹A) power-iteration steps per refresh
    cutoff: float = 1 / 16   # band-stop lower edge as a fraction of λmax


class DeflationState(NamedTuple):
    W: jnp.ndarray        # [k, N, Lτ] orthonormal basis
    chol: jnp.ndarray     # [k, k] lower Cholesky of WᵀAW (refresh-point A)
    pvec: jnp.ndarray     # [N, Lτ] running λmax(P⁻¹A) power-iteration vector
    lam_max: jnp.ndarray  # scalar, current λmax estimate


def init(key, k: int, Nsites: int, Ltau: int, dtype=jnp.float32) -> DeflationState:
    """Random orthonormal basis; becomes useful after the first refreshes.

    ``dtype`` complex (the complex-hopping / twisted-BC path): the basis is
    drawn circularly complex and every Gram/projection below runs with the
    Hermitian inner product — a complex k-dim basis spans a 2k-dim real
    subspace of the ℝ²ⁿ embedding the Re-Hermitian CG works in, and because
    M†M is ℂ-linear the complex A-orthogonal projector IS the real one on
    that span."""
    kW, kp = jax.random.split(key)
    if jnp.issubdtype(dtype, jnp.complexfloating):
        rdt = jnp.zeros((), dtype).real.dtype
        g = jax.random.normal(kW, (2, k, Nsites, Ltau), dtype=rdt)
        W0 = (g[0] + 1j * g[1]).astype(dtype)
        gp = jax.random.normal(kp, (2, Nsites, Ltau), dtype=rdt)
        pvec = (gp[0] + 1j * gp[1]).astype(dtype)
    else:
        W0 = jax.random.normal(kW, (k, Nsites, Ltau), dtype=dtype)
        pvec = jax.random.normal(kp, (Nsites, Ltau), dtype=dtype)
    Q, _ = jnp.linalg.qr(W0.reshape(k, -1).T)          # [N·Lτ, k]
    W = Q.T.reshape(k, Nsites, Ltau).astype(dtype)
    pvec = (pvec / jnp.sqrt(fdot(pvec, pvec, axis=(-2, -1)))).astype(dtype)
    lam_dt = jnp.zeros((), dtype).real.dtype
    return DeflationState(
        W=W, chol=jnp.eye(k, dtype=dtype),
        pvec=pvec, lam_max=jnp.asarray(1.0, lam_dt),
    )


def _orthonormalize(W):
    """Euclidean QR over the flattened field axes: [k, N, Lτ] → same, rows
    orthonormal. Only span(W) matters for the projector, so plain QR (no
    Rayleigh-Ritz) is enough."""
    k, N, Lt = W.shape
    Q, R = jnp.linalg.qr(W.reshape(k, -1).T)           # Q: [N·Lτ, k]
    # fix degenerate columns (can only happen while W is still random junk)
    d = jnp.abs(jnp.diagonal(R, axis1=-2, axis2=-1))
    Q = jnp.where(d[None, :] > 1e-30, Q, 0.0)
    return Q.T.reshape(k, N, Lt).astype(W.dtype)


def _orthonormalize_psum(W, psum):
    """CholeskyQR2 over the site-sharded flattened field axes: ``W`` is the
    LOCAL [k, B, Lτ] row block and ``psum`` reduces over the site mesh axis.
    Two Cholesky-QR passes restore full f32 orthonormality even after the
    hard Chebyshev filter skews the Gram; only span(W) matters downstream,
    and span is shard-decomposition invariant, so the sharded projector
    agrees with the unsharded QR one to rounding."""
    k, B, Lt = W.shape
    wf_dt = jnp.complex64 if jnp.iscomplexobj(W) else jnp.float32
    Wf = W.reshape(k, -1).astype(wf_dt)
    for _ in range(2):
        # Hermitian row Gram W·W† (== W·Wᵀ on the real path)
        G = psum(jnp.matmul(Wf, jnp.conj(Wf).T,
                            precision=jax.lax.Precision.HIGHEST))
        # jitter scale mirrors refresh(): near-parallel rows (the filter
        # concentrates everything toward the slow tail) stay factorizable;
        # a truly degenerate row has G[i,i]≈jitter and solves to zero —
        # the same outcome as the unsharded QR's degenerate-column zeroing
        jitter = 1e-6 * (jnp.real(jnp.trace(G)) / k) + 1e-30
        L = jnp.linalg.cholesky(G + jitter * jnp.eye(k, dtype=G.dtype))
        bad = jnp.any(jnp.isnan(L))
        L = jnp.where(bad, jnp.eye(k, dtype=G.dtype), L)
        Wf = jax.scipy.linalg.solve_triangular(L, Wf, lower=True)
        Wf = jnp.where(bad, jnp.zeros_like(Wf), Wf)
    return Wf.reshape(k, B, Lt).astype(W.dtype)


def refresh(st: DeflationState, apply_A: Callable, apply_P: Callable,
            cfg: DeflationConfig, psum: Callable | None = None) -> DeflationState:
    """Once-per-update basis improvement at the current field.

    ``apply_A``/``apply_P`` act on [..., N, Lτ] with leading batch axes
    (every model operator and KPM apply already does). Cost:
    ``power_iters`` single + ``filter_degree``·k batched operator applies
    plus one [N·Lτ, k] QR and a k×k Cholesky.

    ``psum`` (site-sharded mode, parallel/lattice_shard.py): the state's
    field axes are LOCAL row blocks [.., B, Lτ], ``apply_A``/``apply_P``
    are the shard-local halo operators, and ``psum`` reduces scalars /
    k×k Grams over the site mesh axis. The QR becomes CholeskyQR2; span(W)
    — all the projector sees — is decomposition-invariant, so sharded and
    unsharded refreshes agree to rounding.
    """
    # --- λmax(P⁻¹A) power iteration, warm-started from the carried vector
    # (dtype-pinned: fdot may accumulate wider than the field dtype)
    vdt = st.pvec.dtype

    def pstep(v, _):
        w = apply_P(apply_A(v))
        nrm2 = fdot(w, w, axis=(-2, -1))
        lam = jnp.sqrt(psum(nrm2) if psum is not None else nrm2)
        v_new = (w / jnp.maximum(lam, 1e-30).astype(w.dtype)).astype(vdt)
        return v_new, lam

    pvec, lams = jax.lax.scan(pstep, st.pvec, None, length=cfg.power_iters)
    lam_max = jnp.maximum(lams[-1], 1e-30).astype(st.lam_max.dtype)

    # --- Chebyshev band-stop filter W ← T_d(ℓ(P⁻¹A))·W on [a, b]:
    # ℓ maps [a, b] → [−1, 1]; |T_d| ≤ 1 on the band, grows like
    # cosh(d·acosh(ℓ(0))) below it — the small-λ tail is amplified ~50×
    # per refresh relative to the bulk at d=8. Standard three-term
    # recurrence; magnitudes stay O(cosh(d·acosh((b+a)/(b−a)))) ≈ 30,
    # well within f32, and the QR below renormalizes anyway.
    wdt = st.W.dtype
    edt = jnp.zeros((), wdt).real.dtype  # edge arithmetic stays real
    b_edge = (1.02 * lam_max).astype(edt)
    a_edge = (cfg.cutoff * lam_max).astype(edt)
    center = (b_edge + a_edge) / 2
    half = jnp.maximum((b_edge - a_edge) / 2, 1e-30).astype(edt)

    def ell(V):  # ℓ(P⁻¹A)·V = (c·V − P⁻¹A·V)/e  (sign flip is harmless)
        return ((center * V - apply_P(apply_A(V))) / half).astype(wdt)

    W0 = st.W
    W1 = ell(W0)
    for _ in range(max(cfg.filter_degree - 1, 0)):
        W0, W1 = W1, (2.0 * ell(W1) - W0).astype(wdt)
    W = (_orthonormalize_psum(W1, psum) if psum is not None
         else _orthonormalize(W1))

    # --- projector normal matrix: chol(WᵀAW) as ONE [k,NL]×[NL,k] matmul —
    # an fdot outer-product form would materialize a [k, k, N·Lτ] temp
    # (gigabytes at deep β); HIGHEST keeps full f32 products
    AW = apply_A(W)
    k = W.shape[0]
    # C_ij = w_i†·A·w_j (Hermitian PD; conj is the identity on real W)
    C = jnp.matmul(jnp.conj(W.reshape(k, -1)), AW.reshape(k, -1).T,
                   precision=jax.lax.Precision.HIGHEST)
    if psum is not None:
        C = psum(C)
    C = 0.5 * (C + jnp.conj(C).T)
    jitter = 1e-6 * (jnp.real(jnp.trace(C)) / C.shape[0]) + 1e-30
    chol = jnp.linalg.cholesky(C + jitter * jnp.eye(C.shape[0], dtype=C.dtype))
    # a failed factorization (NaNs) neutralizes the correction (W·0 = 0)
    bad = jnp.any(jnp.isnan(chol))
    chol = jnp.where(bad, jnp.eye(C.shape[0], dtype=C.dtype), chol)
    W = jnp.where(bad, jnp.zeros_like(W), W)
    return DeflationState(W=W, chol=chol, pvec=pvec, lam_max=lam_max)


def project(st: DeflationState, r0, x0, psum: Callable | None = None):
    """Init-deflation: correct ``x0`` toward the A-orthogonal projection of
    the error onto span(W), using the refresh-point ``WᵀAW`` factor.

    ``r0 = b − A·x0`` with arbitrary leading batch axes; returns the
    corrected ``x0``. The caller recomputes the exact residual afterward —
    along an HMC trajectory A drifts from the refresh point, so updating
    ``r0`` with a stored ``A_refresh·W`` would leave (x0, r0) inconsistent
    and bias the converged solution below the verification threshold; one
    extra operator apply per solve buys exactness instead.

    ``psum`` (site-sharded mode): W/r0/x0 carry local [.., B, Lτ] row
    blocks; the [.., k] coefficient contraction is psum-reduced, the
    k×k solve is replicated, and the correction stays local.
    """
    dtype = r0.dtype
    k = st.W.shape[0]
    N, Lt = r0.shape[-2:]
    lead = r0.shape[:-2]
    Wf = st.W.reshape(k, -1).astype(dtype)
    # both contractions as HIGHEST-precision matmuls: the default bf16
    # matmul would corrupt the correction, and an fdot broadcast form
    # would materialize a [..., k, N, Lτ] temp
    c = jnp.matmul(r0.reshape(lead + (-1,)), jnp.conj(Wf).T,
                   precision=jax.lax.Precision.HIGHEST)       # [..., k]: w_i†·r0
    if psum is not None:
        c = psum(c)
    # cho_solve does not broadcast the factor over RHS batch axes: fold the
    # batch into the trailing RHS axis instead
    y = jax.scipy.linalg.cho_solve((st.chol.astype(dtype), True),
                                   c.reshape(-1, k).T)
    y = y.T.reshape(lead + (k,))
    corr = jnp.matmul(y, Wf, precision=jax.lax.Precision.HIGHEST)
    return x0 + corr.reshape(lead + (N, Lt))
