"""Iterative linear solvers as on-device ``lax.while_loop`` programs.

Reference: IterativeSolvers.jl. Differences forced by the accelerator
execution model:

* **Batched right-hand sides.** The reference solves one system at a time
  (e.g. the Green's-function estimator does nᵥ serial CG solves,
  GreensFunctions.jl:209-231). Here every solver accepts fields shaped
  ``[..., N, Lτ]`` with arbitrary leading batch axes; all batch elements
  iterate together with *masked updates* once individually converged, so a
  batch of solves costs max(iters) rather than sum(iters).
* **Value-encoded control flow.** Convergence, the κ-bound early abort
  (IterativeSolvers.jl:198-231) and the residual-verification + retry ladder
  of ``Models.ldiv!`` (Models.jl:74-186) are masks/flags carried through the
  loop state rather than Python control flow.

Dtype policy (f32 fields on the accelerator, f64 under x64):

* **entry/exit quantities** — |b|, the initial residual, and the
  post-solve residual *verification* — accumulate through
  :func:`elphdynamics_tpu.utils.dtypes.fdot`: f64 under x64, exact
  two-products + double-f32 pairwise reduction (~1 ulp) in pure-f32 mode;
* **loop-body dots** (pAp, r·z, per-iteration ε) use
  :func:`~elphdynamics_tpu.utils.dtypes.fdot_fast` — hardware precision —
  because CG re-derives its residual each iteration, the f32 tree-sum error
  (~1e-6 relative) sits far below the 1e-5 tolerance, and every solve ends
  in the compensated verification + retry ladder anyway. This keeps the
  latency-critical while_loop free of the log₂(n)-level compensation tree.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from elphdynamics_tpu.utils.dtypes import fdot, fdot_fast

# module default for cg(unroll=None): iterations per while_loop trip
CG_UNROLL = 1


def _dot(a, b):
    """Batched real inner product over the trailing two axes (accurate
    accumulation; scalars may come back wider than the field dtype)."""
    return fdot(a, b, axis=(-2, -1))


def _norm(a):
    return jnp.sqrt(_dot(a, a))


def _dot_hot(a, b):
    """Loop-body inner product (see dtypes.fdot_fast): hardware precision in
    f32 mode — every solve is still verified with the compensated _norm."""
    return fdot_fast(a, b, axis=(-2, -1))


def _norm_hot(a):
    return jnp.sqrt(_dot_hot(a, a))


def _bc(s, like):
    """Broadcast a batch-shaped scalar against a field array; non-bool
    scalars are cast back to the field dtype so wide accumulators never
    widen the fields."""
    s = s[..., None, None]
    return s if s.dtype == jnp.bool_ else s.astype(like.dtype)


class CGResult(NamedTuple):
    x: jnp.ndarray
    iters: jnp.ndarray      # per-batch iteration count
    converged: jnp.ndarray  # per-batch bool (tolerance reached)


def cg(
    apply_A: Callable,
    b,
    x0=None,
    *,
    apply_P: Callable | None = None,
    tol: float = 1e-5,
    maxiter: int = 1000,
    kappa_max: float = 1e12,
    active0=None,
    deflate=None,
    unroll: int | None = None,
):
    """Preconditioned conjugate gradient (IterativeSolvers.jl:153-234).

    Solves ``A·x = b`` for SPD ``A``; ``apply_P`` applies ``P⁻¹``. Residual
    tolerance is relative to ``|b|``; iteration also stops for a batch
    element when the running condition-number lower bound ``κmin =
    (2j/log(2ε₀/ε))²`` exceeds ``kappa_max`` (the reference's early-abort,
    IterativeSolvers.jl:214-218). ``active0`` optionally masks out batch
    elements that should not be solved at all (used by the fallback ladder).
    ``deflate`` is an optional :class:`elphdynamics_tpu.ops.deflation.DeflationState`;
    its init-projection is applied to (x0, r0) before iterating — beyond
    reference parity, see ops/deflation.py.
    """
    b = jnp.asarray(b)
    if x0 is None:
        x0 = jnp.zeros_like(b)
    P = apply_P if apply_P is not None else (lambda v: v)

    normb = _norm(b)
    safe_normb = jnp.where(normb > 0, normb, 1.0)
    r0 = b - apply_A(x0)
    if deflate is not None:
        from elphdynamics_tpu.ops.deflation import project
        # two passes = one step of iterative refinement: the f32 WᵀAW
        # factor limits a single projection to ~1e-4·|b| residual in the
        # slow modes (cond(WᵀAW) ≈ 1/λ_slow amplifies the f32 roundoff);
        # re-projecting the exact residual squares that error away without
        # any f64 math (production runs x64-disabled)
        for _ in range(2):
            x0 = project(deflate, r0, x0)
            r0 = b - apply_A(x0)
    z0 = P(r0)
    rdotz0 = _dot(r0, z0)
    eps0 = _norm(r0) / safe_normb

    if active0 is None:
        active0 = jnp.ones(b.shape[:-2], dtype=bool)
    else:
        active0 = jnp.asarray(active0)
    # elements already at tolerance never iterate
    active0 = active0 & (eps0 >= tol)

    def cond(state):
        j, x, r, z, p, rdotz, kmin, iters, active, conv = state
        return (j < maxiter) & jnp.any(active)

    def body(state):
        j, x, r, z, p, rdotz, kmin, iters, active, conv = state
        Ap = apply_A(p)
        pAp = _dot_hot(p, Ap)
        safe_pAp = jnp.where(pAp != 0, pAp, 1.0)
        alpha = rdotz / safe_pAp
        x_new = x + _bc(alpha, x) * p
        r_new = r - _bc(alpha, r) * Ap
        eps = _norm_hot(r_new) / safe_normb
        # reference formula (IterativeSolvers.jl:214): the log is SIGNED and
        # squared away — a residual transiently overshooting 2·ε₀ yields a
        # modest bound, not an abort; only stagnation at ε ≈ 2·ε₀ (log → 0)
        # legitimately diverges. Guard just that singularity.
        logr = jnp.log(2.0 * eps0 / jnp.where(eps > 0, eps, 1e-300))
        logr = jnp.where(jnp.abs(logr) > 1e-12, logr, 1e-12)
        kmin_new = jnp.maximum(kmin, (2.0 * (j + 1) / logr) ** 2)
        done = (eps < tol) | (kmin_new > kappa_max)
        z_new = P(r_new)
        rdotz_new = _dot_hot(r_new, z_new)
        beta = rdotz_new / jnp.where(rdotz != 0, rdotz, 1.0)
        p_new = z_new + _bc(beta, p) * p

        m = _bc(active, x)
        x = jnp.where(m, x_new, x)
        r = jnp.where(m, r_new, r)
        z = jnp.where(m, z_new, z)
        p = jnp.where(m, p_new, p)
        rdotz = jnp.where(active, rdotz_new, rdotz)
        kmin = jnp.where(active, kmin_new, kmin)
        iters = iters + active.astype(iters.dtype)
        conv = conv | (active & (eps < tol))
        active = active & ~done
        return (j + 1, x, r, z, p, rdotz, kmin, iters, active, conv)

    batch_shape = b.shape[:-2]
    state0 = (
        jnp.asarray(0),
        x0,
        r0,
        z0,
        z0,
        rdotz0,
        jnp.zeros(batch_shape, dtype=normb.dtype),
        jnp.zeros(batch_shape, dtype=jnp.int32),
        active0,
        (eps0 < tol),
    )
    # optional loop unrolling: run `unroll` masked iterations per
    # while_loop trip, trading ≤ unroll−1 wasted (fully-masked) iterations
    # at the tail for fewer condition evaluations / state round-trips —
    # a latency knob for the small-N regime (see BASELINE.md; CG_UNROLL
    # is the module default the solve paths inherit)
    n_unroll = CG_UNROLL if unroll is None else unroll
    body_n = body
    if n_unroll > 1:
        def body_n(state):
            for _ in range(n_unroll):
                state = body(state)
            return state
    _, x, r, _, _, _, _, iters, _, conv = lax.while_loop(cond, body_n, state0)
    return CGResult(x=x, iters=iters, converged=conv)


def cg_split(
    apply_A: Callable,
    b,
    x0=None,
    *,
    apply_Linv: Callable,
    apply_LTinv: Callable,
    tol: float = 1e-5,
    maxiter: int = 1000,
    kappa_max: float = 1e12,
):
    """CG with a *split* preconditioner L/Lᵀ: iterates the transformed system
    ``[L⁻¹·A·L⁻ᵀ]·u = L⁻¹·b`` with u = Lᵀ·x carried implicitly
    (IterativeSolvers.jl:64-147 — the variant no stock example exercises,
    kept for solver-surface parity). Batched RHS with masked convergence,
    same κ-abort as :func:`cg`; the residual criterion is
    ``|L⁻ᵀL⁻¹(A·x−b)| / |L⁻ᵀL⁻¹b|`` exactly as the reference's.
    """
    b = jnp.asarray(b)
    if x0 is None:
        x0 = jnp.zeros_like(b)

    r0 = apply_Linv(b - apply_A(x0))
    p0 = apply_LTinv(r0)
    normLb = _norm(apply_LTinv(apply_Linv(b)))
    safe_normLb = jnp.where(normLb > 0, normLb, 1.0)
    eps0 = _norm(p0) / safe_normLb
    rdotr0 = _dot(r0, r0)
    active0 = eps0 >= tol

    def cond(state):
        j, x, r, p, rdotr, kmin, iters, active, conv = state
        return (j < maxiter) & jnp.any(active)

    def body(state):
        j, x, r, p, rdotr, kmin, iters, active, conv = state
        Ap = apply_A(p)
        alpha = rdotr / _dot_hot(p, Ap)
        x_new = x + _bc(alpha, x) * p
        r_new = r - _bc(alpha, r) * apply_Linv(Ap)
        rdotr_new = _dot_hot(r_new, r_new)
        beta = rdotr_new / jnp.where(rdotr != 0, rdotr, 1.0)
        p_new = apply_LTinv(r_new) + _bc(beta, p) * p
        eps = _norm_hot(p_new) / safe_normLb
        # reference formula (IterativeSolvers.jl:214): the log is SIGNED and
        # squared away — a residual transiently overshooting 2·ε₀ yields a
        # modest bound, not an abort; only stagnation at ε ≈ 2·ε₀ (log → 0)
        # legitimately diverges. Guard just that singularity.
        logr = jnp.log(2.0 * eps0 / jnp.where(eps > 0, eps, 1e-300))
        logr = jnp.where(jnp.abs(logr) > 1e-12, logr, 1e-12)
        kmin_new = jnp.maximum(kmin, (2.0 * (j + 1) / logr) ** 2)
        done = (eps < tol) | (kmin_new > kappa_max)

        m = _bc(active, x)
        x = jnp.where(m, x_new, x)
        r = jnp.where(m, r_new, r)
        p = jnp.where(m, p_new, p)
        rdotr = jnp.where(active, rdotr_new, rdotr)
        kmin = jnp.where(active, kmin_new, kmin)
        iters = iters + active.astype(iters.dtype)
        conv = conv | (active & (eps < tol))
        active = active & ~done
        return (j + 1, x, r, p, rdotr, kmin, iters, active, conv)

    batch_shape = b.shape[:-2]
    state0 = (
        jnp.asarray(0), x0, r0, p0, rdotr0,
        jnp.zeros(batch_shape, dtype=normLb.dtype),
        jnp.zeros(batch_shape, dtype=jnp.int32),
        active0, (eps0 < tol),
    )
    _, x, _, _, _, _, iters, _, conv = lax.while_loop(cond, body, state0)
    return CGResult(x=x, iters=iters, converged=conv)


def block_cg(
    apply_A: Callable,
    B,
    X0=None,
    *,
    apply_P: Callable | None = None,
    tol: float = 1e-5,
    maxiter: int = 1000,
    kappa_max: float = 1e12,
    active0=None,
    psum_axis: str | None = None,
    sync_axis: str | None = None,
):
    """Breakdown-guarded block CG: solve ``A·X = B`` for ``s`` right-hand
    sides [..., s, N, Lτ] that share the operator, with the search block
    spanning ALL residuals (O'Leary 1980).

    ``psum_axis`` runs the solver shard-local under ``shard_map`` with the
    field axes partitioned over that mesh axis: every Gram/norm reduction
    completes with a ``lax.psum``, so the mathematics is identical to the
    unsharded solve (used by the site-sharded estimator path,
    parallel/lattice_shard.py). ``sync_axis`` couples the while_loop trip
    count across an extra mesh axis (2-D chain × site meshes — see
    ``_cg_local``'s deadlock note): converged rows run masked-idle
    iterations so every participant executes the same collectives.

    Beyond reference scope (IterativeSolvers.jl solves one system at a
    time): where :func:`cg` runs the s systems as independent batch lanes,
    block CG lets every system's update draw on the whole s-dimensional
    Krylov block, which dynamically deflates up to s−1 slow modes — exactly
    the effect the (measured-ineffective) persistent-deflation experiment
    (`ops/deflation.py`) could not get from a *stale* basis, obtained here
    from the current operator at no extra matvec cost. The win grows with
    the operator's condition number, i.e. with β.

    f32 robustness (the GMRES mid-cycle lesson, tests/test_solvers.py):

    * **converged columns freeze** — their residual is tolerance-floor
      noise; letting it into the shared Gram solves corrupts every other
      column. Frozen columns are zeroed out of the direction block and the
      Gram gets a unit diagonal in their slot.
    * **Gram solves are diagonally scaled to unit diagonal** (see
      ``colsolve``) — the conditioning the former per-iteration column
      normalization bought, without its two extra full-field passes; the
      initial direction block is still normalized once.
    * α/β come from the explicit Gram solves ``(PᵀAP)α = PᵀR`` and
      ``(PᵀAP)β = −QᵀZ`` rather than the ρ-recursion — self-correcting
      under inexact arithmetic.
    * **all Gram/update einsums are pinned to HIGHEST precision** — a
      single-pass bf16 or TF32 product injects ~1e-3 noise into the shared
      Gram and the X/R updates, which was measured to blow the iteration
      count up ~8× at β=16.
    """
    B = jnp.asarray(B)
    if B.ndim < 3:
        raise ValueError("block_cg needs [..., s, N, Ltau] right-hand sides")
    if X0 is None:
        X0 = jnp.zeros_like(B)
    P = apply_P if apply_P is not None else (lambda v: v)
    s = B.shape[-3]

    def _ps(v):
        return lax.psum(v, psum_axis) if psum_axis is not None else v

    def gram(U, W):
        # [..., a, b] = Σ_{N,Lτ} U[..., a]·W[..., b]. Precision MUST be
        # HIGHEST: a backend's default einsum precision may be one-pass
        # bf16 or TF32, whose noise in the shared Gram corrupts every
        # column's α/β and blows the iteration count up ~8× (measured at
        # β=16 — scripts/bench_block.py; the CPU studies ran full f32 and
        # were blind to it). The contraction is s×s-small, so the cost is nil.
        return _ps(jnp.einsum("...aij,...bij->...ab", U, W,
                              precision=lax.Precision.HIGHEST))

    def nrm(a):
        return jnp.sqrt(_ps(_dot(a, a)))

    def nrm_hot(a):
        return jnp.sqrt(_ps(_dot_hot(a, a)))

    def colsolve(G, C):
        """Batched s×s solve G⁻¹·C with the diagonal scaling
        D⁻½·(D⁻½GD⁻½)⁻¹·D⁻½ folded in — the same conditioning the former
        per-iteration column normalization of Pd bought, at s×s cost
        instead of two full-field passes (it cancels identically in the
        X/R updates). s=2 (the spin-stacked trajectory solves) uses the
        closed-form 2×2 inverse: a batched LU is a latency-bound chain of
        small kernels, two calls per iteration (the cost that made block
        CG lose wall time while winning iterations, scripts/bench_block.py;
        not measured on H100)."""
        dg = jnp.diagonal(G, axis1=-2, axis2=-1)
        sc = 1.0 / jnp.sqrt(jnp.where(dg > 0, dg, 1.0))
        Gh = G * sc[..., :, None] * sc[..., None, :]
        Ch = sc[..., :, None] * C
        if s == 2:
            a = Gh[..., 0, 0]
            b = Gh[..., 0, 1]
            b2 = Gh[..., 1, 0]
            c = Gh[..., 1, 1]
            det = a * c - b * b2
            det = jnp.where(det != 0, det, 1.0)
            r0 = (c[..., None] * Ch[..., 0, :] - b[..., None] * Ch[..., 1, :]) / det[..., None]
            r1 = (a[..., None] * Ch[..., 1, :] - b2[..., None] * Ch[..., 0, :]) / det[..., None]
            Y = jnp.stack([r0, r1], axis=-2)
        else:
            Y = jnp.linalg.solve(Gh, Ch)
        return sc[..., :, None] * Y

    normb = nrm(B)                         # [..., s]
    safe_normb = jnp.where(normb > 0, normb, 1.0)
    R = B - apply_A(X0)
    Z = P(R)
    eps0 = nrm(R) / safe_normb

    if active0 is None:
        active0 = jnp.ones(B.shape[:-2], dtype=bool)
    else:
        active0 = jnp.asarray(active0) & jnp.ones(B.shape[:-2], dtype=bool)
    active0 = active0 & (eps0 >= tol)

    def normalize(Pd):
        n = nrm_hot(Pd)                     # [..., s]
        return Pd / _bc(jnp.where(n > 0, n, 1.0), Pd)

    Pd0 = normalize(Z * _bc(active0, Z))

    def cond(state):
        j, X, R, Pd, kmin, iters, active, conv = state
        any_active = jnp.any(active)
        if sync_axis is not None:
            any_active = lax.psum(any_active.astype(jnp.int32), sync_axis) > 0
        return (j < maxiter) & any_active

    def body(state):
        j, X, R, Pd, kmin, iters, active, conv = state
        act_dir = _bc(active, Pd)
        Pd = Pd * act_dir
        Q = apply_A(Pd)
        G = gram(Pd, Q)                     # [..., s, s]
        # frozen slots: unit diagonal keeps the batched LU non-singular
        eye = jnp.eye(s, dtype=G.dtype)
        G = G + eye * (~active).astype(G.dtype)[..., None, :]
        alpha = colsolve(G, gram(Pd, R))    # [..., sdir, srhs]
        alpha = alpha * active[..., None, :].astype(alpha.dtype)
        # HIGHEST for the same reason as gram(): the bf16 default would
        # inject ~8e-3 relative noise straight into X and R every iteration
        X_new = X + jnp.einsum("...aij,...ab->...bij", Pd, alpha,
                               precision=lax.Precision.HIGHEST)
        R_new = R - jnp.einsum("...aij,...ab->...bij", Q, alpha,
                               precision=lax.Precision.HIGHEST)
        eps = nrm_hot(R_new) / safe_normb
        # per-column κ lower bound, as in cg (IterativeSolvers.jl:214)
        logr = jnp.log(2.0 * eps0 / jnp.where(eps > 0, eps, 1e-300))
        logr = jnp.where(jnp.abs(logr) > 1e-12, logr, 1e-12)
        kmin_new = jnp.maximum(kmin, (2.0 * (j + 1) / logr) ** 2)
        done = (eps < tol) | (kmin_new > kappa_max)
        Z_new = P(R_new) * _bc(active & ~done, R_new)
        beta = colsolve(G, -gram(Q, Z_new))
        Pd_new = Z_new + jnp.einsum("...aij,...ab->...bij", Pd, beta,
                                    precision=lax.Precision.HIGHEST)

        m = _bc(active, X)
        X = jnp.where(m, X_new, X)
        R = jnp.where(m, R_new, R)
        Pd = jnp.where(m, Pd_new, 0.0)
        kmin = jnp.where(active, kmin_new, kmin)
        iters = iters + active.astype(iters.dtype)
        conv = conv | (active & (eps < tol))
        active = active & ~done
        return (j + 1, X, R, Pd, kmin, iters, active, conv)

    batch_shape = B.shape[:-2]
    state0 = (
        jnp.asarray(0), X0, R, Pd0,
        jnp.zeros(batch_shape, dtype=normb.dtype),
        jnp.zeros(batch_shape, dtype=jnp.int32),
        active0, (eps0 < tol),
    )
    _, X, _, _, _, iters, _, conv = lax.while_loop(cond, body, state0)
    return CGResult(x=X, iters=iters, converged=conv)


def block_solve_checked(
    apply_A: Callable,
    B,
    X0=None,
    *,
    apply_P: Callable | None = None,
    tol: float = 1e-5,
    maxiter: int = 1000,
    kappa_max: float = 1e12,
    apply_A_check: Callable | None = None,
):
    """:func:`block_cg` with the residual-verification + retry ladder of
    :func:`solve_checked` (Models.jl:74-186); failed columns are re-solved
    by plain unpreconditioned masked CG. ``apply_A_check`` as in
    :func:`solve_checked`."""
    A_chk = apply_A_check if apply_A_check is not None else apply_A
    res1 = block_cg(apply_A, B, X0=X0, apply_P=apply_P, tol=tol,
                    maxiter=maxiter, kappa_max=kappa_max)
    normb = _norm(B)
    safe_normb = jnp.where(normb > 0, normb, 1.0)
    err = _norm(A_chk(res1.x) - B) / safe_normb
    bad = err > jnp.sqrt(tol)
    flag = jnp.where(bad, jnp.where(res1.iters >= maxiter, 1, 2), 0)
    x_start = jnp.where(_bc(bad, res1.x), 0.0, res1.x)
    res2 = cg(A_chk, B, x0=x_start, tol=tol, maxiter=10 * maxiter,
              kappa_max=kappa_max, active0=bad)
    x = jnp.where(_bc(bad, res1.x), res2.x, res1.x)
    err2 = _norm(A_chk(x) - B) / safe_normb
    iters = res1.iters + jnp.where(bad, res2.iters, 0)
    still_bad = bad & (err2 > jnp.sqrt(tol))
    flag = jnp.where(still_bad, flag, 0)
    return SolveResult(x=x, iters=iters, residual=err2, flag=flag)


class SolveResult(NamedTuple):
    x: jnp.ndarray
    iters: jnp.ndarray
    residual: jnp.ndarray
    flag: jnp.ndarray  # 0 ok / 1 hit maxiter / 2 false convergence (Models.jl:95-134)


def solve_checked(
    apply_A: Callable,
    b,
    x0=None,
    *,
    apply_P: Callable | None = None,
    tol: float = 1e-5,
    maxiter: int = 1000,
    kappa_max: float = 1e12,
    fallback: bool = True,
    deflate=None,
    apply_A_check: Callable | None = None,
):
    """CG solve with residual verification and retry ladder (Models.jl:74-186).

    After a preconditioned solve the true residual ``|A·x−b|/|b|`` is
    recomputed; elements with residual > √tol are flagged (1 = hit maxiter,
    2 = false convergence), zeroed, and re-solved *unpreconditioned* with
    10× the iteration budget — as masked members of a second while_loop that
    exits immediately if nothing failed. ``x0`` optionally warm-starts the
    first solve (the ``construct_guess`` knob the reference documents in its
    example TOMLs; the retry always restarts from zero, undeflated).

    ``apply_A_check`` optionally supplies a higher-precision operator for
    the residual verification and the retry (the split in-loop precision
    policy, ``[solver] loop_precision``): the cheap operator only steers the
    iteration, the verified residual and any fallback re-solve are computed
    with the accurate one.
    """
    A_chk = apply_A_check if apply_A_check is not None else apply_A
    res1 = cg(apply_A, b, x0=x0, apply_P=apply_P, tol=tol, maxiter=maxiter,
              kappa_max=kappa_max, deflate=deflate)
    normb = _norm(b)
    safe_normb = jnp.where(normb > 0, normb, 1.0)
    err = _norm(A_chk(res1.x) - b) / safe_normb
    bad = err > jnp.sqrt(tol)
    flag = jnp.where(bad, jnp.where(res1.iters >= maxiter, 1, 2), 0)

    if apply_P is None or not fallback:
        return SolveResult(x=res1.x, iters=res1.iters, residual=err, flag=flag)

    x_start = jnp.where(_bc(bad, res1.x), 0.0, res1.x)
    res2 = cg(A_chk, b, x0=x_start, tol=tol, maxiter=10 * maxiter,
              kappa_max=kappa_max, active0=bad)
    x = jnp.where(_bc(bad, res1.x), res2.x, res1.x)
    err2 = _norm(A_chk(x) - b) / safe_normb
    iters = res1.iters + res2.iters
    still_bad = bad & (err2 > jnp.sqrt(tol))
    flag = jnp.where(still_bad, flag, 0)
    return SolveResult(x=x, iters=iters, residual=err2, flag=flag)


# ---------------------------------------------------------------------------
# BiCGStab (IterativeSolvers.jl:323-417) — for non-symmetric M solves
# ---------------------------------------------------------------------------

def bicgstab(
    apply_A: Callable,
    b,
    x0=None,
    *,
    apply_P: Callable | None = None,
    tol: float = 1e-5,
    maxiter: int = 1000,
):
    """Preconditioned BiCGStab with batched RHS and masked convergence."""
    b = jnp.asarray(b)
    if x0 is None:
        x0 = jnp.zeros_like(b)
    P = apply_P if apply_P is not None else (lambda v: v)

    normb = _norm(b)
    safe_normb = jnp.where(normb > 0, normb, 1.0)
    r0 = b - apply_A(x0)
    rt = r0
    batch_shape = b.shape[:-2]
    zero = jnp.zeros(batch_shape, dtype=normb.dtype)

    def cond(state):
        j, x, r, pvec, v, rho, alpha, omega, iters, active, conv = state
        return (j < maxiter) & jnp.any(active)

    def body(state):
        j, x, r, pvec, v, rho_old, alpha, omega, iters, active, conv = state
        rho = _dot_hot(rt, r)
        breakdown = rho == 0
        beta = (rho / jnp.where(rho_old != 0, rho_old, 1.0)) * (alpha / jnp.where(omega != 0, omega, 1.0))
        p_new = r + _bc(beta, r) * (pvec - _bc(omega, v) * v)
        phat = P(p_new)
        v_new = apply_A(phat)
        rtv = _dot_hot(rt, v_new)
        alpha_new = rho / jnp.where(rtv != 0, rtv, 1.0)
        s = r - _bc(alpha_new, r) * v_new
        eps_s = _norm_hot(s) / safe_normb
        early = eps_s < tol
        shat = P(s)
        t = apply_A(shat)
        tt = _dot_hot(t, t)
        omega_new = _dot_hot(t, s) / jnp.where(tt != 0, tt, 1.0)
        x_full = x + _bc(alpha_new, x) * phat + _bc(omega_new, x) * shat
        x_early = x + _bc(alpha_new, x) * phat
        r_new = s - _bc(omega_new, r) * t
        eps = _norm_hot(r_new) / safe_normb
        done = early | (eps < tol) | breakdown | (omega_new == 0)

        m = _bc(active, x)
        x = jnp.where(m, jnp.where(_bc(early, x), x_early, x_full), x)
        r = jnp.where(m, r_new, r)
        pvec = jnp.where(m, p_new, pvec)
        v = jnp.where(m, v_new, v)
        rho_old = jnp.where(active, rho, rho_old)
        alpha = jnp.where(active, alpha_new, alpha)
        omega = jnp.where(active, omega_new, omega)
        iters = iters + active.astype(iters.dtype)
        conv = conv | (active & (early | (eps < tol)))
        active = active & ~done
        return (j + 1, x, r, pvec, v, rho_old, alpha, omega, iters, active, conv)

    eps0 = _norm(r0) / safe_normb
    state0 = (
        jnp.asarray(0), x0, r0, jnp.zeros_like(b), jnp.zeros_like(b),
        zero + 1.0, zero, zero + 1.0,
        jnp.zeros(batch_shape, dtype=jnp.int32), eps0 >= tol, eps0 < tol,
    )
    _, x, _, _, _, _, _, _, iters, _, conv = lax.while_loop(cond, body, state0)
    return CGResult(x=x, iters=iters, converged=conv)


# ---------------------------------------------------------------------------
# restarted GMRES (IterativeSolvers.jl:427-550)
# ---------------------------------------------------------------------------

def gmres(
    apply_A: Callable,
    b,
    x0=None,
    *,
    apply_P: Callable | None = None,
    tol: float = 1e-5,
    maxiter: int = 1000,
    restart: int = 20,
    side: str = "right",
):
    """Preconditioned restarted GMRES with Givens rotations, batched over
    arbitrary leading axes of ``b`` like :func:`cg`.

    All batch elements run one shared restart-cycle loop: the Krylov basis
    carries the batch axes (``V`` is [m+1, ..., N, Lτ]) and the Hessenberg /
    rotation state is per-batch ([..., m+1, m] etc.), so nᵥ estimator
    systems build their Arnoldi bases together as stacked matvecs instead of
    nᵥ sequential solves (IterativeSolvers.jl:427-550 is one-at-a-time).
    Converged elements stop counting iterations and stop applying updates at
    restart boundaries; the loop exits when every element has converged.

    ``side`` selects right (default) or left preconditioning. The reference
    left-preconditions (IterativeSolvers.jl:478), which makes the Givens
    residual estimate track ‖P(b−Ax)‖ — the iteration then stops up to
    κ(P) short of the TRUE residual target, and at f32 tolerances the
    residual-verified wrapper rejects the solve and falls back to the slow
    unpreconditioned retry. Right preconditioning solves (A·P)u = b with
    x = P·u, whose estimate IS the true residual; conversion costs one
    extra ``apply_P`` per restart cycle.
    """
    b = jnp.asarray(b)
    if x0 is None:
        x0 = jnp.zeros_like(b)
    P = apply_P if apply_P is not None else (lambda v: v)
    right = apply_P is not None and side == "right"
    n_outer = max(1, -(-maxiter // restart))
    m = restart
    batch = b.shape[:-2]
    dt = b.dtype

    pb = b if right else P(b)
    normb = _norm(pb).astype(dt)
    normb = jnp.where(normb > 0, normb, 1.0)

    def arnoldi_iter(carry, i):
        V, H, cs, sn, s, done, iters = carry
        # freeze converged batch elements: once done, their Krylov state
        # must stop growing — post-convergence Arnoldi columns are noise at
        # the working precision's floor, and letting them into the
        # back-substitution corrupts y through near-singular trailing
        # Hessenberg diagonals (invisible at f64, ~1e-3 errors at f32)
        frozen = done
        w = apply_A(P(V[i])) if right else P(apply_A(V[i]))
        # modified Gram-Schmidt against all columns, masked to k <= i
        def mgs(carry_w, k):
            w = carry_w
            hk = jnp.where(k <= i, _dot_hot(V[k], w).astype(dt), 0.0)
            w = w - _bc(hk, w) * V[k]
            return w, hk
        w, hcol = lax.scan(mgs, w, jnp.arange(m + 1))   # hcol: [m+1, ...]
        hip = _norm_hot(w).astype(dt)
        safe_hip = jnp.where(hip > 0, hip, 1.0)
        v_new = jnp.where(_bc(hip > 0, w), w / _bc(safe_hip, w), w)
        V = V.at[i + 1].set(jnp.where(_bc(frozen, w), 0.0, v_new))
        col = jnp.moveaxis(hcol, 0, -1).at[..., i + 1].set(hip)  # [..., m+1]
        # apply previous Givens rotations to the new column
        def rot(carry_col, k):
            col = carry_col
            hk = col[..., k]
            hk1 = col[..., k + 1]
            new_k = jnp.where(k < i, cs[..., k] * hk + sn[..., k] * hk1, hk)
            new_k1 = jnp.where(k < i, -sn[..., k] * hk + cs[..., k] * hk1, hk1)
            col = col.at[..., k].set(new_k).at[..., k + 1].set(new_k1)
            return col, None
        col, _ = lax.scan(rot, col, jnp.arange(m))
        # new rotation
        denom = jnp.sqrt(col[..., i] ** 2 + col[..., i + 1] ** 2)
        safe_d = jnp.where(denom > 0, denom, 1.0)
        ci = jnp.where(denom > 0, col[..., i] / safe_d, 1.0)
        si = jnp.where(denom > 0, col[..., i + 1] / safe_d, 0.0)
        col = col.at[..., i].set(ci * col[..., i] + si * col[..., i + 1]) \
                 .at[..., i + 1].set(0.0)
        cs = cs.at[..., i].set(jnp.where(frozen, cs[..., i], ci))
        sn = sn.at[..., i].set(jnp.where(frozen, sn[..., i], si))
        s_i = s[..., i]
        s_new = s.at[..., i].set(ci * s_i).at[..., i + 1].set(-si * s_i)
        s = jnp.where(frozen[..., None], s, s_new)
        H = H.at[..., :, i].set(jnp.where(frozen[..., None], 0.0, col))
        eps = jnp.abs(s[..., i + 1]) / normb
        iters = iters + (~done).astype(iters.dtype)
        done = done | (eps < tol)
        return (V, H, cs, sn, s, done, iters), None

    def outer(carry):
        k, x, iters, done_all = carry
        r = (b - apply_A(x)) if right else P(b - apply_A(x))
        beta = _norm_hot(r).astype(dt)
        safe_b = jnp.where(beta > 0, beta, 1.0)
        V = jnp.zeros((m + 1,) + b.shape, dtype=dt).at[0].set(r / _bc(safe_b, r))
        H = jnp.zeros(batch + (m + 1, m), dtype=dt)
        cs = jnp.zeros(batch + (m,), dtype=dt)
        sn = jnp.zeros(batch + (m,), dtype=dt)
        s = jnp.zeros(batch + (m + 1,), dtype=dt).at[..., 0].set(beta)
        done0 = done_all | (beta / normb < tol)
        (V, H, cs, sn, s, done, iters), _ = lax.scan(
            arnoldi_iter, (V, H, cs, sn, s, done0, iters), jnp.arange(m)
        )
        # back-substitution y = H[:m,:m]^-1 s[:m] (upper triangular, batched)
        def back(carry_y, idx):
            y = carry_y
            k = m - 1 - idx
            hkk = H[..., k, k]
            val = (s[..., k] - jnp.sum(H[..., k, :] * y, axis=-1)) \
                / jnp.where(hkk != 0, hkk, 1.0)
            # zero diagonal = frozen/unreached column: keep it out of dx
            y = y.at[..., k].set(jnp.where(hkk != 0, val, 0.0))
            return y, None
        y, _ = lax.scan(back, jnp.zeros(batch + (m,), dtype=dt), jnp.arange(m))
        # dx = Σₖ y[..., k] · V[k] with batch axes (right mode: map the
        # u-space correction through P — P is linear, one apply suffices)
        dx = jnp.sum(jnp.moveaxis(V[:m], 0, -1)
                     * y[..., None, None, :].astype(dt), axis=-1)
        if right:
            dx = P(dx)
        x = jnp.where(_bc(done_all, x), x, x + dx)
        return (k + 1, x, iters, done)

    # while_loop: restart cycles stop once every batch element converged
    # instead of always executing all n_outer of them
    _, x, iters, _ = lax.while_loop(
        lambda c: (c[0] < n_outer) & ~jnp.all(c[3]),
        outer, (jnp.asarray(0), x0, jnp.zeros(batch, jnp.int32),
                jnp.zeros(batch, bool))
    )
    normb_true = _norm(b)
    err = _norm(apply_A(x) - b) / jnp.where(normb_true > 0, normb_true, 1.0)
    return CGResult(x=x, iters=iters, converged=err < jnp.sqrt(tol))
