"""Dtype policy + accurate accumulation primitives.

The reference is Float64 throughout (it is a CPU Julia code;
IterativeSolvers.jl's κ-abort exists because MᵀM becomes ill-conditioned).
On accelerators f64 is slow (emulated, or a small fraction of the f32
rate), so the framework keeps fields in f32 and makes the *reductions*
robust instead:

* under ``jax.config.jax_enable_x64`` (CPU parity mode) every dot product,
  norm and action/energy sum accumulates in f64 (:func:`fdot`/:func:`fsum`);
* without x64 (f32 production) the same reductions run with exact
  Veltkamp/Dekker two-products and a separately summed error channel, which
  removes the O(n·ε) product-rounding term and leaves only the O(log n·ε)
  tree-reduction error of XLA's summation.

Used by the CG/BiCGStab dot products and residual checks
(:mod:`elphdynamics_tpu.solvers`) and by the HMC energies ΔH = H₁−H₀ whose
Metropolis test suffers catastrophic cancellation of O(N·Lτ)-sized actions.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def set_x64(enable: bool = True) -> None:
    """Enable/disable 64-bit mode globally (must run before tracing)."""
    jax.config.update("jax_enable_x64", bool(enable))


def default_real_dtype():
    """The widest real dtype currently available (f64 under x64, else f32)."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def accum_dtype():
    """Dtype used for reductions (dot products, norms)."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


# 2^12 + 1: Veltkamp splitting constant for a 24-bit (f32) mantissa.
_SPLIT_F32 = 4097.0


def _two_product_f32(a, b):
    """Exact product a·b = p + err in f32 (Dekker two-product via Veltkamp
    splits; no FMA needed). Valid for |a|,|b| ≲ 8e34."""
    p = a * b
    c = jnp.asarray(_SPLIT_F32, a.dtype)
    ca = c * a
    ah = ca - (ca - a)
    al = a - ah
    cb = c * b
    bh = cb - (cb - b)
    bl = b - bh
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def _two_sum(a, b):
    """Error-free transform a + b = s + err (Knuth two-sum)."""
    s = a + b
    bp = s - a
    err = (a - (s - bp)) + (b - bp)
    return s, err


def _df_reduce(hi, lo, axis):
    """Sum a double-float array (value = hi + lo elementwise, exactly) over
    ``axis`` with double-f32 (Dekker) arithmetic: a static log₂(n) pairwise
    halving tree whose every combine is an error-free two-sum followed by a
    renormalization. The accumulated value carries ~2·24 bits of mantissa —
    f64-quality accumulation out of pure-f32 hardware ops; only the final
    ``hi + lo`` rounds to f32.
    """
    axes = sorted((ax % hi.ndim) for ax in ((axis,) if isinstance(axis, int) else axis))
    perm = [i for i in range(hi.ndim) if i not in axes] + axes
    hi = jnp.transpose(hi, perm)
    lo = jnp.transpose(lo, perm)
    batch = hi.shape[: hi.ndim - len(axes)]
    hi = hi.reshape(batch + (-1,))
    lo = lo.reshape(batch + (-1,))
    n = hi.shape[-1]
    npad = 1 << max(0, (n - 1).bit_length())
    if npad != n:
        pad = [(0, 0)] * (hi.ndim - 1) + [(0, npad - n)]
        hi = jnp.pad(hi, pad)
        lo = jnp.pad(lo, pad)
        n = npad
    while n > 1:
        h = n // 2
        s, err = _two_sum(hi[..., :h], hi[..., h:])
        l = lo[..., :h] + lo[..., h:] + err
        hi = s + l                      # quick renormalize
        lo = l - (hi - s)
        n = h
    return hi[..., 0] + lo[..., 0]


def fsum(a, axis=None):
    """Accurate sum: f64 accumulation when available, else double-f32
    pairwise accumulation (see :func:`_df_reduce`)."""
    if jax.config.jax_enable_x64:
        if a.dtype == jnp.float32:
            return jnp.sum(a.astype(jnp.float64), axis=axis)
        return jnp.sum(a, axis=axis)
    if a.dtype == jnp.float32:
        ax = tuple(range(a.ndim)) if axis is None else axis
        return _df_reduce(a, jnp.zeros_like(a), ax)
    return jnp.sum(a, axis=axis)


def fdot(a, b, axis=(-2, -1)):
    """Accurate batched inner product ``Σ a·b`` over ``axis``.

    f64 accumulation under x64; in pure-f32 mode, exact two-products
    feed a double-f32 pairwise reduction, so the result is accurate to ~1 ulp
    of the true dot — the product-rounding O(n·ε) and summation O(log n·ε)
    error terms are both eliminated.

    Complex inputs (the complex-hopping path, Models.jl:20's
    ``Continuous = Union{AbstractFloat,Complex}``) return the REAL Hermitian
    inner product Re(a†·b) = Re(a)·Re(b) + Im(a)·Im(b) through the same
    accurate real reductions — exactly the inner product under which the
    Hermitian-positive-definite M†M is an SPD operator on ℝ²ⁿ, so the real
    CG/norm machinery applies unchanged.
    """
    if jnp.iscomplexobj(a) or jnp.iscomplexobj(b):
        a = jnp.asarray(a)
        b = jnp.asarray(b)
        return (fdot(jnp.real(a), jnp.real(b), axis)
                + fdot(jnp.imag(a), jnp.imag(b), axis))
    if jax.config.jax_enable_x64:
        if a.dtype == jnp.float32:
            return jnp.sum(a.astype(jnp.float64) * b.astype(jnp.float64), axis=axis)
        return jnp.sum(a * b, axis=axis)
    if a.dtype == jnp.float32:
        p, e = _two_product_f32(a, b)
        return _df_reduce(p, e, axis)
    return jnp.sum(a * b, axis=axis)


def fdot_fast(a, b, axis=(-2, -1)):
    """Hot-loop inner product: f64 accumulation when available, hardware f32
    otherwise.

    Used INSIDE the iterative-solver loop bodies, where per-iteration dots are
    latency-critical and self-correcting (CG re-derives its residual every
    iteration and every solve ends in a compensated residual verification —
    solvers.solve_checked). The ~log(n)·ε f32 summation error (≈1e-6 relative
    at the stock problem sizes) is far below the 1e-5 solve tolerance;
    quantities that genuinely cancel (ΔH, residual checks, action sums) use
    the full :func:`fdot` instead.
    """
    if jnp.iscomplexobj(a) or jnp.iscomplexobj(b):
        a = jnp.asarray(a)
        b = jnp.asarray(b)
        return (fdot_fast(jnp.real(a), jnp.real(b), axis)
                + fdot_fast(jnp.imag(a), jnp.imag(b), axis))
    if jax.config.jax_enable_x64 and a.dtype == jnp.float32:
        return jnp.sum(a.astype(jnp.float64) * b.astype(jnp.float64), axis=axis)
    return jnp.sum(a * b, axis=axis)


def params_are_complex(params) -> bool:
    """True when any model-parameter leaf is complex — the complex-hopping
    (Peierls-phase / twisted-BC) path, Models.jl:20's ``Continuous =
    Union{AbstractFloat,Complex}`` surface. Trace-time only (dtypes are
    static under jit)."""
    return any(jnp.iscomplexobj(leaf)
               for leaf in jax.tree_util.tree_leaves(params))


def pseudofermion_noise(key, params, shape, dtype):
    """Spin-stacked pseudofermion Gaussians for the φ (and exact-S₀) refresh.

    Real hopping: ``[2, *shape]`` independent unit normals — one real field
    per spin (HMC.jl:666-692). Complex hopping: the SAME two fields packed as
    ONE complex stack entry ``[1, *shape] = R↑ + i·R↓``. Under the real
    ℝ²ⁿ-embedding this is *exactly* the two-spin real algorithm: the complex
    φ = M†(R↑+iR↓) carries cov emb(M†M), its Gaussian weight normalization is
    |det M|² = det M(θ)·det M(−θ) — the sign-problem-free time-reversal-
    symmetric twist ensemble (spin-↓ sees the conjugate Peierls phases), and
    Re(φ†z)/2 (utils.dtypes.fdot) reduces to the two real per-spin actions at
    θ = 0.
    """
    R = jax.random.normal(key, (2,) + tuple(shape), dtype=dtype)
    if params_are_complex(params):
        return (R[0] + 1j * R[1])[None]
    return R


def trace_noise(key, params, shape, dtype):
    """Gaussian probe for stochastic trace/force estimators
    (LangevinDynamics.jl:334-345).

    Real: unit normals with E[ggᵀ] = I. Complex hopping: circular complex
    normals with E[gg†] = I, so −2·Re[g†·∂M·M⁻¹g] estimates the TRS-ensemble
    force −2·Re Tr[M⁻¹∂M] (= d/dx of −ln|det M|²)."""
    if params_are_complex(params):
        g = jax.random.normal(key, (2,) + tuple(shape), dtype=dtype)
        half = jnp.asarray(0.5, dtype) ** 0.5
        return (g[0] + 1j * g[1]) * half
    return jax.random.normal(key, tuple(shape), dtype=dtype)
