"""KPM (Chebyshev) preconditioner for the fermion-matrix solves.

Reference: KPMPreconditioners.jl. In the Θ-twisted frequency basis the
fermion matrix is block diagonal, M[ω,ω] = I − e^{−iφ(ω)}·Ā with
φ(ω) = 2π(ω+1/2)/Lτ and Ā the *time-averaged* single-slice propagator
Ā = exp(−Δτ·K̄)·exp(−Δτ·V̄) (KPMPreconditioners.jl:332-381,944-951). The
preconditioner approximates M⁻¹[ω,ω] by a Chebyshev expansion of
f(z) = (1 − e^{−iφ}z)⁻¹ over the (estimated) spectral interval of Ā.

Restructuring vs the reference:

* the reference loops frequencies serially, each its own N-dim recurrence
  (KPMPreconditioners.jl:449-467); here ALL ⌈Lτ/2⌉ frequencies form the
  columns of one [N, Lω] block and the recurrence runs batched — each step is
  a single-slice checkerboard application on the whole block;
* the data-dependent per-ω expansion orders (:301-307) are kept jit-static by
  computing coefficients at a static ``max_order`` and zero-masking each ω
  beyond its dynamic order (a zero Chebyshev coefficient is a no-op);
* coefficients come from a Gauss-Chebyshev quadrature matmul at a static node
  count (2·max_order) instead of a resized FFTW DCT (:789-839) — same
  integrals, as one matmul;
* spectral bounds use on-device power iteration on Ā and Ā⁻¹ in place of
  host Arnoldi + dense eigvals (:845-942); the ``buf`` inflation (:283-284)
  absorbs the estimate error, and the same validity window (:280) gates
  self-deactivation.

Setup cost amortization (the reference's buffered setup-skip,
KPMPreconditioners.jl:288-308): the *full* setup — 2×``n_power``
power-iteration matvecs for the spectral bounds plus the coefficient
quadrature — runs once per sampler update at the trajectory start;
every solve inside the trajectory only *refreshes* the averaged operator
Ā (cheap τ-means) via :func:`refresh` and reuses the frozen
bounds/coefficients. The ``buf`` inflation of the bounds absorbs the
operator drift along a trajectory exactly as it absorbs the power-iteration
estimate error; a drifted-out-of-window spectrum only degrades CG iteration
counts, never correctness (the preconditioner is used strictly as P⁻¹ inside
a residual-checked solve).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from elphdynamics_tpu.models.adapter import ModelOps
from elphdynamics_tpu.ops import checkerboard as ckb
from elphdynamics_tpu.ops.timefreqfft import omega_to_tau, tau_to_omega


@dataclass(frozen=True)
class KPMConfig:
    n_power: int = 20        # power-iteration steps for the spectral bounds
    buf: float = 0.05        # spectral buffer (KPMPreconditioners.jl:283-284)
    c1: float = 1.0          # order = (λhi−λlo)·(c1/φ + c2) (:301)
    c2: float = 1.0
    max_order: int = 64      # static cap on the expansion order
    # flattened Chebyshev: precompute the dense T_m(Ā′) stack per
    # setup/refresh so each preconditioner application is TWO large stacked
    # matmuls instead of a 2·max_order-deep recurrence of small ones — same
    # FLOPs, 1/max_order the sequential depth (a latency optimisation
    # with no reference counterpart; requires the dense Ā fast path)
    stacked: bool = False
    # replace the τ↔ω FFT pair inside the preconditioner apply with
    # precomputed [Lτ, 2Lω] real DFT matmuls (half spectrum + conjugate
    # symmetry folded into the tables) — a small non-power-of-2 FFT is
    # several launches each way, the matmul one fused op (the speed-up is
    # not measured on H100). None = auto: on while the O(Lτ²) table stays
    # cheap, off for very long τ axes.
    dft_matmul: bool | None = None
    # exact-low-frequency hybrid (beyond-reference): solve the k lowest
    # Matsubara blocks (I − e^{−iφ}Ā)⁻¹ EXACTLY by dense LU once per setup
    # and Chebyshev only the rest. The polynomial degree the expansion
    # needs diverges as 1/φ (KPMPreconditioners.jl:301); the exact blocks
    # remove exactly those frequencies, which pays when that degree is the
    # binding constraint (mild / weakly-τ-varying fields at long Lτ —
    # tests/test_kpm.py). On equilibrated strong-coupling deep-β ensembles
    # it does NOT pay: there the τ-averaged block-diagonal approximation
    # itself breaks down (solving ALL blocks exactly still leaves ~same CG
    # iterations — measured in BASELINE.md); deflation attacks that regime
    # instead. Requires the dense Ā path; complex solves run via the real
    # [[R,−I],[I,R]] embedding (one real LU instead of a complex one).
    exact_lowfreq: int = 0

    def use_dft(self, Ltau: int) -> bool:
        if self.dft_matmul is None:
            return Ltau <= 256
        return self.dft_matmul

    def __hash__(self):
        return hash((self.n_power, self.buf, self.c1, self.c2, self.max_order,
                     self.stacked, self.dft_matmul, self.exact_lowfreq))


class KPMState(NamedTuple):
    """Per-configuration preconditioner state (pytree of device arrays)."""

    expnV_bar: jnp.ndarray   # [N] time-averaged exp(−Δτ·V̄)
    cosh_bar: jnp.ndarray    # [Nbonds] time-averaged checkerboard coefficients
    sinh_bar: jnp.ndarray
    lam_avg: jnp.ndarray     # (λhi+λlo)/2
    lam_mag: jnp.ndarray     # (λhi−λlo)/2
    coeff: jnp.ndarray       # [max_order, Lω] complex Chebyshev coefficients
    active: jnp.ndarray      # scalar bool
    # dense exp(−Δτ·K̄) fast path (Holstein: the averaged hopping matrix is
    # the model's constant expK — one matmul per Chebyshev step)
    expK: jnp.ndarray | None = None
    expK_inv: jnp.ndarray | None = None
    # flattened-Chebyshev stacks (KPMConfig.stacked): [M·N, N] T_m(Ā′)
    # blocks, forward and per-block-transposed
    S_fwd: jnp.ndarray | None = None
    S_tr: jnp.ndarray | None = None
    # exact low-frequency blocks (KPMConfig.exact_lowfreq): real/imag parts
    # of G_j = (I − e^{−iφ_j}Ā)⁻¹ for the k lowest frequencies, [k, N, N]
    G_re: jnp.ndarray | None = None
    G_im: jnp.ndarray | None = None


def _avg_operator(ops: ModelOps, params, derived):
    """Time-averaged Ā pieces (KPMPreconditioners.jl:332-381)."""
    if ops.is_holstein:
        env = derived                      # [.., N, Lτ]
        expnV_bar = jnp.mean(env, axis=-1)
        cosh_bar = params.cosht
        sinh_bar = params.sinht
    else:
        cosh_b, sinh_b = derived           # [Nbonds, Lτ]
        cosh_bar = jnp.mean(cosh_b, axis=-1)
        sinh_bar = jnp.mean(sinh_b, axis=-1)
        expnV_bar = jnp.exp(ops.spec.dtau * params.mu)  # exp(+Δτμ) (SSH convention)
    return expnV_bar, cosh_bar, sinh_bar


# densify the averaged hopping exponential up to this many sites: ~50
# Chebyshev steps per solve then run as single matmuls instead of ngroups
# gather+FMA fold passes; above it the Ā recurrence runs on the group fold.
# The crossover is not measured on H100.
_DENSE_ABAR_MAX_SITES = 4096


def _dense_abar_gate(nsites: int) -> bool:
    """Densify Ā up to _DENSE_ABAR_MAX_SITES sites; fold above."""
    return nsites <= _DENSE_ABAR_MAX_SITES


def _dense_avg(ops: ModelOps, cosh_bar, sinh_bar):
    """On-device densification of exp(−Δτ·K̄): fold the identity through the
    checkerboard groups ONCE per setup/refresh, so every Chebyshev step is a
    single matmul. Used when the model has no constant ``params.expK``
    (SSH's time-dependent hopping; Holstein above its dense gate)."""
    sc = ops.spec.ckb
    eye = jnp.eye(ops.Nsites, dtype=jnp.asarray(cosh_bar).dtype)
    expK = ckb.ckb_mul(sc, cosh_bar, sinh_bar, eye)
    expK_inv = ckb.ckb_inverse_mul(sc, cosh_bar, sinh_bar, eye)
    return expK, expK_inv


# The preconditioner only steers CG; its accuracy affects iteration counts,
# never solution correctness (every solve is residual-verified). DEFAULT is
# the backend's fastest f32 product (TF32 on NVIDIA tensor cores, ~3 decimal
# digits) — enough to steer a residual-checked CG; the fermion operator
# itself runs at HIGHEST or the explicit loop_precision algorithm.
_PRECOND_PRECISION = jax.lax.Precision.DEFAULT


def _mulA(st: "KPMState", spec_ckb, v):
    """Ā·v = exp(−Δτ·K̄)·exp(−Δτ·V̄)·v on [..., N, K] single-slice blocks."""
    w = st.expnV_bar[:, None] * v
    if st.expK is not None:
        return jnp.einsum("ij,...jk->...ik", st.expK.astype(v.dtype), w, precision=_PRECOND_PRECISION)
    return ckb.ckb_mul(spec_ckb, st.cosh_bar, st.sinh_bar, w)


def _mulA_T(st: "KPMState", spec_ckb, v):
    """Āᵀ·v (KPMPreconditioners.jl:737-752) — the ADJOINT Āᴴ·v on the
    complex-hopping path (expnV̄ is real, so only the hopping factor needs
    the conjugate; the checkerboard reversed-order fold is already the
    adjoint for complex coefficients, ops/checkerboard.py:_group_coeffs)."""
    if st.expK is not None:
        K = jnp.conj(st.expK) if jnp.iscomplexobj(st.expK) else st.expK
        w = jnp.einsum("ji,...jk->...ik", K.astype(v.dtype), v, precision=_PRECOND_PRECISION)
    else:
        w = ckb.ckb_transpose_mul(spec_ckb, st.cosh_bar, st.sinh_bar, v)
    return st.expnV_bar[:, None] * w


def _mulA_inv(st: "KPMState", spec_ckb, v):
    """Ā⁻¹·v (KPMPreconditioners.jl:406-420)."""
    if st.expK_inv is not None:
        w = jnp.einsum("ij,...jk->...ik", st.expK_inv.astype(v.dtype), v, precision=_PRECOND_PRECISION)
    else:
        w = ckb.ckb_inverse_mul(spec_ckb, st.cosh_bar, st.sinh_bar, v)
    return w / st.expnV_bar[:, None]


def _build_stack(st: "KPMState", M: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Dense T_m(Ā′) stack for the flattened apply: Ā = expK·diag(expnV̄),
    Ā′ = (Ā − λavg)/λmag, T₀ = I, T₁ = Ā′, T_{m+1} = 2Ā′T_m − T_{m−1}.
    Returns ([M·N, N] forward, [M·N, N] per-block-transposed)."""
    N = st.expK.shape[-1]
    A = st.expK * st.expnV_bar[None, :]
    eye = jnp.eye(N, dtype=A.dtype)
    Ap = A / st.lam_mag - (st.lam_avg / st.lam_mag) * eye
    Ts = [eye, Ap]
    for _ in range(M - 2):
        Ts.append(2.0 * jnp.matmul(Ap, Ts[-1],
                                   precision=_PRECOND_PRECISION) - Ts[-2])
    S = jnp.stack(Ts[:M])                                     # [M, N, N]
    return S.reshape(M * N, N), S.transpose(0, 2, 1).reshape(M * N, N)


def _stacked_cheb(S2, coeff, u):
    """Σₘ c_m(ω)·(S2 block m)·u(ω) via ONE stacked real matmul + a complex
    coefficient combine; equals the recurrence of :func:`_chebyshev_apply`
    (S2 already holds T_m or T_mᵀ)."""
    Lw = u.shape[-1]
    N = S2.shape[-1]
    M = S2.shape[0] // N
    ur = jnp.concatenate([jnp.real(u), jnp.imag(u)], axis=-1)  # [.., N, 2Lω]
    t = jnp.einsum("ij,...jw->...iw", S2.astype(ur.dtype), ur,
                   precision=_PRECOND_PRECISION)
    t = t.reshape(t.shape[:-2] + (M, N, 2 * Lw))
    tr, ti = t[..., :Lw], t[..., Lw:]
    cr = jnp.real(coeff)[:, None, :]                           # [M, 1, Lω]
    ci = jnp.imag(coeff)[:, None, :]
    yr = jnp.sum(cr * tr - ci * ti, axis=-3)
    yi = jnp.sum(cr * ti + ci * tr, axis=-3)
    return jax.lax.complex(yr, yi)


def _dft_tables(Ltau: int) -> tuple[np.ndarray, np.ndarray]:
    """Real [Lτ, 2Lω] / [2Lω, Lτ] DFT tables reproducing exactly the
    τ→ω-half-spectrum map and its conjugate-symmetric inverse used by the
    preconditioner applies (KPMConfig.dft_matmul). Built by pushing basis
    vectors through the reference transforms — definitionally consistent."""
    from elphdynamics_tpu.ops.timefreqfft import theta

    Lw = (Ltau + 1) // 2
    th = theta(Ltau)
    T = np.fft.fft(th * np.eye(Ltau), axis=-1)            # [Lτ in, Lτ out]
    Wf = np.concatenate([T[:, :Lw].real, T[:, :Lw].imag], axis=1)
    Wb = np.zeros((2 * Lw, Ltau))
    for k in range(2 * Lw):
        u = np.zeros(Lw, dtype=complex)
        if k < Lw:
            u[k] = 1.0
        else:
            u[k - Lw] = 1j
        full = np.concatenate([u, np.conj(u[::-1])[(2 * Lw - Ltau):]])
        Wb[k] = np.real(np.conj(th) * np.fft.ifft(full))
    return Wf, Wb


def _to_half_spectrum(v, Ltau: int, use_dft: bool):
    """[.., N, Lτ] real → [.., N, Lω] complex (τ→ω, lower half)."""
    Lw = (Ltau + 1) // 2
    if use_dft:
        Wf, _ = _dft_tables(Ltau)
        uri = jnp.einsum("tk,...nt->...nk", jnp.asarray(Wf, v.dtype), v,
                         precision=_PRECOND_PRECISION)
        return jax.lax.complex(uri[..., :Lw], uri[..., Lw:])
    return tau_to_omega(v)[..., :Lw]


def _from_half_spectrum(u, Ltau: int, dtype, use_dft: bool):
    """[.., N, Lω] complex → [.., N, Lτ] real (conjugate-symmetric ω→τ)."""
    Lw = (Ltau + 1) // 2
    if use_dft:
        _, Wb = _dft_tables(Ltau)
        uri = jnp.concatenate([jnp.real(u), jnp.imag(u)], axis=-1)
        return jnp.einsum("kt,...nk->...nt", jnp.asarray(Wb, dtype), uri,
                          precision=_PRECOND_PRECISION).astype(dtype)
    full = jnp.concatenate(
        [u, jnp.flip(jnp.conj(u), axis=-1)[..., (2 * Lw - Ltau):]], axis=-1)
    return omega_to_tau(full, real=True).astype(dtype)


def _to_half_stacked(v, Ltau: int, use_dft: bool):
    """[.., N, Lτ] real → stacked-real [.., N, 2Lω] (Lω real columns then
    Lω imaginary) — the layout the DFT-matmul transforms produce natively
    and the stacked Chebyshev recurrence consumes."""
    Lw = (Ltau + 1) // 2
    if use_dft:
        Wf, _ = _dft_tables(Ltau)
        return jnp.einsum("tk,...nt->...nk", jnp.asarray(Wf, v.dtype), v,
                          precision=_PRECOND_PRECISION)
    u_c = tau_to_omega(v)[..., :Lw]
    return jnp.concatenate([jnp.real(u_c), jnp.imag(u_c)], axis=-1)


def _from_half_stacked(w, Ltau: int, dtype, use_dft: bool):
    """Stacked-real [.., N, 2Lω] → [.., N, Lτ] real."""
    Lw = (Ltau + 1) // 2
    if use_dft:
        _, Wb = _dft_tables(Ltau)
        return jnp.einsum("kt,...nk->...nt", jnp.asarray(Wb, dtype), w,
                          precision=_PRECOND_PRECISION).astype(dtype)
    u = jax.lax.complex(w[..., :Lw], w[..., Lw:])
    full = jnp.concatenate(
        [u, jnp.flip(jnp.conj(u), axis=-1)[..., (2 * Lw - Ltau):]], axis=-1)
    return omega_to_tau(full, real=True).astype(dtype)


def _stacked_to_complex(w):
    Lw = w.shape[-1] // 2
    return jax.lax.complex(w[..., :Lw], w[..., Lw:])


def _complex_to_stacked(u):
    return jnp.concatenate([jnp.real(u), jnp.imag(u)], axis=-1)


def _lowfreq_blocks(st: "KPMState", k: int, Ltau: int):
    """Dense G_j = (I − e^{−iφ_j}Ā)⁻¹ for the k lowest Matsubara
    frequencies via one batched real [[R,−I],[I,R]] solve. Built once per
    full setup — the ``buf``-window
    argument that lets the bounds freeze across a trajectory applies to
    these blocks equally."""
    N = st.expK.shape[-1]
    A = st.expK * st.expnV_bar[None, :]
    dtype = A.dtype
    eye = jnp.eye(N, dtype=dtype)
    phis = jnp.asarray(2.0 * np.pi / Ltau * (np.arange(k) + 0.5), dtype)
    R = eye[None] - jnp.cos(phis)[:, None, None] * A[None]      # [k, N, N]
    Im = jnp.sin(phis)[:, None, None] * A[None]
    big = jnp.concatenate([
        jnp.concatenate([R, -Im], axis=-1),
        jnp.concatenate([Im, R], axis=-1),
    ], axis=-2)                                                  # [k, 2N, 2N]
    rhs = jnp.concatenate([eye, jnp.zeros_like(eye)], axis=0)    # [2N, N]
    sol = jnp.linalg.solve(big, jnp.broadcast_to(rhs, (k,) + rhs.shape))
    return sol[:, :N, :], sol[:, N:, :]                          # G_re, G_im


def _lowfreq_apply_sym(st: "KPMState", u):
    """Exact G·Gᴴ on the first k frequency columns of the [.., N, Lω]
    block (the symmetric-preconditioner role of the Chebyshev pair)."""
    k = st.G_re.shape[0]
    ul = u[..., :k]
    wr, wi = _lowfreq_apply_sym_halves(st, jnp.real(ul), jnp.imag(ul))
    return jax.lax.complex(wr, wi)


def _lowfreq_apply_sym_halves(st: "KPMState", ur_, ui_):
    """:func:`_lowfreq_apply_sym` on separate real/imaginary column halves
    ([.., N, k] each) — the stacked-real-layout entry point."""
    Gr, Gi = st.G_re.astype(ur_.dtype), st.G_im.astype(ur_.dtype)
    # t = Gᴴ u  (Gᴴ = Grᵀ − iGiᵀ)
    tr = jnp.einsum("kmn,...mk->...nk", Gr, ur_,
                       precision=_PRECOND_PRECISION) \
        + jnp.einsum("kmn,...mk->...nk", Gi, ui_,
                       precision=_PRECOND_PRECISION)
    ti = jnp.einsum("kmn,...mk->...nk", Gr, ui_,
                       precision=_PRECOND_PRECISION) \
        - jnp.einsum("kmn,...mk->...nk", Gi, ur_,
                       precision=_PRECOND_PRECISION)
    # w = G t
    wr = jnp.einsum("knm,...mk->...nk", Gr, tr,
                       precision=_PRECOND_PRECISION) \
        - jnp.einsum("knm,...mk->...nk", Gi, ti,
                       precision=_PRECOND_PRECISION)
    wi = jnp.einsum("knm,...mk->...nk", Gr, ti,
                       precision=_PRECOND_PRECISION) \
        + jnp.einsum("knm,...mk->...nk", Gi, tr,
                       precision=_PRECOND_PRECISION)
    return wr, wi


def _state_is_complex(st: "KPMState") -> bool:
    """Trace-time: is this a complex-hopping (Peierls/twist) state?
    expnV̄ is always real; the hopping factor carries the phases."""
    if st.expK is not None:
        return jnp.iscomplexobj(st.expK)
    return jnp.iscomplexobj(st.sinh_bar)


def _spectral_radius(apply_fn, n_site, n_iter, key, dtype):
    """Power-iteration estimate of the dominant |eigenvalue|."""
    v = jax.random.normal(key, (n_site, 1), dtype=dtype)
    v = v / jnp.linalg.norm(v)

    def body(_, carry):
        v, lam = carry
        w = apply_fn(v)
        nw = jnp.linalg.norm(w)
        safe = jnp.where(nw > 0, nw, 1.0)
        return w / safe, nw

    rdtype = jnp.zeros((), dtype).real.dtype  # norm is real even for complex v
    v, lam = jax.lax.fori_loop(0, n_iter, body, (v, jnp.asarray(1.0, rdtype)))
    return lam


def setup(ops: ModelOps, params, x, cfg: KPMConfig, key) -> KPMState:
    """Build the KPM state for the current phonon configuration
    (the role of ``setup!``, KPMPreconditioners.jl:269-321)."""
    derived = ops.derived(params, x)
    expnV_bar, cosh_bar, sinh_bar = _avg_operator(ops, params, derived)
    sc = ops.spec.ckb
    dtype = expnV_bar.dtype
    dense = ops.is_holstein and getattr(ops.spec, "dense_ckb", False)
    expK = params.expK if dense else None
    expK_inv = params.expK_inv if dense else None
    if expK is None and 0 < sc.nbonds and _dense_abar_gate(ops.Nsites):
        # no constant dense matrix from the model (SSH / fold-mode Holstein):
        # densify the *averaged* hopping exponential on-device
        expK, expK_inv = _dense_avg(ops, cosh_bar, sinh_bar)
    st0 = KPMState(expnV_bar=expnV_bar, cosh_bar=cosh_bar, sinh_bar=sinh_bar,
                   lam_avg=jnp.asarray(1.0, dtype), lam_mag=jnp.asarray(1.0, dtype),
                   coeff=jnp.zeros((1, 1)), active=jnp.asarray(True),
                   expK=expK, expK_inv=expK_inv)
    # complex hopping (Peierls phases / twist): Ā is complex (Hermitian bond
    # blocks times a real positive diagonal — near-real positive spectrum,
    # same interval assumption as the real path); the power iteration must
    # run on complex vectors and the expansion covers the FULL Lτ spectrum
    # (complex fields have no conjugate symmetry to fold onto a half)
    cplx = _state_is_complex(st0)
    pdtype = dtype
    if cplx:
        pdtype = jnp.complex128 if dtype == jnp.float64 else jnp.complex64

    k1, k2 = jax.random.split(key)
    e_max = _spectral_radius(
        lambda v: _mulA(st0, sc, v), ops.Nsites, cfg.n_power, k1, pdtype
    )
    e_min = 1.0 / _spectral_radius(
        lambda v: _mulA_inv(st0, sc, v), ops.Nsites, cfg.n_power, k2, pdtype
    )
    active = (e_min > 0.0) & (e_min < 1.0) & (e_max > 1.0) & ((e_max - e_min) < 2.0)

    lam_lo = jnp.maximum(0.0, (1.0 - 2.0 * cfg.buf) * e_min)
    lam_hi = (1.0 + 2.0 * cfg.buf) * e_max
    lam_avg = (lam_hi + lam_lo) / 2
    lam_mag = (lam_hi - lam_lo) / 2

    # Chebyshev coefficients for every frequency at once. Real fields use the
    # lower half spectrum (conjugate symmetry supplies the rest); complex
    # fields need all Lτ frequencies.
    Ltau = ops.Ltau
    Lw = Ltau if cplx else (Ltau + 1) // 2
    phis = jnp.asarray(2.0 * np.pi / Ltau * (np.arange(Lw) + 0.5), dtype)
    M = cfg.max_order
    NM = 2 * M
    theta_n = (np.arange(NM) + 0.5) * np.pi / NM
    nodes = jnp.asarray(np.cos(theta_n), dtype)              # [NM]
    xs = lam_mag * nodes + lam_avg                           # [NM]
    f = 1.0 / (1.0 - jnp.exp(-1j * phis)[None, :] * xs[:, None])   # [NM, Lw]
    cosmat = jnp.asarray(np.cos(np.outer(np.arange(M), theta_n)), dtype)  # [M, NM]
    scale = jnp.asarray(np.where(np.arange(M) == 0, 1.0, 2.0), dtype)[:, None] / NM
    coeff = scale * jnp.matmul(cosmat, f,                    # [M, Lw]
                               precision=jax.lax.Precision.HIGHEST)

    # zero-mask beyond each ω's dynamic order (:301-307); on the full
    # spectrum the hard frequencies sit at BOTH ends (e^{−iφ} → 1 as φ → 0
    # or 2π), so the order criterion uses the distance to the nearer pole
    phis_eff = jnp.minimum(phis, 2.0 * np.pi - phis) if cplx else phis
    order = jnp.floor((lam_hi - lam_lo) * (cfg.c1 / phis_eff + cfg.c2))
    order = jnp.clip(order, 1, M)
    morder = jnp.arange(M)[:, None] < order[None, :]
    coeff = jnp.where(morder, coeff, 0.0)

    st = KPMState(
        expnV_bar=expnV_bar,
        cosh_bar=cosh_bar,
        sinh_bar=sinh_bar,
        lam_avg=lam_avg,
        lam_mag=lam_mag,
        coeff=coeff,
        active=active,
        expK=expK,
        expK_inv=expK_inv,
    )
    # the stacked-real flattened apply and the [[R,−I],[I,R]] low-frequency
    # LU both assume a REAL Ā — the complex path uses the plain complex
    # recurrence instead (correctness first; the complex einsum already
    # advances real+imag with fused real matmuls)
    if cfg.stacked and expK is not None and not cplx:
        S_fwd, S_tr = _build_stack(st, cfg.max_order)
        st = st._replace(S_fwd=S_fwd, S_tr=S_tr)
    if cfg.exact_lowfreq > 0 and expK is not None and not cplx:
        k = min(cfg.exact_lowfreq, Lw)
        G_re, G_im = _lowfreq_blocks(st, k, Ltau)
        # the exact blocks replace those columns: zero their Chebyshev
        # coefficients so the polynomial part contributes nothing there
        st = st._replace(G_re=G_re, G_im=G_im,
                         coeff=st.coeff.at[:, :k].set(0.0))
    return st


def refresh(ops: ModelOps, st: KPMState, params, x) -> KPMState:
    """Cheap per-solve refresh: recompute the time-averaged operator Ā for
    the current phonon configuration, reuse the spectral bounds and Chebyshev
    coefficients of a previous full :func:`setup` (the reference's
    within-``buf`` skip, KPMPreconditioners.jl:288-308)."""
    derived = ops.derived(params, x)
    expnV_bar, cosh_bar, sinh_bar = _avg_operator(ops, params, derived)
    st = st._replace(expnV_bar=expnV_bar, cosh_bar=cosh_bar, sinh_bar=sinh_bar)
    if not ops.is_holstein and st.expK is not None:
        expK, expK_inv = _dense_avg(ops, cosh_bar, sinh_bar)
        st = st._replace(expK=expK, expK_inv=expK_inv)
    if st.S_fwd is not None:
        M = st.coeff.shape[0]
        S_fwd, S_tr = _build_stack(st, M)
        st = st._replace(S_fwd=S_fwd, S_tr=S_tr)
    return st


def _chebyshev_apply(ops: ModelOps, st: KPMState, u, coeff, transposed: bool):
    """Σₘ c_m(ω)·T_m(Ā′)·u on the [.., N, Lω] frequency block, where
    Ā′ = (Ā − λavg)/λmag (KPMPreconditioners.jl:514-554,685-693)."""
    sc = ops.spec.ckb
    mul = _mulA_T if transposed else _mulA

    def Ap(v):
        av = mul(st, sc, v)
        return av / st.lam_mag - (st.lam_avg / st.lam_mag) * v

    out = coeff[0] * u
    u_nm1 = u
    u_n = Ap(u)

    def body(m, carry):
        out, u_nm1, u_n = carry
        out = out + coeff[m] * u_n
        u_np1 = 2.0 * Ap(u_n) - u_nm1
        return (out, u_n, u_np1)

    M = coeff.shape[0]
    out, _, _ = jax.lax.fori_loop(1, M, body, (out, u_nm1, u_n))
    return out


def _cmul_halves(coeff_m, w):
    """Multiply a stacked-real half-spectrum block ``w`` ([.., N, 2Lω]:
    Lω real columns then Lω imaginary columns) by the complex per-ω
    coefficients ``coeff_m`` ([Lω]) — elementwise, fuses into the
    neighbouring matmuls."""
    Lw = w.shape[-1] // 2
    cr = jnp.real(coeff_m).astype(w.dtype)
    ci = jnp.imag(coeff_m).astype(w.dtype)
    wr, wi = w[..., :Lw], w[..., Lw:]
    return jnp.concatenate([cr * wr - ci * wi, cr * wi + ci * wr], axis=-1)


def _chebyshev_apply_stacked(ops: ModelOps, st: KPMState, w, coeff,
                             transposed: bool):
    """The recurrence of :func:`_chebyshev_apply` on the stacked-real
    layout: Ā′ is real, so one [N,N]@[N,2Lω] matmul advances the real and
    imaginary column halves together instead of the two matmuls the complex
    einsum decomposes into. At large N the Chebyshev matmuls are HBM-bound
    on re-reading Ā (BASELINE.md §profile) — doubling the columns per read
    doubles their arithmetic intensity; only the coefficient combine needs
    the complex structure, and that is elementwise."""
    sc = ops.spec.ckb
    mul = _mulA_T if transposed else _mulA

    def Ap(v):
        av = mul(st, sc, v)
        return av / st.lam_mag - (st.lam_avg / st.lam_mag) * v

    out = _cmul_halves(coeff[0], w)
    u_nm1 = w
    u_n = Ap(w)

    def body(m, carry):
        out, u_nm1, u_n = carry
        out = out + _cmul_halves(coeff[m], u_n)
        u_np1 = 2.0 * Ap(u_n) - u_nm1
        return (out, u_n, u_np1)

    M = coeff.shape[0]
    out, _, _ = jax.lax.fori_loop(1, M, body, (out, u_nm1, u_n))
    return out


def _apply_complex(ops: ModelOps, st: KPMState, v, passes):
    """Complex-hopping preconditioner pipeline: τ→ω on the FULL spectrum
    (complex fields — the CG vectors of the Hermitian-M†M solves — have no
    conjugate symmetry), one complex Chebyshev recurrence per ``pass``
    (coeff, adjoint?) on the [.., N, Lτ] block, ω→τ without the real
    projection. ``st.coeff`` is [max_order, Lτ] here (setup builds the full
    spectrum when the state is complex)."""
    u = tau_to_omega(v)
    for coeff, adjoint in passes:
        u = _chebyshev_apply(ops, st, u, coeff, transposed=adjoint)
    out = omega_to_tau(u, real=False).astype(v.dtype)
    return jnp.where(st.active, out, v)


def apply_symmetric(ops: ModelOps, st: KPMState, v, cfg: KPMConfig | None = None):
    """Apply the symmetric preconditioner P⁻¹ ≈ (MᵀM)⁻¹ to a real [.., N, Lτ]
    field (the CG path, KPMPreconditioners.jl:426-481,606-679):
    τ→ω, per-ω [M⁻ᵀ·M⁻¹] Chebyshev pair on the half spectrum, conjugate
    symmetry for the rest, ω→τ.

    The whole pipeline runs on the stacked-real layout [.., N, 2Lω] (real
    columns then imaginary columns): the DFT-matmul transforms natively
    produce/consume it, and the recurrence then advances both halves with
    one matmul per T_m (see :func:`_chebyshev_apply_stacked`).

    Complex-hopping states route through :func:`_apply_complex` instead:
    P⁻¹ ≈ (M†M)⁻¹ = M⁻¹·M⁻ᴴ — the adjoint polynomial (conj coefficients,
    Āᴴ) then the forward one, per-ω Hermitian-PSD so CG under the real
    embedding (utils/dtypes.fdot) stays SPD-preconditioned."""
    if _state_is_complex(st):
        return _apply_complex(ops, st, v,
                              [(jnp.conj(st.coeff), True), (st.coeff, False)])
    Ltau = ops.Ltau
    use_dft = cfg is not None and cfg.use_dft(Ltau)
    Lw = (Ltau + 1) // 2
    w_in = _to_half_stacked(v, Ltau, use_dft)
    if st.S_fwd is not None:
        u = _stacked_cheb(st.S_tr, jnp.conj(st.coeff), _stacked_to_complex(w_in))
        u = _stacked_cheb(st.S_fwd, st.coeff, u)
        w = _complex_to_stacked(u)
    else:
        w = _chebyshev_apply_stacked(ops, st, w_in, jnp.conj(st.coeff),
                                     transposed=True)
        w = _chebyshev_apply_stacked(ops, st, w, st.coeff, transposed=False)
    if st.G_re is not None:
        # exact G·Gᴴ on the lowest frequencies (their Chebyshev
        # coefficients are zeroed at setup)
        k = st.G_re.shape[0]
        lr, li = _lowfreq_apply_sym_halves(st, w_in[..., :k],
                                           w_in[..., Lw:Lw + k])
        w = jnp.concatenate([lr, w[..., k:Lw], li, w[..., Lw + k:]], axis=-1)
    out = _from_half_stacked(w, Ltau, v.dtype, use_dft)
    return jnp.where(st.active, out, v)


def dense_Abar(ops: ModelOps, st: KPMState) -> np.ndarray:
    """Densify the averaged single-slice operator Ā column by column — the
    debugging hook of the reference (``construct_Bbar``,
    KPMPreconditioners.jl:956-991)."""
    dt = st.expK.dtype if st.expK is not None else st.sinh_bar.dtype
    eye = jnp.eye(ops.Nsites, dtype=dt)
    return np.asarray(_mulA(st, ops.spec.ckb, eye))


class Preconditioner(NamedTuple):
    """Bundle of preconditioner callables handed to the samplers.

    ``setup(params, x)`` runs the full spectral-bounds + coefficient build;
    ``refresh(st, params, x)`` re-derives only the averaged operator from an
    earlier state (buffered setup-skip); the ``symmetric``/``left``/``right``
    applies take ``(st, v)``.
    """

    setup: object
    refresh: object
    symmetric: object
    left: object = None
    right: object = None


def make_symmetric_precond(ops: ModelOps, cfg: KPMConfig, seed: int = 1234):
    """Symmetric-only :class:`Preconditioner` for the CG samplers: full setup
    once per phonon update, cheap refresh + apply inside the CG loops."""
    key = jax.random.PRNGKey(seed)
    return Preconditioner(
        setup=lambda params, x: setup(ops, params, x, cfg, key),
        refresh=lambda st, params, x: refresh(ops, st, params, x),
        symmetric=lambda st, v: apply_symmetric(ops, st, v, cfg),
    )


def make_precond(ops: ModelOps, cfg: KPMConfig, seed: int = 1234):
    """:class:`Preconditioner` covering all three solver modes
    (SymmetricKPMPreconditioner for CG, LeftRightKPMPreconditioner for
    BiCGStab/GMRES; ProcessInputFile.jl:502-506)."""
    key = jax.random.PRNGKey(seed)
    return Preconditioner(
        setup=lambda params, x: setup(ops, params, x, cfg, key),
        refresh=lambda st, params, x: refresh(ops, st, params, x),
        symmetric=lambda st, v: apply_symmetric(ops, st, v, cfg),
        left=lambda st, v: apply_left(ops, st, v, cfg),
        right=lambda st, v: apply_right(ops, st, v, cfg),
    )


def apply_left(ops: ModelOps, st: KPMState, v, cfg: KPMConfig | None = None):
    """P⁻¹ ≈ M⁻¹ (GMRES/BiCGStab preconditioner,
    KPMPreconditioners.jl:514-554). Stacked-real pipeline like
    :func:`apply_symmetric`; complex-hopping states use the full-spectrum
    complex recurrence."""
    if _state_is_complex(st):
        return _apply_complex(ops, st, v, [(st.coeff, False)])
    Ltau = ops.Ltau
    use_dft = cfg is not None and cfg.use_dft(Ltau)
    w = _to_half_stacked(v, Ltau, use_dft)
    if st.S_fwd is not None:
        w = _complex_to_stacked(
            _stacked_cheb(st.S_fwd, st.coeff, _stacked_to_complex(w)))
    else:
        w = _chebyshev_apply_stacked(ops, st, w, st.coeff, transposed=False)
    out = _from_half_stacked(w, Ltau, v.dtype, use_dft)
    return jnp.where(st.active, out, v)


def apply_right(ops: ModelOps, st: KPMState, v, cfg: KPMConfig | None = None):
    """P⁻¹ ≈ M⁻ᵀ (KPMPreconditioners.jl:560-600) — M⁻ᴴ on the
    complex-hopping path (the model's mulMT is M† there)."""
    if _state_is_complex(st):
        return _apply_complex(ops, st, v, [(jnp.conj(st.coeff), True)])
    Ltau = ops.Ltau
    use_dft = cfg is not None and cfg.use_dft(Ltau)
    w = _to_half_stacked(v, Ltau, use_dft)
    if st.S_fwd is not None:
        w = _complex_to_stacked(
            _stacked_cheb(st.S_tr, jnp.conj(st.coeff), _stacked_to_complex(w)))
    else:
        w = _chebyshev_apply_stacked(ops, st, w, jnp.conj(st.coeff),
                                     transposed=True)
    out = _from_half_stacked(w, Ltau, v.dtype, use_dft)
    return jnp.where(st.active, out, v)
