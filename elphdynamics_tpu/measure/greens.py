"""Stochastic Green's-function estimation.

Reference: GreensFunctions.jl. Per measurement step, nᵥ Gaussian vectors R
and their solutions M⁻¹R estimate the single-particle Green's function; all
pairwise combinations (i, j) of vectors build translation-averaged two-point
and four-point tensors via space-time FFT convolution with antiperiodic
doubling of the τ axis (GreensFunctions.jl:239-288,351-439).

Restructuring vs the reference:

* the nᵥ linear systems are solved as ONE batched CG (the reference does nᵥ
  serial solves, GreensFunctions.jl:209-231);
* the C(nᵥ,2) pair convolutions are batched over a pair axis and only their
  *pair sums* are materialised (every downstream measurement is linear in the
  per-pair tensors, Measurements.jl:545-566);
* the two-point GΔ0 sum uses the bilinearity identity
  Σ_{i<j} conv(aᵢ+aⱼ, bᵢ+bⱼ)/2 = [(nᵥ−2)·Σᵢconv(aᵢ,bᵢ) + conv(Σa, Σb)]/2,
  reducing nᵥ(nᵥ−1)/2 convolutions to nᵥ+1.

Layouts: M-space fields are [nᵥ, N, Lτ]; cell layout is
[nₒ, L1, L2, L3, Lτ·(2)] with the FFT axes innermost. Tensor index
convention matches the reference accessors (GreensFunctions.jl:293-329):
``G[o₂, o₁, l1, l2, l3, τ]`` is ⟨T c_{i+r,o₂}(τ) c⁺_{i,o₁}(0)⟩-type averages.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from elphdynamics_tpu.dynamics.solve import SolverConfig, resolve_precond, solve_minv
from elphdynamics_tpu.models.adapter import ModelOps


class GreensData(NamedTuple):
    R: jnp.ndarray       # [nv, N, Ltau]
    MinvR: jnp.ndarray   # [nv, N, Ltau]
    iters: jnp.ndarray   # scalar (mean per solve)
    flag: jnp.ndarray


def sample_greens(ops: ModelOps, params, x, key, nv: int,
                  scfg: SolverConfig, precond=None):
    """Draw nᵥ random vectors and solve MᵀM·z = Mᵀ·r for all of them at once
    (GreensFunctions.jl:201-234).

    Complex hopping: the probes become circular complex normals with
    E[RR†] = I (utils.dtypes.trace_noise), so M⁻¹R ⊙ conj(R) estimates the
    spin-↑ Green's function of the TRS twist ensemble; spin-↓ is its
    conjugate."""
    from elphdynamics_tpu.utils.dtypes import trace_noise
    derived = ops.derived(params, x)
    key, kr = jax.random.split(key)
    R = trace_noise(kr, params, (nv, ops.Nsites, ops.Ltau),
                    jnp.asarray(x).dtype)
    pa = resolve_precond(precond, params, x)
    # the nv systems share this configuration's operator → eligible for the
    # block-CG path ([solver] block = true)
    sol = solve_minv(ops, params, derived, R, scfg, pa, block=True)
    iters = jnp.sum(sol.iters) // nv
    return GreensData(R=R, MinvR=sol.x, iters=iters, flag=jnp.max(sol.flag)), key


# ---------------------------------------------------------------------------
# layout helpers
# ---------------------------------------------------------------------------

def to_cell_layout(lattice, v):
    """[..., N, T] -> [..., nₒ, L1, L2, L3, T].

    Site ordering is orbit-fastest then l1, l2, l3 (Lattices.jl:83-104).
    """
    no = lattice.unit_cell.norbits
    L1, L2, L3 = lattice.L1, lattice.L2, lattice.L3
    lead = v.shape[:-2]
    T = v.shape[-1]
    v = v.reshape(lead + (L3, L2, L1, no, T))
    ndim = v.ndim
    perm = tuple(range(ndim - 5)) + (ndim - 2, ndim - 3, ndim - 4, ndim - 5, ndim - 1)
    return jnp.transpose(v, perm)


def antiperiodic_double(v):
    """τ axis L → 2L with a sign flip (GreensFunctions.jl:406-418)."""
    return jnp.concatenate([v, -v], axis=-1)


def periodic_double(v):
    """τ axis L → 2L by repetition (GreensFunctions.jl:424-439)."""
    return jnp.concatenate([v, v], axis=-1)


def _neg_index(A, axes):
    """A[-k mod L] along the given axes: reverse + roll by one."""
    for ax in axes:
        A = jnp.roll(jnp.flip(A, axis=ax), 1, axis=ax)
    return A


# DFT-matmul lowering of the convolution transforms (the KPM dft_matmul
# trick, ops/kpm.py:_dft_tables, applied to the measurement stage). Off by
# default (jnp.fft); True forces it for tests and A/B benches. The matmuls
# run at HIGHEST precision — these transforms feed physics observables, not a
# preconditioner.
DFT_MATMUL: bool = False


def _dft_mat(n: int, inverse: bool) -> np.ndarray:
    k = np.arange(n)
    F = np.exp((2j if inverse else -2j) * np.pi * np.outer(k, k) / n)
    return (F / n) if inverse else F


def _fft_axis(v, axis: int, inverse: bool):
    n = v.shape[axis]
    if not DFT_MATMUL:
        return (jnp.fft.ifft if inverse else jnp.fft.fft)(v, axis=axis)
    cdtype = jnp.result_type(v.dtype, jnp.complex64)
    F = jnp.asarray(_dft_mat(n, inverse), cdtype)
    v = jnp.moveaxis(v, axis, -1).astype(cdtype)
    out = jnp.einsum("kt,...t->...k", F, v,
                     precision=jax.lax.Precision.HIGHEST)
    return jnp.moveaxis(out, -1, axis)


def _fftn4(v, inverse: bool = False):
    """fftn/ifftn over the trailing 4 axes, per-axis FFT-or-DFT-matmul."""
    for ax in (-4, -3, -2, -1):
        if v.shape[ax] > 1:
            v = _fft_axis(v, ax, inverse)
    return v.astype(jnp.result_type(v.dtype, jnp.complex64))


def convolve(a, b, V):
    """Translation-averaged outer-orbital convolution
    (GreensFunctions.jl:351-400).

    a, b: [..., nₒ, L1, L2, L3, T]. Returns [..., nₒ(a), nₒ(b), L1, L2, L3, T]
    where result[s₂, s₁, Δ] = Σ_i a[s₂, i+Δ]·b[s₁, i] / V.
    """
    A = _fftn4(a)
    B = _fftn4(b)
    Bneg = _neg_index(B, (-4, -3, -2, -1))
    prod = A[..., :, None, :, :, :, :] * Bneg[..., None, :, :, :, :, :] / V
    return _fftn4(prod, inverse=True)


def translational_average(f, g):
    """fg(Δ) = (1/V)·Σᵢ f(i+Δ)·g(i) over all axes of f (Utilities.jl:49-60).

    f, g: [..., L1, L2, L3, T]; average over the trailing 4 axes.
    """
    F = _fftn4(f)
    G = _fftn4(g)
    V = f.shape[-1] * f.shape[-2] * f.shape[-3] * f.shape[-4]
    prod = F * _neg_index(G, (-4, -3, -2, -1)) / V
    return _fftn4(prod, inverse=True)


# ---------------------------------------------------------------------------
# pair tensors
# ---------------------------------------------------------------------------

class PairTensors(NamedTuple):
    """Pair-SUMMED estimator tensors [nₒ, nₒ, L1, L2, L3, 2Lτ] (complex) —
    sums over the C(nᵥ,2) unordered pairs, matching the accumulate-then-
    normalise convention of the reference container (Measurements.jl:590-629).

    On the complex-hopping (TRS twist) path every tensor is the exact
    spin-averaged generalisation of its real meaning, so the downstream
    assembly formulas apply unchanged: G = (G↑+G↓)/2 = Re G↑;
    GG = G↑·G↓ (opposite-spin pairing, real expectation);
    GDD_G00 = Re GΔΔ · Re G00 (the spin-summed direct density product /4);
    G0D_GD0 = Re[GΔ0·G0Δ] (the per-spin exchange, averaged over ↑↑/↓↓).
    GDD_minus = −Im GΔΔ · Im G00 — identically zero for real hopping (None
    there); under TRS it carries the genuinely new Sz–Sz direct term
    (n↑−n↓ = −2i·Im G↑ per configuration)."""

    G: jnp.ndarray          # GΔ0
    GG: jnp.ndarray         # GΔ0·GΔ0
    GDD_G00: jnp.ndarray    # GΔΔ·G00
    G0D_GD0: jnp.ndarray    # GΔ0·G0Δ
    n_pairs: int
    GDD_minus: jnp.ndarray | None = None
    # complex path only: the per-spin (↑) complex Green's tensor, needed by
    # estimators whose contractions fix a spin (BondPairGreens β identities)
    G_up: jnp.ndarray | None = None


def pair_indices(nv: int):
    iu, ju = np.triu_indices(nv, k=1)
    return iu, ju


def pair_tensor_sums(lattice, R, MinvR) -> PairTensors:
    """Build the four pair-summed tensors from [nv, N, Lτ] fields
    (GreensFunctions.jl:239-288, batched over pairs).

    Complex-hopping (TRS twist) path: conj goes on every probe R in a
    same-vector pairing (the estimator is G↑ = E[M⁻¹R ⊙ conj R]); each
    unordered pair assigns vector i to spin ↑ and j to spin ↓ = conj, and
    spin sums reduce to Re — per factor for direct (cross-spin) products,
    of the whole convolution for the same-spin exchange. Real hopping is
    the exact specialization (conj/Re are identities)."""
    nv = R.shape[0]
    Ltau = R.shape[-1]
    no = lattice.unit_cell.norbits
    ncells = lattice.ncells
    V = 2 * Ltau * ncells
    cplx = jnp.iscomplexobj(R)

    Rc = to_cell_layout(lattice, R)          # [nv, no, L1, L2, L3, L]
    Mc = to_cell_layout(lattice, MinvR)
    Rcc = jnp.conj(Rc) if cplx else Rc       # the estimator's probe side

    Ra = antiperiodic_double(Rcc)            # [nv, no, ..., 2L]
    Ma = antiperiodic_double(Mc)

    # --- GΔ0 via the bilinearity identity: (nv−2)/2·Σdiag + conv(Σ,Σ)/2
    diag = convolve(Ma, Ra, V)               # [nv, no, no, ...]
    diag_sum = jnp.sum(diag, axis=0)
    tot = convolve(jnp.sum(Ma, axis=0), jnp.sum(Ra, axis=0), V)
    G = ((nv - 2) * diag_sum + tot) / 2.0
    G_up = None
    if cplx:
        G_up = G                             # per-spin (↑) complex tensor
        G = jnp.real(G)                      # spin average (G↑+G↓)/2

    # --- product tensors, batched over pairs
    iu, ju = pair_indices(nv)
    Mi, Mj = Mc[iu], Mc[ju]
    Ri, Rj = Rcc[iu], Rcc[ju]

    # opposite-spin product G↑Δ0·G↓Δ0: the j-side estimate is conjugated
    # wholesale (M and probe together), expectation |G↑|² — real
    MiMj = periodic_double(Mi * (jnp.conj(Mj) if cplx else Mj))
    RiRj = periodic_double(Ri * (jnp.conj(Rj) if cplx else Rj))
    GG = jnp.sum(convolve(MiMj, RiRj, V), axis=0)

    # diagonal (density) fields D = M⁻¹R ⊙ conj R per vector
    Dj = periodic_double(Mj * Rj)
    Di = periodic_double(Mi * Ri)
    if cplx:
        dd_plus = jnp.sum(convolve(Dj, Di, V), axis=0)           # GΔΔ·G00
        dd_cross = jnp.sum(convolve(Dj, jnp.conj(Di), V), axis=0)  # GΔΔ·conj(G00)
        GDD_G00 = jnp.real(dd_plus + dd_cross) / 2.0   # ReGΔΔ·ReG00
        GDD_minus = jnp.real(dd_plus - dd_cross) / 2.0  # −ImGΔΔ·ImG00
    else:
        GDD_G00 = jnp.sum(convolve(Dj, Di, V), axis=0)
        GDD_minus = None

    # same-spin exchange GΔ0·G0Δ (M pairs with the OTHER vector's probe)
    MiRj = periodic_double(Mi * Rj)
    MjRi = periodic_double(Mj * Ri)
    G0D_GD0 = jnp.sum(convolve(MiRj, MjRi, V), axis=0)
    if cplx:
        G0D_GD0 = jnp.real(G0D_GD0)          # (↑↑ + ↓↓)/2

    return PairTensors(G=G, GG=GG, GDD_G00=GDD_G00, G0D_GD0=G0D_GD0,
                       n_pairs=len(iu), GDD_minus=GDD_minus, G_up=G_up)
