"""Holstein model: fermion matrix M, derivatives, and bosonic action.

Hamiltonian (HolsteinModels.jl:28-33):

    H =  Σ P²/2 + Σ (ω²/2)x² + Σ ω₄x⁴      [phonons]
      +  Σ (λx + λ₂x²)n                     [el-ph coupling]
      +  Σ ωᵢⱼ(xᵢ ± xⱼ)²                    [phonon dispersion]
      -  Σ μn - Σ t(c⁺c + h.c.)             [electrons]

Fermion matrix convention (HolsteinModels.jl:575-589):

    M[τ,τ'] = I δ(τ,τ') - B(τ) δ(τ,τ'+1)   (+B(1) at the (1,Lτ) corner)
    B(τ)    = exp(-Δτ·K) · exp(-Δτ·V[x(τ)])
    exp(-Δτ·V)ᵢᵢ(τ) = exp(-Δτ·(λᵢxᵢ(τ) + λ₂ᵢxᵢ(τ)² - μᵢ))

Layout: all space-time fields are ``[..., N, Lτ]`` with τ on the
fast axis; the τ-couplings of M become ``jnp.roll`` along axis -1 plus a
per-τ sign vector (antiperiodic wrap), and exp(-Δτ·K) is the checkerboard
fold from :mod:`elphdynamics_tpu.ops.checkerboard`. Everything is pure: the
reference's cached ``expnΔτV`` (HolsteinModels.jl:526-549) is a derived value
computed inside the jitted step.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from elphdynamics_tpu.lattice import Lattice, sort_neighbor_table
from elphdynamics_tpu.ops.checkerboard import (
    CheckerboardSpec,
    build_checkerboard_spec,
    ckb_mul,
    ckb_transpose_mul,
)


class HolsteinParams(NamedTuple):
    """Dynamic (device) model parameters — a pytree of jnp arrays."""

    mu: jnp.ndarray      # [N] chemical potential
    omega: jnp.ndarray   # [N] phonon frequency
    omega4: jnp.ndarray  # [N] anharmonic X⁴ coefficient
    lam: jnp.ndarray     # [N] linear el-ph coupling λ
    lam2: jnp.ndarray    # [N] quadratic el-ph coupling λ₂
    cosht: jnp.ndarray   # [Nbonds] cosh(Δτ·t), checkerboard order
    sinht: jnp.ndarray   # [Nbonds] sinh(Δτ·t), checkerboard order
    wij: jnp.ndarray     # [Nwij] dispersive phonon coupling ωᵢⱼ (may be empty)
    t: jnp.ndarray = None  # [Nbonds] bare hoppings, original bond order
    # dense checkerboard fast path (see ops/checkerboard.dense_matrix): the
    # time-independent exp(−Δτ·K) as one [N, N] matrix, applied as a matmul
    expK: jnp.ndarray = None
    expK_inv: jnp.ndarray = None


@dataclass(frozen=True)
class HolsteinSpec:
    """Static model description (host side; hashable, safe to close over)."""

    lattice: Lattice
    beta: float
    dtau: float
    Ltau: int
    Nsites: int
    Nph: int
    Nbonds: int
    Ndim: int
    Ndof: int
    ckb: CheckerboardSpec
    # apply exp(−Δτ·K) as a dense [N,N] matmul instead of the group fold
    dense_ckb: bool = False
    # dispersive phonon coupling ωᵢⱼ(xᵢ ± xⱼ)² tables (may be empty)
    wij_table: np.ndarray = field(default_factory=lambda: np.zeros((2, 0), dtype=np.int64))
    wij_sign: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.int64))
    # bond bookkeeping for measurements (original bond order = appended
    # per definition, Models.jl:32-56)
    bond_defs: tuple = ()                    # ((o1, o2, (dL1,dL2,dL3)), ...)
    bond_def_of_bond: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.int64))
    ckb_to_bond: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.int64))
    bond_to_ckb: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.int64))

    def __hash__(self):
        return hash((self.Nsites, self.Ltau, self.Nbonds, round(self.beta, 12),
                     round(self.dtau, 12), self.dense_ckb))

    def __eq__(self, other):
        return (
            isinstance(other, HolsteinSpec)
            and self.Nsites == other.Nsites
            and self.Ltau == other.Ltau
            and self.beta == other.beta
            and self.dtau == other.dtau
            and self.ckb == other.ckb
            and np.array_equal(self.wij_table, other.wij_table)
        )


def build_holstein(
    lattice: Lattice,
    beta: float,
    dtau: float,
    *,
    t_assignments=(),      # iterable of (t, stddev, o1, o2, (dL1,dL2,dL3))
    mu=0.0, mu_std=0.0,
    omega=1.0, omega_std=0.0,
    lam=0.0, lam_std=0.0,
    lam2=0.0, lam2_std=0.0,
    omega4=0.0, omega4_std=0.0,
    wij_assignments=(),    # iterable of (w, stddev, sign, o1, o2, (dL,))
    per_orbit: dict | None = None,
    rng: np.random.Generator | None = None,
    dtype=None,
    # N ≤ dense_threshold: exp(−Δτ·K) as one [N,N] matmul (also the
    # regime where the split loop_precision lever applies); above it, the
    # gather group fold, whose cost grows as N instead of N²
    dense_threshold: int = 2048,
    twist=None,            # (θ1, θ2, θ3) twisted-BC flux angles, radians
) -> tuple[HolsteinSpec, HolsteinParams]:
    """Construct a Holstein model spec + parameter pytree.

    Mirrors the reference's incremental ``assign_*!`` builders with per-site
    Gaussian disorder (HolsteinModels.jl:323-471) and ``initialize_model!``'s
    neighbor-table sort + checkerboard grouping (HolsteinModels.jl:484-517).
    ``per_orbit`` optionally maps parameter names to {orbit: (val, std)}
    overrides for multi-orbital unit cells.

    **Complex hopping** (the reference's ``Continuous =
    Union{AbstractFloat,Complex}`` surface, Models.jl:20): complex ``t``
    values in ``t_assignments`` — or a nonzero ``twist``, which multiplies
    every bond of displacement dL by the uniform-vector-potential Peierls
    phase ``exp(i·Σ_d θ_d·dL_d/L_d)`` (total flux θ_d through cycle d) —
    switch the checkerboard tables to the Hermitian convention
    c = cosh(Δτ|t|), s = (t/|t|)·sinh(Δτ|t|) with conj(s) on the second
    endpoint (Checkerboard.jl:78). Supported surface: operators
    (mulM/mulMT≡M†/mulMTM), dense expK, and the Hermitian-M†M CG solves
    (utils/dtypes.fdot). HMC/Langevin forces and the measurement stack stay
    real-hopping-only (no stock reference example exercises complex t).
    """
    rng = rng or np.random.default_rng(0)
    N = lattice.nsites
    if dtype is None:
        from elphdynamics_tpu.utils.dtypes import default_real_dtype
        dtype = default_real_dtype()
    Ltau = int(round(beta / dtau))

    def _assign(base, std, name):
        vals = base + std * rng.standard_normal(N) if std else np.full(N, float(base))
        if per_orbit and name in per_orbit:
            for orbit, (v, s) in per_orbit[name].items():
                sel = lattice.site_to_orbit == orbit
                vals = np.where(sel, v + (s * rng.standard_normal(N) if s else 0.0), vals)
        return vals

    mu_v = _assign(mu, mu_std, "mu")
    om_v = _assign(omega, omega_std, "omega")
    om4_v = _assign(omega4, omega4_std, "omega4")
    lam_v = _assign(lam, lam_std, "lambda")
    lam2_v = _assign(lam2, lam2_std, "lambda2")

    # hopping bonds (HolsteinModels.jl:418-444)
    if twist is not None and np.any(np.asarray(twist)):
        tw3 = np.zeros(3)
        tw3[: len(tuple(twist))] = twist
        twist = tw3
    else:
        twist = None
    t_dtype = (np.complex128 if twist is not None
               or any(np.iscomplexobj(a[0]) for a in t_assignments)
               else np.float64)
    Ls = np.asarray([lattice.L1, lattice.L2, lattice.L3], np.float64)
    tables = []
    tvals = []
    bond_defs = []
    bond_def_of_bond = []
    for idef, (tval, tstd, o1, o2, dL) in enumerate(t_assignments):
        tb = lattice.calc_neighbor_table(o1, o2, dL)
        nnew = tb.shape[1]
        phase = np.sign(tval) if tval != 0 else 1.0
        tv = phase * (abs(tval) + (tstd * rng.standard_normal(nnew) if tstd else 0.0))
        if twist is not None:
            dL3 = np.zeros(3)
            dL3[: len(dL)] = dL
            tv = tv * np.exp(1j * float(np.sum(twist * dL3 / Ls)))
        tables.append(tb)
        tvals.append(np.broadcast_to(tv, (nnew,)).astype(t_dtype))
        bond_defs.append((o1, o2, tuple(dL)))
        bond_def_of_bond.extend([idef] * nnew)
    if tables:
        table = np.concatenate(tables, axis=1)
        t = np.concatenate(tvals)
    else:
        table = np.zeros((2, 0), dtype=np.int64)
        t = np.zeros(0, dtype=t_dtype)
    table_sorted, perm = sort_neighbor_table(table)
    t_sorted = t[perm]
    ckb = build_checkerboard_spec(N, table_sorted)
    t_ckb = t_sorted[ckb.order]
    ckb_to_bond = perm[ckb.order] if table.shape[1] else np.zeros(0, dtype=np.int64)
    bond_to_ckb = np.argsort(ckb_to_bond) if table.shape[1] else np.zeros(0, dtype=np.int64)

    # dispersive phonon couplings (HolsteinModels.jl:449-471)
    wtabs, wvals, wsigns = [], [], []
    for (wval, wstd, sgn, o1, o2, dL) in wij_assignments:
        tb = lattice.calc_neighbor_table(o1, o2, dL)
        nnew = tb.shape[1]
        wtabs.append(tb)
        wvals.append(wval + (wstd * rng.standard_normal(nnew) if wstd else np.zeros(nnew)))
        wsigns.append(np.full(nnew, int(sgn)))
    if wtabs:
        wij_table = np.concatenate(wtabs, axis=1)
        wij = np.concatenate(wvals)
        wij_sign = np.concatenate(wsigns)
    else:
        wij_table = np.zeros((2, 0), dtype=np.int64)
        wij = np.zeros(0)
        wij_sign = np.zeros(0, dtype=np.int64)

    dense_ckb = 0 < ckb.nbonds and N <= dense_threshold
    spec = HolsteinSpec(
        lattice=lattice,
        beta=float(beta),
        dtau=float(dtau),
        Ltau=Ltau,
        Nsites=N,
        Nph=N,
        Nbonds=ckb.nbonds,
        Ndim=N * Ltau,
        Ndof=N * Ltau,
        ckb=ckb,
        dense_ckb=dense_ckb,
        wij_table=wij_table,
        wij_sign=wij_sign,
        bond_defs=tuple(bond_defs),
        bond_def_of_bond=np.asarray(bond_def_of_bond, dtype=np.int64),
        ckb_to_bond=ckb_to_bond,
        bond_to_ckb=bond_to_ckb,
    )
    cosh_v, sinh_v = _ckb_tables(dtau, t_ckb)
    cdtype = dtype
    if np.iscomplexobj(t):
        cdtype = (jnp.complex64 if jnp.dtype(dtype) == jnp.float32
                  else jnp.complex128)
    params = HolsteinParams(
        mu=jnp.asarray(mu_v, dtype),
        omega=jnp.asarray(om_v, dtype),
        omega4=jnp.asarray(om4_v, dtype),
        lam=jnp.asarray(lam_v, dtype),
        lam2=jnp.asarray(lam2_v, dtype),
        cosht=jnp.asarray(cosh_v, cdtype),
        sinht=jnp.asarray(sinh_v, cdtype),
        wij=jnp.asarray(wij, dtype),
        t=jnp.asarray(t, cdtype),
        expK=(jnp.asarray(_ckb_dense(ckb, dtau, t_ckb), cdtype) if dense_ckb else None),
        expK_inv=(jnp.asarray(_ckb_dense(ckb, dtau, t_ckb, inverse=True), cdtype)
                  if dense_ckb else None),
    )
    return spec, params


def _ckb_tables(dtau, t_ckb):
    """(cosh, sinh) checkerboard coefficient tables. Real t: the reference's
    cosh/sinh(Δτ·t) (HolsteinModels.jl:492-493). Complex t: the Hermitian
    2×2-block convention c = cosh(Δτ|t|), s = (t/|t|)·sinh(Δτ|t|) — reduces
    exactly to the real formulas for real t (the sign rides the phase)."""
    if np.iscomplexobj(t_ckb):
        at = np.abs(t_ckb)
        phase = np.where(at > 0, t_ckb / np.where(at > 0, at, 1.0), 1.0)
        return np.cosh(dtau * at).astype(np.complex128), \
            phase * np.sinh(dtau * at)
    return np.cosh(dtau * t_ckb), np.sinh(dtau * t_ckb)


def _ckb_dense(ckb, dtau, t_ckb, inverse=False):
    from elphdynamics_tpu.ops.checkerboard import dense_matrix

    cosh_v, sinh_v = _ckb_tables(dtau, t_ckb)
    return dense_matrix(ckb, cosh_v, sinh_v, inverse=inverse)


# ---------------------------------------------------------------------------
# derived quantities
# ---------------------------------------------------------------------------

def expnV(spec: HolsteinSpec, p: HolsteinParams, x):
    """exp(-Δτ·V[x])ᵢᵢ(τ) = exp(-Δτ·(λx + λ₂x² - μ)), shape [..., N, Lτ].

    Pure-functional replacement of ``update_model!`` (HolsteinModels.jl:526-549).
    """
    lam = p.lam[:, None]
    lam2 = p.lam2[:, None]
    mu = p.mu[:, None]
    return jnp.exp(-spec.dtau * (lam * x + lam2 * x * x - mu))


def _tau_sign_first(spec: HolsteinSpec, dtype):
    """[+1, -1, ..., -1]: sign vector for the antiperiodic wrap at τ=0."""
    s = -jnp.ones(spec.Ltau, dtype=dtype)
    return s.at[0].set(1.0)


def _tau_sign_last(spec: HolsteinSpec, dtype):
    """[-1, ..., -1, +1]: sign vector for the wrap at τ=Lτ-1 (Mᵀ)."""
    s = -jnp.ones(spec.Ltau, dtype=dtype)
    return s.at[-1].set(1.0)


# ---------------------------------------------------------------------------
# fermion matrix multiplication routines
# ---------------------------------------------------------------------------

# ``[solver] loop_precision`` names → dot algorithms. "high" is a 3-pass
# bf16 product with f32 accumulation (≈ f32 accuracy at a fraction of the
# f32 cost); it is named as an explicit algorithm so that no backend can
# read it as single-pass TF32 (``Precision.HIGH``'s meaning on GPUs).
_PRECISIONS = {
    None: jax.lax.Precision.HIGHEST,
    "highest": jax.lax.Precision.HIGHEST,
    "high": jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3,
    "default": jax.lax.Precision.DEFAULT,
}


def resolve_precision(precision, dtype):
    """The ``precision=`` argument of the operator matmuls for a
    ``loop_precision`` name. The 3-pass bf16 algorithm is defined for f32
    operands only: f64 (x64 parity runs) and complex matrices keep HIGHEST."""
    prec = _PRECISIONS[precision]
    if (isinstance(prec, jax.lax.DotAlgorithmPreset)
            and jnp.dtype(dtype) != jnp.float32):
        return jax.lax.Precision.HIGHEST
    return prec


def apply_expK(spec: HolsteinSpec, p: HolsteinParams, y, precision=None):
    """exp(−Δτ·K)·y over the site axis: one matmul in dense mode, the
    checkerboard group fold otherwise.

    ``precision`` selects the dense matmul's algorithm (None = HIGHEST,
    full f32). The in-CG-loop matvecs may run at "high" (3-pass bf16)
    under the split policy of ``[solver] loop_precision``: every solve
    still ends in a HIGHEST-precision residual verification + retry ladder
    (solvers.solve_checked), and ΔH/forces/endpoint solves stay at
    HIGHEST, so the Metropolis test never sees the cheaper operator's noise.
    """
    if spec.dense_ckb:
        return jnp.einsum("ij,...jt->...it", p.expK, y,
                          precision=resolve_precision(
                              precision, jnp.result_type(p.expK, y)))
    return ckb_mul(spec.ckb, p.cosht, p.sinht, y)


def apply_expK_T(spec: HolsteinSpec, p: HolsteinParams, y, precision=None):
    """exp(−Δτ·K)ᵀ·y — the ADJOINT exp(−Δτ·K)†·y on the complex-hopping
    path (expK is Hermitian there, so the fold's reversed group order
    already is the adjoint; the dense path conjugates explicitly)."""
    if spec.dense_ckb:
        K = jnp.conj(p.expK) if jnp.iscomplexobj(p.expK) else p.expK
        return jnp.einsum("ji,...jt->...it", K, y,
                          precision=resolve_precision(
                              precision, jnp.result_type(K, y)))
    return ckb_transpose_mul(spec.ckb, p.cosht, p.sinht, y)


def mulM(spec: HolsteinSpec, p: HolsteinParams, env, v, precision=None):
    """y = M·v with v of shape [..., N, Lτ] (HolsteinModels.jl:569-626).

    y(τ) = v(τ) - B(τ)·v(τ-1) for τ>0; y(0) = v(0) + B(0)·v(Lτ-1),
    B(τ) = exp(-Δτ·K)·exp(-Δτ·V(τ)). ``env`` is the precomputed expnV.
    """
    v = jnp.asarray(v)
    y = env * jnp.roll(v, 1, axis=-1)
    y = apply_expK(spec, p, y, precision)
    return v + _tau_sign_first(spec, v.dtype) * y


def mulMT(spec: HolsteinSpec, p: HolsteinParams, env, v, precision=None):
    """y = Mᵀ·v (HolsteinModels.jl:631-684).

    y(τ) = v(τ) - Bᵀ(τ+1)·v(τ+1) for τ<Lτ-1; y(Lτ-1) = v(Lτ-1) + Bᵀ(0)·v(0).
    """
    v = jnp.asarray(v)
    z = apply_expK_T(spec, p, v, precision)
    w = env * z
    return v + _tau_sign_last(spec, v.dtype) * jnp.roll(w, -1, axis=-1)


def mulMTM(spec: HolsteinSpec, p: HolsteinParams, env, v, precision=None):
    """y = MᵀM·v (Models.jl:215-224)."""
    return mulMT(spec, p, env, mulM(spec, p, env, v, precision), precision)


def mulMMT(spec: HolsteinSpec, p: HolsteinParams, env, v, precision=None):
    """y = MMᵀ·v (Models.jl:229-238)."""
    return mulM(spec, p, env, mulMT(spec, p, env, v, precision), precision)


def muldMdx(spec: HolsteinSpec, p: HolsteinParams, env, x, u, v):
    """⟨∂M/∂xᵢ(τ)⟩ = uᵀ·[∂M/∂xᵢ(τ)]·v for every dof (HolsteinModels.jl:691-755).

    One elementwise pass + one checkerboard-transpose of ``u``:
    dMdx(i,τ) = ±Δτ·(λᵢ + 2λ₂ᵢxᵢ(τ))·expnV(i,τ)·v(i,τ-1)·[exp(-ΔτK)ᵀu](i,τ)
    with the minus sign on the τ=0 (antiperiodic wrap) slice.
    """
    x = jnp.asarray(x)
    lam = p.lam[:, None]
    lam2 = p.lam2[:, None]
    sgn = -_tau_sign_first(spec, x.dtype)  # [-1 at τ=0, +1 elsewhere] → see below
    # reference: dMdx(τ=1) has -Δτ..., τ>1 has +Δτ → sign = -1 at τ=0, +1 else
    d = sgn * spec.dtau * (lam + 2.0 * lam2 * x) * env * jnp.roll(v, 1, axis=-1)
    y = apply_expK_T(spec, p, u)
    if jnp.iscomplexobj(y) or jnp.iscomplexobj(d):
        # complex-hopping path: the force on the REAL field x is
        # Re[u†·∂M/∂x·v] (the adjoint pairing; the real path's uᵀ∂Mv is its
        # real-dtype specialization). apply_expK_T is already the adjoint
        # exp(−ΔτK)† on this path, so only the elementwise conjugate remains.
        return jnp.real(jnp.conj(y) * d)
    return y * d


# ---------------------------------------------------------------------------
# bosonic (phonon) action
# ---------------------------------------------------------------------------

def calc_Sb(spec: HolsteinSpec, p: HolsteinParams, x, shifted: bool = False):
    """Phonon action Sb (PhononAction.jl:11-66).

    Sb = Δτ·Σ[ω²x²/2 + ω₄x⁴ − λx·shifted + (Δx/Δτ)²/2 + ωᵢⱼ²(xᵢ±xⱼ)²/2].
    ``shifted`` subtracts the λx background (used by Langevin dynamics).
    """
    x = jnp.asarray(x)
    om2 = (p.omega ** 2)[:, None]
    om4 = p.omega4[:, None]
    lam = p.lam[:, None]
    dx = x - jnp.roll(x, 1, axis=-1)
    sb = om2 * x * x / 2 + om4 * x ** 4 + dx * dx / (2 * spec.dtau ** 2)
    if shifted:
        sb = sb - lam * x
    from elphdynamics_tpu.utils.dtypes import fsum
    total = fsum(sb, axis=(-2, -1))
    if spec.wij_table.shape[1] > 0:
        i = jnp.asarray(spec.wij_table[0])
        j = jnp.asarray(spec.wij_table[1])
        sgn = jnp.asarray(spec.wij_sign, x.dtype)[:, None]
        pair = jnp.take(x, i, axis=-2) + sgn * jnp.take(x, j, axis=-2)
        total = total + jnp.sum((p.wij ** 2)[:, None] * pair * pair / 2, axis=(-2, -1))
    return spec.dtau * total


def calc_dSbdx(spec: HolsteinSpec, p: HolsteinParams, x, shifted: bool = False):
    """∂Sb/∂xᵢ(τ) (PhononAction.jl:114-187)."""
    x = jnp.asarray(x)
    om2 = (p.omega ** 2)[:, None]
    om4 = p.omega4[:, None]
    lam = p.lam[:, None]
    lap = jnp.roll(x, 1, axis=-1) + jnp.roll(x, -1, axis=-1) - 2.0 * x
    d = spec.dtau * (om2 * x + 4.0 * om4 * x ** 3) - lap / spec.dtau
    if shifted:
        d = d - spec.dtau * lam
    if spec.wij_table.shape[1] > 0:
        i = jnp.asarray(spec.wij_table[0])
        j = jnp.asarray(spec.wij_table[1])
        sgn = jnp.asarray(spec.wij_sign, x.dtype)[:, None]
        w2 = (p.wij ** 2)[:, None]
        pair = spec.dtau * w2 * (jnp.take(x, i, axis=-2) + sgn * jnp.take(x, j, axis=-2))
        d = d.at[..., i, :].add(pair)
        d = d.at[..., j, :].add(sgn * pair)
    return d


# ---------------------------------------------------------------------------
# Λ operators for the HMC exponential-shift trick (HMC.jl:921-1030)
# ---------------------------------------------------------------------------

def calc_Lambda(spec: HolsteinSpec, p: HolsteinParams, x):
    """Λ(i,τ) = exp(-Δτ·(λx + λ₂x²)/2) (HMC.jl:921-941)."""
    lam = p.lam[:, None]
    lam2 = p.lam2[:, None]
    return jnp.exp(-spec.dtau * (lam * x + lam2 * x * x) / 2.0)


def mulLambda(spec: HolsteinSpec, Lam, v):
    """v' = Λ·v as an operator: v'(τ) = -Λ(τ+1)v(τ+1), v'(Lτ-1) = Λ(0)v(0)
    (HMC.jl:951-968)."""
    w = Lam * v
    return _tau_sign_last(spec, w.dtype) * jnp.roll(w, -1, axis=-1)


def mulLambdaInv(spec: HolsteinSpec, Lam, v):
    """v' = Λ⁻¹·v: v'(τ) = -v(τ-1)/Λ(τ), v'(0) = v(Lτ-1)/Λ(0) (HMC.jl:978-995)."""
    return _tau_sign_first(spec, v.dtype) * jnp.roll(v, 1, axis=-1) / Lam


def muldLambdadx(spec: HolsteinSpec, p: HolsteinParams, x, Lam, vl, vr):
    """⟨vₗ|∂Λ/∂x(τ)|vᵣ⟩ per dof, to be *added* to a force (HMC.jl:1005-1025).

    contribution(i,τ) = ±vₗ(i,τ)·Δτ·(λᵢ/2 + λ₂ᵢxᵢ(τ))·Λ(i,τ)·vᵣ(i,τ-1),
    with the minus sign on the τ=0 slice.
    """
    lam = p.lam[:, None]
    lam2 = p.lam2[:, None]
    sgn = -_tau_sign_first(spec, Lam.dtype)
    base = sgn * spec.dtau * (lam / 2.0 + lam2 * x) * Lam * jnp.roll(vr, 1, axis=-1)
    if jnp.iscomplexobj(vl) or jnp.iscomplexobj(vr):
        # complex path: Re[vl†·∂Λ/∂x·vr] (Λ itself is real diagonal)
        return jnp.real(jnp.conj(vl) * base)
    return vl * base
