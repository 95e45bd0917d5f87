"""Optical SSH model: bond phonons modulating the electron hopping.

Reference: SSHModels.jl. The phonon ``x`` lives on bonds and modulates the
hopping ``t' = t − (αx + sign(x)·α₂x²)`` (SSHModels.jl:530-535); the fermion
matrix uses a *time-dependent* checkerboard factorisation

    B(τ) = exp(-Δτ·K[x(τ)]) · exp(+Δτ·μ)        (SSHModels.jl:587-601)

Layout: phonon fields are ``[..., Nph, Lτ]``; the per-(τ,bond)
checkerboard coefficients are a ``[Nbonds, Lτ]`` array computed inside the
jitted step (replacing the mutated caches of ``update_model!``,
SSHModels.jl:510-562). The inherently sequential ``muldMdx!`` walk over bonds
in checkerboard order with carried partial products (SSHModels.jl:707-829)
becomes a fold over the (few, static) checkerboard *groups*: within a group
all bonds are disjoint, so the per-bond sequential updates commute and
vectorise exactly.

Primary-field aliasing: same-named phonons on different bond types share one
degree of freedom (SSHModels.jl:480-502); represented here by a per-phonon
``primary_phonon`` map used to tie noise vectors and accumulate forces.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from elphdynamics_tpu.lattice import Lattice, sort_neighbor_table
from elphdynamics_tpu.ops.checkerboard import (
    CheckerboardSpec,
    build_checkerboard_spec,
    ckb_mul,
    ckb_transpose_mul,
)


class SSHParams(NamedTuple):
    """Dynamic model parameters (pytree)."""

    mu: jnp.ndarray      # [N] chemical potential
    t: jnp.ndarray       # [Nbonds] bare hopping MAGNITUDE (original bond
                         # order; signed real — the phonon modulates this)
    omega: jnp.ndarray   # [Nph] phonon frequency
    omega4: jnp.ndarray  # [Nph] anharmonic coefficient
    alpha: jnp.ndarray   # [Nph] linear el-ph coupling
    alpha2: jnp.ndarray  # [Nph] quadratic el-ph coupling
    # complex Peierls phases per bond (twisted BCs; None = real hopping).
    # The physical hopping is t_phase·t′(x): the gauge field multiplies the
    # whole modulated amplitude (Peierls substitution), the lattice
    # distortion modulates its magnitude. A complex leaf here routes the
    # whole dynamics stack onto the TRS |det M(θ)|² ensemble
    # (utils.dtypes.params_are_complex), exactly as Holstein's complex t.
    t_phase: jnp.ndarray | None = None


@dataclass(frozen=True)
class SSHSpec:
    """Static model description."""

    lattice: Lattice
    beta: float
    dtau: float
    Ltau: int
    Nsites: int
    Nbonds: int
    Nph: int
    Ndim: int
    Ndof: int
    ckb: CheckerboardSpec
    # bond bookkeeping (original bond order = appended per definition)
    ckb_to_bond: np.ndarray      # [Nbonds] checkerboard position -> original bond
    bond_to_ckb: np.ndarray      # [Nbonds] original bond -> checkerboard position
    bond_to_phonon: np.ndarray   # [Nbonds] -1 if the bond carries no phonon
    phonon_to_bond: np.ndarray   # [Nph]
    primary_phonon: np.ndarray   # [Nph] phonon -> its primary alias
    bond_to_definition: np.ndarray  # [Nbonds] bond -> bond-definition index
    bond_defs: tuple = ()        # ((o1, o2, (dL...), has_phonon), ...)
    # build per-τ dense exp(−Δτ·K[x(τ)]) matrices inside the jitted step and
    # apply them as batched matmuls (gated by memory: Lτ·N² elements)
    dense_ckb: bool = False

    def __hash__(self):
        return hash((self.Nsites, self.Ltau, self.Nbonds, self.Nph,
                     round(self.beta, 12), round(self.dtau, 12),
                     self.ckb_to_bond.tobytes(), self.bond_to_phonon.tobytes(),
                     self.primary_phonon.tobytes(), self.dense_ckb))

    def __eq__(self, other):
        return (
            isinstance(other, SSHSpec)
            and self.Nsites == other.Nsites
            and self.Ltau == other.Ltau
            and self.ckb == other.ckb
            and np.array_equal(self.ckb_to_bond, other.ckb_to_bond)
            and np.array_equal(self.bond_to_phonon, other.bond_to_phonon)
            and np.array_equal(self.primary_phonon, other.primary_phonon)
        )


def build_ssh(
    lattice: Lattice,
    beta: float,
    dtau: float,
    *,
    hoppings=(),  # iterable of dicts: t, t_std, omega, omega_std, omega4, omega4_std,
                  #                    alpha, alpha_std, alpha2, alpha2_std,
                  #                    o1, o2, dL, name
    mu_assignments=(),  # iterable of (mu, std, orbit or None-for-all)
    twist=None,         # (θ1, θ2[, θ3]) twisted-BC flux angles, radians
    rng: np.random.Generator | None = None,
    dtype=None,
) -> tuple[SSHSpec, SSHParams]:
    """Construct the SSH model (mirrors ``initialize_model!``, SSHModels.jl:348-505).

    ``twist`` threads uniform Peierls phases exp(i·Σ θ_d·dL_d/L_d) through
    the bonds (the SSH side of Models.jl:20's complex type surface, beyond
    the reference's real-only stock examples): the phases multiply the
    whole phonon-modulated amplitude t_phase·(t − αx − sign(x)α₂x²), the
    checkerboard runs the Hermitian conj(s) convention, mulMT becomes the
    adjoint M†, and the samplers run the sign-problem-free TRS ensemble
    |det M(θ)|² with spin-↓ on conjugate phases."""
    rng = rng or np.random.default_rng(0)
    N = lattice.nsites
    if dtype is None:
        from elphdynamics_tpu.utils.dtypes import default_real_dtype
        dtype = default_real_dtype()
    Ltau = int(round(beta / dtau))

    if twist is not None and np.any(np.asarray(twist)):
        tw3 = np.zeros(3)
        tw3[: len(tuple(twist))] = twist
        Ls = np.array([lattice.L1, lattice.L2, lattice.L3], dtype=float)
    else:
        twist = None

    mu_v = np.zeros(N)
    for (mu0, std, orbit) in mu_assignments:
        for i in range(N):
            if orbit is None or lattice.site_to_orbit[i] == orbit:
                mu_v[i] = mu0 + (std * rng.standard_normal() if std else 0.0)

    tables, tvals, bond_defs = [], [], []
    phases = []
    om, om4, al, al2 = [], [], [], []
    phonon_to_bond, bond_to_phonon = [], []
    names = []
    bond_count = 0
    ph_names = []  # name per phonon type (for primary-field tying)
    for idef, h in enumerate(hoppings):
        tb = lattice.calc_neighbor_table(h["o1"], h["o2"], h["dL"])
        nnew = tb.shape[1]
        tval, tstd = h.get("t", 0.0), h.get("t_std", 0.0)
        phase = np.sign(tval) if tval != 0 else 1.0
        tv = phase * (abs(tval) + (tstd * rng.standard_normal(nnew) if tstd else np.zeros(nnew)))
        tables.append(tb)
        tvals.append(tv)
        if twist is not None:
            dL3 = np.zeros(3)
            dL3[: len(h["dL"])] = h["dL"]
            phases.append(np.full(
                nnew, np.exp(1j * float(np.sum(tw3 * dL3 / Ls)))))
        bond_defs.extend([idef] * nnew)
        has_phonon = (h.get("omega", 0.0) != 0.0) or (h.get("omega_std", 0.0) != 0.0)
        name = h.get("name") or f"__anon{idef}"
        names.append(name)
        if has_phonon:
            ph_names.append(name)

            def draw(key, std_key):
                v0, s0 = h.get(key, 0.0), h.get(std_key, 0.0)
                ph = np.sign(v0) if v0 != 0 else 1.0
                if key.startswith("omega"):
                    return v0 + (s0 * rng.standard_normal(nnew) if s0 else np.zeros(nnew))
                return ph * (abs(v0) + (s0 * rng.standard_normal(nnew) if s0 else np.zeros(nnew)))

            om.append(draw("omega", "omega_std"))
            om4.append(draw("omega4", "omega4_std"))
            al.append(draw("alpha", "alpha_std"))
            al2.append(draw("alpha2", "alpha2_std"))
            phonon_to_bond.extend(range(bond_count, bond_count + nnew))
            bond_to_phonon.extend(range(len(phonon_to_bond) - nnew, len(phonon_to_bond)))
        else:
            bond_to_phonon.extend([-1] * nnew)
        bond_count += nnew

    if tables:
        table = np.concatenate(tables, axis=1)
        t = np.concatenate(tvals)
    else:
        table = np.zeros((2, 0), dtype=np.int64)
        t = np.zeros(0)
    nb = table.shape[1]

    # sort + checkerboard-group (SSHModels.jl:436-446). Unlike Holstein we keep
    # parameter arrays in *original* bond order and carry permutations.
    table_sorted, perm = sort_neighbor_table(table)
    ckb = build_checkerboard_spec(N, table_sorted)
    # checkerboard position n corresponds to sorted bond ckb.order[n],
    # which is original bond perm[ckb.order[n]]
    ckb_to_bond = perm[ckb.order] if nb else np.zeros(0, dtype=np.int64)
    bond_to_ckb = np.argsort(ckb_to_bond) if nb else np.zeros(0, dtype=np.int64)

    Nph = len(phonon_to_bond)
    bond_to_phonon = np.asarray(bond_to_phonon, dtype=np.int64)
    phonon_to_bond = np.asarray(phonon_to_bond, dtype=np.int64)

    # primary-field tying: same-named phonon types alias the earliest type
    # (SSHModels.jl:480-502). Phonons are laid out contiguously per type.
    primary = np.arange(Nph, dtype=np.int64)
    type_sizes = [len(o) for o in om]
    type_starts = np.cumsum([0] + type_sizes[:-1]) if type_sizes else np.zeros(0, dtype=np.int64)
    for a in range(len(ph_names)):
        for b in range(a + 1, len(ph_names)):
            if ph_names[a] == ph_names[b] and type_sizes[a] == type_sizes[b]:
                sa, sb_ = int(type_starts[a]), int(type_starts[b])
                for k in range(type_sizes[b]):
                    if primary[sb_ + k] == sb_ + k:
                        primary[sb_ + k] = primary[sa + k]

    # Per-τ dense exp(−Δτ·K[x(τ)]) path: OFF by default. The per-(chain,τ)
    # matrices make every apply a batched MATVEC (N² bytes read per N·Lτ
    # outputs) where the group fold is ngroups gather+FMA passes; not
    # measured on H100. The densifier (dense_K) remains
    # for write_K_matrix and testing; the KPM averaged operator keeps its
    # own single-slice densification (ops/kpm._dense_avg), which IS a win.
    dense_ckb = False
    spec = SSHSpec(
        lattice=lattice,
        beta=float(beta),
        dtau=float(dtau),
        Ltau=Ltau,
        Nsites=N,
        Nbonds=nb,
        Nph=Nph,
        dense_ckb=dense_ckb,
        Ndim=N * Ltau,
        Ndof=Nph * Ltau,
        ckb=ckb,
        ckb_to_bond=ckb_to_bond,
        bond_to_ckb=bond_to_ckb,
        bond_to_phonon=bond_to_phonon,
        phonon_to_bond=phonon_to_bond,
        primary_phonon=primary,
        bond_to_definition=np.asarray(bond_defs, dtype=np.int64),
        bond_defs=tuple(
            (h["o1"], h["o2"], tuple(h["dL"]),
             (h.get("omega", 0.0) != 0.0) or (h.get("omega_std", 0.0) != 0.0))
            for h in hoppings
        ),
    )
    cdtype = (jnp.complex64 if jnp.dtype(dtype) == jnp.float32
              else jnp.complex128)
    params = SSHParams(
        mu=jnp.asarray(mu_v, dtype),
        t=jnp.asarray(t, dtype),
        omega=jnp.asarray(np.concatenate(om) if om else np.zeros(0), dtype),
        omega4=jnp.asarray(np.concatenate(om4) if om4 else np.zeros(0), dtype),
        alpha=jnp.asarray(np.concatenate(al) if al else np.zeros(0), dtype),
        alpha2=jnp.asarray(np.concatenate(al2) if al2 else np.zeros(0), dtype),
        t_phase=(jnp.asarray(np.concatenate(phases)
                             if phases else np.zeros(0), cdtype)
                 if twist is not None else None),
    )
    return spec, params


# ---------------------------------------------------------------------------
# derived quantities
# ---------------------------------------------------------------------------

def tie_fields(spec: SSHSpec, x):
    """Equalise aliased phonon worldlines: x ← x[primary] (SSHModels.jl:567-576)."""
    return jnp.take(x, jnp.asarray(spec.primary_phonon), axis=-2)


def hopping_t_prime(spec: SSHSpec, p: SSHParams, x):
    """Modulated hopping t'(bond,τ) = t − (αx + sign(x)α₂x²), original bond
    order, shape [..., Nbonds, Lτ] (SSHModels.jl:510-541)."""
    btp = jnp.asarray(np.maximum(spec.bond_to_phonon, 0))
    has = jnp.asarray((spec.bond_to_phonon >= 0))[:, None]
    xb = jnp.take(x, btp, axis=-2)
    a = p.alpha[btp][:, None]
    a2 = p.alpha2[btp][:, None]
    v = a * xb + jnp.sign(xb) * a2 * xb * xb
    return p.t[:, None] - jnp.where(has, v, 0.0)


class SSHDerived(NamedTuple):
    """Derived per-configuration state (the pure replacement of the
    reference's mutated cosh/sinh caches, SSHModels.jl:510-562)."""

    cosh: jnp.ndarray            # [Nbonds, Lτ], checkerboard order
    sinh: jnp.ndarray
    Kd: jnp.ndarray = None       # [Lτ, N, N] dense exp(−Δτ·K[x(τ)]) (optional)

    # tuple-unpacking compatibility: (cosh, sinh) = derived
    def __iter__(self):
        return iter((self.cosh, self.sinh))


def dense_K(spec: SSHSpec, cosh_b, sinh_b):
    """Per-τ dense exp(−Δτ·K[x(τ)]) built by folding the checkerboard groups
    on [Lτ, N, N] identity stacks — traced inside jit (the coefficients are
    x-dependent), then applied as batched matmuls."""
    ckb = spec.ckb
    N, Lt = spec.Nsites, spec.Ltau
    D = jnp.broadcast_to(jnp.eye(N, dtype=cosh_b.dtype), (Lt, N, N))
    for g in range(ckb.ngroups):
        bos = ckb.bond_of_site[g]
        m = jnp.asarray(ckb.mask[g])[None, :, None]
        c = jnp.where(m, cosh_b[bos].T[:, :, None], jnp.ones((), cosh_b.dtype))
        s = jnp.where(m, sinh_b[bos].T[:, :, None], jnp.zeros((), sinh_b.dtype))
        D = c * D + s * jnp.take(D, jnp.asarray(ckb.partner[g]), axis=1)
    return D


def ckb_coeffs(spec: SSHSpec, p: SSHParams, x):
    """Derived state: (cosh, sinh) of Δτ·t' in checkerboard order, shape
    [Nbonds, Lτ], plus the dense per-τ matrices in dense mode.

    Complex hopping (``p.t_phase``): the physical amplitude is
    t_phase·t′(x) with t′ real, so the bond exponential's Hermitian form is
    c = cosh(Δτ·t′) (real) and s = t_phase·sinh(Δτ·t′) with conj(s) on the
    second endpoint — exactly Holstein's convention (Checkerboard.jl:78),
    handled downstream by ckb_mul/ckb_transpose_mul (the transpose fold is
    then the adjoint)."""
    tp = hopping_t_prime(spec, p, x)
    tp_ckb = jnp.take(tp, jnp.asarray(spec.ckb_to_bond), axis=-2)
    arg = spec.dtau * tp_ckb
    cosh_b, sinh_b = jnp.cosh(arg), jnp.sinh(arg)
    if p.t_phase is not None:
        ph_ckb = jnp.take(p.t_phase, jnp.asarray(spec.ckb_to_bond), axis=-1)
        sinh_b = ph_ckb[:, None] * sinh_b
        cosh_b = cosh_b.astype(sinh_b.dtype)
        if spec.dense_ckb:
            raise NotImplementedError(
                "dense_ckb with complex SSH hopping (the dense fold lacks "
                "the adjoint convention; dense mode is measured-off anyway)")
    Kd = dense_K(spec, cosh_b, sinh_b) if spec.dense_ckb else None
    return SSHDerived(cosh=cosh_b, sinh=sinh_b, Kd=Kd)


def exp_mu(spec: SSHSpec, p: SSHParams):
    """exp(+Δτ·μ) diagonal, shape [N, 1] (SSHModels.jl:139,513)."""
    return jnp.exp(spec.dtau * p.mu)[:, None]


# ---------------------------------------------------------------------------
# fermion matrix multiplication routines
# ---------------------------------------------------------------------------

def _tau_sign_first(Ltau, dtype):
    s = -jnp.ones(Ltau, dtype=dtype)
    return s.at[0].set(1.0)


def _tau_sign_last(Ltau, dtype):
    s = -jnp.ones(Ltau, dtype=dtype)
    return s.at[-1].set(1.0)


def _apply_K(spec: SSHSpec, coeffs, y, transpose=False):
    """exp(−Δτ·K[x(τ)])·y — per-τ batched matmul in dense mode, the
    checkerboard group fold otherwise."""
    Kd = getattr(coeffs, "Kd", None)
    if Kd is not None:
        import jax

        eq = "tji,...jt->...it" if transpose else "tij,...jt->...it"
        return jnp.einsum(eq, Kd, y, precision=jax.lax.Precision.HIGHEST)
    cosh_b, sinh_b = coeffs
    fn = ckb_transpose_mul if transpose else ckb_mul
    return fn(spec.ckb, cosh_b, sinh_b, y)


def mulM(spec: SSHSpec, p: SSHParams, coeffs, v):
    """y = M·v (SSHModels.jl:581-640). ``coeffs`` is the derived state from
    :func:`ckb_coeffs`; v is [..., N, Lτ]."""
    v = jnp.asarray(v)
    y = exp_mu(spec, p) * jnp.roll(v, 1, axis=-1)
    y = _apply_K(spec, coeffs, y)
    return v + _tau_sign_first(spec.Ltau, v.dtype) * y


def mulMT(spec: SSHSpec, p: SSHParams, coeffs, v):
    """y = Mᵀ·v (SSHModels.jl:646-701)."""
    v = jnp.asarray(v)
    z = _apply_K(spec, coeffs, v, transpose=True)
    w = exp_mu(spec, p) * z
    return v + _tau_sign_last(spec.Ltau, v.dtype) * jnp.roll(w, -1, axis=-1)


def mulMTM(spec: SSHSpec, p: SSHParams, coeffs, v):
    return mulMT(spec, p, coeffs, mulM(spec, p, coeffs, v))


def mulMMT(spec: SSHSpec, p: SSHParams, coeffs, v):
    return mulM(spec, p, coeffs, mulMT(spec, p, coeffs, v))


def muldMdx(spec: SSHSpec, p: SSHParams, coeffs, x, u, v):
    """⟨∂M/∂x_b(τ)⟩ = uᵀ·[∂M/∂x_b(τ)]·v per dof, [..., Nph, Lτ]
    (SSHModels.jl:707-829).

    Group-fold formulation of the reference's bond-sequential walk: carry
    b ← G_g·b and c ← G_g⁻¹·c through the checkerboard groups; after applying
    group g, every phonon-carrying bond (i,j) in g contributes

        dmdx(τ) = ±Δτ·(α + 2α₂x(τ))·( c_j(τ)·b_i(τ) + c_i(τ)·b_j(τ) )

    (sign flipped on the τ=0 wrap slice). Within a group bonds are disjoint,
    so this equals the reference's sequential per-bond update exactly. The
    quadratic-coupling derivative uses the reference's own expression
    ``α + 2α₂x`` (SSHModels.jl:809) verbatim.
    """
    from elphdynamics_tpu.ops.checkerboard import _group_coeffs

    cosh_b, sinh_b = coeffs
    cplx = jnp.iscomplexobj(sinh_b)
    x = jnp.asarray(x)
    u = jnp.asarray(u)
    v = jnp.asarray(v)
    b = exp_mu(spec, p) * jnp.roll(v, 1, axis=-1)
    c = ckb_transpose_mul(spec.ckb, cosh_b, sinh_b, u)

    batch = jnp.broadcast_shapes(x.shape[:-2], u.shape[:-2], v.shape[:-2])
    out = jnp.zeros(batch + (spec.Nph, spec.Ltau), dtype=x.dtype)
    sgn = -_tau_sign_first(spec.Ltau, x.dtype)
    ckb = spec.ckb
    for g in range(ckb.ngroups):
        # apply group g to b, inverse of group g to c. The bond blocks are
        # HERMITIAN on the complex path ([c, s; s̄, c]) so the u-side chain
        # needs the same coefficients with the endpoint-conj placement —
        # _group_coeffs handles both paths (flip s's sign for the inverse)
        in_g = np.nonzero(ckb.groups == g)[0]
        cg, sg = _group_coeffs(ckb, g, cosh_b, sinh_b)
        prt = jnp.asarray(ckb.partner[g])
        b = cg * b + sg * jnp.take(b, prt, axis=-2)
        c = cg * c - sg * jnp.take(c, prt, axis=-2)
        # contributions from phonon-carrying bonds of this group
        bonds_orig = spec.ckb_to_bond[in_g]
        ph = spec.bond_to_phonon[bonds_orig]
        sel = ph >= 0
        if not np.any(sel):
            continue
        i_s = ckb.neighbor_table[0, in_g[sel]]
        j_s = ckb.neighbor_table[1, in_g[sel]]
        ph_s = ph[sel]
        xg = jnp.take(x, jnp.asarray(ph_s), axis=-2)
        dKdx = p.alpha[ph_s][:, None] + 2.0 * p.alpha2[ph_s][:, None] * xg
        bi = jnp.take(b, jnp.asarray(i_s), axis=-2)
        bj = jnp.take(b, jnp.asarray(j_s), axis=-2)
        ci = jnp.take(c, jnp.asarray(i_s), axis=-2)
        cj = jnp.take(c, jnp.asarray(j_s), axis=-2)
        if cplx:
            # u†·Γ_ph·v per bond with Γ_ph = [0, ph; p̄h, 0] (the phase sits
            # on the i←j entry, the conj on j←i — the checkerboard's conj(s)
            # convention): the force on the REAL bond field is the Re part
            # (pseudofermion pairs pack as Re/Im, utils.dtypes)
            phb = jnp.take(p.t_phase, jnp.asarray(bonds_orig[sel]),
                           axis=-1)[:, None]
            dmdx = sgn * spec.dtau * dKdx * jnp.real(
                phb * jnp.conj(ci) * bj + jnp.conj(phb) * jnp.conj(cj) * bi)
        else:
            dmdx = sgn * spec.dtau * dKdx * (cj * bi + ci * bj)
        out = out.at[..., jnp.asarray(ph_s), :].add(dmdx)

    # primary-field accumulation + broadcast (SSHModels.jl:820-827)
    prim = jnp.asarray(spec.primary_phonon)
    tied = jnp.zeros_like(out).at[..., prim, :].add(out)
    return jnp.take(tied, prim, axis=-2)


# ---------------------------------------------------------------------------
# bosonic (phonon) action — primary fields only (PhononAction.jl:68-107)
# ---------------------------------------------------------------------------

def _primary_mask(spec: SSHSpec, dtype):
    return jnp.asarray(spec.primary_phonon == np.arange(spec.Nph), dtype)[:, None]


def calc_Sb(spec: SSHSpec, p: SSHParams, x, shifted: bool = False):
    """Sb = Σ_primary Σ_τ [Δτω²x²/2 + Δτω₄x⁴ + (Δx)²/(2Δτ)]."""
    x = jnp.asarray(x)
    om2 = (p.omega ** 2)[:, None]
    om4 = p.omega4[:, None]
    dx = x - jnp.roll(x, 1, axis=-1)
    sb = spec.dtau * (om2 * x * x / 2 + om4 * x ** 4) + dx * dx / (2 * spec.dtau)
    from elphdynamics_tpu.utils.dtypes import fsum
    return fsum(_primary_mask(spec, x.dtype) * sb, axis=(-2, -1))


def calc_dSbdx(spec: SSHSpec, p: SSHParams, x, shifted: bool = False):
    """∂Sb/∂x per dof (PhononAction.jl:189-233; computed for all fields —
    aliased worldlines carry identical values by construction)."""
    x = jnp.asarray(x)
    om2 = (p.omega ** 2)[:, None]
    om4 = p.omega4[:, None]
    lap = jnp.roll(x, 1, axis=-1) + jnp.roll(x, -1, axis=-1) - 2.0 * x
    return spec.dtau * (om2 * x + 4.0 * om4 * x ** 3) - lap / spec.dtau
