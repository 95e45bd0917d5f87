"""Inter-site (bond-pair) correlation functions.

Reference: Measurements.jl:1656-2483. For every pair of bond definitions
(n″, n′) — bond n′ runs orbitals b→a displaced r′ cells, bond n″ runs d→c
displaced r″ — these estimators combine shifted single-orbital fields of the
two random vectors of each (i, j) pair into translational averages:

* BondBond (:1663-1785): ⟨K[a,b,r′](τ,r)·K[c,d,r″](0,0)⟩ with
  K = Σ_σ a⁺σ(i+r+r′)·bσ(i+r) — 2 convolution terms + a δ(a,d) contact term;
* CurrentCurrent (:1790-2384): the same contractions weighted by the (bare
  Holstein / modulated SSH) hopping amplitudes — 8 convolution terms + 4
  contact terms;
* BondPairGreens (:2390-2483): ⟨Δ[a,b,r′](τ,r)·Δ⁺[c,d,r″](0,0)⟩ — 1
  convolution term + τ=β boundary identities.

Batched: every term is batched over ALL vector pairs (i, j) at once (the
reference loops pairs serially); the translational averages are batched FFTs
over [P·n_bond_pairs, L1, L2, L3, Lτ] blocks.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from elphdynamics_tpu.measure import greens as G


def _cshift(F, r):
    """F(i+r): circshift by −r over the spatial axes (-4, -3, -2)."""
    return jnp.roll(F, shift=(-r[0], -r[1], -r[2]), axis=(-4, -3, -2))


def _ta(f, g):
    """Batched translational average over (L1, L2, L3, Lτ)."""
    return G.translational_average(f, g)


def _beta_slice_negated(arr_tau0):
    """C(β, r) = C(0, −r): negate the spatial displacement of the τ=0 slice
    (Measurements.jl:1770-1778). arr_tau0: [..., L1, L2, L3]."""
    return G._neg_index(arr_tau0, (-3, -2, -1))


class BondFields:
    """Cell-layout per-vector-pair fields for the intersite estimators.

    Complex-hopping (TRS twist) path: the probe fields r₁/r₂ are stored
    CONJUGATED (the estimator pairing is G↑ = E[M⁻¹R ⊙ conj R]); the
    estimator bodies then apply Re per factor on direct (cross-spin) terms
    and Re on the whole product on same-spin exchange terms — identities on
    the real path."""

    def __init__(self, lattice, R, MinvR, pair_idx):
        iu, ju = pair_idx
        self.cplx = bool(jnp.iscomplexobj(R))
        # complex128 canonicalizes to complex64 when x64 is off (f32 production)
        Rc = G.to_cell_layout(lattice, R).astype(jnp.complex128)
        if self.cplx:
            Rc = jnp.conj(Rc)
        Mc = G.to_cell_layout(lattice, MinvR).astype(jnp.complex128)
        # reference naming: r₁/M⁻¹r₁ = vector i, r₂/M⁻¹r₂ = vector j
        self.r1 = Rc[iu]      # [P, no, L1, L2, L3, Lt]
        self.M1 = Mc[iu]
        self.r2 = Rc[ju]
        self.M2 = Mc[ju]

    def f(self, which, orbital):
        return getattr(self, which)[:, orbital]


def measure_bondbond(ops, pt, bf: BondFields, bond_pairs, time_dependent):
    """Measurements.jl:1663-1785. Returns [n_pairs, L1, L2, L3, Lt(+1)|1]."""
    spec = ops.spec
    Lt = ops.Ltau
    defs = spec.bond_defs
    out = []
    for (n2, n1) in bond_pairs:  # pairs[1,p]=n″=first, pairs[2,p]=n′=second
        d, c, r2v = defs[n2][0], defs[n2][1], defs[n2][2]
        b, a, r1v = defs[n1][0], defs[n1][1], defs[n1][2]

        bb = jnp.zeros(bf.r1.shape[2:], dtype=jnp.complex128)  # [L1,L2,L3,Lt]

        # + 4·⟨b(i+r,τ)a⁺(i+r+r′,τ)⟩⟨d(i,0)c⁺(i+r″,0)⟩ — direct (Σσσ'):
        # complex path takes Re per factor (spin-sum 2ReG per K operator)
        G1 = bf.f("M1", b) * _cshift(bf.f("r1", a), r1v)
        G2 = bf.f("M2", d) * _cshift(bf.f("r2", c), r2v)
        if bf.cplx:
            G1, G2 = jnp.real(G1), jnp.real(G2)
        bb = bb + 4.0 * jnp.sum(_ta(G1, G2), axis=0)

        # − 2·⟨b(i+r,τ)c⁺(i+r″,0)⟩⟨d(i,0)a⁺(i+r+r′,τ)⟩ — same-spin exchange
        # (Σσ → 2·Re of the whole contraction on the complex path)
        G2x = bf.f("M1", b) * _cshift(bf.f("r2", a), r1v)
        G1x = bf.f("M2", d) * _cshift(bf.f("r1", c), r2v)
        exch = jnp.sum(_ta(G1x, G2x), axis=0)
        if bf.cplx:
            exch = jnp.real(exch)
        bb = bb - 2.0 * exch

        # + 2·δ(a,d)·δ(r+r′)·⟨b(i+r−r″,τ)c⁺(i,0)⟩, recorded at l = −r′−r″
        # exactly as the reference does (:1750-1762)
        if a == d:
            lat = spec.lattice
            l = (np.mod(-r1v[0] - r2v[0], lat.L1),
                 np.mod(-r1v[1] - r2v[1], lat.L2),
                 np.mod(-r1v[2] - r2v[2], lat.L3))
            gval = pt.G[b, c, l[0], l[1], l[2], 0]  # pair-summed GΔ0
            bb = bb.at[l[0], l[1], l[2], 0].add(2.0 * gval)

        out.append(_finalize_tau(bb, Lt, time_dependent, beta_negated=True))
    return jnp.stack(out)


def measure_currentcurrent(ops, params, x, pt, bf: BondFields, bond_pairs,
                           time_dependent):
    """⟨J′(τ,r)·J″(0,0)⟩ with J = i·Σσ(tσ·c†c − tσ*·c†c) per bond
    (Measurements.jl:1790-2384; complex hopping beyond reference scope).

    Derived from operator-level Wick contractions (exact-tested against the
    dense propagator, real and twisted: tests/test_intersite_corr.py,
    tests/test_complex_measurements.py) rather than transcribed verbatim:
    the reference CODE disagrees with its own comments in three places, and
    the comments are what Wick gives —

    * term (4) accumulates −4 at Measurements.jl:1929 under a ``J += 4``
      comment; +4 is correct (the four direct terms must assemble to the
      per-configuration ⟨J′⟩⟨J″⟩ product −4t′t″(Gab−Gba)(Gcd−Gdc));
    * the a==d / b==c / a==c contact terms (:2317-2352) reuse the
      *placement* index l as the circshift of G₁, pairing b(i+r′) instead
      of the comment's b(i−r′) (wrong whenever the bond displacement ≠ 0);
    * the b==c contact (:2343) reads orbital b where the comment (and the
      δ(b,c) Wick contraction) require orbital a.

    Complex hopping (TRS twist ensemble, spin-↓ = conjugate phases): each
    term belongs to one of the four operator groups (t′A−t′*Ā)(t″B−t″*B̄),
    fixing its conj placements; spin sums make direct terms Re-per-weighted-
    factor and exchange/contact terms Re-of-the-whole-product (identities
    on the real path, where G↓ = G↑ and per-spin values are real)."""
    spec = ops.spec
    Lt = ops.Ltau
    lat = spec.lattice
    defs = spec.bond_defs
    ndefs = len(defs)
    ncells = lat.ncells

    # hopping weights per definition in cell layout. Bonds are one-per-base-
    # cell in cell-linear order but DEDUPED (lattice.calc_neighbor_table
    # drops the second copy of a pair the periodic wrap duplicates, e.g. at
    # L = 2), so scatter per-bond values onto base cells rather than
    # reshaping — a dropped duplicate's cell correctly carries weight 0
    # (that cell hosts no bond in the deduped Hamiltonian).
    if ops.is_holstein:
        tvals = jnp.asarray(params.t)                        # [Nbonds]
        tail = ()
    else:
        from elphdynamics_tpu.models import ssh as Sm
        tvals = Sm.hopping_t_prime(spec, params, x)          # [Nbonds, Lt]
        if getattr(params, "t_phase", None) is not None:
            tvals = params.t_phase[:, None] * tvals          # twisted SSH
        tail = (Lt,)
    norb = lat.unit_cell.norbits
    grids = []
    n0 = 0
    for dfn in defs:
        tb = lat.calc_neighbor_table(dfn[0], dfn[1], dfn[2])
        nnew = tb.shape[1]
        base_cells = jnp.asarray(tb[0] // norb)
        g = jnp.zeros((ncells,) + tail, dtype=tvals.dtype)
        g = g.at[base_cells].set(tvals[n0:n0 + nnew])
        n0 += nnew
        grids.append(g)
    t = jnp.stack(grids).reshape((ndefs, lat.L3, lat.L2, lat.L1) + tail)
    if ops.is_holstein:
        t = jnp.transpose(t, (0, 3, 2, 1))[..., None]        # [def, L1,L2,L3, 1]
    else:
        t = jnp.transpose(t, (0, 3, 2, 1, 4))                # [def, L1,L2,L3, Lt]
    t = t.astype(jnp.complex128)

    cplx = bf.cplx
    out = []
    for (n2, n1) in bond_pairs:
        d, c, r2v = defs[n2][0], defs[n2][1], defs[n2][2]
        b, a, r1v = defs[n1][0], defs[n1][1], defs[n1][2]
        t1 = t[n1]   # t′ weights (bond n′)
        t2 = t[n2]   # t″ weights (bond n″)
        t1c = jnp.conj(t1)
        t2c = jnp.conj(t2)

        cc = jnp.zeros(bf.r1.shape[2:], dtype=jnp.complex128)

        def direct(G1, G2, w1, w2, coeff):
            # spin-summed trace product: each factor is Σσ (tσ-weighted Gσ)
            # = 2·Re(w·G↑) under TRS; on the real path plain w·G
            f1, f2 = w1 * G1, w2 * G2
            if cplx:
                f1 = jnp.real(f1).astype(jnp.complex128)
                f2 = jnp.real(f2).astype(jnp.complex128)
            return coeff * jnp.sum(_ta(f1, f2), axis=0)

        def exch(G1, G2, w1, w2, coeff):
            # same-spin contraction: Σσ = 2·Re(w′w″·G↑G↑) under TRS
            v = jnp.sum(_ta(w1 * G1, w2 * G2), axis=0)
            if cplx:
                v = jnp.real(v).astype(jnp.complex128)
            return coeff * v

        # direct terms — the per-configuration ⟨J′⟩⟨J″⟩ product; group
        # (conj placement) after each coefficient
        # (1) +4 [A·B̄]: G₁=M₁[b]·sh(r₁[a],r′), G₂=sh(M₂[c],r″)·r₂[d]
        cc = cc + direct(bf.f("M1", b) * _cshift(bf.f("r1", a), r1v),
                         _cshift(bf.f("M2", c), r2v) * bf.f("r2", d),
                         t1, t2c, 4.0)
        # (2) −4 [A·B]: G₂=M₂[d]·sh(r₂[c],r″)
        cc = cc + direct(bf.f("M1", b) * _cshift(bf.f("r1", a), r1v),
                         bf.f("M2", d) * _cshift(bf.f("r2", c), r2v),
                         t1, t2, -4.0)
        # (3) −4 [Ā·B̄]: G₁=sh(M₁[a],r′)·r₁[b]
        cc = cc + direct(_cshift(bf.f("M1", a), r1v) * bf.f("r1", b),
                         _cshift(bf.f("M2", c), r2v) * bf.f("r2", d),
                         t1c, t2c, -4.0)
        # (4) +4 [Ā·B]: the reference code's −4 at :1929 is a sign bug —
        #     its own comment and the Wick product both give +4 (docstring)
        cc = cc + direct(_cshift(bf.f("M1", a), r1v) * bf.f("r1", b),
                         bf.f("M2", d) * _cshift(bf.f("r2", c), r2v),
                         t1c, t2, 4.0)
        # exchange terms
        # (5) −2 [A·B̄]: G₁=M₁[b]·sh(r₂[a],r′), G₂=sh(M₂[c],r″)·r₁[d]
        cc = cc + exch(bf.f("M1", b) * _cshift(bf.f("r2", a), r1v),
                       _cshift(bf.f("M2", c), r2v) * bf.f("r1", d),
                       t1, t2c, -2.0)
        # (6) +2 [A·B]: G₁=sh(r₁[c],r″)·M₂[d], G₂=M₁[b]·sh(r₂[a],r′)
        #     with weights t″ on G₁ and t′ on G₂ (:2254-2263)
        cc = cc + exch(_cshift(bf.f("r1", c), r2v) * bf.f("M2", d),
                       bf.f("M1", b) * _cshift(bf.f("r2", a), r1v),
                       t2, t1, 2.0)
        # (7) +2 [Ā·B̄]: G₁=sh(M₁[a],r′)·r₂[b], G₂=r₁[d]·sh(M₂[c],r″)
        cc = cc + exch(_cshift(bf.f("M1", a), r1v) * bf.f("r2", b),
                       bf.f("r1", d) * _cshift(bf.f("M2", c), r2v),
                       t1c, t2c, 2.0)
        # (8) −2 [Ā·B]: G₂=sh(r₁[c],r″)·M₂[d]
        cc = cc + exch(_cshift(bf.f("M1", a), r1v) * bf.f("r2", b),
                       _cshift(bf.f("r1", c), r2v) * bf.f("M2", d),
                       t1c, t2, -2.0)

        # ---- contact (δ(τ)) terms — the equal-time δ pieces of the four
        # exchange contractions, each a lattice average placed at one
        # displacement. The G₁ factor is paired at cell (y + l) against the
        # G₂ factor at cell y (the reference comments' ⟨...(r+i,0)...(i,0)⟩
        # with r = l; its code shifts the other way, see docstring).
        norm = ncells * Lt

        def contact(G1, G2, l, w1, w2):
            val = jnp.sum(_cshift(w1 * G1, l) * (w2 * G2),
                          axis=(-4, -3, -2, -1))
            v = jnp.sum(val) / norm
            if cplx:
                v = jnp.real(v).astype(jnp.complex128)
            return v

        if a == c:
            # δ(a,c): +2·t′(i+l)t″(i)·⟨b(i+l,0)d⁺(i,0)⟩ at l = r″−r′ [A·B̄]
            l = (np.mod(r2v[0] - r1v[0], lat.L1), np.mod(r2v[1] - r1v[1], lat.L2),
                 np.mod(r2v[2] - r1v[2], lat.L3))
            v = contact(bf.f("M1", b), bf.f("r1", d), l, t1, t2c)
            cc = cc.at[l[0], l[1], l[2], 0].add(2.0 * v)
        if a == d:
            # δ(a,d): −2·t′(i+l)t″(i)·⟨b(i+l,0)c⁺(r″+i,0)⟩ at l = −r′ [A·B]
            l = (np.mod(-r1v[0], lat.L1), np.mod(-r1v[1], lat.L2),
                 np.mod(-r1v[2], lat.L3))
            v = contact(bf.f("M1", b), _cshift(bf.f("r1", c), r2v), l, t1, t2)
            cc = cc.at[l[0], l[1], l[2], 0].add(-2.0 * v)
        if b == c:
            # δ(b,c): −2·t′(i+l)t″(i)·⟨a(r′+i+l,0)d⁺(i,0)⟩ at l = r″ [Ā·B̄]
            # (orbital a, as the reference's comment has it — its code reads
            # orbital b, the third bug in the docstring)
            l = (np.mod(r2v[0], lat.L1), np.mod(r2v[1], lat.L2), np.mod(r2v[2], lat.L3))
            v = contact(_cshift(bf.f("M1", a), r1v), bf.f("r1", d), l, t1c, t2c)
            cc = cc.at[l[0], l[1], l[2], 0].add(-2.0 * v)
        if b == d:
            # δ(b,d): +2·t′t″·⟨a(r′+i,0)c⁺(r″+i,0)⟩ at l = 0 [Ā·B]
            v = contact(_cshift(bf.f("M1", a), r1v),
                        _cshift(bf.f("r1", c), r2v), (0, 0, 0), t1c, t2)
            cc = cc.at[0, 0, 0, 0].add(2.0 * v)

        out.append(_finalize_tau(cc, Lt, time_dependent, beta_negated=True))
    return jnp.stack(out)


def measure_bondpairgreens(ops, pt, bf: BondFields, bond_pairs, time_dependent,
                           n_pairs: int):
    """Measurements.jl:2390-2483."""
    spec = ops.spec
    Lt = ops.Ltau
    lat = spec.lattice
    defs = spec.bond_defs
    out = []
    for (n2, n1) in bond_pairs:
        d, c, r2v = defs[n2][0], defs[n2][1], defs[n2][2]
        b, a, r1v = defs[n1][0], defs[n1][1], defs[n1][2]

        # ⟨a(r′+r+i,τ)c⁺(r″+i,0)⟩⟨b(r+i,τ)d⁺(i,0)⟩ (:2443-2455).
        # The pair operator fixes the spins (a↑c†↑)·(b↓d†↓): on the complex
        # path the ↓ factor is the conjugated estimate — conj the j-side
        # (M2 together with its stored-conjugated probe r2) wholesale.
        M2b = jnp.conj(bf.f("M2", b)) if bf.cplx else bf.f("M2", b)
        r2d = jnp.conj(bf.f("r2", d)) if bf.cplx else bf.f("r2", d)
        G2 = _cshift(bf.f("M1", a), r1v) * M2b
        G1 = _cshift(bf.f("r1", c), r2v) * r2d
        pg = jnp.sum(_ta(G2, G1), axis=0)

        if not time_dependent:
            out.append(pg[..., :1])
            continue
        main = jnp.concatenate([pg, pg[..., :1]], axis=-1)
        # τ=β corrections (:2462-2478). The wrap identities are per-spin:
        # the (a↑c†↑) factor contributes G↑ entries (pt.G_up on the complex
        # path), the (b↓d†↓) factor their conjugates; both reduce to the
        # real pt.G for real hopping.
        Gup = pt.G if pt.G_up is None else pt.G_up
        Gdn = pt.G if pt.G_up is None else jnp.conj(pt.G_up)
        beta = main[..., Lt]
        same_r = tuple(r1v) == tuple(r2v)
        if a == c and b == d and same_r:
            delta_r0 = jnp.zeros(beta.shape).at[0, 0, 0].add(1.0 * n_pairs)
            beta = beta + delta_r0
        if b == d:
            # − δ(r=0)·G↑(r′−r″; c,a; 0) placed at r = 0
            l = (np.mod(r1v[0] - r2v[0], lat.L1), np.mod(r1v[1] - r2v[1], lat.L2),
                 np.mod(r1v[2] - r2v[2], lat.L3))
            beta = beta.at[0, 0, 0].add(-Gup[a, c, l[0], l[1], l[2], 0])
        if a == c:
            # − δ(r″ = r′+r)·G↓(r; d,b; 0) at r = r″−r′
            l = (np.mod(r2v[0] - r1v[0], lat.L1), np.mod(r2v[1] - r1v[1], lat.L2),
                 np.mod(r2v[2] - r1v[2], lat.L3))
            beta = beta.at[l[0], l[1], l[2]].add(-Gdn[b, d, l[0], l[1], l[2], 0])
        main = main.at[..., Lt].set(beta)
        out.append(main)
    return jnp.stack(out)


def _finalize_tau(arr, Lt, time_dependent, beta_negated):
    """[L1, L2, L3, Lt] -> [..., Lt+1] (τ=β via C(β,r)=C(0,−r)) or [..., 1]."""
    if not time_dependent:
        return arr[..., :1]
    beta = _beta_slice_negated(arr[..., 0]) if beta_negated else arr[..., 0]
    return jnp.concatenate([arr, beta[..., None]], axis=-1)
