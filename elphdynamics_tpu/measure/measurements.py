"""Observable measurements, binning, and post-processing.

Reference: Measurements.jl (the reference's largest component). The
measurement step accumulates, per sampler sweep:

* global: density, ⟨N̂²⟩, μ (Measurements.jl:845-861,1283-1312)
* on-site per orbital: density, double occupancy, ⟨x⟩, ⟨x²⟩, ⟨x⁴⟩, phonon
  KE/PE, el-ph energy, μ (:916-1024)
* inter-site per bond type: electron KE, SSH phonon stats incl. the
  sign-switch fraction (:1029-1155)
* on-site correlations: Greens, DenDen, SpinSpin, PairGreens, PhononGreens
  with their τ=β boundary identities (:1466-1650)
* inter-site correlations: BondBond, CurrentCurrent, BondPairGreens, SSH
  PhononGreens (:1656-2541)
* post-processing per bin: spatial FFT to momentum space (:1158-1170),
  normalisation by bin_size·C(nᵥ,2) (:590-629), and Simpson-integrated
  susceptibilities (Pair/Charge/Spin/BondPair, :2550-2572).

Restructuring: the reference loops over every random-vector pair
(i, j), accumulating per-pair measurements (:545-566). Every accumulated
quantity is *linear* in the per-pair estimator tensors, so the step here
assembles everything once from pair-summed tensors (see greens.py) plus
per-vector sums — pair loops collapse into the identities

    Σ_{i<j}(aᵢ + aⱼ) = (nᵥ−1)·Σᵢaᵢ,
    Σ_{i<j} aᵢ·bⱼ + aⱼ·bᵢ = (Σa)(Σb) − Σᵢaᵢbᵢ.

The whole step is one jitted function producing an increment pytree that is
added into the (device-resident) bin container.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from elphdynamics_tpu.dynamics.force import SolverConfig
from elphdynamics_tpu.measure import greens as G
from elphdynamics_tpu.models.adapter import ModelOps
from elphdynamics_tpu.utils.math import simpson

ONSITE_CORR_KINDS = ("Greens", "DenDen", "SpinSpin", "PairGreens", "PhononGreens")
INTERSITE_CORR_KINDS = ("BondBond", "CurrentCurrent", "BondPairGreens", "PhononGreens")


@dataclass(frozen=True)
class MeasurementSpec:
    """Static measurement configuration (from the [measurements] TOML table,
    SURVEY §5 'config system')."""

    nv: int = 10
    # kind -> (measure, time_dependent)
    onsite_corr: tuple = ()      # e.g. (("Greens", True), ("DenDen", True))
    intersite_corr: tuple = ()
    onsite_pairs: tuple | None = None      # orbital pairs; None = all
    intersite_pairs: tuple | None = None   # bond-definition pairs; None = all
    snapshots: tuple = ()        # subset of (density, double_occupancy, phonon_position)

    def __hash__(self):
        return hash((self.nv, self.onsite_corr, self.intersite_corr,
                     self.onsite_pairs, self.intersite_pairs, self.snapshots))


def _corr_pairs(n, explicit):
    if explicit is not None:
        return np.asarray(explicit, dtype=np.int64).reshape(-1, 2)
    return np.asarray([(i, j) for i in range(n) for j in range(n)], dtype=np.int64)


def _normalize_kinds(entries):
    """(kind, td[, pairs]) tuples -> {kind: (td, pairs_or_None)}."""
    out = {}
    for e in entries:
        kind, td = e[0], e[1]
        pairs = e[2] if len(e) > 2 else None
        out[kind] = (td, pairs)
    return out


def _container_shapes(ops: ModelOps, mspec: MeasurementSpec):
    """Shape dictionary of the accumulation container."""
    lat = ops.spec.lattice
    no = lat.unit_cell.norbits
    L1, L2, L3 = lat.L1, lat.L2, lat.L3
    Lt = ops.Ltau
    ndefs = len(ops.spec.bond_defs)

    shapes: dict[str, Any] = {
        "global": {"density": (), "Nsqr": (), "mu": ()},
    }
    onsite = {"density": (no,), "double_occ": (no,), "mu": (no,)}
    if ops.is_holstein:
        onsite.update({k: (no,) for k in ("x", "x2", "x4", "phonon_ke", "phonon_pe", "elph_energy")})
    shapes["onsite"] = onsite

    inter = {"el_ke": (ndefs,)}
    if not ops.is_holstein:
        inter.update({k: (ndefs,) for k in
                      ("x", "x2", "x4", "phonon_ke", "phonon_pe", "elph_energy", "sign_switch")})
    shapes["intersite"] = inter

    shapes["onsite_corr"] = {}
    for kind, (td, kp) in _normalize_kinds(mspec.onsite_corr).items():
        op = _corr_pairs(no, kp if kp is not None else mspec.onsite_pairs)
        shapes["onsite_corr"][kind] = (len(op), L1, L2, L3, (Lt + 1) if td else 1)
    shapes["intersite_corr"] = {}
    for kind, (td, kp) in _normalize_kinds(mspec.intersite_corr).items():
        if kind == "PhononGreens":
            # SSH bond phonons: pairs over phonon types (Measurements.jl:2497)
            ntypes = max(sum(1 for d in ops.spec.bond_defs if d[3]), 1)
            npair = len(_corr_pairs(ntypes, kp))
        else:
            npair = len(_corr_pairs(ndefs, kp if kp is not None else mspec.intersite_pairs))
        shapes["intersite_corr"][kind] = (npair, L1, L2, L3, (Lt + 1) if td else 1)
    return shapes


def zero_container(ops: ModelOps, mspec: MeasurementSpec, dtype=None):
    shapes = _container_shapes(ops, mspec)
    if dtype is None:
        from elphdynamics_tpu.utils.dtypes import default_real_dtype
        dtype = default_real_dtype()
    cdtype = jnp.complex128 if dtype == jnp.float64 else jnp.complex64

    def mk(group, complex_valued):
        return {k: jnp.zeros(v, cdtype if complex_valued else dtype)
                for k, v in group.items()}

    return {
        "global": mk(shapes["global"], False),
        "onsite": mk(shapes["onsite"], False),
        "intersite": mk(shapes["intersite"], False),
        "onsite_corr": mk(shapes["onsite_corr"], True),
        "intersite_corr": mk(shapes["intersite_corr"], True),
    }


# ---------------------------------------------------------------------------
# the measurement step
# ---------------------------------------------------------------------------

def make_measurement_step(ops: ModelOps, mspec: MeasurementSpec,
                          scfg: SolverConfig = SolverConfig(), precond=None):
    """Build ``(params, x, key) -> (increment_pytree, stats, key)``."""
    lat = ops.spec.lattice
    spec = ops.spec
    no = lat.unit_cell.norbits
    Lt = ops.Ltau
    nv = mspec.nv
    n_pairs = nv * (nv - 1) // 2
    ncells = lat.ncells
    norm_site = ncells * Lt   # per-orbital onsite normalisation (:938)
    site_orbit = jnp.asarray(lat.site_to_orbit)
    onsite_pairs = _corr_pairs(no, mspec.onsite_pairs)
    ndefs = len(spec.bond_defs)
    inter_pairs = _corr_pairs(ndefs, mspec.intersite_pairs)
    onsite_kinds = _normalize_kinds(mspec.onsite_corr)
    inter_kinds = _normalize_kinds(mspec.intersite_corr)

    def kind_pairs(kinds, kind, n, default):
        td, kp = kinds[kind]
        pairs = _corr_pairs(n, kp) if kp is not None else default
        return td, pairs

    def orbit_sum(field_site_tau):
        """Sum an [N, Lt] field into per-orbital totals [no]."""
        tot = jnp.sum(field_site_tau, axis=-1)
        return jnp.zeros(no, tot.dtype).at[site_orbit].add(tot)

    def analyze(params, x, gd):
        """Everything downstream of the nᵥ estimator solves — pure function
        of (params, x, GreensData); exposed as ``step.analyze`` so the
        site-sharded driver can run the solves through the sharded CG and
        only this stage on gathered fields."""
        R, MinvR = gd.R, gd.MinvR
        pt = G.pair_tensor_sums(lat, R, MinvR)
        out: dict[str, Any] = {"global": {}, "onsite": {}, "intersite": {},
                               "onsite_corr": {}, "intersite_corr": {}}

        # ---- per-vector diagonal estimates Gᵢ(s,τ) = (M⁻¹rᵢ·conj(rᵢ))(s,τ)
        # (conj is an identity on the real path). On the complex-hopping TRS
        # path the spin-summed density is 2 − 2·Re G exactly (the Im parts of
        # ↑ and ↓ = conj cancel), so the scalar estimators run on Re Gdiag;
        # double occupancy needs |1−G|² and keeps the complex field.
        cplx = jnp.iscomplexobj(R)
        Rp = jnp.conj(R) if cplx else R
        Gdiag_c = MinvR * Rp                    # [nv, N, Lt]
        Gdiag = jnp.real(Gdiag_c) if cplx else Gdiag_c
        TrG = jnp.sum(Gdiag, axis=(-2, -1)) / Lt  # [nv]
        N_per_vec = 2.0 * (spec.Nsites - TrG)     # ⟨N̂⟩ per vector (:1287-1288)

        # ---- global (:845-861)
        # density: Σ_{i<j}(nᵢ+nⱼ)/2 /N = (nv−1)/2·Σᵢnᵢ/N
        out["global"]["density"] = (nv - 1) / 2.0 * jnp.sum(N_per_vec) / spec.Nsites
        # ⟨N̂²⟩ (:1297-1312): Σ_{i<j}[NᵢNⱼ + TrG̃ᵢ + TrG̃ⱼ − 2(N/nₛ)ΣG0D(τ=0)]
        sumN = jnp.sum(N_per_vec)
        NN = (sumN ** 2 - jnp.sum(N_per_vec ** 2)) / 2.0
        g0d_sum = jnp.real(jnp.sum(pt.G0D_GD0[..., 0]))
        out["global"]["Nsqr"] = (NN + (nv - 1) * jnp.sum(TrG)
                                 - 2.0 * (spec.Nsites / no) * g0d_sum)
        out["global"]["mu"] = n_pairs * jnp.mean(params.mu)

        # ---- on-site (:916-1024)
        one_minus_G = 1.0 - Gdiag
        sum1mG = jnp.sum(one_minus_G, axis=0)     # Σᵢ(1−Gᵢ)  [N, Lt]
        dens_site = (nv - 1) * sum1mG             # Σpairs[(1−G₁)+(1−G₂)]
        # ⟨n↑n↓⟩ = Σpairs Re[(1−G₁)(1−conj G₂)] = (|Σ(1−G)|² − Σ|1−Gᵢ|²)/2 —
        # the real-path identity with |·|² in place of squares
        omg_c = 1.0 - Gdiag_c
        sum_c = jnp.sum(omg_c, axis=0)
        docc_site = (jnp.abs(sum_c) ** 2 - jnp.sum(jnp.abs(omg_c) ** 2,
                                                   axis=0)) / 2.0
        out["onsite"]["density"] = orbit_sum(dens_site) / norm_site
        out["onsite"]["double_occ"] = orbit_sum(docc_site) / norm_site
        mu_site = jnp.broadcast_to(params.mu[:, None], (spec.Nsites, Lt))
        out["onsite"]["mu"] = n_pairs * orbit_sum(mu_site) / norm_site

        if ops.is_holstein:
            dtau = spec.dtau
            dx = jnp.roll(x, -1, axis=-1) - x
            ke = 0.5 / dtau - dx ** 2 / (2 * dtau ** 2)
            pe = (params.omega ** 2)[:, None] * x ** 2 / 2 + params.omega4[:, None] * x ** 4
            out["onsite"]["x"] = n_pairs * orbit_sum(x) / norm_site
            out["onsite"]["x2"] = n_pairs * orbit_sum(x ** 2) / norm_site
            out["onsite"]["x4"] = n_pairs * orbit_sum(x ** 4) / norm_site
            out["onsite"]["phonon_ke"] = n_pairs * orbit_sum(ke) / norm_site
            out["onsite"]["phonon_pe"] = n_pairs * orbit_sum(pe) / norm_site
            # λ⟨x(n₊+n₋)⟩: Σpairs λx(2−G₁−G₂) = λx[2·n_pairs − (nv−1)ΣᵢGᵢ]
            lamx = params.lam[:, None] * x
            elph = lamx * (2.0 * n_pairs - (nv - 1) * jnp.sum(Gdiag, axis=0))
            out["onsite"]["elph_energy"] = orbit_sum(elph) / norm_site

        # ---- inter-site (:1029-1155)
        if spec.Nbonds == 0:
            # bond-free model (e.g. single site): emit empty containers so
            # the increment pytree always matches zero_container
            shapes = _container_shapes(ops, mspec)
            out["intersite"] = {k: jnp.zeros(v) for k, v in shapes["intersite"].items()}
        else:
            # sites of each original-order bond
            s1 = jnp.asarray(spec.ckb.neighbor_table[0][spec.bond_to_ckb])
            s2 = jnp.asarray(spec.ckb.neighbor_table[1][spec.bond_to_ckb])
            bdef = jnp.asarray(
                spec.bond_def_of_bond if ops.is_holstein else spec.bond_to_definition)
            # h(b,τ) per vector: G(s1,s2)+G(s2,s1); Σpairs h = −(nv−1)Σᵢ[...].
            # Complex path: conj probe + Re — each pair's (i→↑, j→↓)
            # assignment symmetrizes to the spin-summed 2·Re G per vector.
            est_12c = jnp.take(MinvR, s1, axis=-2) * jnp.take(Rp, s2, axis=-2)
            est_21c = jnp.take(MinvR, s2, axis=-2) * jnp.take(Rp, s1, axis=-2)
            est_12 = jnp.real(est_12c) if cplx else est_12c
            est_21 = jnp.real(est_21c) if cplx else est_21c
            h = -(nv - 1) * jnp.sum(est_12 + est_21, axis=0)   # [Nbonds, Lt]
            if ops.is_holstein:
                Vb = ncells * Lt                              # (:1041)
                if cplx:
                    # Hermitian pair −t·c†₂c₁ − t̄·c†₁c₂ per spin; the TRS
                    # ↓ spin carries the conjugate phases, so the spin-summed
                    # bond KE is 2·Re[t·G↑(1,2) + t̄·G↑(2,1)] — t pairs with
                    # the 1→2 propagator, t̄ with the reverse
                    ke_pair = jnp.real(params.t[:, None] * est_12c
                                       + jnp.conj(params.t)[:, None] * est_21c)
                    ke_b = (nv - 1) * jnp.sum(ke_pair, axis=0)
                else:
                    ke_b = -params.t[:, None] * h             # Σpairs −t·h
                out["intersite"]["el_ke"] = (
                    jnp.zeros(ndefs).at[bdef].add(jnp.sum(ke_b, axis=-1)) / Vb)
            else:
                from elphdynamics_tpu.models import ssh as Sm
                # Per-definition normalisation volume. The reference uses
                # V = div(Nbonds, nbonds)·Lτ (Measurements.jl:1094), which
                # implicitly assumes every bond definition contributes the
                # same bond count; we compute the TRUE per-definition count
                # instead (identical for every stock lattice, where counts
                # are equal; correct where the reference would mis-normalise
                # a mixed/deduped case — divergence documented in
                # docs/parity.md)
                def_counts = np.bincount(
                    np.asarray(spec.bond_to_definition), minlength=ndefs)
                Vb = jnp.asarray(np.maximum(def_counts, 1) * Lt,
                                 dtype=x.dtype)               # [ndefs]
                tp = Sm.hopping_t_prime(spec, params, x)      # [Nbonds, Lt]
                if cplx:
                    # twisted SSH: the full amplitude is t_phase·t′ per
                    # (bond, τ); same Hermitian-pair Re structure as the
                    # Holstein complex branch above
                    tf = params.t_phase[:, None] * tp
                    ke_pair = jnp.real(tf * est_12c
                                       + jnp.conj(tf) * est_21c)
                    ke_b = (nv - 1) * jnp.sum(ke_pair, axis=0)
                else:
                    ke_b = -tp * h
                out["intersite"]["el_ke"] = (
                    jnp.zeros(ndefs).at[bdef].add(jnp.sum(ke_b, axis=-1)) / Vb)
                # phonon-carrying bonds (:1127-1148)
                has_ph = jnp.asarray(spec.bond_to_phonon >= 0)
                php = jnp.asarray(np.maximum(spec.bond_to_phonon, 0))
                xb = jnp.take(x, php, axis=-2)                # [Nbonds, Lt]
                om = params.omega[php][:, None]
                al = params.alpha[php][:, None]
                dxb = jnp.roll(xb, -1, axis=-1) - xb
                mask = has_ph[:, None]

                def acc(v):
                    return jnp.zeros(ndefs).at[bdef].add(
                        jnp.sum(jnp.where(mask, v, 0.0), axis=-1)) / Vb

                out["intersite"]["phonon_pe"] = n_pairs * acc(om ** 2 * xb ** 2 / 2)
                out["intersite"]["phonon_ke"] = n_pairs * acc(
                    0.5 / spec.dtau - dxb ** 2 / (2 * spec.dtau ** 2))
                out["intersite"]["elph_energy"] = acc(al * h * xb)
                out["intersite"]["x"] = n_pairs * acc(xb)
                out["intersite"]["x2"] = n_pairs * acc(xb ** 2)
                out["intersite"]["x4"] = n_pairs * acc(xb ** 4)
                switch = (jnp.sign(params.t[:, None]) != jnp.sign(tp)).astype(x.dtype)
                out["intersite"]["sign_switch"] = n_pairs * acc(switch)

        # ---- on-site correlations (:1466-1650)
        if onsite_kinds:
            def oslices(pairs_arr):
                """Common per-pair tensors for a given orbital-pair list."""
                o1 = pairs_arr[:, 0]
                o2 = pairs_arr[:, 1]
                d = {
                    "o1": o1, "o2": o2,
                    "Gp": pt.G[o2, o1],             # [np, L1, L2, L3, 2Lt]
                    "GGp": pt.GG[o2, o1],
                    "GDDp": pt.GDD_G00[o2, o1],
                    "G0Dp": pt.G0D_GD0[o2, o1],
                    "G_o2o2_00": pt.G[o2, o2, 0, 0, 0, 0][:, None, None, None],
                    "G_o1o1_00": pt.G[o1, o1, 0, 0, 0, 0][:, None, None, None],
                    "G_o2o1_00": pt.G[o2, o1, 0, 0, 0, 0][:, None, None, None],
                }
                same_orb = jnp.asarray(o1 == o2)[:, None, None, None]
                delta_r = jnp.zeros(d["Gp"].shape[1:4]).at[0, 0, 0].set(1.0)[None]
                d["delta"] = same_orb * delta_r   # δᵣ·δ(o₁,o₂) [np, L1, L2, L3]
                return d

            def tslice(A, with_beta):
                """[np, l..., 2Lt] -> [np, l..., Lt(+1)] with τ=β = τ=0."""
                if not with_beta:
                    return A[..., :1]
                return jnp.concatenate([A[..., :Lt], A[..., :1]], axis=-1)

            if "Greens" in onsite_kinds:
                td, kp = kind_pairs(onsite_kinds, "Greens", no, onsite_pairs)
                sl = oslices(kp)
                main = sl["Gp"][..., :Lt] if td else sl["Gp"][..., :1]
                if td:
                    # G(β) = δᵣ − G(0) (:1475-1478), per-pair sum: δ → n_pairs·δ
                    beta_slice = (n_pairs * sl["delta"] - sl["Gp"][..., 0])[..., None]
                    main = jnp.concatenate([main, beta_slice], axis=-1)
                out["onsite_corr"]["Greens"] = main

            if "DenDen" in onsite_kinds:
                td, kp = kind_pairs(onsite_kinds, "DenDen", no, onsite_pairs)
                sl = oslices(kp)
                delta_t0 = jnp.zeros(2 * Lt).at[0].set(1.0)
                # δᵣδτ·Gᵣ₀τ0 term uses the already pair-summed G_o2o1_00
                dd = 4.0 * (n_pairs - sl["G_o2o2_00"][..., None]
                            - sl["G_o1o1_00"][..., None]
                            + sl["GDDp"]
                            + 0.5 * (sl["delta"][..., None] * delta_t0
                                     * sl["G_o2o1_00"][..., None]
                                     - sl["G0Dp"]))
                out["onsite_corr"]["DenDen"] = tslice(dd, td)

            if "SpinSpin" in onsite_kinds:
                td, kp = kind_pairs(onsite_kinds, "SpinSpin", no, onsite_pairs)
                sl = oslices(kp)
                delta_t0 = jnp.zeros(2 * Lt).at[0].set(1.0)
                ss = (-2.0 * sl["G0Dp"]
                      + 2.0 * sl["delta"][..., None] * delta_t0
                      * sl["G_o2o1_00"][..., None])
                if pt.GDD_minus is not None:
                    # TRS-twist direct term: per configuration
                    # n↑ − n↓ = −2i·Im G↑, so ⟨SzΔSz0⟩ gains
                    # −4·⟨ImGΔΔ·ImG00⟩ = +4·GDD_minus (zero for real hopping)
                    ss = ss + 4.0 * pt.GDD_minus[sl["o2"], sl["o1"]]
                if td:
                    # τ=β: swapped orbitals, negated displacement (:1512-1521)
                    o1, o2 = sl["o1"], sl["o2"]
                    G0D_sw = pt.G0D_GD0[o1, o2]
                    neg = G._neg_index(G0D_sw[..., 0], (-3, -2, -1))
                    G_sw_00 = pt.G[o1, o2, 0, 0, 0, 0][:, None, None, None]
                    beta = -2.0 * neg + 2.0 * sl["delta"] * G_sw_00
                    if pt.GDD_minus is not None:
                        beta = beta + 4.0 * G._neg_index(
                            pt.GDD_minus[o1, o2][..., 0], (-3, -2, -1))
                    ss = jnp.concatenate([ss[..., :Lt], beta[..., None]], axis=-1)
                else:
                    ss = ss[..., :1]
                out["onsite_corr"]["SpinSpin"] = ss

            if "PairGreens" in onsite_kinds:
                td, kp = kind_pairs(onsite_kinds, "PairGreens", no, onsite_pairs)
                sl = oslices(kp)
                pg = sl["GGp"]
                if td:
                    beta = sl["GGp"][..., 0] + sl["delta"] * (
                        n_pairs - 2.0 * jnp.real(sl["G_o1o1_00"]))
                    pg = jnp.concatenate([pg[..., :Lt], beta[..., None]], axis=-1)
                else:
                    pg = pg[..., :1]
                out["onsite_corr"]["PairGreens"] = pg

            if "PhononGreens" in onsite_kinds and ops.is_holstein:
                td, kp = kind_pairs(onsite_kinds, "PhononGreens", no, onsite_pairs)
                xc = G.to_cell_layout(lat, x)     # [no, L1, L2, L3, Lt]
                xx = G.translational_average(xc[kp[:, 0]].astype(jnp.complex128),
                                             xc[kp[:, 1]].astype(jnp.complex128))
                xx = n_pairs * xx
                if td:
                    xx = jnp.concatenate([xx, xx[..., :1]], axis=-1)
                else:
                    xx = xx[..., :1]
                out["onsite_corr"]["PhononGreens"] = xx

        # ---- inter-site correlations (:1656-2541)
        if inter_kinds:
            inter = {}
            if "PhononGreens" in inter_kinds and not ops.is_holstein:
                # SSH bond-phonon Green's function (:2488-2541)
                ntypes = max(sum(1 for d in spec.bond_defs if d[3]), 1)
                td, ppairs = kind_pairs(inter_kinds, "PhononGreens", ntypes, 
                                        _corr_pairs(ntypes, None))
                per_type = ops.Nph // ntypes
                L1, L2, L3 = lat.L1, lat.L2, lat.L3
                if per_type != lat.ncells:
                    raise ValueError(
                        "SSH PhononGreens needs one phonon per unit cell per "
                        "type (bond dedup on tiny lattices breaks this — same "
                        "contract as the reference, Measurements.jl:2508)")
                xt = x.reshape(ntypes, per_type, Lt)
                xt = xt.reshape(ntypes, L3, L2, L1, Lt).transpose(0, 3, 2, 1, 4)
                x1 = xt[ppairs[:, 0]].astype(jnp.complex128)
                x2 = xt[ppairs[:, 1]].astype(jnp.complex128)
                xx = n_pairs * G.translational_average(x2, x1)
                if td:
                    xx = jnp.concatenate([xx, xx[..., :1]], axis=-1)
                else:
                    xx = xx[..., :1]
                inter["PhononGreens"] = xx
            rest = {k: v for k, v in inter_kinds.items()
                    if k != "PhononGreens" or ops.is_holstein}
            if rest:
                inter.update(_intersite_correlations(
                    ops, params, x, R, MinvR, pt, rest, inter_pairs))
            out["intersite_corr"] = inter

        # ---- snapshots (:1349-1460): per-site instantaneous estimates
        snaps = {}
        if "density" in mspec.snapshots or "double_occupancy" in mspec.snapshots:
            Gsite = jnp.mean(Gdiag_c, axis=(0, -1))    # per-site ⟨c c†⟩
            if "density" in mspec.snapshots:
                snaps["density"] = 2.0 * (1.0 - jnp.real(Gsite))
            if "double_occupancy" in mspec.snapshots:
                snaps["double_occupancy"] = jnp.abs(1.0 - Gsite) ** 2
        if "phonon_position" in mspec.snapshots:
            snaps["phonon_position"] = jnp.mean(x, axis=-1)
        stats = {"iters": gd.iters, "flag": gd.flag}
        return out, stats, snaps

    def step(params, x, key):
        gd, key = G.sample_greens(ops, params, x, key, nv, scfg, precond)
        out, stats, snaps = analyze(params, x, gd)
        return out, stats, snaps, key

    step.analyze = analyze
    return step


def _intersite_correlations(ops, params, x, R, MinvR, pt, kinds, pairs):
    """Bond-pair correlation functions (BondBond, CurrentCurrent,
    BondPairGreens) — see measure/intersite_corr.py. ``kinds`` maps
    kind -> (time_dependent, pairs_or_None)."""
    from elphdynamics_tpu.measure import intersite_corr as IC

    nv = R.shape[0]
    n_pairs = nv * (nv - 1) // 2
    ndefs = len(ops.spec.bond_defs)
    bf = IC.BondFields(ops.spec.lattice, R, MinvR, G.pair_indices(nv))

    def bp(kind):
        td, kp = kinds[kind]
        arr = _corr_pairs(ndefs, kp) if kp is not None else pairs
        return td, [tuple(p) for p in np.asarray(arr)]

    out = {}
    if "BondBond" in kinds:
        td, bond_pairs = bp("BondBond")
        out["BondBond"] = IC.measure_bondbond(ops, pt, bf, bond_pairs, td)
    if "CurrentCurrent" in kinds:
        td, bond_pairs = bp("CurrentCurrent")
        out["CurrentCurrent"] = IC.measure_currentcurrent(
            ops, params, x, pt, bf, bond_pairs, td)
    if "BondPairGreens" in kinds:
        td, bond_pairs = bp("BondPairGreens")
        out["BondPairGreens"] = IC.measure_bondpairgreens(
            ops, pt, bf, bond_pairs, td, n_pairs)
    return out


# ---------------------------------------------------------------------------
# bin post-processing (:574-676)
# ---------------------------------------------------------------------------

def process_bin(ops: ModelOps, mspec: MeasurementSpec, container, bin_size: int):
    """Normalise, momentum-transform, and compute susceptibilities.

    Returns a dict with position/momentum correlations and susceptibilities;
    runs on device, called once per bin.
    """
    nv = mspec.nv
    V = bin_size * (nv * (nv - 1) // 2)
    out = {
        "global": {k: v / V for k, v in container["global"].items()},
        "onsite": {k: v / V for k, v in container["onsite"].items()},
        "intersite": {k: v / V for k, v in container["intersite"].items()},
        "onsite_corr": {},
        "intersite_corr": {},
        "onsite_susc": {},
        "intersite_susc": {},
    }

    susc_map = {"PairGreens": "PairSusc", "DenDen": "ChargeSusc",
                "SpinSpin": "SpinSusc", "BondPairGreens": "BondPairSusc"}

    for group, sgroup in (("onsite_corr", "onsite_susc"),
                          ("intersite_corr", "intersite_susc")):
        for kind, pos in container[group].items():
            pos = pos / V
            mom = jnp.fft.fftn(pos, axes=(1, 2, 3))
            out[group][kind] = {"position": pos, "momentum": mom}
            if kind in susc_map and pos.shape[-1] > 1:
                # ∫₀^β dτ C(τ) by Simpson (:2550-2572); τ axis is last
                sp = simpson(jnp.moveaxis(pos, -1, 0), ops.dtau)
                sm = simpson(jnp.moveaxis(mom, -1, 0), ops.dtau)
                out[sgroup][susc_map[kind]] = {"position": sp, "momentum": sm}
    return out
