"""Checkerboard decomposition of the hopping-matrix exponential.

The reference (Checkerboard.jl) applies ``exp(-Δτ·K)`` matrix-free as an
ordered product of 2×2 bond rotations ``[c s; s̄ c]``, looping over bonds with
an inner SIMD loop over imaginary time (Checkerboard.jl:57-121). Bonds are
greedily grouped into sweeps of mutually disjoint bonds
(Checkerboard.jl:471-515).

Formulation: within one group every site appears in at most one
bond, so the group's action is, for the whole ``[N, Lτ]`` space-time block,

    y  <-  c_site * y + s_site * y[partner, :]

where ``partner`` is a static involutive permutation of sites (identity for
untouched sites), and ``c_site/s_site`` are per-site coefficients gathered
from per-bond tables. A full multiply is a short unrolled fold over the
(few, static) groups — pure gathers + fused multiply-adds that XLA maps onto
fused elementwise loops with no scalar loops.

* transpose  = reversed group order (Checkerboard.jl:149-230)
* inverse    = reversed order with the sign of ``s`` flipped (Checkerboard.jl:238-316)
* inverse-transpose = forward order, flipped sign (Checkerboard.jl:323-401)

Coefficients may be per-bond ``[Nb]`` (Holstein: time-independent hopping,
HolsteinModels.jl:103-110), per-bond-and-time ``[Nb, Lτ]`` (SSH: phonon-
modulated hopping, SSHModels.jl:179-185), applied to fields ``[N]`` (single
slice, used by the KPM preconditioner) or ``[N, Lτ]``.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np


def checkerboard_groups(neighbor_table: np.ndarray) -> np.ndarray:
    """Greedy grouping of bonds into mutually disjoint sweeps.

    Same algorithm as the reference (Checkerboard.jl:471-515): walk bonds in
    (sorted) order, assigning each to the first group in which it shares no
    site with an earlier member. Returns 0-based group ids per bond.
    Dispatches to the native C++ implementation when available
    (native/checkerboard_native.cpp).
    """
    from elphdynamics_tpu import native

    ng = native.checkerboard_groups(neighbor_table)
    if ng is not None:
        return ng
    nb = neighbor_table.shape[1]
    groups = np.full(nb, -1, dtype=np.int64)
    group = -1
    nassigned = 0
    while nassigned < nb:
        group += 1
        occupied: set[int] = set()
        for n in range(nb):
            if groups[n] >= 0:
                continue
            i, j = int(neighbor_table[0, n]), int(neighbor_table[1, n])
            if i in occupied or j in occupied:
                continue
            groups[n] = group
            occupied.add(i)
            occupied.add(j)
            nassigned += 1
    return groups


@dataclass(frozen=True)
class CheckerboardSpec:
    """Static (host, numpy) description of the checkerboard decomposition.

    ``partner[g]`` is the involutive site permutation of group ``g``;
    ``bond_of_site[g]`` maps each site to the bond index supplying its
    coefficients (0 for untouched sites, which are masked);
    ``is_lo[g]`` marks the first endpoint of each bond (receives ``s``,
    the second endpoint receives ``conj(s)``);
    ``order`` is the bond permutation putting caller bond arrays into
    sorted-then-grouped order (i.e. ``coeffs_sorted = coeffs[order]``).
    """

    nsites: int
    nbonds: int
    ngroups: int
    # (ngroups, nsites) arrays
    partner: np.ndarray
    bond_of_site: np.ndarray
    mask: np.ndarray
    is_lo: np.ndarray
    # bond bookkeeping
    neighbor_table: np.ndarray  # (2, nbonds) in checkerboard (grouped) order
    order: np.ndarray  # (nbonds,) original-bond-index -> position not needed; see below
    groups: np.ndarray  # (nbonds,) group id per bond (in checkerboard order)

    def __hash__(self):  # allow use as a static argument
        return hash((self.nsites, self.nbonds, self.ngroups,
                     self.neighbor_table.tobytes(), self.groups.tobytes()))

    def __eq__(self, other):
        return (
            isinstance(other, CheckerboardSpec)
            and self.nsites == other.nsites
            and np.array_equal(self.neighbor_table, other.neighbor_table)
            and np.array_equal(self.groups, other.groups)
        )


def build_checkerboard_spec(nsites: int, neighbor_table: np.ndarray) -> CheckerboardSpec:
    """Build the group/permutation representation.

    ``neighbor_table`` is (2, nbonds) in *canonically sorted* order (see
    ``lattice.sort_neighbor_table``). The returned ``order`` array maps
    sorted-bond-order coefficient arrays into checkerboard order:
    ``coeffs_ckb = coeffs_sorted[order]``.
    """
    neighbor_table = np.asarray(neighbor_table, dtype=np.int64)
    nb = neighbor_table.shape[1]
    groups_sorted = checkerboard_groups(neighbor_table)
    order = np.argsort(groups_sorted, kind="stable")
    table = neighbor_table[:, order]
    groups = groups_sorted[order]
    ngroups = int(groups.max()) + 1 if nb > 0 else 0

    partner = np.tile(np.arange(nsites, dtype=np.int64), (max(ngroups, 1), 1))
    bond_of_site = np.zeros((max(ngroups, 1), nsites), dtype=np.int64)
    mask = np.zeros((max(ngroups, 1), nsites), dtype=bool)
    is_lo = np.zeros((max(ngroups, 1), nsites), dtype=bool)
    for n in range(nb):
        g = groups[n]
        i, j = table[0, n], table[1, n]
        assert not mask[g, i] and not mask[g, j], "bonds within a group must be disjoint"
        partner[g, i] = j
        partner[g, j] = i
        bond_of_site[g, i] = n
        bond_of_site[g, j] = n
        mask[g, i] = True
        mask[g, j] = True
        is_lo[g, i] = True
    return CheckerboardSpec(
        nsites=nsites,
        nbonds=nb,
        ngroups=ngroups,
        partner=partner,
        bond_of_site=bond_of_site,
        mask=mask,
        is_lo=is_lo,
        neighbor_table=table,
        order=order,
        groups=groups,
    )


def _group_coeffs(spec: CheckerboardSpec, g: int, cosh_b, sinh_b):
    """Per-site (c, s) coefficient arrays for group ``g``.

    ``cosh_b/sinh_b`` are in checkerboard order, shape [Nb] (time-independent)
    or [Nb, Lτ]. Returns [N, 1] or [N, Lτ] arrays broadcastable against an
    ``[..., N, K]`` field (sites always on axis -2).
    """
    bos = spec.bond_of_site[g]
    m = spec.mask[g][:, None]
    c = jnp.asarray(cosh_b)[bos]
    s = jnp.asarray(sinh_b)[bos]
    if c.ndim == 1:
        c = c[:, None]
        s = s[:, None]
    if jnp.iscomplexobj(s):
        # complex hopping (Peierls phase / twisted BC): the 2×2 bond block
        # is the Hermitian [c, s; s̄, c] — the first endpoint receives s,
        # the second conj(s) (Checkerboard.jl:78,116,137). Each block being
        # Hermitian, the reversed-order "transpose" fold is exactly the
        # adjoint exp(−Δτ·K)†.
        lo = spec.is_lo[g][:, None]
        s = jnp.where(lo, s, jnp.conj(s))
    c = jnp.where(m, c, jnp.ones((), dtype=c.dtype))
    s = jnp.where(m, s, jnp.zeros((), dtype=s.dtype))
    return c, s


def _apply_groups(spec: CheckerboardSpec, cosh_b, sinh_b, v, group_order, sign):
    """Fold the group rotations over ``v`` with sites on axis -2.

    ``v`` is ``[..., N, K]`` — K is the imaginary-time axis for space-time
    fields, or an arbitrary batch of single-slice vectors (e.g. the KPM
    preconditioner's frequency columns). ``sign=+1`` applies each group,
    ``sign=-1`` its inverse (cosh is even, sinh odd in the hopping: flipping
    the sign of ``s`` inverts the 2×2 rotation exactly,
    Checkerboard.jl:258-259).
    """
    v = jnp.asarray(v)
    if v.shape[-2] != spec.nsites:
        raise ValueError(f"site axis (-2) must have size {spec.nsites}, got {v.shape}")
    for g in group_order:
        c, s = _group_coeffs(spec, g, cosh_b, sinh_b)
        if sign < 0:
            s = -s
        vp = jnp.take(v, jnp.asarray(spec.partner[g]), axis=-2)
        v = c * v + s * vp
    return v


def ckb_mul(spec: CheckerboardSpec, cosh_b, sinh_b, v):
    """``y = exp(-Δτ·K)·v`` (Checkerboard.jl:57-121): groups in forward order."""
    return _apply_groups(spec, cosh_b, sinh_b, v, range(spec.ngroups), +1)


def ckb_transpose_mul(spec: CheckerboardSpec, cosh_b, sinh_b, v):
    """``y = exp(-Δτ·K)ᵀ·v`` (Checkerboard.jl:149-230): reversed group order."""
    return _apply_groups(spec, cosh_b, sinh_b, v, range(spec.ngroups - 1, -1, -1), +1)


def ckb_inverse_mul(spec: CheckerboardSpec, cosh_b, sinh_b, v):
    """``y = exp(+Δτ·K)·v`` (Checkerboard.jl:238-316): reversed order, -s."""
    return _apply_groups(spec, cosh_b, sinh_b, v, range(spec.ngroups - 1, -1, -1), -1)


def ckb_inverse_transpose_mul(spec: CheckerboardSpec, cosh_b, sinh_b, v):
    """``y = exp(+Δτ·K)ᵀ·v`` (Checkerboard.jl:323-401): forward order, -s."""
    return _apply_groups(spec, cosh_b, sinh_b, v, range(spec.ngroups), -1)


def ckb_matrix(spec: CheckerboardSpec, cosh_b, sinh_b, transpose: bool = False) -> np.ndarray:
    """Densified single-slice checkerboard matrix, for tests only
    (mirrors Checkerboard.jl:14-49's role as a testing densifier)."""
    eye = np.eye(spec.nsites)
    fn = ckb_transpose_mul if transpose else ckb_mul
    return np.asarray(fn(spec, cosh_b, sinh_b, eye))


def dense_matrix(spec: CheckerboardSpec, cosh_b, sinh_b, inverse: bool = False) -> np.ndarray:
    """The exact dense [N, N] matrix of the checkerboard product, assembled
    host-side in float64 from the same elementary 2×2 rotations.

    Fast path: for time-independent hopping the whole multi-group fold
    collapses to ONE constant matrix, so ``exp(−Δτ·K)·v`` becomes a single
    matmul instead of ``ngroups`` gather+FMA passes over HBM. The matrix
    equals the group-fold product bit-for-bit up to f64 rounding.
    """
    from elphdynamics_tpu import native

    is_complex = np.iscomplexobj(cosh_b) or np.iscomplexobj(sinh_b)
    ddtype = np.complex128 if is_complex else np.float64
    cosh_b = np.asarray(cosh_b, dtype=ddtype)
    sinh_b = np.asarray(sinh_b, dtype=ddtype)
    N = spec.nsites
    if not is_complex:
        nd = native.dense_matrix(spec.neighbor_table, N, cosh_b, sinh_b,
                                 inverse=inverse)
        if nd is not None:
            return nd
    D = np.eye(N, dtype=ddtype)
    order = range(spec.nbonds) if not inverse else range(spec.nbonds - 1, -1, -1)
    sgn = -1.0 if inverse else 1.0
    for n in order:
        i, j = spec.neighbor_table[0, n], spec.neighbor_table[1, n]
        c = cosh_b[n]
        s = sgn * sinh_b[n]
        ri = D[i].copy()
        rj = D[j].copy()
        # second endpoint takes conj(s) (Checkerboard.jl:78); identical to
        # the real path when s is real
        D[i] = c * ri + s * rj
        D[j] = c * rj + np.conj(s) * ri
    return D
