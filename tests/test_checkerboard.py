import jax.numpy as jnp
import numpy as np

from elphdynamics_tpu.lattice import Lattice, UnitCell, sort_neighbor_table
from elphdynamics_tpu.ops.checkerboard import (
    build_checkerboard_spec,
    checkerboard_groups,
    ckb_inverse_mul,
    ckb_inverse_transpose_mul,
    ckb_matrix,
    ckb_mul,
    ckb_transpose_mul,
)
from dense_reference import dense_expK


def make_square_spec(L=4, dtau=0.1, t=1.0, seed=0):
    uc = UnitCell.create(2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
    lat = Lattice.create(uc, L)
    tx = lat.calc_neighbor_table(0, 0, (1, 0, 0))
    ty = lat.calc_neighbor_table(0, 0, (0, 1, 0))
    table = np.concatenate([tx, ty], axis=1)
    table_sorted, perm = sort_neighbor_table(table)
    rng = np.random.default_rng(seed)
    tvals = t + 0.1 * rng.standard_normal(table.shape[1])
    spec = build_checkerboard_spec(lat.nsites, table_sorted)
    t_ckb = tvals[perm][spec.order]
    cosh_b = np.cosh(dtau * t_ckb)
    sinh_b = np.sinh(dtau * t_ckb)
    return spec, cosh_b, sinh_b


def test_groups_disjoint():
    spec, _, _ = make_square_spec()
    for g in range(spec.ngroups):
        bonds = spec.neighbor_table[:, spec.groups == g]
        sites = bonds.reshape(-1)
        assert len(set(sites.tolist())) == len(sites)


def test_groups_greedy_matches_bruteforce():
    table = np.array([[0, 0, 1, 2], [1, 2, 3, 3]])
    groups = checkerboard_groups(table)
    # bond0 (0,1)->g0; bond1 (0,2) overlaps bond0 at 0 -> g1;
    # bond2 (1,3) overlaps bond0 at 1 -> joins g1; bond3 (2,3) overlaps -> g2? check:
    # g0 pass: bond0 in, bond1 blocked(0), bond2 blocked(1), bond3 in (2,3 free)
    assert groups[0] == 0 and groups[3] == 0
    assert groups[1] == 1 and groups[2] == 1


def test_ckb_mul_matches_dense():
    spec, cosh_b, sinh_b = make_square_spec()
    D = dense_expK(spec.nsites, spec.neighbor_table, spec.groups, cosh_b, sinh_b)
    got = ckb_matrix(spec, cosh_b, sinh_b)
    assert np.allclose(got, D, atol=1e-13)


def test_ckb_transpose_matches_dense_T():
    spec, cosh_b, sinh_b = make_square_spec()
    D = dense_expK(spec.nsites, spec.neighbor_table, spec.groups, cosh_b, sinh_b)
    got = ckb_matrix(spec, cosh_b, sinh_b, transpose=True)
    assert np.allclose(got, D.T, atol=1e-13)


def test_ckb_inverse_roundtrip():
    spec, cosh_b, sinh_b = make_square_spec()
    rng = np.random.default_rng(1)
    v = rng.standard_normal((spec.nsites, 8))
    y = ckb_mul(spec, cosh_b, sinh_b, v)
    back = ckb_inverse_mul(spec, cosh_b, sinh_b, y)
    assert np.allclose(back, v, atol=1e-12)
    y = ckb_transpose_mul(spec, cosh_b, sinh_b, v)
    back = ckb_inverse_transpose_mul(spec, cosh_b, sinh_b, y)
    assert np.allclose(back, v, atol=1e-12)


def test_ckb_time_dependent_coeffs():
    """Per-(bond, τ) coefficients (SSH form) applied slice by slice match
    single-slice applications."""
    spec, cosh_b, sinh_b = make_square_spec()
    L = 6
    rng = np.random.default_rng(2)
    tvals = 1.0 + 0.05 * rng.standard_normal((spec.nbonds, L))
    cB = np.cosh(0.1 * tvals)
    sB = np.sinh(0.1 * tvals)
    v = rng.standard_normal((spec.nsites, L))
    out = np.asarray(ckb_mul(spec, cB, sB, v))
    for tau in range(L):
        ref = np.asarray(ckb_mul(spec, cB[:, tau], sB[:, tau], v[:, tau : tau + 1]))
        assert np.allclose(out[:, tau : tau + 1], ref, atol=1e-13)


def test_ckb_batched():
    spec, cosh_b, sinh_b = make_square_spec()
    rng = np.random.default_rng(3)
    v = rng.standard_normal((3, spec.nsites, 5))
    out = np.asarray(ckb_mul(spec, cosh_b, sinh_b, v))
    for b in range(3):
        ref = np.asarray(ckb_mul(spec, cosh_b, sinh_b, v[b]))
        assert np.allclose(out[b], ref)


def test_ckb_approximates_matrix_exponential():
    """The checkerboard product approximates exp(-Δτ·K) to O(Δτ²)."""
    import scipy.linalg  # available? fall back to eigh if not

    spec, _, _ = make_square_spec(L=4)
    # uniform t=1 for clean comparison
    dtau = 0.05
    cosh_b = np.full(spec.nbonds, np.cosh(dtau))
    sinh_b = np.full(spec.nbonds, np.sinh(dtau))
    K = np.zeros((spec.nsites, spec.nsites))
    for n in range(spec.nbonds):
        i, j = spec.neighbor_table[:, n]
        K[i, j] = -1.0
        K[j, i] = -1.0
    exact = scipy.linalg.expm(-dtau * K)
    approx = ckb_matrix(spec, cosh_b, sinh_b)
    assert np.max(np.abs(approx - exact)) < 5 * dtau ** 2
