"""Spatial (site-axis) lattice sharding over a device mesh.

SURVEY §5's context-parallel analog: when ``N·Lτ`` outgrows one chip, shard
the **site** axis of the ``[N, Lτ]`` space-time fields over a 1-D mesh axis
``"site"`` and keep τ on-chip (the FFT axis of Fourier acceleration / KPM
stays local). The checkerboard group fold becomes a halo-exchange pattern:

* within a group every site couples to exactly one partner site; partners
  owned by a ring-adjacent shard are fetched with ``lax.ppermute`` (one
  collective permute per boundary-crossing group — x-direction groups of a
  row-blocked square lattice cross no boundary and need none);
* CG inner products reduce with ``psum`` over the site axis — the only
  all-reduce in the hot loop (SURVEY §5 "distributed backend");
* the diagonal ``exp(−Δτ·V)`` and the τ-shift of M are shard-local.

Prototype scope (asserted at plan time, not silently wrong):

* matrix-free group-fold checkerboard (the dense-matmul path would shard as a
  plain ``pjit`` matmul instead);
* equal contiguous site blocks, every bond connecting ring-adjacent blocks —
  true for the standard orbit-fastest row-major orderings of the square /
  cubic / honeycomb lattices sharded along their slowest axis.

Reference parity note: the reference has no distributed execution at all
(ElPhDynamics.jl:90-95); this component is new scope.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from elphdynamics_tpu.dynamics import hmc as _hmc
from elphdynamics_tpu.ops.checkerboard import CheckerboardSpec
from elphdynamics_tpu.utils.dtypes import fdot_fast


@dataclass(frozen=True)
class ShardPlan:
    """Host-side halo-exchange plan for one (CheckerboardSpec, D) pair.

    Per checkerboard group ``g`` and shard ``d`` (all numpy, built once):

    * ``send_next[g]``: [D, Hp_g] local row offsets each shard sends to its
      next ring neighbour (serving that neighbour's prev-halo);
    * ``send_prev[g]``: [D, Hn_g] offsets sent to the previous neighbour;
    * ``partner_local[g]``: [D, B] gather indices into the extended block
      ``[local B | prev halo Hp_g | next halo Hn_g]``;
    * ``bond_of_site[g]`` / ``mask[g]``: [D, B] per-shard coefficient tables;
    * ``is_lo[g]``: [D, B] first-endpoint marks — the complex-hopping
      (Peierls-phase / twisted-BC) fold applies ``conj(s)`` on the second
      endpoint of each Hermitian 2×2 bond block
      (ops/checkerboard.py:_group_coeffs; Checkerboard.jl:78,116,137).
    """

    D: int
    B: int
    axis: str
    ngroups: int
    hp: tuple
    hn: tuple
    send_next: tuple
    send_prev: tuple
    partner_local: tuple
    bond_of_site: tuple
    mask: tuple
    is_lo: tuple

    def __hash__(self):
        return hash((self.D, self.B, self.axis, self.ngroups, self.hp, self.hn))


def build_shard_plan(spec: CheckerboardSpec, D: int, axis: str = "site") -> ShardPlan:
    """Plan the halo exchanges for sharding ``spec``'s site axis over D blocks."""
    N = spec.nsites
    if N % D != 0:
        raise ValueError(f"nsites={N} not divisible by n_shards={D}")
    B = N // D

    hp, hn = [], []
    send_next, send_prev, partner_local, bos_l, mask_l = [], [], [], [], []
    is_lo_l = []
    for g in range(spec.ngroups):
        prev_need = [[] for _ in range(D)]
        next_need = [[] for _ in range(D)]
        for d in range(D):
            for i in range(d * B, (d + 1) * B):
                p = int(spec.partner[g][i])
                sp = p // B
                if sp == d:
                    continue
                if sp == (d - 1) % D:
                    prev_need[d].append(p)
                elif sp == (d + 1) % D:
                    next_need[d].append(p)
                else:
                    raise NotImplementedError(
                        f"bond reaches non-adjacent shard ({d}->{sp}); "
                        "order sites so bonds cross at most one block boundary")
        prev_need = [sorted(set(x)) for x in prev_need]
        next_need = [sorted(set(x)) for x in next_need]
        Hp = max((len(x) for x in prev_need), default=0)
        Hn = max((len(x) for x in next_need), default=0)

        pl = np.zeros((D, B), dtype=np.int64)
        for d in range(D):
            pos_prev = {p: B + k for k, p in enumerate(prev_need[d])}
            pos_next = {p: B + Hp + k for k, p in enumerate(next_need[d])}
            for li, i in enumerate(range(d * B, (d + 1) * B)):
                p = int(spec.partner[g][i])
                if p // B == d:
                    pl[d, li] = p - d * B
                elif p in pos_prev:
                    pl[d, li] = pos_prev[p]
                else:
                    pl[d, li] = pos_next[p]
        # pad needs with the neighbour's first row (dummy, never referenced)
        for d in range(D):
            prev_need[d] += [((d - 1) % D) * B] * (Hp - len(prev_need[d]))
            next_need[d] += [((d + 1) % D) * B] * (Hn - len(next_need[d]))
        sn = np.asarray([[p - d * B for p in prev_need[(d + 1) % D]]
                         for d in range(D)], dtype=np.int64).reshape(D, Hp)
        sp_ = np.asarray([[p - d * B for p in next_need[(d - 1) % D]]
                          for d in range(D)], dtype=np.int64).reshape(D, Hn)

        hp.append(Hp)
        hn.append(Hn)
        send_next.append(sn)
        send_prev.append(sp_)
        partner_local.append(pl)
        bos_l.append(spec.bond_of_site[g].reshape(D, B).copy())
        mask_l.append(spec.mask[g].reshape(D, B).copy())
        is_lo_l.append(spec.is_lo[g].reshape(D, B).copy())

    return ShardPlan(D=D, B=B, axis=axis, ngroups=spec.ngroups,
                     hp=tuple(hp), hn=tuple(hn),
                     send_next=tuple(send_next), send_prev=tuple(send_prev),
                     partner_local=tuple(partner_local),
                     bond_of_site=tuple(bos_l), mask=tuple(mask_l),
                     is_lo=tuple(is_lo_l))


def site_mesh(D: int, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    if len(devices) < D:
        raise RuntimeError(
            f"site_mesh needs {D} devices, found {len(devices)}. For virtual "
            "CPU devices set XLA_FLAGS=--xla_force_host_platform_device_count "
            "and JAX_PLATFORMS=cpu BEFORE the first jax use — the platform "
            "cannot be switched once a backend is initialised.")
    return Mesh(np.asarray(devices[:D]), axis_names=("site",))


@dataclass(frozen=True)
class WijPlan:
    """Halo plan for the dispersive ωᵢⱼ phonon coupling (PhononAction.jl's
    (xᵢ±xⱼ)² terms) under site sharding.

    Each pair ``k = (i, j, sign)`` is evaluated twice, once from each side:
    the i-side entry lives on i's shard (contributing ∂S/∂xᵢ and, alone, the
    action term), the j-side entry on j's shard (contributing ∂S/∂xⱼ). The
    remote partner row is fetched with the same one-ppermute-per-direction
    pattern as the checkerboard halos; pairs must connect ring-adjacent
    shards (asserted at plan time).

    All tables are [D, Kmax]-padded numpy with ``mask_*`` validity masks;
    ``row_*`` are local row offsets, ``ext_*`` index the extended block
    ``[local B | prev halo Hp | next halo Hn]``, ``k_*`` index the pair
    (→ ``params.wij`` / ``wij_sign``).
    """

    D: int
    B: int
    hp: int
    hn: int
    send_next: np.ndarray    # [D, Hp] local rows shipped to the next shard
    send_prev: np.ndarray    # [D, Hn] local rows shipped to the prev shard
    row_i: np.ndarray        # [D, Ki] i-side local rows
    ext_j: np.ndarray        # [D, Ki] extended index of the j partner
    k_i: np.ndarray          # [D, Ki] pair index
    mask_i: np.ndarray       # [D, Ki]
    row_j: np.ndarray        # [D, Kj] j-side local rows
    ext_i: np.ndarray        # [D, Kj] extended index of the i partner
    k_j: np.ndarray          # [D, Kj]
    mask_j: np.ndarray       # [D, Kj]

    def __hash__(self):
        return hash((self.D, self.B, self.hp, self.hn,
                     self.row_i.shape, self.row_j.shape))


def build_wij_plan(wij_table: np.ndarray, N: int, D: int) -> WijPlan | None:
    """Plan the halo exchange for the ωᵢⱼ pair list ``wij_table`` ([2, Nwij]
    site indices) under D contiguous site blocks. Returns None when there is
    no dispersion."""
    nw = wij_table.shape[1]
    if nw == 0:
        return None
    B = N // D

    # remote rows each shard needs, per ring direction
    prev_need = [[] for _ in range(D)]
    next_need = [[] for _ in range(D)]

    def need(d, p):
        sp = p // B
        if sp == d:
            return
        if sp == (d - 1) % D:
            if p not in prev_need[d]:
                prev_need[d].append(p)
        elif sp == (d + 1) % D:
            if p not in next_need[d]:
                next_need[d].append(p)
        else:
            raise NotImplementedError(
                f"wij pair reaches non-adjacent shard ({d}->{sp}); "
                "order sites so dispersion crosses at most one block boundary")

    side_i = [[] for _ in range(D)]   # (local_row, partner_global, k)
    side_j = [[] for _ in range(D)]
    for k in range(nw):
        i = int(wij_table[0, k])
        j = int(wij_table[1, k])
        di, dj = i // B, j // B
        side_i[di].append((i - di * B, j, k))
        need(di, j)
        side_j[dj].append((j - dj * B, i, k))
        need(dj, i)

    prev_need = [sorted(x) for x in prev_need]
    next_need = [sorted(x) for x in next_need]
    Hp = max((len(x) for x in prev_need), default=0)
    Hn = max((len(x) for x in next_need), default=0)

    def ext_of(d, p):
        if p // B == d:
            return p - d * B
        if p in prev_need[d]:
            return B + prev_need[d].index(p)
        return B + Hp + next_need[d].index(p)

    Ki = max((len(x) for x in side_i), default=0)
    Kj = max((len(x) for x in side_j), default=0)
    row_i = np.zeros((D, Ki), dtype=np.int64)
    ext_j = np.zeros((D, Ki), dtype=np.int64)
    k_i = np.zeros((D, Ki), dtype=np.int64)
    mask_i = np.zeros((D, Ki), dtype=bool)
    row_j = np.zeros((D, Kj), dtype=np.int64)
    ext_i = np.zeros((D, Kj), dtype=np.int64)
    k_j = np.zeros((D, Kj), dtype=np.int64)
    mask_j = np.zeros((D, Kj), dtype=bool)
    for d in range(D):
        for a, (r, p, k) in enumerate(side_i[d]):
            row_i[d, a] = r
            ext_j[d, a] = ext_of(d, p)
            k_i[d, a] = k
            mask_i[d, a] = True
        for a, (r, p, k) in enumerate(side_j[d]):
            row_j[d, a] = r
            ext_i[d, a] = ext_of(d, p)
            k_j[d, a] = k
            mask_j[d, a] = True

    # send tables: what shard d ships next = what shard d+1 needs from prev
    for d in range(D):
        prev_need[d] += [((d - 1) % D) * B] * (Hp - len(prev_need[d]))
        next_need[d] += [((d + 1) % D) * B] * (Hn - len(next_need[d]))
    send_next = np.asarray([[p - d * B for p in prev_need[(d + 1) % D]]
                            for d in range(D)], dtype=np.int64).reshape(D, Hp)
    send_prev = np.asarray([[p - d * B for p in next_need[(d - 1) % D]]
                            for d in range(D)], dtype=np.int64).reshape(D, Hn)

    return WijPlan(D=D, B=B, hp=Hp, hn=Hn,
                   send_next=send_next, send_prev=send_prev,
                   row_i=row_i, ext_j=ext_j, k_i=k_i, mask_i=mask_i,
                   row_j=row_j, ext_i=ext_i, k_j=k_j, mask_j=mask_j)


def _wij_extend(wplan: WijPlan, axis: str, x_loc):
    """Extended ``[B + Hp + Hn, Lτ]`` block with the dispersion halo rows."""
    d = lax.axis_index(axis)
    D = wplan.D
    parts = [x_loc]
    if wplan.hp > 0:
        rows = jnp.take(jnp.asarray(wplan.send_next), d, axis=0)
        parts.append(lax.ppermute(jnp.take(x_loc, rows, axis=-2), axis,
                                  [(i, (i + 1) % D) for i in range(D)]))
    if wplan.hn > 0:
        rows = jnp.take(jnp.asarray(wplan.send_prev), d, axis=0)
        parts.append(lax.ppermute(jnp.take(x_loc, rows, axis=-2), axis,
                                  [(i, (i - 1) % D) for i in range(D)]))
    return jnp.concatenate(parts, axis=-2) if len(parts) > 1 else x_loc


def wij_sb_local(wplan: WijPlan, axis: str, wij_vals, wij_sign, dtau, x_loc):
    """Local (pre-psum) ωᵢⱼ action contribution Δτ·Σ_k ω_k²(xᵢ±xⱼ)²/2,
    counted once per pair on the i-side shard (PhononAction.jl:33-44)."""
    d = lax.axis_index(axis)
    ext = _wij_extend(wplan, axis, x_loc)
    row = jnp.take(jnp.asarray(wplan.row_i), d, axis=0)
    pj = jnp.take(jnp.asarray(wplan.ext_j), d, axis=0)
    kk = jnp.take(jnp.asarray(wplan.k_i), d, axis=0)
    m = jnp.take(jnp.asarray(wplan.mask_i), d, axis=0)[:, None]
    sgn = jnp.take(jnp.asarray(wij_sign).astype(x_loc.dtype), kk)[:, None]
    w2 = (jnp.take(wij_vals, kk) ** 2)[:, None]
    pair = jnp.take(x_loc, row, axis=-2) + sgn * jnp.take(ext, pj, axis=-2)
    return dtau * jnp.sum(jnp.where(m, w2 * pair * pair / 2, 0.0))


def wij_dsb_local(wplan: WijPlan, axis: str, wij_vals, wij_sign, dtau,
                  x_loc, d_loc):
    """Add the ωᵢⱼ gradient to the local ∂Sb/∂x block: ∂/∂xᵢ = Δτ·ω²·pair on
    the i side, ∂/∂xⱼ = ±Δτ·ω²·pair on the j side (PhononAction.jl:158-187).
    Each side is evaluated on its owner shard — no remote scatter."""
    d = lax.axis_index(axis)
    ext = _wij_extend(wplan, axis, x_loc)
    sgn_all = jnp.asarray(wij_sign).astype(x_loc.dtype)

    def side(rows_t, ext_t, k_t, mask_t, from_j):
        row = jnp.take(jnp.asarray(rows_t), d, axis=0)
        pp = jnp.take(jnp.asarray(ext_t), d, axis=0)
        kk = jnp.take(jnp.asarray(k_t), d, axis=0)
        m = jnp.take(jnp.asarray(mask_t), d, axis=0)[:, None]
        sgn = jnp.take(sgn_all, kk)[:, None]
        w2 = (jnp.take(wij_vals, kk) ** 2)[:, None]
        mine = jnp.take(x_loc, row, axis=-2)
        theirs = jnp.take(ext, pp, axis=-2)
        # pair is always xᵢ + sgn·xⱼ
        pair = (theirs + sgn * mine) if from_j else (mine + sgn * theirs)
        g = dtau * w2 * pair
        if from_j:
            g = sgn * g
        return row, jnp.where(m, g, 0.0)

    ri, gi = side(wplan.row_i, wplan.ext_j, wplan.k_i, wplan.mask_i, False)
    rj, gj = side(wplan.row_j, wplan.ext_i, wplan.k_j, wplan.mask_j, True)
    d_loc = d_loc.at[..., ri, :].add(gi)
    d_loc = d_loc.at[..., rj, :].add(gj)
    return d_loc


# ---------------------------------------------------------------------------
# shard-local checkerboard fold with ppermute halos
# ---------------------------------------------------------------------------

def _group_coeffs(plan: ShardPlan, g: int, cosh_b, sinh_b, dtype):
    """Per-local-site (c, s) tables of group ``g``: [B, 1] for per-bond
    scalars (Holstein), [B, Lτ] for per-(bond,τ) coefficients (SSH)."""
    d = lax.axis_index(plan.axis)
    bos = jnp.take(jnp.asarray(plan.bond_of_site[g]), d, axis=0)       # [B]
    m = jnp.take(jnp.asarray(plan.mask[g]), d, axis=0)[:, None]
    c = jnp.asarray(cosh_b)[bos]
    s = jnp.asarray(sinh_b)[bos]
    if c.ndim == 1:
        c = c[:, None]
        s = s[:, None]
    if jnp.iscomplexobj(s):
        # complex hopping (Peierls phase / twisted BC): the 2×2 bond block is
        # the Hermitian [c, s; s̄, c] — the second endpoint receives conj(s)
        # (ops/checkerboard.py:_group_coeffs; Checkerboard.jl:78,116,137);
        # the reversed-order fold is then exactly the adjoint exp(−Δτ·K)†
        lo = jnp.take(jnp.asarray(plan.is_lo[g]), d, axis=0)[:, None]
        s = jnp.where(lo, s, jnp.conj(s))
    c = jnp.where(m, c, jnp.ones((), c.dtype))
    s = jnp.where(m, s, jnp.zeros((), s.dtype))
    return c, s


def _extend_group(plan: ShardPlan, g: int, v_loc):
    """``[local B | prev halo | next halo]`` extended block for group ``g``
    (one ppermute per boundary-crossing direction)."""
    d = lax.axis_index(plan.axis)
    D = plan.D
    parts = [v_loc]
    if plan.hp[g] > 0:
        rows = jnp.take(jnp.asarray(plan.send_next[g]), d, axis=0)
        parts.append(lax.ppermute(jnp.take(v_loc, rows, axis=-2), plan.axis,
                                  [(i, (i + 1) % D) for i in range(D)]))
    if plan.hn[g] > 0:
        rows = jnp.take(jnp.asarray(plan.send_prev[g]), d, axis=0)
        parts.append(lax.ppermute(jnp.take(v_loc, rows, axis=-2), plan.axis,
                                  [(i, (i - 1) % D) for i in range(D)]))
    return jnp.concatenate(parts, axis=-2) if len(parts) > 1 else v_loc


def _fold_local(plan: ShardPlan, cosh_b, sinh_b, v_loc, group_order, sign):
    """One checkerboard fold on the local ``[..., B, K]`` block; halo rows
    are fetched per boundary-crossing group with a single ppermute each."""
    d = lax.axis_index(plan.axis)
    for g in group_order:
        c, s = _group_coeffs(plan, g, cosh_b, sinh_b, v_loc.dtype)
        if sign < 0:
            s = -s
        ext = _extend_group(plan, g, v_loc)
        pl = jnp.take(jnp.asarray(plan.partner_local[g]), d, axis=0)   # [B]
        vp = jnp.take(ext, pl, axis=-2)
        v_loc = c * v_loc + s * vp
    return v_loc


def ckb_mul_local(plan, cosh_b, sinh_b, v_loc):
    return _fold_local(plan, cosh_b, sinh_b, v_loc, range(plan.ngroups), +1)


def ckb_transpose_mul_local(plan, cosh_b, sinh_b, v_loc):
    return _fold_local(plan, cosh_b, sinh_b, v_loc,
                       range(plan.ngroups - 1, -1, -1), +1)


def ckb_inverse_mul_local(plan, cosh_b, sinh_b, v_loc):
    return _fold_local(plan, cosh_b, sinh_b, v_loc,
                       range(plan.ngroups - 1, -1, -1), -1)


# ---------------------------------------------------------------------------
# sharded Holstein fermion matrix + CG (mulM structure: models/holstein.py,
# HolsteinModels.jl:569-684; CG: IterativeSolvers.jl:153-234)
# ---------------------------------------------------------------------------


def _holstein_kpm_ops(plan: ShardPlan, params):
    """Averaged-operator triple builder for the sharded Holstein KPM
    (constant hopping tables, per-solve τ-mean of exp(−Δτ·V))."""
    def ops_of(env_loc):
        expnV_bar = jnp.mean(env_loc, axis=-1)

        def mulA(v):
            return ckb_mul_local(plan, params.cosht, params.sinht,
                                 expnV_bar[:, None] * v)

        def mulA_T(v):
            return expnV_bar[:, None] * ckb_transpose_mul_local(
                plan, params.cosht, params.sinht, v)

        def mulA_inv(v):
            return ckb_inverse_mul_local(
                plan, params.cosht, params.sinht, v) / expnV_bar[:, None]

        return mulA, mulA_T, mulA_inv

    return ops_of


def _ssh_kpm_ops(plan: ShardPlan, expmu_loc):
    """Averaged-operator triple builder for the sharded SSH KPM (τ-means of
    the time-dependent coefficients; exp(+Δτμ) diagonal)."""
    def ops_of(env):
        cosh_b, sinh_b = env
        cosh_bar = jnp.mean(cosh_b, axis=-1)
        sinh_bar = jnp.mean(sinh_b, axis=-1)
        ex = expmu_loc(cosh_b.dtype)

        def mulA(v):
            return ckb_mul_local(plan, cosh_bar, sinh_bar, ex * v)

        def mulA_T(v):
            return ex * ckb_transpose_mul_local(plan, cosh_bar, sinh_bar, v)

        def mulA_inv(v):
            return ckb_inverse_mul_local(plan, cosh_bar, sinh_bar, v) / ex

        return mulA, mulA_T, mulA_inv

    return ops_of


def make_sharded_holstein_solver(model_spec, plan: ShardPlan, mesh: Mesh):
    """Build ``solve(params, env, b) -> (x, iters)`` solving MᵀM·x = Mᵀ·b with
    the site axis sharded over ``mesh``. ``env``/fields enter as full global
    arrays; shard_map partitions them as P('site', None).

    Everything inside runs SPMD: the fold's ppermute halos ride the mesh,
    CG dot products psum over 'site'.
    """
    Ltau = model_spec.Ltau

    def local_ops(params, env_loc):
        sgn_first = (-jnp.ones(Ltau, env_loc.dtype)).at[0].set(1.0)
        sgn_last = (-jnp.ones(Ltau, env_loc.dtype)).at[-1].set(1.0)

        def mulM(v):
            y = env_loc * jnp.roll(v, 1, axis=-1)
            y = ckb_mul_local(plan, params.cosht, params.sinht, y)
            return v + sgn_first * y

        def mulMT(v):
            z = ckb_transpose_mul_local(plan, params.cosht, params.sinht, v)
            w = env_loc * z
            return v + sgn_last * jnp.roll(w, -1, axis=-1)

        return mulM, mulMT

    def pdot(a, b):
        # Re(a†·b) on the complex-hopping path (utils/dtypes.fdot_fast):
        # the real Hermitian inner product under which M†M is SPD on ℝ²ⁿ
        return lax.psum(jnp.sum(fdot_fast(a, b, axis=(-2, -1))), plan.axis)

    def solve_local(params, env_loc, b_loc, tol, maxiter):
        mulM, mulMT = local_ops(params, env_loc)
        x, j, _ = _cg_local(lambda v: mulMT(mulM(v)), mulMT(b_loc), tol,
                            maxiter, pdot)
        return x, j

    def solve(params, env, b, tol=1e-5, maxiter=1000):
        fn = jax.shard_map(
            partial(solve_local, tol=tol, maxiter=maxiter),
            mesh=mesh,
            in_specs=(P(), P(plan.axis, None), P(plan.axis, None)),
            out_specs=(P(plan.axis, None), P()),
        )
        return fn(params, env, b)

    def mulM_sharded(params, env, v):
        def f(params, env_loc, v_loc):
            mulM, _ = local_ops(params, env_loc)
            return mulM(v_loc)

        return jax.shard_map(
            f, mesh=mesh,
            in_specs=(P(), P(plan.axis, None), P(plan.axis, None)),
            out_specs=P(plan.axis, None))(params, env, v)

    def mulMT_sharded(params, env, v):
        def f(params, env_loc, v_loc):
            _, mulMT = local_ops(params, env_loc)
            return mulMT(v_loc)

        return jax.shard_map(
            f, mesh=mesh,
            in_specs=(P(), P(plan.axis, None), P(plan.axis, None)),
            out_specs=P(plan.axis, None))(params, env, v)

    return solve, mulM_sharded, mulMT_sharded


# ---------------------------------------------------------------------------
# FULL lattice-sharded HMC update (Holstein). All cross-shard communication
# is the checkerboard halo ppermutes plus psum scalar reductions; every
# other piece of HMC.jl's update (Λ operators, phonon action, Fourier
# acceleration, leapfrog) is site-local. KPM preconditioning is not yet
# sharded — the CG runs unpreconditioned (the residual-checked ladder is
# unaffected); wij phonon dispersion is rejected at build time.
# ---------------------------------------------------------------------------

def _kpm_local(plan: ShardPlan, kcfg, Ltau, N, dtype, axis, ops_of,
               cplx: bool = False):
    """Sharded symmetric KPM preconditioner (ops/kpm.py math on local blocks).

    The τ↔ω transform is shard-local (τ on-chip); the Chebyshev recurrence's
    Ā applications use the halo fold; power-iteration norms psum over the
    site axis. ``ops_of(env_loc)`` builds the local averaged-operator
    triple ``(mulA, mulA_T, mulA_inv)`` for the current derived state
    (model-specific — Holstein folds the constant hopping, SSH the τ-mean of
    the time-dependent coefficients). Returns ``(setup, make_apply)``:
    ``setup(env_loc, key)`` runs once per sampler update (bounds +
    coefficients), ``make_apply(state, env_loc)`` binds the per-solve
    averaged-operator refresh.

    ``cplx=True`` is the complex-hopping (Peierls / twisted-BC) pipeline
    (ops/kpm.py:_apply_complex): the CG vectors have no conjugate symmetry,
    so the expansion covers the FULL Lτ spectrum and the recurrence runs on
    complex blocks (the halo ppermutes carry complex data); the power
    iteration draws complex probes and psums |w|² norms.
    """
    from elphdynamics_tpu.ops.kpm import (_cmul_halves, _from_half_stacked,
                                          _to_half_stacked)
    from elphdynamics_tpu.ops.timefreqfft import omega_to_tau, tau_to_omega

    use_dft = kcfg.use_dft(Ltau) if hasattr(kcfg, "use_dft") else False
    Lw = Ltau if cplx else (Ltau + 1) // 2
    M = kcfg.max_order
    phis = jnp.asarray(2.0 * np.pi / Ltau * (np.arange(Lw) + 0.5), dtype)
    NM = 2 * M
    theta_n = (np.arange(NM) + 0.5) * np.pi / NM
    nodes = jnp.asarray(np.cos(theta_n), dtype)
    cosmat = jnp.asarray(np.cos(np.outer(np.arange(M), theta_n)), dtype)
    scale = jnp.asarray(np.where(np.arange(M) == 0, 1.0, 2.0), dtype)[:, None] / NM
    B = plan.B
    pdtype = dtype
    if cplx:
        pdtype = (jnp.complex128 if jnp.dtype(dtype) == jnp.float64
                  else jnp.complex64)

    def setup(env_loc, key):
        mulA, _, mulA_inv = ops_of(env_loc)
        d = lax.axis_index(axis)

        def n2(w):
            # |w|² psum — real for complex probes (= kpm._spectral_radius's
            # jnp.linalg.norm on the full vector)
            return lax.psum(jnp.sum(jnp.real(w * jnp.conj(w))), axis) \
                if cplx else lax.psum(jnp.sum(w * w), axis)

        def radius(apply_fn, k):
            v_full = jax.random.normal(k, (N, 1), pdtype)
            v = lax.dynamic_slice_in_dim(v_full, d * B, B, axis=0)
            v = v / jnp.sqrt(n2(v))

            def body(_, carry):
                v, lam = carry
                w = apply_fn(v)
                nw = jnp.sqrt(n2(w))
                return w / jnp.where(nw > 0, nw, 1.0), nw

            _, lam = lax.fori_loop(0, kcfg.n_power, body,
                                   (v, jnp.asarray(1.0, dtype)))
            return lam

        k1, k2 = jax.random.split(key)
        e_max = radius(mulA, k1)
        e_min = 1.0 / radius(mulA_inv, k2)
        active = (e_min > 0.0) & (e_min < 1.0) & (e_max > 1.0) \
            & ((e_max - e_min) < 2.0)
        lam_lo = jnp.maximum(0.0, (1.0 - 2.0 * kcfg.buf) * e_min)
        lam_hi = (1.0 + 2.0 * kcfg.buf) * e_max
        lam_avg = (lam_hi + lam_lo) / 2
        lam_mag = (lam_hi - lam_lo) / 2
        xs = lam_mag * nodes + lam_avg
        f = 1.0 / (1.0 - jnp.exp(-1j * phis)[None, :] * xs[:, None])
        coeff = scale * jnp.matmul(cosmat, f,
                                   precision=jax.lax.Precision.HIGHEST)
        # full-spectrum order criterion: the hard frequencies sit at BOTH
        # ends (e^{−iφ} → 1 as φ → 0 or 2π) — kpm.setup's phis_eff
        phis_eff = jnp.minimum(phis, 2.0 * np.pi - phis) if cplx else phis
        order = jnp.clip(jnp.floor((lam_hi - lam_lo)
                                   * (kcfg.c1 / phis_eff + kcfg.c2)), 1, M)
        coeff = jnp.where(jnp.arange(M)[:, None] < order[None, :], coeff, 0.0)
        return dict(lam_avg=lam_avg, lam_mag=lam_mag, coeff=coeff, active=active)

    def make_apply(st, env_loc):
        mulA, mulA_T, _ = ops_of(env_loc)

        def cheb(w, coeff, transposed):
            # stacked-real layout [.., B, 2Lω]: one fold advances both
            # column halves per Ā read (the measured unsharded win,
            # ops/kpm.py:_chebyshev_apply_stacked), and the halo ppermutes
            # move only real data
            mul = mulA_T if transposed else mulA

            def Ap(v):
                return mul(v) / st["lam_mag"] - (st["lam_avg"] / st["lam_mag"]) * v

            out = _cmul_halves(coeff[0], w)
            u_nm1 = w
            u_n = Ap(w)

            def body(m, carry):
                out, u_nm1, u_n = carry
                out = out + _cmul_halves(coeff[m], u_n)
                return (out, u_n, 2.0 * Ap(u_n) - u_nm1)

            out, _, _ = lax.fori_loop(1, M, body, (out, u_nm1, u_n))
            return out

        def cheb_c(u, coeff, transposed):
            # plain complex recurrence on the full [.., B, Lτ] spectrum
            # (ops/kpm.py:_chebyshev_apply — no conjugate symmetry to fold)
            mul = mulA_T if transposed else mulA

            def Ap(v):
                return mul(v) / st["lam_mag"] - (st["lam_avg"] / st["lam_mag"]) * v

            out = coeff[0] * u
            u_nm1 = u
            u_n = Ap(u)

            def body(m, carry):
                out, u_nm1, u_n = carry
                out = out + coeff[m] * u_n
                return (out, u_n, 2.0 * Ap(u_n) - u_nm1)

            out, _, _ = lax.fori_loop(1, M, body, (out, u_nm1, u_n))
            return out

        def apply_P(v):
            if cplx:
                u = tau_to_omega(v)
                u = cheb_c(u, jnp.conj(st["coeff"]), True)
                u = cheb_c(u, st["coeff"], False)
                out = omega_to_tau(u, real=False).astype(v.dtype)
                return jnp.where(st["active"], out, v)
            w = _to_half_stacked(v, Ltau, use_dft)
            w = cheb(w, jnp.conj(st["coeff"]), True)
            w = cheb(w, st["coeff"], False)
            out = _from_half_stacked(w, Ltau, v.dtype, use_dft)
            return jnp.where(st["active"], out, v)

        return apply_P

    return setup, make_apply


def make_sharded_hmc_step(model_spec, plan: ShardPlan, mesh: Mesh,
                          mass_table, cfg, kpm_cfg=None,
                          chains_axis: str | None = None,
                          dynamic_dt: bool = False,
                          params_axis: int | None = None):
    """Sharded HMC update ``(params, x, v, key) -> (x', v', stats, key)``
    with the [N, Lτ] phonon field partitioned P('site', None) over ``mesh``.

    Noise is drawn with the exact key-split order of
    :func:`elphdynamics_tpu.dynamics.hmc.make_hmc_step` (each shard draws
    the full field and keeps its rows), so a sharded trajectory reproduces
    the unsharded one to psum-reduction rounding — asserted by
    tests/test_lattice_shard.py.

    ``kpm_cfg`` (a :class:`~elphdynamics_tpu.ops.kpm.KPMConfig`) enables the
    sharded symmetric KPM preconditioner: spectral setup once per update at
    the trajectory start, averaged-operator refresh per solve — the same
    buffered-skip cadence as the unsharded path.

    ``dynamic_dt=True`` returns ``(params, x, v, key, dt) -> ...`` with the
    leapfrog step size a traced scalar (trajectory length Nt stays static
    from ``cfg``) — the burnin dt tuner's contract, mirroring
    :func:`~elphdynamics_tpu.dynamics.hmc.make_hmc_step`.

    ``params_axis=0`` (combined mesh only) maps a leading chain axis of the
    params pytree over the local chain block — parallel tempering's
    per-rung stacked ladder (dynamics/tempering.ladder_params).

    With ``cfg.log_verbose`` the stats dict carries per-timestep
    ``traj_H/traj_S/traj_K/traj_iters`` arrays ([Nt]-leading), restoring the
    reference's verbose hmc_sim_log.out cadence (HMC.jl:285-304) under
    sharding.

    With ``cfg.deflate_k > 0`` the returned step threads a
    :class:`~elphdynamics_tpu.ops.deflation.DeflationState` as a trailing
    argument/output — ``(params, x, v, key, defl[, dt]) -> (x', v', stats,
    key, defl')`` — with the [k, N, Lτ] basis rows partitioned over the
    site axis (refresh = shard-local Chebyshev filter + CholeskyQR2 with
    psum'd Grams; see ops/deflation.py).
    """
    wplan = build_wij_plan(model_spec.wij_table, model_spec.Nsites, plan.D)
    wij_sign = model_spec.wij_sign
    Ltau = model_spec.Ltau
    N = model_spec.Nsites
    dtau = model_spec.dtau
    B = plan.B
    D = plan.D
    Nt = cfg.Nt
    mass_full = jnp.asarray(mass_table)
    use_defl = int(getattr(cfg, "deflate_k", 0)) > 0

    from elphdynamics_tpu.ops.fourier_accel import accelerate
    from elphdynamics_tpu.utils.dtypes import fdot

    def step_local(params, x_loc, v_loc, key, dt, defl_in=None):
        d = lax.axis_index(plan.axis)
        rows = d * B + jnp.arange(B)
        mass = lax.dynamic_slice_in_dim(mass_full, d * B, B, axis=0)
        lam = lax.dynamic_slice_in_dim(params.lam, d * B, B)[:, None]
        lam2 = lax.dynamic_slice_in_dim(params.lam2, d * B, B)[:, None]
        om = lax.dynamic_slice_in_dim(params.omega, d * B, B)[:, None]
        om4 = lax.dynamic_slice_in_dim(params.omega4, d * B, B)[:, None]
        mu = lax.dynamic_slice_in_dim(params.mu, d * B, B)[:, None]
        sgn_first = (-jnp.ones(Ltau, x_loc.dtype)).at[0].set(1.0)
        sgn_last = (-jnp.ones(Ltau, x_loc.dtype)).at[-1].set(1.0)

        def psum(s):
            return lax.psum(s, plan.axis)

        def pdot(a, b, axes=None):
            return psum(jnp.sum(fdot(a, b, axis=axes or tuple(range(a.ndim)))))

        # --- local model ops (models/holstein.py formulas on the block)
        def env_of(x):
            return jnp.exp(-dtau * (lam * x + lam2 * x * x - mu))

        def mulM(env, v):
            y = env * jnp.roll(v, 1, axis=-1)
            y = ckb_mul_local(plan, params.cosht, params.sinht, y)
            return v + sgn_first * y

        def mulMT(env, v):
            z = ckb_transpose_mul_local(plan, params.cosht, params.sinht, v)
            w = env * z
            return v + sgn_last * jnp.roll(w, -1, axis=-1)

        def mulMTM(env, v):
            return mulMT(env, mulM(env, v))

        def muldMdx(env, x, u, v):
            dd = (-sgn_first) * dtau * (lam + 2.0 * lam2 * x) * env \
                * jnp.roll(v, 1, axis=-1)
            y = ckb_transpose_mul_local(plan, params.cosht, params.sinht, u)
            if jnp.iscomplexobj(y) or jnp.iscomplexobj(dd):
                # complex-hopping force on the REAL field: Re[u†·∂M/∂x·v]
                # (models/holstein.py:muldMdx — the fold already is the
                # adjoint, only the elementwise conjugate remains)
                return jnp.real(jnp.conj(y) * dd)
            return y * dd

        def calc_Lam(x):
            return jnp.exp(-dtau * (lam * x + lam2 * x * x) / 2.0)

        def mulLambda(Lam, v):
            return sgn_last * jnp.roll(Lam * v, -1, axis=-1)

        def mulLambdaInv(Lam, v):
            return sgn_first * jnp.roll(v, 1, axis=-1) / Lam

        def muldLambdadx(x, Lam, vl, vr):
            base = (-sgn_first) * dtau * (lam / 2.0 + lam2 * x) * Lam \
                * jnp.roll(vr, 1, axis=-1)
            if jnp.iscomplexobj(vl) or jnp.iscomplexobj(vr):
                # complex path: Re[vl†·∂Λ/∂x·vr] (models/holstein.py)
                return jnp.real(jnp.conj(vl) * base)
            return vl * base

        def calc_Sb(x):
            dx = x - jnp.roll(x, 1, axis=-1)
            sb = om ** 2 * x * x / 2 + om4 * x ** 4 + dx * dx / (2 * dtau ** 2)
            total = jnp.sum(fdot(sb, jnp.ones_like(sb), axis=(0, 1)))
            if wplan is not None:
                total = total + wij_sb_local(
                    wplan, plan.axis, params.wij, wij_sign, 1.0, x)
            return dtau * psum(total)

        def calc_dSbdx(x):
            lap = jnp.roll(x, 1, axis=-1) + jnp.roll(x, -1, axis=-1) - 2.0 * x
            g = dtau * (om ** 2 * x + 4.0 * om4 * x ** 3) - lap / dtau
            if wplan is not None:
                g = wij_dsb_local(wplan, plan.axis, params.wij, wij_sign,
                                  dtau, x, g)
            return g

        # --- sharded symmetric KPM preconditioner (optional): full spectral
        # setup once per update, averaged-operator refresh per solve
        cplx = jnp.iscomplexobj(params.cosht)
        if kpm_cfg is not None:
            kpm_setup, kpm_make_apply = _kpm_local(
                plan, kpm_cfg, Ltau, N, x_loc.dtype, plan.axis,
                _holstein_kpm_ops(plan, params), cplx=cplx)
        else:
            kpm_setup = kpm_make_apply = None

        # --- batched-over-spin preconditioned CG for MᵀM (psum dots;
        # spins share one convergence scalar — a simplicity trade)
        def solve_O(env, rhs, tol, kst=None, x0=None, defl=None):
            P_apply = (kpm_make_apply(kst, env) if kst is not None else None)
            A = lambda v: mulMTM(env, v)
            if defl is not None:
                # shard-local init-projection (ops/deflation.py; the psum'd
                # [.., k] contraction is the only cross-shard traffic). Two
                # passes = the same iterative-refinement step solvers.cg
                # applies; block CG and deflation don't compose (the
                # solve_oinv gate), so the projected start goes straight
                # to the psum CG.
                from elphdynamics_tpu.ops import deflation as _defl_mod
                x0p = jnp.zeros_like(rhs) if x0 is None else x0
                r0 = rhs - A(x0p)
                for _ in range(2):
                    x0p = _defl_mod.project(defl, r0, x0p, psum=psum)
                    r0 = rhs - A(x0p)
                return _cg_local(A, rhs, tol, cfg.maxiter, pdot, P_apply,
                                 x0=x0p, sync_axis=chains_axis)
            return _traj_solve_local(A, rhs, tol,
                                     cfg.maxiter, pdot, P_apply, plan.axis,
                                     cfg, x0=x0, sync_axis=chains_axis)

        # --- noise in the unsharded step's exact key-split order
        key, k_v, k_p, k_acc = jax.random.split(key, 4)
        R_full = jax.random.normal(k_v, (N, Ltau), dtype=x_loc.dtype)
        R = lax.dynamic_slice_in_dim(R_full, d * B, B, axis=0)
        Rpm_full = jax.random.normal(k_p, (2, N, Ltau), dtype=x_loc.dtype)
        Rpm = lax.dynamic_slice_in_dim(Rpm_full, d * B, B, axis=1)
        if cplx:
            # both spins pack into ONE complex stack entry — the TRS twist
            # ensemble (utils/dtypes.pseudofermion_noise); same draws, same
            # key order as the unsharded step
            Rpm = (Rpm[0] + 1j * Rpm[1])[None]

        v0 = cfg.alpha * v_loc + jnp.sqrt(1.0 - cfg.alpha ** 2) \
            * accelerate(mass, R, -0.5)
        env0 = env_of(x_loc)
        MtR = mulMT(env0, Rpm)
        Lam0 = calc_Lam(x_loc)
        phi = mulLambdaInv(Lam0, MtR)

        # full KPM spectral setup once per update (seed matches
        # kpm.make_symmetric_precond for parity with the unsharded path)
        kst = (kpm_setup(env0, jax.random.PRNGKey(1234))
               if kpm_cfg is not None else None)

        # deflation-basis refresh at the update's starting field, exactly
        # the unsharded cadence (dynamics/hmc.py) with shard-local blocks:
        # the basis rows W[:, local, :] live on this shard; psum reduces
        # the power-iteration norms and the k×k Grams
        if use_defl:
            if (jnp.iscomplexobj(params.cosht)
                    and not jnp.iscomplexobj(defl_in.W)):
                # complex hopping needs a complex basis so the Hermitian
                # Grams/projections in ops/deflation.py see conjugated
                # vectors (init_deflation(..., params=params))
                raise ValueError(
                    "complex hopping parameters require a complex "
                    "deflation basis: initialize with "
                    "init_deflation(ops, cfg, key, params=params)")
            from elphdynamics_tpu.ops import deflation as _defl_mod
            apP0 = (kpm_make_apply(kst, env0) if kst is not None
                    else (lambda v: v))
            defl = _defl_mod.refresh(
                defl_in, lambda v: mulMTM(env0, v), apP0,
                _defl_mod.DeflationConfig(cfg.deflate_k, cfg.deflate_filter,
                                          cfg.deflate_power,
                                          cfg.deflate_cutoff),
                psum=psum)
        else:
            defl = None

        tol1, tol2 = cfg.tol, cfg.tol ** 2
        use_guess = bool(getattr(cfg, "construct_guess", False))
        g_ord = int(getattr(cfg, "guess_order", 1))

        def S_and_z(x, env, tol, x0=None):
            Lam = calc_Lam(x)
            Lphi = mulLambda(Lam, phi)
            z, it, flag = solve_O(env, Lphi, tol, kst,
                                  x0=x0 if use_guess else None, defl=defl)
            Sf = pdot(Lphi, z) / 2
            return Lphi, z, Sf + calc_Sb(x), it, flag

        def calc_K(v):
            mv = accelerate(mass, v, 1.0)
            return pdot(v, mv) / 2

        Lphi0, z0, S0, it0, flag0 = S_and_z(x_loc, env0, tol2)
        H0 = S0 + calc_K(v0)

        def forces(x, env, z):
            """Fermionic force; the bosonic part is added only for the plain
            leapfrog — the multi-timestep integrator handles it in the Nb
            substeps (HMC.jl:524,581)."""
            Mz = mulM(env, z)
            dSf = -jnp.sum(muldMdx(env, x, Mz, z), axis=0)
            Lam = calc_Lam(x)
            dSf = dSf + jnp.sum(muldLambdadx(x, Lam, phi, z), axis=0)
            if cfg.Nb == 1:
                return dSf + calc_dSbdx(x)
            return dSf

        def qf(g):
            return accelerate(mass, g, -1.0)

        Qd0 = qf(forces(x_loc, env0, z0))

        def boson_substeps(x, v):
            """Nb small bosonic steps per fermionic step (HMC.jl:535-565);
            entirely site-local."""
            dt_b = dt / cfg.Nb
            QdSb = qf(calc_dSbdx(x))

            def sub(carry, _):
                x, v, QdSb = carry
                v = v - dt_b / 2 * QdSb
                x = x + dt_b * v
                QdSb2 = qf(calc_dSbdx(x))
                v = v - dt_b / 2 * QdSb2
                return (x, v, QdSb2), None

            (x, v, _), _ = lax.scan(sub, (x, v, QdSb), None, length=cfg.Nb)
            return x, v

        def body(carry, _):
            x, v, Qd, hist, iters, flag = carry
            ok = flag == 0
            v1 = v - dt / 2 * Qd
            if cfg.Nb == 1:
                x1 = x + dt * v1
            else:
                x1, v1 = boson_substeps(x, v1)
            env1 = env_of(x1)
            Lam1 = calc_Lam(x1)
            Lphi1 = mulLambda(Lam1, phi)
            # warm-start extrapolation over the rotated history tuple
            # (hmc.py's zhist_*)
            guess = (_hmc.zhist_guess(hist, g_ord) if use_guess
                     else None)
            z1, it1, fl1 = solve_O(env1, Lphi1, tol1, kst, x0=guess,
                                   defl=defl)
            Qd1 = qf(forces(x1, env1, z1))
            v1 = v1 - dt / 2 * Qd1
            x = jnp.where(ok, x1, x)
            v = jnp.where(ok, v1, v)
            Qd = jnp.where(ok, Qd1, Qd)
            hist = _hmc.zhist_push(hist, z1, ok)
            iters = iters + jnp.where(ok, it1, 0)
            flag = jnp.maximum(flag, jnp.where(ok, fl1, 0))
            if cfg.log_verbose:
                # per-timestep energies reusing the tol¹ solve (psum scalars;
                # the reference's verbose update_log, HMC.jl:285-304)
                S_t = pdot(Lphi1, z1) / 2 + calc_Sb(x)
                K_t = calc_K(v)
                ys = (S_t + K_t, S_t, K_t, it1)
            else:
                ys = None
            return (x, v, Qd, hist, iters, flag), ys

        hist0 = _hmc.zhist_init(z0, g_ord if use_guess else 1)
        (x1, v1, _, hist1, iters, flag), traj = lax.scan(
            body, (x_loc, v0, Qd0, hist0, it0, flag0), None,
            length=Nt)
        z_last = _hmc.zhist_last(hist1)

        env1 = env_of(x1)
        Lphi1, z1, S1, it2, fl2 = S_and_z(x1, env1, tol2, x0=z_last)
        iters = iters + it2
        flag = jnp.maximum(flag, fl2)
        K1 = calc_K(v1)
        H1 = S1 + K1
        dH = H1 - H0
        P = jnp.minimum(1.0, jnp.exp(-dH))
        u = jax.random.uniform(k_acc, P.shape, dtype=P.dtype)
        accept = (u < P) & (flag == 0)
        x_new = jnp.where(accept, x1, x_loc)
        v_new = jnp.where(accept, v1, -v0)
        mean_iters = (iters + Nt + 1) // (Nt + 2)
        if not cfg.log_verbose:
            traj_out = (jnp.nan, jnp.nan, jnp.nan, jnp.nan)
        else:
            traj_out = traj
        out = (x_new, v_new, accept, mean_iters.astype(jnp.int32), dH,
               flag, H1, S1, K1, traj_out[0], traj_out[1], traj_out[2],
               traj_out[3], key)
        if use_defl:
            out = out + (defl,)
        return out

    from elphdynamics_tpu.ops.deflation import DeflationState as _DState

    if chains_axis is None:
        if params_axis is not None:
            raise ValueError("params_axis requires a chains_axis (2-D mesh)")
        in_specs = (P(), P(plan.axis, None), P(plan.axis, None), P(), P())
        out_specs = (P(plan.axis, None), P(plan.axis, None)) + (P(),) * 12
        if use_defl:
            # basis rows partitioned over sites; k×k factor + λmax replicated
            dspec = _DState(W=P(None, plan.axis, None), chol=P(),
                            pvec=P(plan.axis, None), lam_max=P())
            in_specs = in_specs + (dspec,)
            out_specs = out_specs + (dspec,)
        sharded = jax.shard_map(
            step_local, mesh=mesh,
            in_specs=in_specs, out_specs=out_specs,
            check_vma=False,
        )
    else:
        # 2-D (chain × site) mesh: each device holds its chain block's rows;
        # the site collectives batch over the local chains, the chain axis
        # carries no communication (pure data parallel, SURVEY §5)
        ca = chains_axis
        p_spec = P(ca) if params_axis == 0 else P()
        in_axes = (params_axis, 0, 0, 0, None) + ((0,) if use_defl else ())
        in_specs = (p_spec, P(ca, plan.axis, None), P(ca, plan.axis, None),
                    P(ca), P())
        out_specs = (P(ca, plan.axis, None), P(ca, plan.axis, None)) \
            + (P(ca),) * 12
        if use_defl:
            dspec = _DState(W=P(ca, None, plan.axis, None), chol=P(ca),
                            pvec=P(ca, plan.axis, None), lam_max=P(ca))
            in_specs = in_specs + (dspec,)
            out_specs = out_specs + (dspec,)
        sharded = jax.shard_map(
            jax.vmap(step_local, in_axes=in_axes),
            mesh=mesh,
            in_specs=in_specs, out_specs=out_specs,
            check_vma=False,
        )

    def _stats(accept, iters, dH, flag, H, S, K, tH, tS, tK, tI):
        st = {"accepted": accept, "iters": iters, "delta_H": dH,
              "flag": flag,
              # H/S/K restore the hmc_sim_log.out observability of the
              # unsharded path (HMC.jl:236-304) under --site-devices
              "H": H, "S": S, "K": K}
        if cfg.log_verbose:
            # [Nt] per-timestep traces ([chains, Nt] on the combined mesh —
            # the chain vmap stacks outside the scan axis, matching the
            # unsharded hmc.HMCStats.traj_* layout the driver expects)
            st.update(traj_H=tH, traj_S=tS, traj_K=tK, traj_iters=tI)
        return st

    if use_defl:
        # deflation threads the per-update basis through the step as an
        # explicit trailing in/out (the driver keeps it in HMCState.defl,
        # mirroring the unsharded make_hmc_step contract)
        def step_defl(params, x, v, key, defl, dt=None):
            dt_in = cfg.dt if dt is None else dt
            (x_new, v_new, accept, iters, dH, flag, H, S, K,
             tH, tS, tK, tI, key, defl_new) = sharded(
                params, x, v, key, dt_in, defl)
            return (x_new, v_new, _stats(accept, iters, dH, flag, H, S, K,
                                         tH, tS, tK, tI), key, defl_new)

        if dynamic_dt:
            return jax.jit(step_defl)

        def step_defl_static(params, x, v, key, defl):
            return step_defl(params, x, v, key, defl)

        return jax.jit(step_defl_static)

    def step(params, x, v, key, dt=None):
        dt_in = cfg.dt if dt is None else dt
        (x_new, v_new, accept, iters, dH, flag, H, S, K,
         tH, tS, tK, tI, key) = sharded(params, x, v, key, dt_in)
        return x_new, v_new, _stats(accept, iters, dH, flag, H, S, K,
                                    tH, tS, tK, tI), key

    if dynamic_dt:
        return jax.jit(step)

    def step_static(params, x, v, key):
        return step(params, x, v, key)

    return jax.jit(step_static)


def chain_site_mesh(n_chain: int, n_site: int, devices=None) -> Mesh:
    """2-D mesh composing chain data parallelism with lattice sharding:
    axis 'chain' (no hot-loop communication) × axis 'site' (halo ppermutes +
    psum reductions ride the inner, faster dimension)."""
    if devices is None:
        devices = jax.devices()
    if len(devices) < n_chain * n_site:
        raise RuntimeError(
            f"chain_site_mesh needs {n_chain * n_site} devices, found "
            f"{len(devices)} (see site_mesh on virtual-device setup)")
    devs = np.asarray(devices[: n_chain * n_site]).reshape(n_chain, n_site)
    return Mesh(devs, axis_names=("chain", "site"))


# ---------------------------------------------------------------------------
# SSH under site sharding. The electron vectors (φ, z, CG workspace — the
# memory- and FLOP-dominant state) are partitioned P('site', None); the
# phonon field x lives on BONDS and is kept replicated: every shard runs the
# identical leapfrog on it, with the fermionic force psum-assembled from
# per-shard bond contributions. Cross-shard traffic = the checkerboard halo
# ppermutes + one [Nph, Lτ] force psum per force evaluation + scalar psums.
# Fold-mode only (the dense per-τ path would shard as a pjit matmul).
# ---------------------------------------------------------------------------

def _ssh_group_phonons(model_spec, plan: ShardPlan):
    """Per (group, shard) phonon tables for the sharded SSH ``muldMdx``:
    ``ph_of_site[g][d, s]`` = phonon index of the bond at local site s in
    group g (0 when masked), ``ph_mask[g][d, s]`` = site has a
    phonon-carrying bond in g, ``bond_orig[g][d, s]`` = the bond's index in
    ORIGINAL bond order (for the per-bond ``t_phase`` lookup on the
    complex-hopping path)."""
    ckb = model_spec.ckb
    D, B = plan.D, plan.B
    ph_of_site, ph_mask, bond_orig = [], [], []
    for g in range(ckb.ngroups):
        bond_ckb = ckb.bond_of_site[g]              # [N] ckb bond index
        orig = model_spec.ckb_to_bond[bond_ckb]     # original bond order
        ph = model_spec.bond_to_phonon[orig]        # [-1 if no phonon]
        valid = ckb.mask[g] & (ph >= 0)
        ph_of_site.append(np.maximum(ph, 0).reshape(D, B).copy())
        ph_mask.append(valid.reshape(D, B).copy())
        bond_orig.append(orig.reshape(D, B).copy())
    return tuple(ph_of_site), tuple(ph_mask), tuple(bond_orig)


def _ssh_local_ops(model_spec, plan: ShardPlan, params):
    """Shard-local SSH fermion-matrix applies (SSHModels.jl:581-701 with the
    fold replaced by the halo fold). ``coeffs`` = (cosh, sinh) [Nbonds, Lτ]
    derived from the replicated phonon field; vectors are local blocks."""
    Ltau = model_spec.Ltau
    B = plan.B

    def expmu_loc(dtype):
        d = lax.axis_index(plan.axis)
        return jnp.exp(model_spec.dtau
                       * lax.dynamic_slice_in_dim(params.mu, d * B, B)
                       ).astype(dtype)[:, None]

    def mulM(coeffs, v):
        cosh_b, sinh_b = coeffs[0], coeffs[1]
        sgn_first = (-jnp.ones(Ltau, v.dtype)).at[0].set(1.0)
        y = expmu_loc(v.dtype) * jnp.roll(v, 1, axis=-1)
        y = ckb_mul_local(plan, cosh_b, sinh_b, y)
        return v + sgn_first * y

    def mulMT(coeffs, v):
        cosh_b, sinh_b = coeffs[0], coeffs[1]
        sgn_last = (-jnp.ones(Ltau, v.dtype)).at[-1].set(1.0)
        z = ckb_transpose_mul_local(plan, cosh_b, sinh_b, v)
        w = expmu_loc(v.dtype) * z
        return v + sgn_last * jnp.roll(w, -1, axis=-1)

    return mulM, mulMT, expmu_loc


def make_sharded_ssh_solver(model_spec, plan: ShardPlan, mesh: Mesh):
    """``solve(params, coeffs, b) -> (x, iters)`` for MᵀM·x = Mᵀ·b with the
    electron site axis sharded; ``coeffs`` (the [Nbonds, Lτ] cosh/sinh from
    :func:`elphdynamics_tpu.models.ssh.ckb_coeffs`) enter replicated."""

    def solve_local(params, cosh_b, sinh_b, b_loc, tol, maxiter):
        mulM, mulMT, _ = _ssh_local_ops(model_spec, plan, params)
        coeffs = (cosh_b, sinh_b)

        def pdot(a, b):
            # Re(a†·b) on the complex-hopping path (utils/dtypes.fdot_fast)
            return lax.psum(jnp.sum(fdot_fast(a, b, axis=(-2, -1))),
                            plan.axis)

        x, j, _ = _cg_local(lambda v: mulMT(coeffs, mulM(coeffs, v)),
                            mulMT(coeffs, b_loc), tol, maxiter, pdot)
        return x, j

    def solve(params, coeffs, b, tol=1e-5, maxiter=1000):
        fn = jax.shard_map(
            partial(solve_local, tol=tol, maxiter=maxiter),
            mesh=mesh,
            in_specs=(P(), P(), P(), P(plan.axis, None)),
            out_specs=(P(plan.axis, None), P()),
        )
        return fn(params, coeffs[0], coeffs[1], b)

    def _wrap_mul(which):
        def f(params, cosh_b, sinh_b, v_loc):
            mulM, mulMT, _ = _ssh_local_ops(model_spec, plan, params)
            return (mulM if which == "M" else mulMT)((cosh_b, sinh_b), v_loc)

        def apply(params, coeffs, v):
            return jax.shard_map(
                f, mesh=mesh,
                in_specs=(P(), P(), P(), P(plan.axis, None)),
                out_specs=P(plan.axis, None))(params, coeffs[0], coeffs[1], v)

        return apply

    return solve, _wrap_mul("M"), _wrap_mul("MT")


# ---------------------------------------------------------------------------
# Sharded measurement sampling: the nᵥ Green's-function estimator solves
# (GreensFunctions.jl:201-234) are the dominant measurement cost; under
# --site-devices they run through the same halo-fold + psum-CG machinery as
# the sampler, with the optional sharded KPM preconditioner. The downstream
# pair-convolution / estimator stage stays on one device (per-pair
# [nₒ, L1, L2, L3, 2Lτ] FFT work, off the hot loop) — gathering R/M⁻¹R is
# exactly the footprint the sampler already holds per chain.
# ---------------------------------------------------------------------------

def _estimator_solve_local(A, rhs, scfg, pdot, P_apply, axis):
    """The nᵥ estimator systems, shard-local: global-dot CG by default;
    with ``scfg.block`` the psum-aware :func:`solvers.block_cg` (the s=nᵥ
    block deflates the deep-β slow modes — BASELINE.md §block CG; same
    mathematics as the unsharded `[solver] block` path)."""
    if getattr(scfg, "block", False):
        from elphdynamics_tpu import solvers as _solvers
        res = _solvers.block_cg(A, rhs, apply_P=P_apply, tol=scfg.tol,
                                maxiter=scfg.maxiter, psum_axis=axis)
        d = A(res.x) - rhs
        err = jnp.sqrt(pdot(d, d)) / jnp.maximum(jnp.sqrt(pdot(rhs, rhs)),
                                                 1e-30)
        flag = jnp.where(err > jnp.sqrt(scfg.tol), 1, 0)
        return res.x, jnp.max(res.iters), flag
    return _cg_local(A, rhs, scfg.tol, scfg.maxiter, pdot, P_apply)


def make_sharded_greens_sampler(model_spec, plan: ShardPlan, mesh: Mesh,
                                nv: int, scfg, kpm_cfg=None):
    """Holstein ``sample(params, x, key) -> (R, MinvR, iters, flag, key)``
    with the [nv, N, Lτ] estimator systems solved site-sharded.

    The key-split order and R draw match
    :func:`elphdynamics_tpu.measure.greens.sample_greens` exactly (each
    shard draws the full block and keeps its rows), so a sharded measurement
    sees the same random vectors as the unsharded path; the solutions agree
    within the solver tolerance ball. The returned flag carries the
    residual-verification ladder of the Models.jl ldiv! convention.
    """
    from elphdynamics_tpu.utils.dtypes import fdot

    Ltau = model_spec.Ltau
    N = model_spec.Nsites
    dtau = model_spec.dtau
    B = plan.B

    def sample_local(params, x_loc, key):
        d = lax.axis_index(plan.axis)
        lam = lax.dynamic_slice_in_dim(params.lam, d * B, B)[:, None]
        lam2 = lax.dynamic_slice_in_dim(params.lam2, d * B, B)[:, None]
        mu = lax.dynamic_slice_in_dim(params.mu, d * B, B)[:, None]
        sgn_first = (-jnp.ones(Ltau, x_loc.dtype)).at[0].set(1.0)
        sgn_last = (-jnp.ones(Ltau, x_loc.dtype)).at[-1].set(1.0)
        env = jnp.exp(-dtau * (lam * x_loc + lam2 * x_loc * x_loc - mu))

        def mulM(v):
            y = env * jnp.roll(v, 1, axis=-1)
            y = ckb_mul_local(plan, params.cosht, params.sinht, y)
            return v + sgn_first * y

        def mulMT(v):
            z = ckb_transpose_mul_local(plan, params.cosht, params.sinht, v)
            w = env * z
            return v + sgn_last * jnp.roll(w, -1, axis=-1)

        def pdot(a, b):
            return lax.psum(jnp.sum(fdot(a, b, axis=tuple(range(a.ndim)))),
                            plan.axis)

        # exact key-split order of sample_greens; complex hopping draws the
        # circular complex probes of utils.dtypes.trace_noise (E[RR†] = I)
        cplx = jnp.iscomplexobj(params.cosht)
        key, kr = jax.random.split(key)
        if cplx:
            g_full = jax.random.normal(kr, (2, nv, N, Ltau), dtype=x_loc.dtype)
            half = jnp.asarray(0.5, x_loc.dtype) ** 0.5
            R_full = (g_full[0] + 1j * g_full[1]) * half
        else:
            R_full = jax.random.normal(kr, (nv, N, Ltau), dtype=x_loc.dtype)
        R = lax.dynamic_slice_in_dim(R_full, d * B, B, axis=1)

        P_apply = None
        if kpm_cfg is not None:
            kpm_setup, kpm_make_apply = _kpm_local(
                plan, kpm_cfg, Ltau, N, x_loc.dtype, plan.axis,
                _holstein_kpm_ops(plan, params), cplx=cplx)
            kst = kpm_setup(env, jax.random.PRNGKey(1234))
            P_apply = kpm_make_apply(kst, env)

        z, it, flag = _estimator_solve_local(
            lambda v: mulMT(mulM(v)), mulMT(R), scfg, pdot, P_apply,
            plan.axis)
        return R, z, it, flag, key

    sharded = jax.shard_map(
        sample_local, mesh=mesh,
        in_specs=(P(), P(plan.axis, None), P()),
        out_specs=(P(None, plan.axis, None), P(None, plan.axis, None),
                   P(), P(), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


def make_sharded_ssh_greens_sampler(model_spec, plan: ShardPlan, mesh: Mesh,
                                    nv: int, scfg, kpm_cfg=None):
    """SSH counterpart of :func:`make_sharded_greens_sampler`: the bond
    phonon field enters replicated, the electron vectors shard over sites."""
    from elphdynamics_tpu.models import ssh as Sm
    from elphdynamics_tpu.utils.dtypes import fdot

    Ltau = model_spec.Ltau
    N = model_spec.Nsites
    B = plan.B

    def sample_local(params, x, key):
        d = lax.axis_index(plan.axis)
        mulM, mulMT, expmu_loc = _ssh_local_ops(model_spec, plan, params)
        coeffs = Sm.ckb_coeffs(model_spec, params, x)

        def pdot(a, b):
            return lax.psum(jnp.sum(fdot(a, b, axis=tuple(range(a.ndim)))),
                            plan.axis)

        # exact key-split order of sample_greens; complex hopping draws the
        # circular complex probes of utils.dtypes.trace_noise (E[RR†] = I)
        cplx = params.t_phase is not None
        key, kr = jax.random.split(key)
        if cplx:
            g_full = jax.random.normal(kr, (2, nv, N, Ltau), dtype=x.dtype)
            half = jnp.asarray(0.5, x.dtype) ** 0.5
            R_full = (g_full[0] + 1j * g_full[1]) * half
        else:
            R_full = jax.random.normal(kr, (nv, N, Ltau), dtype=x.dtype)
        R = lax.dynamic_slice_in_dim(R_full, d * B, B, axis=1)

        P_apply = None
        if kpm_cfg is not None:
            kpm_setup, kpm_make_apply = _kpm_local(
                plan, kpm_cfg, Ltau, N, x.dtype, plan.axis,
                _ssh_kpm_ops(plan, expmu_loc), cplx=cplx)
            kst = kpm_setup(coeffs, jax.random.PRNGKey(1234))
            P_apply = kpm_make_apply(kst, coeffs)

        z, it, flag = _estimator_solve_local(
            lambda v: mulMT(coeffs, mulM(coeffs, v)), mulMT(coeffs, R),
            scfg, pdot, P_apply, plan.axis)
        return R, z, it, flag, key

    sharded = jax.shard_map(
        sample_local, mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=(P(None, plan.axis, None), P(None, plan.axis, None),
                   P(), P(), P()),
        check_vma=False,
    )
    return jax.jit(sharded)



def _ssh_muldmdx_builder(model_spec, plan: ShardPlan, ph_of_site, ph_mask,
                         bond_orig, expmu_loc, params):
    """Shard-local slice of the SSH uᵀ(∂M/∂x)v group-fold walk
    (SSHModels.jl:707-829) scattered onto the FULL [.., Nph, Lτ] array
    (pre-psum). Carries b ← G_g b and c ← G_g⁻¹ c; within a group the
    partner's updated value is locally reconstructible (the 2×2 bond
    rotation is shared), so no second halo fetch is needed.

    Complex hopping (``params.t_phase``): the per-site contribution mirrors
    models/ssh.py:muldMdx's Re[u†·Γ_ph·v] bond contraction — the bond (i,j)
    contributes Re(ph·c̄ᵢ·bⱼ) at the j endpoint and Re(p̄h·c̄ⱼ·bᵢ) at i, so
    each site applies its endpoint-placed phase (conj on the ``is_lo`` first
    endpoint) to conj(cp_new)·b."""
    Ltau = model_spec.Ltau
    Nph = model_spec.Nph
    dtau = model_spec.dtau
    cplx = params.t_phase is not None

    def muldmdx_partial(coeffs, x_full, u_loc, v_loc):
        d = lax.axis_index(plan.axis)
        cosh_b, sinh_b = coeffs[0], coeffs[1]
        b = expmu_loc(v_loc.dtype) * jnp.roll(v_loc, 1, axis=-1)
        c = ckb_transpose_mul_local(plan, cosh_b, sinh_b, u_loc)
        dKdx_full = (params.alpha[:, None]
                     + 2.0 * params.alpha2[:, None] * x_full)
        sgn = jnp.ones(Ltau, x_full.dtype).at[0].set(-1.0)  # −sgn_first
        batch = jnp.broadcast_shapes(u_loc.shape[:-2], v_loc.shape[:-2])
        out = jnp.zeros(batch + (Nph, Ltau), dtype=x_full.dtype)
        for g in range(plan.ngroups):
            cg, sg = _group_coeffs(plan, g, cosh_b, sinh_b, b.dtype)
            ext_b = _extend_group(plan, g, b)
            ext_c = _extend_group(plan, g, c)
            pl = jnp.take(jnp.asarray(plan.partner_local[g]), d, axis=0)
            bp = jnp.take(ext_b, pl, axis=-2)
            cp_old = jnp.take(ext_c, pl, axis=-2)
            b_new = cg * b + sg * bp
            # partner's updated c: the partner sits at the OPPOSITE bond
            # endpoint, so its fold coefficient is conj(sg) on the complex
            # path (identity on real)
            cp_new = cg * cp_old - jnp.conj(sg) * c
            c = cg * c - sg * cp_old
            b = b_new
            ph = jnp.take(jnp.asarray(ph_of_site[g]), d, axis=0)
            pm = jnp.take(jnp.asarray(ph_mask[g]), d, axis=0)[:, None]
            dk = jnp.take(dKdx_full, ph, axis=-2)
            if cplx:
                bo = jnp.take(jnp.asarray(bond_orig[g]), d, axis=0)
                phb = jnp.take(params.t_phase, bo, axis=-1)[:, None]
                lo = jnp.take(jnp.asarray(plan.is_lo[g]), d, axis=0)[:, None]
                ph_eff = jnp.where(lo, jnp.conj(phb), phb)
                term = sgn * dtau * dk * jnp.real(
                    ph_eff * jnp.conj(cp_new) * b)
            else:
                term = sgn * dtau * dk * cp_new * b
            out = out.at[..., ph, :].add(jnp.where(pm, term, 0.0))
        return out

    return muldmdx_partial


def make_sharded_ssh_hmc_step(model_spec, plan: ShardPlan, mesh: Mesh,
                              mass_table, cfg, kpm_cfg=None,
                              chains_axis: str | None = None,
                              dynamic_dt: bool = False,
                              params_axis: int | None = None):
    """Sharded SSH HMC update ``(params, x, v, key) -> (x', v', stats, key)``.

    The [Nph, Lτ] bond-phonon field (and momenta) stay replicated — every
    shard integrates the identical trajectory; the fermionic force is
    psum-assembled from shard-local bond contributions via the group-fold
    ``muldMdx`` walk (SSHModels.jl:707-829) with halo-extended partial
    products. Noise follows the exact key-split order of
    :func:`elphdynamics_tpu.dynamics.hmc.make_hmc_step` for parity testing.
    ``kpm_cfg`` enables the sharded symmetric KPM preconditioner on the
    τ-averaged hopping (setup once per update, refresh per solve).

    ``dynamic_dt`` and ``cfg.log_verbose`` as in
    :func:`make_sharded_hmc_step` (traced step size; per-timestep traj_*
    energy traces).
    """
    from elphdynamics_tpu.models import ssh as S
    from elphdynamics_tpu.ops.fourier_accel import accelerate
    from elphdynamics_tpu.utils.dtypes import fdot

    Ltau = model_spec.Ltau
    N = model_spec.Nsites
    Nph = model_spec.Nph
    dtau = model_spec.dtau
    B = plan.B
    Nt = cfg.Nt
    mass_full = jnp.asarray(mass_table)
    prim = jnp.asarray(model_spec.primary_phonon)
    prim_mask_np = (model_spec.primary_phonon
                    == np.arange(model_spec.Nph))
    ph_of_site, ph_mask, bond_orig = _ssh_group_phonons(model_spec, plan)
    use_defl = int(getattr(cfg, "deflate_k", 0)) > 0

    def step_local(params, x, v, key, dt, defl_in=None):
        d = lax.axis_index(plan.axis)
        mulM, mulMT, expmu_loc = _ssh_local_ops(model_spec, plan, params)

        def psum(s):
            return lax.psum(s, plan.axis)

        def pdot(a, b, axes=None):
            return psum(jnp.sum(fdot(a, b, axis=axes or tuple(range(a.ndim)))))

        def coeffs_of(x):
            # (cosh, sinh) of Δτ·t′ with the Peierls phase folded into s —
            # models/ssh.py:ckb_coeffs without the dense-mode Kd (the sharded
            # path always runs the halo fold; conj(s) endpoint placement is
            # applied by _group_coeffs)
            tp = S.hopping_t_prime(model_spec, params, x)
            tp_ckb = jnp.take(tp, jnp.asarray(model_spec.ckb_to_bond), axis=-2)
            arg = dtau * tp_ckb
            c, sn = jnp.cosh(arg), jnp.sinh(arg)
            if params.t_phase is not None:
                ph_ckb = jnp.take(params.t_phase,
                                  jnp.asarray(model_spec.ckb_to_bond), axis=-1)
                sn = ph_ckb[:, None] * sn
                c = c.astype(sn.dtype)
            return (c, sn)

        def tie(a):
            return jnp.take(a, prim, axis=-2)

        muldmdx_partial = _ssh_muldmdx_builder(
            model_spec, plan, ph_of_site, ph_mask, bond_orig, expmu_loc,
            params)

        # --- bosonic action/grad: primary fields only, replicated x
        def calc_Sb(x):
            return S.calc_Sb(model_spec, params, x, False)

        def calc_dSbdx(x):
            return S.calc_dSbdx(model_spec, params, x, False)

        # --- sharded symmetric KPM on the τ-averaged hopping (optional);
        # complex hopping runs the full-spectrum complex pipeline
        cplx = params.t_phase is not None
        if kpm_cfg is not None:
            kpm_setup, kpm_make_apply = _kpm_local(
                plan, kpm_cfg, Ltau, N, x.dtype, plan.axis,
                _ssh_kpm_ops(plan, expmu_loc), cplx=cplx)
        else:
            kpm_setup = kpm_make_apply = None

        def solve_O(coeffs, rhs, tol, kst=None, x0=None, defl=None):
            P_apply = (kpm_make_apply(kst, coeffs) if kst is not None
                       else None)
            A = lambda v: mulMT(coeffs, mulM(coeffs, v))
            if defl is not None:
                # shard-local init-projection (see make_sharded_hmc_step)
                from elphdynamics_tpu.ops import deflation as _defl_mod
                x0p = jnp.zeros_like(rhs) if x0 is None else x0
                r0 = rhs - A(x0p)
                for _ in range(2):
                    x0p = _defl_mod.project(defl, r0, x0p, psum=psum)
                    r0 = rhs - A(x0p)
                return _cg_local(A, rhs, tol, cfg.maxiter, pdot, P_apply,
                                 x0=x0p, sync_axis=chains_axis)
            return _traj_solve_local(
                A, rhs, tol,
                cfg.maxiter, pdot, P_apply, plan.axis, cfg, x0=x0,
                sync_axis=chains_axis)

        # --- noise in the unsharded step's exact key-split order
        key, k_v, k_p, k_acc = jax.random.split(key, 4)
        R = tie(jax.random.normal(k_v, (Nph, Ltau), dtype=x.dtype))
        v0 = cfg.alpha * v + jnp.sqrt(1.0 - cfg.alpha ** 2) \
            * accelerate(mass_full, R, -0.5)
        Rpm_full = jax.random.normal(k_p, (2, N, Ltau), dtype=x.dtype)
        Rpm = lax.dynamic_slice_in_dim(Rpm_full, d * B, B, axis=1)
        if cplx:
            # both spins pack into ONE complex stack entry — the TRS twist
            # ensemble (utils/dtypes.pseudofermion_noise); same draws, same
            # key order as the unsharded step
            Rpm = (Rpm[0] + 1j * Rpm[1])[None]

        coeffs0 = coeffs_of(x)
        phi = mulMT(coeffs0, Rpm)   # [2, B, Lτ] ([1] complex) — no Λ for SSH

        kst = (kpm_setup(coeffs0, jax.random.PRNGKey(1234))
               if kpm_cfg is not None else None)

        # deflation-basis refresh at the update's starting field (electron
        # vector space [k, B, Lτ] local blocks; unsharded cadence)
        if use_defl:
            if cplx and not jnp.iscomplexobj(defl_in.W):
                # complex hopping needs a complex basis (Hermitian
                # Grams/projections): init_deflation(..., params=params)
                raise ValueError(
                    "complex hopping parameters require a complex "
                    "deflation basis: initialize with "
                    "init_deflation(ops, cfg, key, params=params)")
            from elphdynamics_tpu.ops import deflation as _defl_mod
            apP0 = (kpm_make_apply(kst, coeffs0) if kst is not None
                    else (lambda v: v))
            defl = _defl_mod.refresh(
                defl_in, lambda v: mulMT(coeffs0, mulM(coeffs0, v)), apP0,
                _defl_mod.DeflationConfig(cfg.deflate_k, cfg.deflate_filter,
                                          cfg.deflate_power,
                                          cfg.deflate_cutoff),
                psum=psum)
        else:
            defl = None

        tol1, tol2 = cfg.tol, cfg.tol ** 2
        use_guess = bool(getattr(cfg, "construct_guess", False))
        g_ord = int(getattr(cfg, "guess_order", 1))

        def S_of(x, coeffs, tol, x0=None):
            z, it, flag = solve_O(coeffs, phi, tol, kst,
                                  x0=x0 if use_guess else None, defl=defl)
            Sf = pdot(phi, z) / 2
            return z, Sf + calc_Sb(x), it, flag

        prim_mask = jnp.asarray(prim_mask_np, x.dtype)[:, None]

        def calc_K(v):
            mv = accelerate(mass_full, v, 1.0)
            return fdot(prim_mask * v, mv, axis=(-2, -1)) / 2

        z0, S0, it0, flag0 = S_of(x, coeffs0, tol2)
        H0 = S0 + calc_K(v0)

        def forces(x_full, coeffs, z_loc):
            Mz = mulM(coeffs, z_loc)
            part = muldmdx_partial(coeffs, x_full, Mz, z_loc)
            dSf = -psum(jnp.sum(part, axis=0))
            tied = jnp.zeros_like(dSf).at[prim].add(dSf)
            dSf = jnp.take(tied, prim, axis=-2)
            if cfg.Nb == 1:
                return dSf + calc_dSbdx(x_full)
            return dSf

        def qf(g):
            return accelerate(mass_full, g, -1.0)

        Qd0 = qf(forces(x, coeffs0, z0))

        def boson_substeps(x, v):
            dt_b = dt / cfg.Nb
            QdSb = qf(calc_dSbdx(x))

            def sub(carry, _):
                x, v, QdSb = carry
                v = v - dt_b / 2 * QdSb
                x = x + dt_b * v
                QdSb2 = qf(calc_dSbdx(x))
                v = v - dt_b / 2 * QdSb2
                return (x, v, QdSb2), None

            (x, v, _), _ = lax.scan(sub, (x, v, QdSb), None, length=cfg.Nb)
            return x, v

        def body(carry, _):
            x, v, Qd, hist, iters, flag = carry
            ok = flag == 0
            v1 = v - dt / 2 * Qd
            if cfg.Nb == 1:
                x1 = x + dt * v1
            else:
                x1, v1 = boson_substeps(x, v1)
            coeffs1 = coeffs_of(x1)
            # warm-start extrapolation over the rotated history tuple
            # (hmc.py's zhist_*)
            guess = (_hmc.zhist_guess(hist, g_ord) if use_guess
                     else None)
            z1, it1, fl1 = solve_O(coeffs1, phi, tol1, kst, x0=guess,
                                   defl=defl)
            Qd1 = qf(forces(x1, coeffs1, z1))
            v1 = v1 - dt / 2 * Qd1
            x = jnp.where(ok, x1, x)
            v = jnp.where(ok, v1, v)
            Qd = jnp.where(ok, Qd1, Qd)
            hist = _hmc.zhist_push(hist, z1, ok)
            iters = iters + jnp.where(ok, it1, 0)
            flag = jnp.maximum(flag, jnp.where(ok, fl1, 0))
            if cfg.log_verbose:
                S_t = pdot(phi, z1) / 2 + calc_Sb(x)
                K_t = calc_K(v)
                ys = (S_t + K_t, S_t, K_t, it1)
            else:
                ys = None
            return (x, v, Qd, hist, iters, flag), ys

        hist0 = _hmc.zhist_init(z0, g_ord if use_guess else 1)
        (x1, v1, _, hist1, iters, flag), traj = lax.scan(
            body, (x, v0, Qd0, hist0, it0, flag0), None, length=Nt)
        z_last = _hmc.zhist_last(hist1)

        coeffs1 = coeffs_of(x1)
        z1, S1, it2, fl2 = S_of(x1, coeffs1, tol2, x0=z_last)
        iters = iters + it2
        flag = jnp.maximum(flag, fl2)
        K1 = calc_K(v1)
        H1 = S1 + K1
        dH = H1 - H0
        Pacc = jnp.minimum(1.0, jnp.exp(-dH))
        u = jax.random.uniform(k_acc, Pacc.shape, dtype=Pacc.dtype)
        accept = (u < Pacc) & (flag == 0)
        x_new = jnp.where(accept, x1, x)
        v_new = jnp.where(accept, v1, -v0)
        mean_iters = (iters + Nt + 1) // (Nt + 2)
        if not cfg.log_verbose:
            traj_out = (jnp.nan, jnp.nan, jnp.nan, jnp.nan)
        else:
            traj_out = traj
        out = (x_new, v_new, accept, mean_iters.astype(jnp.int32), dH,
               flag, H1, S1, K1, traj_out[0], traj_out[1], traj_out[2],
               traj_out[3], key)
        if use_defl:
            out = out + (defl,)
        return out

    from elphdynamics_tpu.ops.deflation import DeflationState as _DState

    if chains_axis is None:
        if params_axis is not None:
            raise ValueError("params_axis requires a chains_axis (2-D mesh)")
        in_specs = (P(), P(), P(), P(), P())
        out_specs = (P(),) * 14
        if use_defl:
            dspec = _DState(W=P(None, plan.axis, None), chol=P(),
                            pvec=P(plan.axis, None), lam_max=P())
            in_specs = in_specs + (dspec,)
            out_specs = out_specs + (dspec,)
        sharded = jax.shard_map(
            step_local, mesh=mesh,
            in_specs=in_specs, out_specs=out_specs,
            check_vma=False,
        )
    else:
        # 2-D (chain × site) mesh: per-chain replicated bond fields over the
        # site axis, chain axis pure data parallel
        ca = chains_axis
        p_spec = P(ca) if params_axis == 0 else P()
        in_axes = (params_axis, 0, 0, 0, None) + ((0,) if use_defl else ())
        in_specs = (p_spec, P(ca), P(ca), P(ca), P())
        out_specs = (P(ca),) * 14
        if use_defl:
            dspec = _DState(W=P(ca, None, plan.axis, None), chol=P(ca),
                            pvec=P(ca, plan.axis, None), lam_max=P(ca))
            in_specs = in_specs + (dspec,)
            out_specs = out_specs + (dspec,)
        sharded = jax.shard_map(
            jax.vmap(step_local, in_axes=in_axes),
            mesh=mesh,
            in_specs=in_specs, out_specs=out_specs,
            check_vma=False,
        )

    def _stats(accept, iters, dH, flag, H, S, K, tH, tS, tK, tI):
        st = {"accepted": accept, "iters": iters, "delta_H": dH,
              "flag": flag,
              # H/S/K restore the hmc_sim_log.out observability of the
              # unsharded path (HMC.jl:236-304) under --site-devices
              "H": H, "S": S, "K": K}
        if cfg.log_verbose:
            st.update(traj_H=tH, traj_S=tS, traj_K=tK, traj_iters=tI)
        return st

    if use_defl:
        def step_defl(params, x, v, key, defl, dt=None):
            dt_in = cfg.dt if dt is None else dt
            (x_new, v_new, accept, iters, dH, flag, H, S, K,
             tH, tS, tK, tI, key, defl_new) = sharded(
                params, x, v, key, dt_in, defl)
            return (x_new, v_new, _stats(accept, iters, dH, flag, H, S, K,
                                         tH, tS, tK, tI), key, defl_new)

        if dynamic_dt:
            return jax.jit(step_defl)

        def step_defl_static(params, x, v, key, defl):
            return step_defl(params, x, v, key, defl)

        return jax.jit(step_defl_static)

    def step(params, x, v, key, dt=None):
        dt_in = cfg.dt if dt is None else dt
        (x_new, v_new, accept, iters, dH, flag, H, S, K,
         tH, tS, tK, tI, key) = sharded(params, x, v, key, dt_in)
        return x_new, v_new, _stats(accept, iters, dH, flag, H, S, K,
                                    tH, tS, tK, tI), key

    if dynamic_dt:
        return jax.jit(step)

    def step_static(params, x, v, key):
        return step(params, x, v, key)

    return jax.jit(step_static)


# ---------------------------------------------------------------------------
# Sharded Langevin dynamics (LangevinDynamics.jl over the site mesh).
# One stochastic force per evaluation: g ~ N(0,1), solve MᵀM·z = Mᵀg with
# psum-CG, dS_f/dx = −2·gᵀ(∂M/∂x)z. Holstein shards the phonon field with
# the electron vectors; SSH keeps the bond field replicated (as in the
# sharded HMC) and psum-assembles the force.
# ---------------------------------------------------------------------------

def _traj_solve_local(A, rhs, tol, maxiter, pdot, P_apply, axis, cfg,
                      x0=None, sync_axis=None):
    """Spin-stacked trajectory solve, shard-local: global-dot CG by
    default; with ``cfg.block`` (and tol above the f32 noise floor — the
    same gate as dynamics/solve.py:solve_oinv) the psum-aware s=2 block
    CG, which deflates one current-operator slow mode per iteration at
    zero extra matvecs (BASELINE.md §block CG)."""
    if getattr(cfg, "block", False) and tol >= 1e-6:
        from elphdynamics_tpu import solvers as _solvers
        res = _solvers.block_cg(A, rhs, X0=x0, apply_P=P_apply, tol=tol,
                                maxiter=maxiter, psum_axis=axis,
                                sync_axis=sync_axis)
        d = A(res.x) - rhs
        err = jnp.sqrt(pdot(d, d)) / jnp.maximum(jnp.sqrt(pdot(rhs, rhs)),
                                                 1e-30)
        flag = jnp.where(err > jnp.sqrt(tol), 1, 0)
        return res.x, jnp.max(res.iters), flag
    return _cg_local(A, rhs, tol, maxiter, pdot, P_apply, x0=x0,
                     sync_axis=sync_axis)


def _cg_local(A, rhs, tol, maxiter, pdot, P_apply=None, x0=None,
              sync_axis=None):
    """Shard-local preconditioned CG on the normal system (psum dots via
    ``pdot``); returns (x, iters, flag) with the residual-verification flag
    of the Models.jl ladder. ``x0`` warm-starts; ``sync_axis`` couples the
    trip count across an extra mesh axis (2-D chain × site meshes: every
    collective inside the body must execute the same number of times on
    every participant or the cross-row rendezvous deadlocks — converged
    rows run masked-idle iterations, as vmapped chains do on one chip)."""
    P_apply = P_apply or (lambda v: v)
    normb = jnp.sqrt(pdot(rhs, rhs))
    safe = jnp.where(normb > 0, normb, 1.0)
    r = rhs if x0 is None else rhs - A(x0)
    z = P_apply(r)
    p = z
    rdotz = pdot(r, z)

    def cond(st):
        j, xs, r, p, rdotz, done = st
        active = ~done
        if sync_axis is not None:
            active = lax.psum(active.astype(jnp.int32), sync_axis) > 0
        return (j < maxiter) & active

    def body(st):
        j, xs, r, p, rdotz, done = st
        Ap = A(p)
        alpha = (rdotz / pdot(p, Ap)).astype(xs.dtype)
        upd = ~done
        xs = jnp.where(upd, xs + alpha * p, xs)
        r = jnp.where(upd, r - alpha * Ap, r)
        done = done | (jnp.sqrt(pdot(r, r)) / safe < tol)
        z = P_apply(r)
        rdotz_new = pdot(r, z)
        p = jnp.where(upd, z + (rdotz_new / rdotz).astype(xs.dtype) * p, p)
        rdotz = jnp.where(upd, rdotz_new, rdotz)
        return (j + 1, xs, r, p, rdotz, done)

    j, xs, *_ = lax.while_loop(
        cond, body,
        (jnp.asarray(0),
         jnp.zeros_like(rhs) if x0 is None else x0,
         r, p, rdotz, jnp.asarray(False)))
    err = jnp.sqrt(pdot(A(xs) - rhs, A(xs) - rhs)) / safe
    flag = jnp.where(err > jnp.sqrt(tol), 1, 0)
    return xs, j, flag


def make_sharded_langevin_step(model_spec, plan: ShardPlan, mesh: Mesh,
                               Q_table, dt: float, method: str = "euler",
                               scfg=None, kpm_cfg=None,
                               chains_axis: str | None = None,
                               params_axis: int | None = None):
    """Sharded Holstein Langevin update ``(params, x, key) -> (x', stats,
    key)`` with the [N, Lτ] field partitioned P('site', None); Euler / RK /
    Heun integrators (LangevinDynamics.jl:81-324). Noise follows the exact
    key-split order of :func:`elphdynamics_tpu.dynamics.langevin.
    make_langevin_step` for parity testing. ``chains_axis`` runs the step
    chain-batched on a 2-D (chain × site) mesh — the chain axis is pure data
    parallel; the CG trip counts couple across it (see ``_cg_local``).
    ``params_axis=0`` (combined mesh only) maps a leading chain axis of the
    params leaves — the ``[tempering]`` per-rung ladder."""
    from elphdynamics_tpu.dynamics.solve import SolverConfig
    from elphdynamics_tpu.ops.fourier_accel import accelerate

    scfg = scfg or SolverConfig()
    wplan = build_wij_plan(model_spec.wij_table, model_spec.Nsites, plan.D)
    wij_sign = model_spec.wij_sign
    Ltau = model_spec.Ltau
    N = model_spec.Nsites
    dtau = model_spec.dtau
    B = plan.B
    Q_full = jnp.asarray(Q_table)

    def step_local(params, x_loc, key):
        d = lax.axis_index(plan.axis)
        Q = lax.dynamic_slice_in_dim(Q_full, d * B, B, axis=0)
        lam = lax.dynamic_slice_in_dim(params.lam, d * B, B)[:, None]
        lam2 = lax.dynamic_slice_in_dim(params.lam2, d * B, B)[:, None]
        om = lax.dynamic_slice_in_dim(params.omega, d * B, B)[:, None]
        om4 = lax.dynamic_slice_in_dim(params.omega4, d * B, B)[:, None]
        mu = lax.dynamic_slice_in_dim(params.mu, d * B, B)[:, None]
        sgn_first = (-jnp.ones(Ltau, x_loc.dtype)).at[0].set(1.0)
        sgn_last = (-jnp.ones(Ltau, x_loc.dtype)).at[-1].set(1.0)
        cplx = jnp.iscomplexobj(params.cosht)

        def pdot(a, b):
            return lax.psum(jnp.sum(fdot_fast(a, b, axis=(-2, -1))),
                            plan.axis)

        def env_of(x):
            return jnp.exp(-dtau * (lam * x + lam2 * x * x - mu))

        def mulM(env, v):
            y = env * jnp.roll(v, 1, axis=-1)
            y = ckb_mul_local(plan, params.cosht, params.sinht, y)
            return v + sgn_first * y

        def mulMT(env, v):
            z = ckb_transpose_mul_local(plan, params.cosht, params.sinht, v)
            w = env * z
            return v + sgn_last * jnp.roll(w, -1, axis=-1)

        def muldMdx(env, x, u, v):
            dd = (-sgn_first) * dtau * (lam + 2.0 * lam2 * x) * env \
                * jnp.roll(v, 1, axis=-1)
            y = ckb_transpose_mul_local(plan, params.cosht, params.sinht, u)
            if jnp.iscomplexobj(y) or jnp.iscomplexobj(dd):
                # complex-hopping force: Re[u†·∂M/∂x·v] (models/holstein.py)
                return jnp.real(jnp.conj(y) * dd)
            return y * dd

        def calc_dSbdx(x):
            lap = jnp.roll(x, 1, axis=-1) + jnp.roll(x, -1, axis=-1) - 2.0 * x
            g = dtau * (om ** 2 * x + 4.0 * om4 * x ** 3) - lap / dtau
            g = g - dtau * lam   # shifted (Langevin convention)
            if wplan is not None:
                g = wij_dsb_local(wplan, plan.axis, params.wij, wij_sign,
                                  dtau, x, g)
            return g

        if kpm_cfg is not None:
            kpm_setup, kpm_make_apply = _kpm_local(
                plan, kpm_cfg, Ltau, N, x_loc.dtype, plan.axis,
                _holstein_kpm_ops(plan, params), cplx=cplx)
        else:
            kpm_setup = kpm_make_apply = None

        def force(x, key, kst):
            """One stochastic force evaluation (fresh g), exact unsharded
            key-split order (total_force: key, kg = split(key)). Complex
            hopping draws the circular complex probe of
            utils.dtypes.trace_noise (E[gg†] = I)."""
            env = env_of(x)
            key, kg = jax.random.split(key)
            if cplx:
                gg = jax.random.normal(kg, (2, N, Ltau), dtype=x.dtype)
                half = jnp.asarray(0.5, x.dtype) ** 0.5
                g_full = (gg[0] + 1j * gg[1]) * half
            else:
                g_full = jax.random.normal(kg, (N, Ltau), dtype=x.dtype)
            g = lax.dynamic_slice_in_dim(g_full, d * B, B, axis=0)

            def A(v):
                return mulMT(env, mulM(env, v))

            P_apply = (kpm_make_apply(kst, env) if kst is not None else None)
            rhs = mulMT(env, g)
            z, it, flag = _cg_local(A, rhs, scfg.tol, scfg.maxiter, pdot,
                                    P_apply, sync_axis=chains_axis)
            dSf = -2.0 * muldMdx(env, x, g, z)
            return dSf + calc_dSbdx(x), it, flag, key

        # noise: key, kn = split(key) then eta = normal(kn, [N, Lτ])
        key, kn = jax.random.split(key)
        eta_full = jax.random.normal(kn, (N, Ltau), dtype=x_loc.dtype)
        eta = lax.dynamic_slice_in_dim(eta_full, d * B, B, axis=0)
        kst = (kpm_setup(env_of(x_loc), jax.random.PRNGKey(1234))
               if kpm_cfg is not None else None)

        if method == "euler":
            dS, it, flag, key = force(x_loc, key, kst)
            QdSdx = accelerate(Q, dS, 1.0)
            sqrtQeta = accelerate(Q, eta, 0.5)
            x_new = x_loc + jnp.sqrt(2.0 * dt) * sqrtQeta - dt * QdSdx
        elif method == "rk":
            f1, it1, fl1, key = force(x_loc, key, kst)
            dx = jnp.sqrt(2.0 * dt) * eta - dt * f1
            f2, it, fl2, key = force(x_loc + dx, key, kst)
            favg = (f1 + f2) / 2.0
            QdSdx = accelerate(Q, favg, 1.0)
            sqrtQeta = accelerate(Q, eta, 0.5)
            x_new = x_loc + jnp.sqrt(2.0 * dt) * sqrtQeta - dt * QdSdx
            flag = jnp.maximum(fl1, fl2)
        elif method == "heun":
            xi = accelerate(Q, eta, 0.5)
            f1, it1, fl1, key = force(x_loc, key, kst)
            dG1 = accelerate(Q, f1, 1.0)
            dx = jnp.sqrt(2.0 * dt) * xi - dt * dG1
            f2, it2, fl2, key = force(x_loc + dx, key, kst)
            dG2 = accelerate(Q, f2, 1.0)
            x_new = x_loc + jnp.sqrt(2.0 * dt) * xi - dt * (dG1 + dG2) / 2.0
            it = (it1 + it2) // 2
            flag = jnp.maximum(fl1, fl2)
        else:
            raise ValueError(method)
        return x_new, it.astype(jnp.int32), flag, key

    if chains_axis is None:
        if params_axis is not None:
            raise ValueError("params_axis requires a chains_axis (2-D mesh)")
        sharded = jax.shard_map(
            step_local, mesh=mesh,
            in_specs=(P(), P(plan.axis, None), P()),
            out_specs=(P(plan.axis, None), P(), P(), P()),
            check_vma=False,
        )
    else:
        ca = chains_axis
        p_spec = P(ca) if params_axis == 0 else P()
        sharded = jax.shard_map(
            jax.vmap(step_local, in_axes=(params_axis, 0, 0)), mesh=mesh,
            in_specs=(p_spec, P(ca, plan.axis, None), P(ca)),
            out_specs=(P(ca, plan.axis, None), P(ca), P(ca), P(ca)),
            check_vma=False,
        )

    def step(params, x, key):
        x_new, iters, flag, key = sharded(params, x, key)
        return x_new, {"iters": iters, "flag": flag}, key

    return jax.jit(step)


def make_sharded_ssh_langevin_step(model_spec, plan: ShardPlan, mesh: Mesh,
                                   Q_table, dt: float, method: str = "euler",
                                   scfg=None, kpm_cfg=None,
                                   chains_axis: str | None = None,
                                   params_axis: int | None = None):
    """Sharded SSH Langevin update: bond-phonon field replicated, electron
    vectors sharded, fermionic force psum-assembled (as in
    :func:`make_sharded_ssh_hmc_step`). ``chains_axis``/``params_axis`` as
    in :func:`make_sharded_langevin_step`."""
    from elphdynamics_tpu.dynamics.solve import SolverConfig
    from elphdynamics_tpu.models import ssh as S
    from elphdynamics_tpu.ops.fourier_accel import accelerate

    scfg = scfg or SolverConfig()
    Ltau = model_spec.Ltau
    N = model_spec.Nsites
    Nph = model_spec.Nph
    dtau = model_spec.dtau
    B = plan.B
    Q_full = jnp.asarray(Q_table)
    prim = jnp.asarray(model_spec.primary_phonon)
    ph_of_site, ph_mask, bond_orig = _ssh_group_phonons(model_spec, plan)

    def step_local(params, x, key):
        d = lax.axis_index(plan.axis)
        mulM, mulMT, expmu_loc = _ssh_local_ops(model_spec, plan, params)
        cplx = params.t_phase is not None

        def pdot(a, b):
            # Re(a†·b) on the complex-hopping path (utils/dtypes.fdot_fast)
            return lax.psum(jnp.sum(fdot_fast(a, b, axis=(-2, -1))),
                            plan.axis)

        def coeffs_of(x):
            # (cosh, sinh) of Δτ·t′ with the Peierls phase folded into s —
            # models/ssh.py:ckb_coeffs without the dense-mode Kd (the sharded
            # path always runs the halo fold; conj(s) endpoint placement is
            # applied by _group_coeffs)
            tp = S.hopping_t_prime(model_spec, params, x)
            tp_ckb = jnp.take(tp, jnp.asarray(model_spec.ckb_to_bond), axis=-2)
            arg = dtau * tp_ckb
            c, sn = jnp.cosh(arg), jnp.sinh(arg)
            if params.t_phase is not None:
                ph_ckb = jnp.take(params.t_phase,
                                  jnp.asarray(model_spec.ckb_to_bond), axis=-1)
                sn = ph_ckb[:, None] * sn
                c = c.astype(sn.dtype)
            return (c, sn)

        muldmdx_partial = _ssh_muldmdx_builder(
            model_spec, plan, ph_of_site, ph_mask, bond_orig, expmu_loc,
            params)

        if kpm_cfg is not None:
            kpm_setup, kpm_make_apply = _kpm_local(
                plan, kpm_cfg, Ltau, N, x.dtype, plan.axis,
                _ssh_kpm_ops(plan, expmu_loc), cplx=cplx)
        else:
            kpm_setup = kpm_make_apply = None

        def force(x, key, kst):
            coeffs = coeffs_of(x)
            key, kg = jax.random.split(key)
            if cplx:
                # circular complex probes, E[gg†] = I — exactly
                # utils.dtypes.trace_noise's draw with the same key
                gg = jax.random.normal(kg, (2, N, Ltau), dtype=x.dtype)
                half = jnp.asarray(0.5, x.dtype) ** 0.5
                g_full = (gg[0] + 1j * gg[1]) * half
            else:
                g_full = jax.random.normal(kg, (N, Ltau), dtype=x.dtype)
            g = lax.dynamic_slice_in_dim(g_full, d * B, B, axis=0)

            def A(v):
                return mulMT(coeffs, mulM(coeffs, v))

            P_apply = (kpm_make_apply(kst, coeffs) if kst is not None
                       else None)
            rhs = mulMT(coeffs, g)
            z, it, flag = _cg_local(A, rhs, scfg.tol, scfg.maxiter, pdot,
                                    P_apply, sync_axis=chains_axis)
            part = muldmdx_partial(coeffs, x, g, z)
            dSf = -2.0 * lax.psum(part, plan.axis)
            tied = jnp.zeros_like(dSf).at[prim].add(dSf)
            dSf = jnp.take(tied, prim, axis=-2)
            return dSf + S.calc_dSbdx(model_spec, params, x, True), it, \
                flag, key

        key, kn = jax.random.split(key)
        eta = jnp.take(jax.random.normal(kn, (Nph, Ltau), dtype=x.dtype),
                       prim, axis=-2)   # ops.tie on the noise
        kst = (kpm_setup(coeffs_of(x), jax.random.PRNGKey(1234))
               if kpm_cfg is not None else None)

        if method == "euler":
            dS, it, flag, key = force(x, key, kst)
            QdSdx = accelerate(Q_full, dS, 1.0)
            sqrtQeta = accelerate(Q_full, eta, 0.5)
            x_new = x + jnp.sqrt(2.0 * dt) * sqrtQeta - dt * QdSdx
        elif method == "rk":
            f1, it1, fl1, key = force(x, key, kst)
            dx = jnp.sqrt(2.0 * dt) * eta - dt * f1
            f2, it, fl2, key = force(x + dx, key, kst)
            favg = (f1 + f2) / 2.0
            QdSdx = accelerate(Q_full, favg, 1.0)
            sqrtQeta = accelerate(Q_full, eta, 0.5)
            x_new = x + jnp.sqrt(2.0 * dt) * sqrtQeta - dt * QdSdx
            flag = jnp.maximum(fl1, fl2)
        elif method == "heun":
            xi = accelerate(Q_full, eta, 0.5)
            f1, it1, fl1, key = force(x, key, kst)
            dG1 = accelerate(Q_full, f1, 1.0)
            dx = jnp.sqrt(2.0 * dt) * xi - dt * dG1
            f2, it2, fl2, key = force(x + dx, key, kst)
            dG2 = accelerate(Q_full, f2, 1.0)
            x_new = x + jnp.sqrt(2.0 * dt) * xi - dt * (dG1 + dG2) / 2.0
            it = (it1 + it2) // 2
            flag = jnp.maximum(fl1, fl2)
        else:
            raise ValueError(method)
        return x_new, it.astype(jnp.int32), flag, key

    if chains_axis is None:
        if params_axis is not None:
            raise ValueError("params_axis requires a chains_axis (2-D mesh)")
        sharded = jax.shard_map(
            step_local, mesh=mesh,
            in_specs=(P(), P(), P()),
            out_specs=(P(), P(), P(), P()),
            check_vma=False,
        )
    else:
        ca = chains_axis
        p_spec = P(ca) if params_axis == 0 else P()
        sharded = jax.shard_map(
            jax.vmap(step_local, in_axes=(params_axis, 0, 0)), mesh=mesh,
            in_specs=(p_spec, P(ca), P(ca)),
            out_specs=(P(ca), P(ca), P(ca), P(ca)),
            check_vma=False,
        )

    def step(params, x, key):
        x_new, iters, flag, key = sharded(params, x, key)
        return x_new, {"iters": iters, "flag": flag}, key

    return jax.jit(step)


# ---------------------------------------------------------------------------
# Sharded special updates (SpecialUpdates.jl over the site mesh). The
# reflection/swap Metropolis tests are exact: refresh φ at the current
# configuration (S₀ = Σ±|R±|²/2 + Sb, solve-free), propose the global move,
# evaluate the new action with a tol² solve, accept/reject. Under
# --site-devices these solves previously gathered to one device — here they
# ride the same halo-fold + psum-CG machinery as the sampler, so a problem
# that needs site sharding for the sampler can special-update too. Key-split
# order matches dynamics/special_updates.py exactly (full-draw-keep-rows),
# so a sharded update reproduces the unsharded accept decisions.
# ---------------------------------------------------------------------------

def _holstein_special_ctx(model_spec, plan: ShardPlan, params, wplan,
                          kpm_cfg, dtype, sync_axis=None):
    """Shard-local Holstein closures for the special-update Metropolis tests
    (the models/holstein.py formulas on the local site block — the same
    definitions as make_sharded_hmc_step's step_local). ``sync_axis``
    couples the CG trip count across the chain axis of a 2-D mesh."""
    from elphdynamics_tpu.utils.dtypes import fdot

    Ltau = model_spec.Ltau
    N = model_spec.Nsites
    dtau = model_spec.dtau
    B = plan.B
    wij_sign = model_spec.wij_sign

    d = lax.axis_index(plan.axis)
    lam = lax.dynamic_slice_in_dim(params.lam, d * B, B)[:, None]
    lam2 = lax.dynamic_slice_in_dim(params.lam2, d * B, B)[:, None]
    om = lax.dynamic_slice_in_dim(params.omega, d * B, B)[:, None]
    om4 = lax.dynamic_slice_in_dim(params.omega4, d * B, B)[:, None]
    mu = lax.dynamic_slice_in_dim(params.mu, d * B, B)[:, None]
    sgn_first = (-jnp.ones(Ltau, dtype)).at[0].set(1.0)
    sgn_last = (-jnp.ones(Ltau, dtype)).at[-1].set(1.0)

    def psum(s):
        return lax.psum(s, plan.axis)

    def pdot(a, b):
        return psum(jnp.sum(fdot(a, b, axis=tuple(range(a.ndim)))))

    def env_of(x):
        return jnp.exp(-dtau * (lam * x + lam2 * x * x - mu))

    def mulM(env, v):
        y = env * jnp.roll(v, 1, axis=-1)
        y = ckb_mul_local(plan, params.cosht, params.sinht, y)
        return v + sgn_first * y

    def mulMT(env, v):
        z = ckb_transpose_mul_local(plan, params.cosht, params.sinht, v)
        w = env * z
        return v + sgn_last * jnp.roll(w, -1, axis=-1)

    def calc_Lam(x):
        return jnp.exp(-dtau * (lam * x + lam2 * x * x) / 2.0)

    def mulLambda(Lam, v):
        return sgn_last * jnp.roll(Lam * v, -1, axis=-1)

    def mulLambdaInv(Lam, v):
        return sgn_first * jnp.roll(v, 1, axis=-1) / Lam

    def calc_Sb(x):
        dx = x - jnp.roll(x, 1, axis=-1)
        sb = om ** 2 * x * x / 2 + om4 * x ** 4 + dx * dx / (2 * dtau ** 2)
        total = jnp.sum(fdot(sb, jnp.ones_like(sb), axis=(0, 1)))
        if wplan is not None:
            total = total + wij_sb_local(
                wplan, plan.axis, params.wij, wij_sign, 1.0, x)
        return dtau * psum(total)

    cplx = jnp.iscomplexobj(params.cosht)
    if kpm_cfg is not None:
        kpm_setup, kpm_make_apply = _kpm_local(
            plan, kpm_cfg, Ltau, N, dtype, plan.axis,
            _holstein_kpm_ops(plan, params), cplx=cplx)
    else:
        kpm_setup = kpm_make_apply = None

    def refresh_phi(x_loc, key):
        """φ± = Λ⁻¹MᵀR± and exact S₀ (HMC.jl:666-692); R is drawn full and
        sliced so every shard sees the unsharded key stream. Complex hopping
        packs both spins into one complex stack entry
        (utils/dtypes.pseudofermion_noise) — S₀ = Re(R†R)/2 is the identical
        two-spin real sum either way."""
        key, kp = jax.random.split(key)
        R_full = jax.random.normal(kp, (2, N, Ltau), dtype=dtype)
        R = lax.dynamic_slice_in_dim(R_full, d * B, B, axis=1)
        if cplx:
            R = (R[0] + 1j * R[1])[None]
        env = env_of(x_loc)
        MtR = mulMT(env, R)
        phi = mulLambdaInv(calc_Lam(x_loc), MtR)
        S0 = fdot(R_full, R_full, axis=(0, -2, -1)) / 2 + calc_Sb(x_loc)
        return phi, S0, key

    def eval_S(x_loc, phi, tol, maxiter):
        """S = Sb + Σ± (Λφ±)ᵀ(MᵀM)⁻¹(Λφ±)/2 via the sharded tol² solve
        (special_updates._eval_S on the mesh)."""
        env = env_of(x_loc)
        Lphi = mulLambda(calc_Lam(x_loc), phi)
        P_apply = None
        if kpm_setup is not None:
            kst = kpm_setup(env, jax.random.PRNGKey(1234))
            P_apply = kpm_make_apply(kst, env)
        z, it, flag = _cg_local(lambda v: mulMT(env, mulM(env, v)), Lphi,
                                tol, maxiter, pdot, P_apply,
                                sync_axis=sync_axis)
        return pdot(Lphi, z) / 2 + calc_Sb(x_loc), it, flag

    return SimpleNamespace(d=d, B=B, refresh_phi=refresh_phi, eval_S=eval_S)


def make_sharded_reflection_update(model_spec, plan: ShardPlan, mesh: Mesh,
                                   cfg, kpm_cfg=None,
                                   chains_axis: str | None = None,
                                   params_axis: int | None = None):
    """Site-sharded Holstein reflection update ``(params, x, key) ->
    (x', acc_rate, key)`` with x partitioned P('site', None)
    (SpecialUpdates.jl:97-160; unsharded analog
    :func:`~elphdynamics_tpu.dynamics.special_updates.make_reflection_update`).
    With ``chains_axis`` the update vmaps over the local chain block of a
    2-D chain × site mesh (per-chain keys ⇒ per-chain sites/decisions);
    ``params_axis=0`` additionally maps stacked per-chain params (the
    tempering ladder) over that chain axis, as in make_sharded_hmc_step."""
    N = model_spec.Nsites
    nmoves = min(cfg.n_moves, N)
    wplan = build_wij_plan(model_spec.wij_table, N, plan.D)

    def update_local(params, x_loc, key):
        ctx = _holstein_special_ctx(model_spec, plan, params, wplan,
                                    kpm_cfg, x_loc.dtype,
                                    sync_axis=chains_axis)
        key, ks = jax.random.split(key)
        sites = jax.random.randint(ks, (nmoves,), 0, N)

        def body(carry, site):
            x, accepted, key = carry
            phi, S0, key = ctx.refresh_phi(x, key)
            r = jnp.clip(site - ctx.d * ctx.B, 0, ctx.B - 1)
            has = (site >= ctx.d * ctx.B) & (site < (ctx.d + 1) * ctx.B)
            x_new = x.at[r].multiply(
                jnp.where(has, -1.0, 1.0).astype(x.dtype))
            S1, _, flag = ctx.eval_S(x_new, phi, cfg.tol ** 2, cfg.maxiter)
            Pacc = jnp.minimum(1.0, jnp.exp(-(S1 - S0)))
            key, ka = jax.random.split(key)
            acc = (jax.random.uniform(ka, dtype=Pacc.dtype) < Pacc) \
                & (flag == 0)
            x = jnp.where(acc, x_new, x)
            return (x, accepted + acc, key), None

        (x_loc, accepted, key), _ = lax.scan(
            body, (x_loc, jnp.asarray(0, jnp.int32), key), sites)
        return x_loc, accepted / jnp.maximum(nmoves, 1), key

    if chains_axis is None:
        if params_axis is not None:
            raise ValueError("params_axis requires a chains_axis (2-D mesh)")
        sharded = jax.shard_map(
            update_local, mesh=mesh,
            in_specs=(P(), P(plan.axis, None), P()),
            out_specs=(P(plan.axis, None), P(), P()),
            check_vma=False,
        )
    else:
        ca = chains_axis
        p_spec = P(ca) if params_axis == 0 else P()
        sharded = jax.shard_map(
            jax.vmap(update_local, in_axes=(params_axis, 0, 0)), mesh=mesh,
            in_specs=(p_spec, P(ca, plan.axis, None), P(ca)),
            out_specs=(P(ca, plan.axis, None), P(ca), P(ca)),
            check_vma=False,
        )
    return jax.jit(sharded)


def make_sharded_swap_update(model_spec, plan: ShardPlan, mesh: Mesh,
                             cfg, kpm_cfg=None, is_holstein=True,
                             chains_axis: str | None = None,
                             params_axis: int | None = None):
    """Site-sharded swap update (SpecialUpdates.jl:233-366). Holstein
    exchanges the two site worldlines of a random checkerboard bond (the
    rows are psum-gathered across shards — one [Lτ] vector each); SSH swaps
    two random bond-phonon worldlines on the replicated field and runs only
    the Metropolis solves sharded. ``chains_axis``/``params_axis`` as in
    :func:`make_sharded_reflection_update`."""
    nmoves = cfg.n_moves

    if is_holstein:
        N = model_spec.Nsites
        if model_spec.Nbonds == 0 or nmoves == 0:
            return None
        wplan = build_wij_plan(model_spec.wij_table, N, plan.D)
        s1 = jnp.asarray(model_spec.ckb.neighbor_table[0])
        s2 = jnp.asarray(model_spec.ckb.neighbor_table[1])

        def update_local(params, x_loc, key):
            ctx = _holstein_special_ctx(model_spec, plan, params, wplan,
                                        kpm_cfg, x_loc.dtype,
                                        sync_axis=chains_axis)

            def get_row(x, i):
                r = jnp.clip(i - ctx.d * ctx.B, 0, ctx.B - 1)
                has = (i >= ctx.d * ctx.B) & (i < (ctx.d + 1) * ctx.B)
                row = lax.dynamic_slice_in_dim(x, r, 1, axis=0)[0]
                return lax.psum(jnp.where(has, row, 0.0), plan.axis)

            def set_row(x, i, val):
                r = jnp.clip(i - ctx.d * ctx.B, 0, ctx.B - 1)
                has = (i >= ctx.d * ctx.B) & (i < (ctx.d + 1) * ctx.B)
                cur = lax.dynamic_slice_in_dim(x, r, 1, axis=0)[0]
                return lax.dynamic_update_slice_in_dim(
                    x, jnp.where(has, val, cur)[None], r, axis=0)

            def body(carry, _):
                x, accepted, key = carry
                key, kb = jax.random.split(key)
                b = jax.random.randint(kb, (), 0, model_spec.Nbonds)
                i, j = s1[b], s2[b]
                phi, S0, key = ctx.refresh_phi(x, key)
                row_i = get_row(x, i)
                row_j = get_row(x, j)
                x_new = set_row(set_row(x, i, row_j), j, row_i)
                S1v, _, flag = ctx.eval_S(x_new, phi, cfg.tol ** 2,
                                          cfg.maxiter)
                Pacc = jnp.minimum(1.0, jnp.exp(-(S1v - S0)))
                key, ka = jax.random.split(key)
                acc = (jax.random.uniform(ka, dtype=Pacc.dtype) < Pacc) \
                    & (flag == 0)
                x = jnp.where(acc, x_new, x)
                return (x, accepted + acc, key), None

            (x_loc, accepted, key), _ = lax.scan(
                body, (x_loc, jnp.asarray(0, jnp.int32), key), None,
                length=nmoves)
            return x_loc, accepted / jnp.maximum(nmoves, 1), key

        if chains_axis is None:
            if params_axis is not None:
                raise ValueError(
                    "params_axis requires a chains_axis (2-D mesh)")
            sharded = jax.shard_map(
                update_local, mesh=mesh,
                in_specs=(P(), P(plan.axis, None), P()),
                out_specs=(P(plan.axis, None), P(), P()),
                check_vma=False,
            )
        else:
            ca = chains_axis
            p_spec = P(ca) if params_axis == 0 else P()
            sharded = jax.shard_map(
                jax.vmap(update_local, in_axes=(params_axis, 0, 0)),
                mesh=mesh,
                in_specs=(p_spec, P(ca, plan.axis, None), P(ca)),
                out_specs=(P(ca, plan.axis, None), P(ca), P(ca)),
                check_vma=False,
            )
        return jax.jit(sharded)

    # --- SSH: replicated bond-phonon field, sharded electron solves
    from elphdynamics_tpu.models import ssh as Sm
    from elphdynamics_tpu.utils.dtypes import fdot

    Ltau = model_spec.Ltau
    N = model_spec.Nsites
    Nph = model_spec.Nph
    B = plan.B
    if Nph < 2 or nmoves == 0:
        return None

    def update_local(params, x, key):
        d = lax.axis_index(plan.axis)
        mulM, mulMT, expmu_loc = _ssh_local_ops(model_spec, plan, params)

        def pdot(a, b):
            return lax.psum(jnp.sum(fdot(a, b, axis=tuple(range(a.ndim)))),
                            plan.axis)

        if kpm_cfg is not None:
            kpm_setup, kpm_make_apply = _kpm_local(
                plan, kpm_cfg, Ltau, N, x.dtype, plan.axis,
                _ssh_kpm_ops(plan, expmu_loc))
        else:
            kpm_setup = kpm_make_apply = None

        def refresh_phi(x, key):
            key, kp = jax.random.split(key)
            R_full = jax.random.normal(kp, (2, N, Ltau), dtype=x.dtype)
            R = lax.dynamic_slice_in_dim(R_full, d * B, B, axis=1)
            coeffs = Sm.ckb_coeffs(model_spec, params, x)
            phi = mulMT(coeffs, R)
            S0 = fdot(R_full, R_full, axis=(0, -2, -1)) / 2 \
                + Sm.calc_Sb(model_spec, params, x, False)
            return phi, S0, key

        def eval_S(x, phi):
            coeffs = Sm.ckb_coeffs(model_spec, params, x)
            P_apply = None
            if kpm_setup is not None:
                kst = kpm_setup(coeffs, jax.random.PRNGKey(1234))
                P_apply = kpm_make_apply(kst, coeffs)
            z, it, flag = _cg_local(
                lambda v: mulMT(coeffs, mulM(coeffs, v)), phi,
                cfg.tol ** 2, cfg.maxiter, pdot, P_apply,
                sync_axis=chains_axis)
            return (pdot(phi, z) / 2
                    + Sm.calc_Sb(model_spec, params, x, False)), it, flag

        def body(carry, _):
            x, accepted, key = carry
            key, k1, k2 = jax.random.split(key, 3)
            i = jax.random.randint(k1, (), 0, Nph)
            j = jax.random.randint(k2, (), 0, Nph - 1)
            j = jnp.where(j >= i, j + 1, j)
            phi, S0, key = refresh_phi(x, key)
            xi, xj = x[i], x[j]
            x_new = x.at[i].set(xj).at[j].set(xi)
            S1v, _, flag = eval_S(x_new, phi)
            Pacc = jnp.minimum(1.0, jnp.exp(-(S1v - S0)))
            key, ka = jax.random.split(key)
            acc = (jax.random.uniform(ka, dtype=Pacc.dtype) < Pacc) \
                & (flag == 0)
            x = jnp.where(acc, x_new, x)
            return (x, accepted + acc, key), None

        (x, accepted, key), _ = lax.scan(
            body, (x, jnp.asarray(0, jnp.int32), key), None, length=nmoves)
        return x, accepted / jnp.maximum(nmoves, 1), key

    if chains_axis is None:
        if params_axis is not None:
            raise ValueError("params_axis requires a chains_axis (2-D mesh)")
        sharded = jax.shard_map(
            update_local, mesh=mesh,
            in_specs=(P(), P(), P()),
            out_specs=(P(), P(), P()),
            check_vma=False,
        )
    else:
        ca = chains_axis
        p_spec = P(ca) if params_axis == 0 else P()
        sharded = jax.shard_map(
            jax.vmap(update_local, in_axes=(params_axis, 0, 0)), mesh=mesh,
            in_specs=(p_spec, P(ca), P(ca)),
            out_specs=(P(ca), P(ca), P(ca)),
            check_vma=False,
        )
    return jax.jit(sharded)
