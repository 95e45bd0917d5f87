"""Parallel tempering over a coupling ladder (beyond reference scope).

Strong-coupling Holstein HMC sticks in ordered (CDW) configurations; the
reference's global reflection/swap updates (SpecialUpdates.jl) move single
sites or bonds and decorrelate slowly near the transition. Parallel
tempering runs K replicas at scaled electron-phonon couplings
λ_r = ladder[r]·λ (rung 0 = the physical coupling) and periodically
proposes exchanging whole configurations between adjacent rungs — the
weakly-coupled rungs mix fast and tunnel ergodicity down the ladder.

Exactness: the exchange is Metropolis on the JOINT (x, v, φ) chain. φ is
refreshed exactly first (φ = Λ⁻¹MᵀR gives S₀ = Σ|R|²/2 + Sb with no
solve — the same trick the reference's special updates use,
HMC.jl:666-692), so one O-solve per chain evaluates the cross action
S_r(x_partner) and

    P(swap) = min(1, exp(−[S_a(x_b) + S_b(x_a) − S_a(x_a) − S_b(x_b)])).

(x, v, φ) swap together; the proposal is symmetric and v's Gaussian is
rung-independent (the mass table is shared) — a valid Gibbs + Metropolis
composition. The swapped φ is implicit: the next HMC update refreshes φ
anyway, so only x and v are returned.

Chain layout: C = K·M chains, rung r owns the contiguous block
[r·M, (r+1)·M); lane m of rung r only ever exchanges with lane m of
rungs r±1 (even/odd pair parity alternates per attempt, the standard
checkerboard schedule).

Shape: everything is one batched program — the K·M refreshes, the
K·M cross solves (batched CG over all chains at once) and the masked
swap are single vmapped calls; no per-pair Python loops.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from elphdynamics_tpu.dynamics.solve import (SolverConfig, resolve_precond,
                                             solve_oinv)
from elphdynamics_tpu.dynamics.special_updates import _refresh_phi
from elphdynamics_tpu.models.adapter import ModelOps
from elphdynamics_tpu.utils.dtypes import fdot


class TemperingConfig(NamedTuple):
    ladder: tuple = (1.0,)   # coupling multipliers; ladder[0] MUST be 1.0
    freq: int = 5            # attempt exchanges every `freq` sampler updates
    tol: float = 1e-5
    maxiter: int = 1000


def ladder_params(params, tcfg: TemperingConfig, n_chains: int):
    """Stack per-chain params: rung r (chains [r·M, (r+1)·M)) scales the
    electron-phonon coupling by ladder[r] — λ for Holstein, α for SSH
    (the quadratic coupling λ₂/α₂ scales with ladder² so it keeps its
    relative strength)."""
    K = len(tcfg.ladder)
    if n_chains % K:
        raise ValueError(f"--chains ({n_chains}) must be divisible by the "
                         f"tempering ladder size ({K})")
    if abs(float(tcfg.ladder[0]) - 1.0) > 1e-12:
        raise ValueError("[tempering] ladder[0] must be 1.0 (the physical "
                         "coupling; measurements bin rung 0 only)")
    M = n_chains // K
    mult = np.repeat(np.asarray(tcfg.ladder, np.float64), M)

    def stack(leaf):
        out = jnp.broadcast_to(leaf, (n_chains,) + jnp.shape(leaf)).copy()
        return out

    stacked = jax.tree.map(stack, params)
    lin, quad = (("lam", "lam2") if hasattr(params, "lam")
                 else ("alpha", "alpha2"))
    base = getattr(params, lin)
    m1 = jnp.asarray(mult, base.dtype).reshape(
        (n_chains,) + (1,) * base.ndim)
    return stacked._replace(**{
        lin: getattr(stacked, lin) * m1,
        quad: getattr(stacked, quad) * (m1 * m1),
    })


def target_mask(tcfg: TemperingConfig, n_chains: int) -> np.ndarray:
    """Boolean [C]: chains at the physical coupling (rung 0)."""
    K = len(tcfg.ladder)
    M = n_chains // K
    m = np.zeros(n_chains, dtype=bool)
    m[:M] = True
    return m


def make_exchange_step(ops: ModelOps, tcfg: TemperingConfig, n_chains: int,
                       precond=None):
    """Build ``exchange(params_stack, x, v, keys, parity) ->
    (x, v, acc_rate, iters, flag, keys)``.

    ``params_stack`` has leaves [C, ...] (from :func:`ladder_params`);
    ``x``/``v`` are [C, Nph, Lτ]; ``keys`` [C, 2]. ``parity`` ∈ {0, 1}
    selects the even/odd rung-pair checkerboard.
    """
    K = len(tcfg.ladder)
    M = n_chains // K
    scfg = SolverConfig(tol=tcfg.tol, maxiter=tcfg.maxiter)

    def eval_S(params_c, x_c, phi_c):
        """S = Sb + Σ± (Λφ±)ᵀO⁻¹(Λφ±)/2 at (params_c, x_c) with the fixed
        pseudofermion φ_c (HMC.jl:743-783)."""
        derived = ops.derived(params_c, x_c)
        if ops.calc_Lambda is not None:
            Lam = ops.calc_Lambda(params_c, x_c)
            Lphi = ops.mulLambda(Lam, phi_c)
        else:
            Lphi = phi_c
        pa = resolve_precond(precond, params_c, x_c)
        sol = solve_oinv(ops, params_c, derived, Lphi, scfg, pa)
        Sf = fdot(Lphi, sol.x, axis=(0, -2, -1)) / 2
        S = Sf + ops.calc_Sb(params_c, x_c, False)
        iters = (jnp.sum(sol.iters) + 1) // 2
        return S, iters, jnp.max(sol.flag)

    def exchange(params_stack, x, v, keys, parity):
        # exact φ refresh on every chain (solve-free)
        phi, S0, keys = jax.vmap(
            lambda p, xc, k: _refresh_phi(ops, p, xc, k))(params_stack, x, keys)

        # partner lane: rung pairing (2i+parity, 2i+parity+1); chains in
        # rungs outside a complete pair keep themselves as partner
        rung = jnp.arange(n_chains) // M
        rel = rung - parity
        lower = (rel % 2 == 0) & (rel >= 0) & (rung + 1 < K)
        upper = (rel % 2 == 1) & (rung - 1 >= 0) & (rel - 1 >= 0)
        partner = jnp.where(lower, jnp.arange(n_chains) + M,
                            jnp.where(upper, jnp.arange(n_chains) - M,
                                      jnp.arange(n_chains)))

        # one batched cross solve: S_c(x_partner, φ_partner) — the
        # pseudofermion TRAVELS with its configuration (the standard
        # pseudofermion-PT choice: the φ-noise then cancels pairwise, e.g.
        # identical rungs accept with probability exactly 1; swapping x
        # under a held φ is also valid Metropolis but its acceptance is
        # suppressed by O(1) pseudofermion fluctuations)
        S_cross, iters, flag = jax.vmap(eval_S)(
            params_stack, x[partner], phi[partner])

        dS_half = S_cross - S0                      # per-chain half of ΔS
        dS_pair = dS_half + dS_half[partner]        # symmetric: same on a,b
        paired = partner != jnp.arange(n_chains)
        # one uniform per PAIR: lower member draws, upper reuses via gather
        key_pair, keys = _split_keys(keys)
        u = jax.vmap(lambda k: jax.random.uniform(k, dtype=dS_pair.dtype))(
            key_pair)
        u_pair = jnp.where(lower, u, u[partner])
        ok_solver = (flag == 0) & (flag[partner] == 0)
        accept = paired & ok_solver & (u_pair < jnp.exp(-dS_pair))

        sel = jnp.where(accept, partner, jnp.arange(n_chains))
        x_new = x[sel]
        v_new = v[sel]
        acc_rate = jnp.sum((accept & lower).astype(jnp.float32)) \
            / jnp.maximum(jnp.sum((paired & lower).astype(jnp.float32)), 1.0)
        return x_new, v_new, acc_rate, jnp.mean(iters), jnp.max(flag), keys

    return exchange


def _split_keys(keys):
    """Per-chain key split for [C, 2] key arrays."""
    both = jax.vmap(jax.random.split)(keys)
    return both[:, 0], both[:, 1]
