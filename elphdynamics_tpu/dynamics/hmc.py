"""Hybrid Monte Carlo over the phonon fields.

Reference: HMC.jl. One update = refresh momenta and auxiliary fields, run a
leapfrog (or multi-timestep) trajectory with Fourier-accelerated mass matrix,
Metropolis accept/reject:

* momenta:  v = α·v + √(1−α²)·M^(−1/2)·R        (partial refresh, HMC.jl:648-660)
* aux field: φ± = Λ⁻¹·Mᵀ·R±  per spin            (HMC.jl:666-692)
* fermionic action: S_f = Σ± (Λφ±)ᵀ·O⁻¹·(Λφ±)/2 with O = MᵀM, evaluated with
  tol² solves at trajectory endpoints and tol¹ inside (HMC.jl:820-915)
* forces: dS_f/dx = Σ± [−(Mz±)ᵀ·∂M/∂x·z± + φ±ᵀ·∂Λᵀ/∂x·z±],  z± = O⁻¹Λφ±
  (HMC.jl:790-814), plus the bosonic dSb/dx
* Λ is the Holstein exponential-shift operator (HMC.jl:921-1030); for SSH the
  φ-variable is MᵀR directly (the reference's Λ fallbacks are no-ops)
* multi-timestep integrator: Nb bosonic substeps per fermionic step
  (HMC.jl:479-638)
* solver failure at any point aborts the trajectory and auto-rejects
  (HMC.jl:410-412,453), encoded here as a flag mask that deactivates the
  remaining (masked) CG iterations rather than branching.

Shape conventions: x, v are [Nph, Lτ]; the two spin systems are stacked
on a leading axis and solved as ONE batched CG (the reference solves them
serially, HMC.jl:851-903). Chains vmap over the whole step.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from elphdynamics_tpu.dynamics.force import SolverConfig
from elphdynamics_tpu.models.adapter import ModelOps
from elphdynamics_tpu.ops.fourier_accel import accelerate
from elphdynamics_tpu.utils.dtypes import fdot, pseudofermion_noise


class HMCConfig(NamedTuple):
    dt: float
    trajectory_time: float
    alpha: float = 0.0       # partial momentum refresh fraction
    Nb: int = 1              # bosonic substeps per fermionic step
    tol: float = 1e-5
    maxiter: int = 1000
    kappa_max: float = 1e12
    solver_kind: str = "cg"  # "cg" | "bicgstab" | "gmres"
    restart: int = 20
    # block CG over the spin-stacked trajectory systems ([solver] block;
    # solvers.block_cg — see solve_oinv for the gating)
    block: bool = False
    # split in-loop operator precision ([solver] loop_precision; see
    # dynamics/solve._cg_operators — tol¹ trajectory solves only, endpoints
    # and verification stay at HIGHEST; see SolverConfig.loop_precision)
    loop_precision: str | None = "high"
    # trajectory integrator: "leapfrog" (the reference's only integrator,
    # HMC.jl:343-638) or "2mn" — Omelyan/Mushrabi/Peshkov 2nd-order
    # minimum-norm (hep-lat/0506011 §2): two force evaluations per dt step
    # with an ~10× smaller shadow-Hamiltonian coefficient, so dt can grow
    # ~2-3× at the same acceptance — a net reduction in solves per
    # trajectory (beyond reference scope)
    integrator: str = "leapfrog"
    log_verbose: bool = False  # per-timestep energy trace (HMC.jl verbose log)
    # warm-start each trajectory solve from the previous timestep's solution
    # (the `construct_guess` knob of the reference's example TOMLs — documented
    # there but never wired into its solver; implemented for real here)
    construct_guess: bool = False
    # linear extrapolation of the two previous trajectory solutions as the
    # warm start (2z₁ − z₀); the solution moves smoothly along the leapfrog
    # so the predicted point starts CG closer than the last solution alone
    guess_order: int = 1
    # incremental slow-mode deflation (ops/deflation.py, beyond reference
    # parity): basis size carried in HMCState.defl, refreshed once per
    # update, init-projected into every trajectory CG. 0 = off.
    deflate_k: int = 0
    deflate_filter: int = 8
    deflate_power: int = 4
    deflate_cutoff: float = 1 / 16
    # burnin-phase automatic step-size selection ([hmc] tune_dt, beyond
    # reference scope — the reference's dt is fixed by hand, HMC.jl:26):
    # Nesterov dual averaging (Hoffman & Gelman 2014 §3.2) drives the mean
    # Metropolis acceptance probability to `target_acceptance`. The deep-β
    # integrator study (BASELINE.md) showed the hand default over-resolves
    # (acc 0.94 where 0.80 is 1.26× cheaper per accepted update) — this
    # automates that recipe. Tuning runs on-device inside the burnin jit;
    # the sampling phase is rebuilt once with the frozen tuned dt.
    tune_dt: bool = False
    target_acceptance: float = 0.8

    @property
    def Nt(self) -> int:
        return max(1, round(self.trajectory_time / self.dt))

    @property
    def dt_b(self) -> float:
        return self.dt / self.Nb


class HMCState(NamedTuple):
    x: jnp.ndarray
    v: jnp.ndarray
    # DeflationState when cfg.deflate_k > 0 (ops/deflation.py), else None
    defl: object = None


class HMCStats(NamedTuple):
    accepted: jnp.ndarray
    iters: jnp.ndarray       # mean CG iters per solve (reference convention HMC.jl:456)
    flag: jnp.ndarray
    delta_H: jnp.ndarray
    # trajectory-endpoint energies, for the hmc_sim_log.out diagnostic
    # (HMC.jl:285-304: columns tot_energy action kin_energy)
    H: jnp.ndarray = jnp.nan
    S: jnp.ndarray = jnp.nan
    K: jnp.ndarray = jnp.nan
    # per-timestep [Nt, ...] energy trace when cfg.log_verbose
    # (the reference's verbose update_log cadence, HMC.jl:285-304)
    traj_H: jnp.ndarray = jnp.nan
    traj_S: jnp.ndarray = jnp.nan
    traj_K: jnp.ndarray = jnp.nan
    traj_iters: jnp.ndarray = jnp.nan


def _spin_stack(a, b):
    return jnp.stack([a, b], axis=0)


# --- warm-start history (rotated buffer tuple) ------------------------------
#
# The trajectory scan needs the previous `guess_order` solutions for the
# polynomial warm-start extrapolation, carried as a tuple of exactly
# H = clamp(order, 1, 4) buffers rotated with masked `jnp.where` copies each
# step (newest first). A dynamic_update_slice ring buffer was measured as the
# alternative (round 5): one write per step instead of H rotation copies, but
# the 4 dynamic-slice reads it adds cost 4-6% end-to-end in the latency-bound
# 8×8 regime (4224 → 4079 sweeps/s) while the rotation traffic it saves is
# noise at 64×64 (9.3 sweeps/s both ways — the copies are ~0.3 ms against a
# 41 ms trajectory step). The rotation form wins or ties everywhere; what the
# round-5 pass kept is sizing H to the order actually used (the previous code
# always carried and rotated 4 buffers, and a single one when warm starts are
# off).

def zhist_size(order: int) -> int:
    return max(1, min(int(order), 4))


def zhist_init(z0, order: int):
    """History tuple of H = clamp(order, 1, 4) buffers, newest first, all
    seeded with ``z0`` (the update's endpoint solution)."""
    return (z0,) * zhist_size(order)


def zhist_last(hist):
    """Most recent solution (the plain ``z_prev`` warm start)."""
    return hist[0]


def zhist_guess(hist, order: int):
    """Polynomial forward extrapolation (binomial coefficients of Δ^k
    applied at the next node) over the newest ``order`` entries."""
    if order <= 1:
        return hist[0]
    if order == 2:
        return 2.0 * hist[0] - hist[1]
    if order == 3:
        return 3.0 * hist[0] - 3.0 * hist[1] + hist[2]
    return 4.0 * hist[0] - 6.0 * hist[1] + 4.0 * hist[2] - hist[3]


def zhist_push(hist, z, ok):
    """Masked rotation: live chains shift ``z`` in as the newest entry;
    failed trajectories (``ok`` False) freeze the whole history — their
    solves are discarded on auto-reject, only finiteness matters."""
    return tuple(jnp.where(ok, new, old)
                 for new, old in zip((z,) + hist[:-1], hist))


def make_hmc_step(
    ops: ModelOps,
    mass_table,
    cfg: HMCConfig,
    precond: tuple[Callable, Callable] | None = None,
    dynamic_dt: bool = False,
):
    """Build the jittable HMC update ``(params, state, key) -> (state, stats, key)``.

    ``mass_table`` is the [Nph, Lτ] dynamical-mass spectrum (``use_mass``
    convention). ``precond``, if given, is a ``(setup_fn, apply_fn)`` pair
    (e.g. from :func:`elphdynamics_tpu.ops.kpm.make_symmetric_precond`);
    setup runs before every batch of solves, matching the reference's
    ``setup!`` cadence (HMC.jl:834).

    ``dynamic_dt=True`` returns ``(params, state, key, dt) -> ...`` with the
    leapfrog step size as a traced scalar (the trajectory LENGTH ``Nt`` stays
    static from ``cfg``), so the burnin dt tuner adjusts dt inside one
    compiled program with zero recompiles or host syncs.
    """
    from elphdynamics_tpu.dynamics.solve import (
        SolverConfig, precond_applies, precond_state, resolve_precond,
        solve_oinv)
    from elphdynamics_tpu.ops import deflation

    mass = jnp.asarray(mass_table)
    has_lambda = ops.calc_Lambda is not None

    def lam_phi(params, x, phi):
        """Λ(x)·φ per spin-stacked φ (identity structure for SSH)."""
        if has_lambda:
            Lam = ops.calc_Lambda(params, x)
            return ops.mulLambda(Lam, phi), Lam
        return phi, None

    def solve_O(params, x, derived, Lphi, tol, pstate, z_guess=None,
                defl=None):
        """Batched-over-spin solve of O·z = Λφ (HMC.jl:820-915).

        ``pstate`` is the KPM state of the full setup at the trajectory start;
        each solve only refreshes the averaged operator against the current x
        (buffered setup-skip, KPMPreconditioners.jl:288-308). ``z_guess``
        warm-starts the CG from the previous timestep's solution; ``defl``
        init-projects the accumulated slow modes out of the start."""
        pa = resolve_precond(precond, params, x, prev_state=pstate)
        scfg = SolverConfig(tol=tol, maxiter=cfg.maxiter, kappa_max=cfg.kappa_max,
                            kind=cfg.solver_kind, restart=cfg.restart,
                            block=cfg.block,
                            loop_precision=cfg.loop_precision)
        x0 = z_guess if (cfg.construct_guess and cfg.solver_kind == "cg") else None
        res = solve_oinv(ops, params, derived, Lphi, scfg, pa, x0=x0,
                         deflate=defl)
        # spin axis is leading: reduce iters (avg, reference's cld(sum,2)) &
        # flag. The stack is [2] real spins or [1] complex (both spins in one
        # packed solve) — average over whatever is there.
        ns = res.iters.shape[0]
        iters = (jnp.sum(res.iters, axis=0) + ns - 1) // ns
        flag = jnp.max(res.flag, axis=0)
        return res.x, iters, flag

    def fermionic_forces(params, x, derived, phi, z):
        """dS_f/dx = −Σ±[(Mz)ᵀ·∂M/∂x·z] + Σ±[φᵀ·∂Λᵀ/∂x·z] (HMC.jl:790-814).
        Spin-stacked inputs φ, z of shape [2, N, Lτ]."""
        Mz = ops.mulM(params, derived, z)
        dmdx = ops.muldMdx(params, derived, x, Mz, z)  # batched over spin
        dSf = -jnp.sum(dmdx, axis=0)
        if has_lambda:
            Lam = ops.calc_Lambda(params, x)
            dl = ops.muldLambdadx(params, x, Lam, phi, z)
            dSf = dSf + jnp.sum(dl, axis=0)
        return dSf

    def forces(params, x, derived, phi, z):
        """Outer-step force: full dS/dx for the plain leapfrog, fermionic-only
        for the multi-timestep integrator (the bosonic force is integrated by
        the Nb substeps, HMC.jl:524,581)."""
        dSf = fermionic_forces(params, x, derived, phi, z)
        if cfg.Nb == 1:
            return dSf + ops.calc_dSbdx(params, x, False)
        return dSf

    def calc_K(v):
        """K = vᵀ·M·v/2 via the mass table (HMC.jl:711-739); SSH counts
        primary fields only. Accumulated via fdot: ΔH = H₁−H₀ cancels
        O(N·Lτ)-sized terms, so the energies need accurate reduction."""
        mv = accelerate(mass, v, 1.0)
        if not ops.is_holstein:
            import numpy as _np
            prim_mask = jnp.asarray(
                (ops.spec.primary_phonon == _np.arange(ops.Nph)), v.dtype
            )[:, None]
            return fdot(prim_mask * v, mv, axis=(-2, -1)) / 2
        return fdot(v, mv, axis=(-2, -1)) / 2

    def calc_S(params, x, Lphi, z):
        """S = Sb + Σ± (Λφ±)ᵀz±/2 (HMC.jl:743-783)."""
        Sf = fdot(Lphi, z, axis=(0, -2, -1)) / 2
        return Sf + ops.calc_Sb(params, x, False)

    tol1 = cfg.tol
    tol2 = cfg.tol ** 2
    # effective warm-start order: the history ring is only consumed when
    # construct_guess is on and the solver is CG (solve_O gates x0 the same
    # way), so it collapses to one slot otherwise
    use_g = cfg.construct_guess and cfg.solver_kind == "cg"
    g_ord = cfg.guess_order if use_g else 1

    def _step(params, state: HMCState, key, dt):
        x0, v_in = state.x, state.v
        key, k_v, k_p, k_acc = jax.random.split(key, 4)

        # --- refresh momenta (partial, HMC.jl:648-660)
        R = ops.tie(jax.random.normal(k_v, x0.shape, dtype=x0.dtype))
        v0 = cfg.alpha * v_in + jnp.sqrt(1.0 - cfg.alpha ** 2) * accelerate(mass, R, -0.5)

        # --- refresh φ per spin (HMC.jl:666-692); on the complex-hopping
        # path the two spin fields pack into one complex stack entry
        # (utils.dtypes.pseudofermion_noise — the TRS twist ensemble)
        Rpm = pseudofermion_noise(k_p, params, (ops.Nsites, ops.Ltau),
                                  x0.dtype)
        derived0 = ops.derived(params, x0)
        MtR = ops.mulMT(params, derived0, Rpm)
        if has_lambda:
            Lam0 = ops.calc_Lambda(params, x0)
            phi = ops.mulLambdaInv(Lam0, MtR)
        else:
            phi = MtR

        # --- full preconditioner setup ONCE per update; the trajectory's
        # solves reuse its bounds/coefficients through cheap refreshes
        pstate = precond_state(precond, params, x0)

        # --- deflation-basis refresh at the update's starting field; one
        # basis serves the whole trajectory (ops/deflation.py)
        if cfg.deflate_k > 0:
            if state.defl is None:
                raise ValueError(
                    "cfg.deflate_k > 0 requires HMCState.defl "
                    "(initialize with dynamics.hmc.init_deflation)")
            from elphdynamics_tpu.utils.dtypes import params_are_complex
            if params_are_complex(params) and not jnp.iscomplexobj(
                    state.defl.W):
                # complex hopping needs a complex basis so the Hermitian
                # Grams/projections in ops/deflation.py see conjugated
                # vectors — init_deflation(..., params=params) provides it
                raise ValueError(
                    "complex hopping parameters require a complex "
                    "deflation basis: initialize with "
                    "init_deflation(ops, cfg, key, params=params)")
            pa0 = precond_applies(precond, pstate)
            apP = pa0.symmetric if pa0 is not None else (lambda v: v)
            defl = deflation.refresh(
                state.defl, lambda v: ops.mulMTM(params, derived0, v), apP,
                deflation.DeflationConfig(cfg.deflate_k, cfg.deflate_filter,
                                          cfg.deflate_power,
                                          cfg.deflate_cutoff))
        else:
            defl = state.defl

        # --- initial endpoint solve (tol², HMC.jl:374)
        Lphi0, _ = lam_phi(params, x0, phi)
        z0, it0, flag0 = solve_O(params, x0, derived0, Lphi0, tol2, pstate,
                                 defl=defl)
        H0 = calc_S(params, x0, Lphi0, z0) + calc_K(v0)

        dSdx0 = forces(params, x0, derived0, phi, z0)
        QdSdx0 = accelerate(mass, dSdx0, -1.0)

        # --- trajectory (leapfrog / multi-timestep)
        def qf(xx):
            return accelerate(mass, xx, -1.0)

        def boson_substeps(x, v, dt_b=None):
            """Nb small steps driven by the bosonic force (HMC.jl:535-565).
            ``dt_b`` overrides the substep length (2MN drifts cover dt/2)."""
            dt_b = dt / cfg.Nb if dt_b is None else dt_b
            dSb = ops.calc_dSbdx(params, x, False)
            QdSb = qf(dSb)

            def sub(carry, _):
                x, v, QdSb = carry
                v = v - dt_b / 2 * QdSb
                x = x + dt_b * v
                QdSb2 = qf(ops.calc_dSbdx(params, x, False))
                v = v - dt_b / 2 * QdSb2
                return (x, v, QdSb2), None

            (x, v, _), _ = lax.scan(sub, (x, v, QdSb), None, length=cfg.Nb)
            return x, v

        def drift(x, v, h):
            """Position update over h: plain drift (Nb=1) or Nb bosonic
            substeps integrating the stiff ω²x² force at h/Nb resolution."""
            if cfg.Nb == 1:
                return x + h * v, v
            return boson_substeps(x, v, dt_b=h / cfg.Nb)

        def force_at(x, guess):
            """derived → tol¹ solve (warm-started) → Q-accelerated force."""
            d = ops.derived(params, x)
            Lphi_x, _ = lam_phi(params, x, phi)
            z, it, fl = solve_O(params, x, d, Lphi_x, tol1, pstate,
                                z_guess=guess, defl=defl)
            dS = forces(params, x, d, phi, z)
            return qf(dS), z, it, fl, Lphi_x

        def body(carry, _):
            x, v, QdSdx, hist, iters, flag = carry
            ok = flag == 0
            v1 = v - dt / 2 * QdSdx
            if cfg.Nb == 1:
                x1 = x + dt * v1
            else:
                x1, v1 = boson_substeps(x, v1)
            d1 = ops.derived(params, x1)
            Lphi1, _ = lam_phi(params, x1, phi)
            guess = zhist_guess(hist, g_ord)
            z1, it1, fl1 = solve_O(params, x1, d1, Lphi1, tol1, pstate,
                                   z_guess=guess, defl=defl)
            dS1 = forces(params, x1, d1, phi, z1)
            Qd1 = qf(dS1)
            v1 = v1 - dt / 2 * Qd1
            # masked commit: trajectories that have failed stop evolving
            x = jnp.where(ok, x1, x)
            v = jnp.where(ok, v1, v)
            QdSdx = jnp.where(ok, Qd1, QdSdx)
            hist = zhist_push(hist, z1, ok)
            iters = iters + jnp.where(ok, it1, 0)
            flag = jnp.maximum(flag, jnp.where(ok, fl1, 0))
            if cfg.log_verbose:
                # per-timestep energies reusing the tol¹ solve (the
                # reference's verbose update_log re-solves; HMC.jl:285-304)
                S_t = calc_S(params, x, Lphi1, z1)
                K_t = calc_K(v)
                ys = (S_t + K_t, S_t, K_t, it1)
            else:
                ys = None
            return (x, v, QdSdx, hist, iters, flag), ys

        # Omelyan 2nd-order minimum-norm coefficient (hep-lat/0506011 §2)
        LAM_2MN = 0.1931833275037836

        def body_2mn(carry, _):
            """One 2MN step: λ-kick (carried force) → dt/2 drift → middle
            kick → dt/2 drift → λ-kick. Two tol¹ solves per step at uniform
            dt/2 spacing, so the polynomial warm-start chain applies
            unchanged; boundary λ-kicks of adjacent steps use the same
            carried force, exactly as the leapfrog body carries QdSdx."""
            x, v, QdSdx, hist, iters, flag = carry
            ok = flag == 0
            v1 = v - LAM_2MN * dt * QdSdx
            x1, v1 = drift(x, v1, dt / 2)
            Qd_m, z_m, it_m, fl_m, _ = force_at(
                x1, zhist_guess(hist, g_ord))
            hist = zhist_push(hist, z_m, ok)
            v1 = v1 - (1.0 - 2.0 * LAM_2MN) * dt * Qd_m
            x1, v1 = drift(x1, v1, dt / 2)
            Qd_e, z_e, it_e, fl_e, Lphi_e = force_at(
                x1, zhist_guess(hist, g_ord))
            hist = zhist_push(hist, z_e, ok)
            v1 = v1 - LAM_2MN * dt * Qd_e
            it1 = it_m + it_e
            fl1 = jnp.maximum(fl_m, fl_e)
            x = jnp.where(ok, x1, x)
            v = jnp.where(ok, v1, v)
            QdSdx = jnp.where(ok, Qd_e, QdSdx)
            iters = iters + jnp.where(ok, it1, 0)
            flag = jnp.maximum(flag, jnp.where(ok, fl1, 0))
            if cfg.log_verbose:
                S_t = calc_S(params, x, Lphi_e, z_e)
                K_t = calc_K(v)
                ys = (S_t + K_t, S_t, K_t, it1)
            else:
                ys = None
            return (x, v, QdSdx, hist, iters, flag), ys

        if cfg.integrator == "leapfrog":
            traj_body = body
        elif cfg.integrator == "2mn":
            traj_body = body_2mn
        else:
            raise ValueError(f"unknown integrator {cfg.integrator!r} "
                             "(expected 'leapfrog' or '2mn')")

        hist0 = zhist_init(z0, g_ord)
        (x1, v1, _, hist1, iters, flag), traj = lax.scan(
            traj_body, (x0, v0, QdSdx0, hist0, it0, flag0), None,
            length=cfg.Nt
        )
        z_last = zhist_last(hist1)

        # --- final endpoint solve (tol²) + Metropolis (HMC.jl:431-472)
        d1 = ops.derived(params, x1)
        Lphi1, _ = lam_phi(params, x1, phi)
        z1, it2, fl2 = solve_O(params, x1, d1, Lphi1, tol2, pstate,
                               z_guess=z_last, defl=defl)
        iters = iters + it2
        flag = jnp.maximum(flag, fl2)
        S1 = calc_S(params, x1, Lphi1, z1)
        K1 = calc_K(v1)
        H1 = S1 + K1
        dH = H1 - H0
        P = jnp.minimum(1.0, jnp.exp(-dH))
        u = jax.random.uniform(k_acc, P.shape, dtype=P.dtype)
        accept = (u < P) & (flag == 0)

        # the refreshed basis is kept on reject too: it was refined at x0,
        # which IS the post-reject field, and it only steers solver starts
        # (solutions are tol-exact either way) — no effect on the target
        # distribution
        x_new = jnp.where(accept, x1, x0)
        v_new = jnp.where(accept, v1, -v0)
        # solves per update: Nt tol¹ (2Nt for 2MN) + 2 tol² endpoints
        nsolves = (2 * cfg.Nt if cfg.integrator == "2mn" else cfg.Nt) + 2
        mean_iters = (iters + nsolves // 2) // nsolves
        stats = HMCStats(accepted=accept, iters=mean_iters, flag=flag, delta_H=dH,
                         H=H1, S=S1, K=K1)
        if cfg.log_verbose:
            stats = stats._replace(traj_H=traj[0], traj_S=traj[1],
                                   traj_K=traj[2], traj_iters=traj[3])
        return HMCState(x=x_new, v=v_new, defl=defl), stats, key

    if dynamic_dt:
        return _step

    def step(params, state: HMCState, key):
        return _step(params, state, key, cfg.dt)

    return step


class DtTunerState(NamedTuple):
    """Nesterov dual-averaging state for the burnin dt tuner
    (Hoffman & Gelman 2014, "The No-U-Turn Sampler", §3.2). All leaves are
    device scalars so the update lives inside the burnin jit."""
    m: jnp.ndarray            # tuning-iteration count
    log_dt: jnp.ndarray       # current (exploring) log step size
    log_dt_avg: jnp.ndarray   # averaged iterate — the value to freeze
    h_bar: jnp.ndarray        # running mean of (target − accept_prob)
    mu: jnp.ndarray           # shrinkage point log(10·dt₀)
    lo: jnp.ndarray           # clamp bounds on log_dt (safety rails)
    hi: jnp.ndarray


def dt_tuner_init(dt0: float, lo: float | None = None,
                  hi: float | None = None) -> DtTunerState:
    f = lambda v: jnp.asarray(v, dtype=jnp.float32)
    lo = dt0 / 64.0 if lo is None else lo
    hi = dt0 * 64.0 if hi is None else hi
    return DtTunerState(m=f(0.0), log_dt=f(np.log(dt0)),
                        log_dt_avg=f(np.log(dt0)), h_bar=f(0.0),
                        mu=f(np.log(10.0 * dt0)),
                        lo=f(np.log(lo)), hi=f(np.log(hi)))


def dt_tuner_update(t: DtTunerState, accept_prob, target: float,
                    gamma: float = 0.05, t0: float = 10.0,
                    kappa: float = 0.75) -> DtTunerState:
    """One dual-averaging step toward mean acceptance = ``target``.

    ``accept_prob`` is the chain-mean Metropolis probability
    min(1, e^{−ΔH}) of the update just taken at exp(t.log_dt)."""
    m = t.m + 1.0
    w = 1.0 / (m + t0)
    h_bar = (1.0 - w) * t.h_bar + w * (target - accept_prob)
    log_dt = jnp.clip(t.mu - jnp.sqrt(m) / gamma * h_bar, t.lo, t.hi)
    eta = m ** (-kappa)
    log_dt_avg = eta * log_dt + (1.0 - eta) * t.log_dt_avg
    return t._replace(m=m, h_bar=h_bar, log_dt=log_dt,
                      log_dt_avg=log_dt_avg)


def init_deflation(ops: ModelOps, cfg: HMCConfig, key, params=None):
    """Fresh per-chain deflation state for ``HMCState.defl`` (None when
    deflation is off). vmap it over split keys for chain batches.

    Pass ``params`` so the basis dtype follows the hopping: complex
    parameters (Peierls phases / twisted BCs) get a circularly-complex
    basis and the Hermitian projector (see ops/deflation.py)."""
    from elphdynamics_tpu.ops import deflation
    from elphdynamics_tpu.utils.dtypes import params_are_complex

    if cfg.deflate_k <= 0:
        return None
    dtype = (jnp.complex64 if params is not None and
             params_are_complex(params) else jnp.float32)
    return deflation.init(key, cfg.deflate_k, ops.Nsites, ops.Ltau,
                          dtype=dtype)
