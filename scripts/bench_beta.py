"""Deep-β (imaginary-time) scaling of the HMC hot loop on the GPU.

Produces the BASELINE.md β-table: sweeps/s/chip, CG iters/solve and
acceptance for the north-star Holstein (and optionally SSH) HMC config at
β ∈ {4, 8, 16, 32}, sweeping the ``exact_lowfreq`` hybrid-KPM block count.
The polynomial degree a pure Chebyshev expansion needs diverges as 1/φ(ω)
(KPMPreconditioners.jl:301) — at β=16 (Lτ=160) this is what collapses
throughput; the exact low-frequency blocks remove exactly those frequencies.

Run from the repo root:
  python scripts/bench_beta.py [--model holstein|ssh] [--betas 4,8,16]
                               [--lowfreq 0,4,8,16] [--L 8] [--steps 4]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np


def run_holstein(L, beta, chains, steps, lowfreq, max_order, dt=0.05, block=False,
                 dense_threshold=2048):
    from elphdynamics_tpu.dynamics.hmc import HMCConfig, HMCState, make_hmc_step
    from elphdynamics_tpu.dynamics.init_phonons import init_phonons_half_filled
    from elphdynamics_tpu.lattice import Lattice, UnitCell
    from elphdynamics_tpu.models.holstein import build_holstein
    from elphdynamics_tpu.models.adapter import make_model_ops
    from elphdynamics_tpu.ops import kpm
    from elphdynamics_tpu.ops.fourier_accel import build_mass

    uc = UnitCell.create(2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
    lat = Lattice.create(uc, L)
    spec, params = build_holstein(
        lat, beta=beta, dtau=0.1,
        t_assignments=[(1.0, 0.0, 0, 0, (1, 0, 0)), (1.0, 0.0, 0, 0, (0, 1, 0))],
        omega=1.0, lam=1.0, mu=0.0, dense_threshold=dense_threshold)
    ops = make_model_ops(spec)
    mass = build_mass(np.asarray(params.omega), spec.dtau, spec.Ltau,
                      [dict(omega_min=0.0, omega_max=10.0, mass=0.5)])
    cfg = HMCConfig(dt=dt, trajectory_time=1.0, Nb=4, tol=1e-5, maxiter=500,
                    construct_guess=True, guess_order=3, block=block)
    kcfg = kpm.KPMConfig(max_order=max_order, exact_lowfreq=lowfreq)
    precond = kpm.make_symmetric_precond(ops, kcfg)
    step = make_hmc_step(ops, mass, cfg, precond)

    keys = jax.random.split(jax.random.PRNGKey(0), chains)
    xs = jnp.stack([init_phonons_half_filled(ops, params, k)[0] for k in keys])
    state = HMCState(x=xs, v=jnp.zeros_like(xs))
    vstep = jax.jit(jax.vmap(step, in_axes=(None, 0, 0)))
    for _ in range(3):
        state, stats, keys = vstep(params, state, keys)
    jax.block_until_ready(state.x)
    t0 = time.time()
    for _ in range(steps):
        state, stats, keys = vstep(params, state, keys)
    jax.block_until_ready(state.x)
    wall = time.time() - t0
    return (steps * chains / wall,
            float(jnp.mean(stats.iters.astype(jnp.float32))),
            float(jnp.mean(stats.accepted)),
            float(jnp.mean(stats.flag.astype(jnp.float32))))


def run_ssh(L, beta, chains, steps, lowfreq, max_order, dt=0.05, block=False,
            dense_threshold=2048):
    from elphdynamics_tpu.dynamics.hmc import HMCConfig, HMCState, make_hmc_step
    from elphdynamics_tpu.dynamics.init_phonons import init_phonons_half_filled
    from elphdynamics_tpu.lattice import Lattice, UnitCell
    from elphdynamics_tpu.models.ssh import build_ssh
    from elphdynamics_tpu.models.adapter import make_model_ops
    from elphdynamics_tpu.ops import kpm
    from elphdynamics_tpu.ops.fourier_accel import build_mass

    uc = UnitCell.create(2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
    lat = Lattice.create(uc, L)
    hop = dict(t=1.0, t_std=0.0, alpha=0.25, alpha_std=0.0,
               alpha2=0.0, alpha2_std=0.0, omega=0.5, omega_std=0.0,
               omega4=0.0, omega4_std=0.0, o1=0, o2=0, name="x")
    spec, params = build_ssh(lat, beta=beta, dtau=0.1, hoppings=[
        dict(hop, dL=(1, 0, 0)), dict(hop, dL=(0, 1, 0), name="y")],
        mu_assignments=[(0.0, 0.0, None)])
    ops = make_model_ops(spec)
    mass = build_mass(np.asarray(params.omega), spec.dtau, spec.Ltau,
                      [dict(omega_min=0.0, omega_max=10.0, mass=0.5)])
    cfg = HMCConfig(dt=dt, trajectory_time=1.0, Nb=4, tol=1e-5, maxiter=500,
                    construct_guess=True, guess_order=3, block=block)
    kcfg = kpm.KPMConfig(max_order=max_order, exact_lowfreq=lowfreq)
    precond = kpm.make_symmetric_precond(ops, kcfg)
    step = make_hmc_step(ops, mass, cfg, precond)

    keys = jax.random.split(jax.random.PRNGKey(0), chains)
    xs = jnp.stack([init_phonons_half_filled(ops, params, k)[0] for k in keys])
    state = HMCState(x=xs, v=jnp.zeros_like(xs))
    vstep = jax.jit(jax.vmap(step, in_axes=(None, 0, 0)))
    for _ in range(3):
        state, stats, keys = vstep(params, state, keys)
    jax.block_until_ready(state.x)
    t0 = time.time()
    for _ in range(steps):
        state, stats, keys = vstep(params, state, keys)
    jax.block_until_ready(state.x)
    wall = time.time() - t0
    return (steps * chains / wall,
            float(jnp.mean(stats.iters.astype(jnp.float32))),
            float(jnp.mean(stats.accepted)),
            float(jnp.mean(stats.flag.astype(jnp.float32))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="holstein", choices=["holstein", "ssh"])
    ap.add_argument("--L", type=int, default=8)
    ap.add_argument("--betas", default="4,8,16")
    ap.add_argument("--lowfreq", default="0,4,8,16")
    ap.add_argument("--max-order", type=int, default=None,
                    help="Chebyshev cap (default: 4 holstein / 8 ssh)")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--dt", type=float, default=0.05,
                    help="leapfrog dt (dH grows ~N·dt^4: shrink at large L)")
    ap.add_argument("--dense-threshold", type=int, default=2048,
                    help="sites at or below use the dense-matmul exp(-dtau K)")
    ap.add_argument("--chains", type=int, default=0,
                    help="override the default chain-batch heuristic")
    ap.add_argument("--block", action="store_true",
                    help="[solver] block: block CG on the trajectory solves")
    args = ap.parse_args()
    max_order = args.max_order or (4 if args.model == "holstein" else 8)
    run = run_holstein if args.model == "holstein" else run_ssh

    print(f"device={jax.devices()[0]} model={args.model} L={args.L} "
          f"max_order={max_order}")
    print(f"{'beta':>5} {'Ltau':>5} {'chains':>6} {'k_exact':>7} "
          f"{'sweeps/s':>9} {'iters':>6} {'acc':>6} {'flag':>5}")
    for beta in [float(b) for b in args.betas.split(",")]:
        Ltau = int(round(beta / 0.1))
        chains = args.chains or (
            max(8, int(128 * 40 / Ltau)) if args.model == "holstein"
            else max(8, int(64 * 40 / Ltau)))
        for k in [int(s) for s in args.lowfreq.split(",")]:
            sw, it, acc, fl = run(args.L, beta, chains, args.steps, k,
                                  max_order, dt=args.dt, block=args.block,
                                  dense_threshold=args.dense_threshold)
            print(f"{beta:>5.0f} {Ltau:>5} {chains:>6} {k:>7} "
                  f"{sw:>9.1f} {it:>6.1f} {acc:>6.3f} {fl:>5.2f}", flush=True)


if __name__ == "__main__":
    main()
