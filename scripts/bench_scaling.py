"""End-to-end HMC throughput vs lattice size on the GPU.

Prints sweeps/s/chip, CG iters/solve, acceptance and per-CG-iteration wall
time for the north-star HMC config at 8×8 … 64×64, with the chain batch
scaled down as the per-chain footprint grows. (A utilization column needs a
peak table keyed by device kind, which the benchmark will bring.)

Run from the repo root: python scripts/bench_scaling.py
  [--dense-threshold N]   sites at or below run the dense-matmul exp(-dtau K)
                          path (default 2048: 64x64 uses the group fold)
  [--sizes 8,16,32,64] [--steps 6] [--max-order 4]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dense-threshold", type=int, default=2048)
    ap.add_argument("--sizes", default="8,16,32,64")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--max-order", type=int, default=4)
    args = ap.parse_args()

    from elphdynamics_tpu.dynamics.hmc import HMCConfig, HMCState, make_hmc_step
    from elphdynamics_tpu.dynamics.init_phonons import init_phonons_half_filled
    from elphdynamics_tpu.lattice import Lattice, UnitCell
    from elphdynamics_tpu.models.holstein import build_holstein
    from elphdynamics_tpu.models.adapter import make_model_ops
    from elphdynamics_tpu.ops import kpm
    from elphdynamics_tpu.ops.fourier_accel import build_mass

    chains_of = {8: 128, 16: 64, 32: 32, 64: 16}
    # leapfrog ΔH ∝ N·dt⁴ at fixed trajectory time: dt must shrink ~N^(-1/4)
    # for constant acceptance (dt=0.05 at 64×64 gives acc≈0.19)
    dt_of = {8: 0.05, 16: 0.05, 32: 0.05, 64: 0.025}
    print(f"device={jax.devices()[0]} dense_threshold={args.dense_threshold} "
          f"max_order={args.max_order}")
    print(f"{'L':>4} {'N':>6} {'chains':>7} {'sweeps/s':>9} {'iters':>6} "
          f"{'acc':>6} {'us/iter':>8}")
    for L in [int(s) for s in args.sizes.split(",")]:
        chains = chains_of.get(L, 16)
        uc = UnitCell.create(2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
        lat = Lattice.create(uc, L)
        spec, params = build_holstein(
            lat, beta=4.0, dtau=0.1,
            t_assignments=[(1.0, 0.0, 0, 0, (1, 0, 0)),
                           (1.0, 0.0, 0, 0, (0, 1, 0))],
            omega=1.0, lam=1.0, mu=0.0,
            dense_threshold=args.dense_threshold)
        ops = make_model_ops(spec)
        mass = build_mass(np.asarray(params.omega), spec.dtau, spec.Ltau,
                          [dict(omega_min=0.0, omega_max=10.0, mass=0.5)])
        cfg = HMCConfig(dt=dt_of.get(L, 0.05), trajectory_time=1.0, Nb=4,
                        tol=1e-5, maxiter=500,
                        construct_guess=True, guess_order=3)
        precond = kpm.make_symmetric_precond(
            ops, kpm.KPMConfig(max_order=args.max_order))
        step = make_hmc_step(ops, mass, cfg, precond)

        keys = jax.random.split(jax.random.PRNGKey(0), chains)
        xs = jnp.stack([init_phonons_half_filled(ops, params, k)[0] for k in keys])
        state = HMCState(x=xs, v=jnp.zeros_like(xs))
        vstep = jax.jit(jax.vmap(step, in_axes=(None, 0, 0)))
        for _ in range(2):
            state, stats, keys = vstep(params, state, keys)
        jax.block_until_ready(state.x)
        t0 = time.time()
        for _ in range(args.steps):
            state, stats, keys = vstep(params, state, keys)
        jax.block_until_ready(state.x)
        dt = time.time() - t0

        sweeps = args.steps * chains / dt
        iters = float(jnp.mean(stats.iters.astype(jnp.float32)))
        acc = float(jnp.mean(stats.accepted))

        n_solves = cfg.Nt + 2
        us_iter = 1e6 * dt / (args.steps * n_solves * iters)  # batch us/iter

        print(f"{L:>4} {spec.Nsites:>6} {chains:>7} {sweeps:>9.1f} {iters:>6.1f} "
              f"{acc:>6.3f} {us_iter:>8.0f}", flush=True)


if __name__ == "__main__":
    main()
