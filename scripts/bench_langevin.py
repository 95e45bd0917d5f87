"""Langevin throughput benchmark (BASELINE.md Langevin row).

Holstein L×L at β with the RK predictor-corrector (2 force solves per
timestep, LangevinDynamics.jl:135-225), KPM-preconditioned CG forces.

Run from the repo root:
    python scripts/bench_langevin.py [--L 8] [--chains 128] [--steps 30]
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
    ap.add_argument("--L", type=int, default=8)
    ap.add_argument("--beta", type=float, default=4.0)
    ap.add_argument("--chains", type=int, default=128)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--warm", type=int, default=10)
    ap.add_argument("--dt", type=float, default=0.01)
    ap.add_argument("--method", default="rk", choices=["euler", "rk", "heun"])
    ap.add_argument("--max-order", type=int, default=8)
    args = ap.parse_args()

    from elphdynamics_tpu.dynamics.init_phonons import init_phonons_half_filled
    from elphdynamics_tpu.dynamics.langevin import make_langevin_step
    from elphdynamics_tpu.dynamics.solve import SolverConfig
    from elphdynamics_tpu.lattice import Lattice, UnitCell
    from elphdynamics_tpu.models.adapter import make_model_ops
    from elphdynamics_tpu.models.holstein import build_holstein
    from elphdynamics_tpu.ops import kpm
    from elphdynamics_tpu.ops.fourier_accel import build_Q

    uc = UnitCell.create(2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
    lat = Lattice.create(uc, args.L)
    spec, params = build_holstein(
        lat, beta=args.beta, dtau=0.1,
        t_assignments=[(1.0, 0.0, 0, 0, (1, 0, 0)),
                       (1.0, 0.0, 0, 0, (0, 1, 0))],
        omega=1.0, lam=1.0, mu=0.0)
    ops = make_model_ops(spec)
    Q = build_Q(np.asarray(params.omega), spec.dtau, spec.Ltau,
                [dict(omega_min=0.0, omega_max=10.0, mass=0.5)])
    precond = kpm.make_symmetric_precond(
        ops, kpm.KPMConfig(max_order=args.max_order))
    scfg = SolverConfig(tol=1e-5, maxiter=1000)
    step = make_langevin_step(ops, Q, args.dt, args.method, scfg, precond)
    vstep = jax.jit(jax.vmap(step, in_axes=(None, 0, 0)))

    keys = jax.random.split(jax.random.PRNGKey(0), args.chains)
    xs = jnp.stack([init_phonons_half_filled(ops, params, k)[0]
                    for k in keys])
    for _ in range(args.warm):
        xs, stats, keys = vstep(params, xs, keys)
    jax.block_until_ready(xs)
    t0 = time.time()
    its = []
    for _ in range(args.steps):
        xs, stats, keys = vstep(params, xs, keys)
        its.append(stats.iters)
    jax.block_until_ready(xs)
    dt = time.time() - t0
    rate = args.steps * args.chains / dt
    it = float(jnp.mean(jnp.stack(its).astype(jnp.float32)))
    print(f"device={jax.devices()[0]} L={args.L} beta={args.beta} "
          f"method={args.method} chains={args.chains} "
          f"dense_ckb={spec.dense_ckb}")
    print(f"{rate:.0f} timesteps/s/chip, {it:.1f} CG iters per force solve "
          f"({dt:.2f}s for {args.steps} steps)")


if __name__ == "__main__":
    main()
