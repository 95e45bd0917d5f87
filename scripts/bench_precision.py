"""Split in-loop operator precision A/B ([solver] loop_precision).

This measures the full HMC update with the in-CG-loop matvecs at HIGHEST
(reference-faithful) vs "high" (the 3-pass bf16 algorithm), with verification/retry/forces/endpoints
kept at HIGHEST either way (dynamics/solve._cg_operators).

Reports sweeps/s, CG iters/solve, acceptance, mean |ΔH|, and flag counts —
the physics-unchanged criteria of VERDICT r3 item 2.

Run from the repo root:
    python scripts/bench_precision.py [--L 8] [--beta 4] [--chains 128]
        [--steps 20] [--max-order 4] [--dt 0.05]
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
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--equil", type=int, default=30)
    ap.add_argument("--max-order", type=int, default=4)
    ap.add_argument("--dt", type=float, default=0.05)
    args = ap.parse_args()

    from elphdynamics_tpu.dynamics.hmc import HMCConfig, HMCState, make_hmc_step
    from elphdynamics_tpu.dynamics.init_phonons import init_phonons_half_filled
    from elphdynamics_tpu.lattice import Lattice, UnitCell
    from elphdynamics_tpu.models.adapter import make_model_ops
    from elphdynamics_tpu.models.holstein import build_holstein
    from elphdynamics_tpu.ops import kpm
    from elphdynamics_tpu.ops.fourier_accel import build_mass

    uc = UnitCell.create(2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
    lat = Lattice.create(uc, args.L)
    spec, params = build_holstein(
        lat, beta=args.beta, dtau=0.1,
        t_assignments=[(1.0, 0.0, 0, 0, (1, 0, 0)),
                       (1.0, 0.0, 0, 0, (0, 1, 0))],
        omega=1.0, lam=1.0, mu=0.0)
    ops = make_model_ops(spec)
    mass = build_mass(np.asarray(params.omega), spec.dtau, spec.Ltau,
                      [dict(omega_min=0.0, omega_max=10.0, mass=0.5)])
    precond = kpm.make_symmetric_precond(
        ops, kpm.KPMConfig(max_order=args.max_order))

    def make_vstep(loop_precision):
        cfg = HMCConfig(dt=args.dt, trajectory_time=1.0, Nb=4, tol=1e-5,
                        maxiter=1000, construct_guess=True, guess_order=3,
                        loop_precision=loop_precision)
        return jax.jit(jax.vmap(make_hmc_step(ops, mass, cfg, precond),
                                in_axes=(None, 0, 0)))

    # equilibrate once with the reference-faithful operator; both arms then
    # run from the same equilibrated fields
    vstep0 = make_vstep(None)
    keys = jax.random.split(jax.random.PRNGKey(0), args.chains)
    xs = jnp.stack([init_phonons_half_filled(ops, params, k)[0] for k in keys])
    st0 = HMCState(x=xs, v=jnp.zeros_like(xs))
    t0 = time.time()
    st = st0
    for _ in range(args.equil):
        st, stats, keys = vstep0(params, st, keys)
    jax.block_until_ready(st.x)
    print(f"device={jax.devices()[0]} L={args.L} beta={args.beta} "
          f"Ltau={spec.Ltau} chains={args.chains} dt={args.dt} "
          f"dense_ckb={spec.dense_ckb} (equil {args.equil} updates, "
          f"{time.time()-t0:.0f}s)", flush=True)

    print(f"{'loop_prec':>9} {'sweeps/s':>9} {'iters':>6} {'acc':>6} "
          f"{'<|dH|>':>9} {'flags':>6} {'run_s':>7}")
    for prec in (None, "high"):
        vstep = vstep0 if prec is None else make_vstep(prec)
        stp, kp = st, keys
        stp, stats, kp = vstep(params, stp, kp)   # compile + warm
        jax.block_until_ready(stp.x)
        accs, dhs, its, fls = [], [], [], []
        tb = time.time()
        for _ in range(args.steps):
            stp, stats, kp = vstep(params, stp, kp)
            accs.append(stats.accepted)
            dhs.append(stats.delta_H)
            its.append(stats.iters)
            fls.append(stats.flag)
        jax.block_until_ready(stp.x)
        run_s = time.time() - tb
        rate = args.steps * args.chains / run_s
        acc = float(jnp.mean(jnp.stack(accs).astype(jnp.float32)))
        adh = float(jnp.mean(jnp.abs(jnp.stack(dhs))))
        it = float(jnp.mean(jnp.stack(its).astype(jnp.float32)))
        nfl = int(jnp.sum(jnp.stack(fls) > 0))
        print(f"{str(prec):>9} {rate:>9.1f} {it:>6.1f} {acc:>6.3f} "
              f"{adh:>9.2e} {nfl:>6d} {run_s:>7.2f}", flush=True)


if __name__ == "__main__":
    main()
