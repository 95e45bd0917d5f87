"""Block-CG A/B on the Green's-estimator solves (solvers.block_cg).

Holstein L×L at β: equilibrate with HMC, then time the measurement-stage
estimator step (nᵥ solves of MᵀM z = Mᵀr per chain, GreensFunctions.jl:201-234)
with `[solver] block` off vs on. Reports measurement steps/s and CG
iterations/solve for both.

Run from the repo root:
    python scripts/bench_block.py [--beta 4] [--L 8] [--chains 32] [--nv 10]
        [--steps 10] [--max-order 4]
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
    ap.add_argument("--beta", type=float, default=4.0)
    ap.add_argument("--L", type=int, default=8)
    ap.add_argument("--chains", type=int, default=32)
    ap.add_argument("--nv", type=int, default=10)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--equil", type=int, default=30)
    ap.add_argument("--max-order", type=int, default=4)
    args = ap.parse_args()

    from elphdynamics_tpu.dynamics.hmc import HMCConfig, HMCState, make_hmc_step
    from elphdynamics_tpu.dynamics.init_phonons import init_phonons_half_filled
    from elphdynamics_tpu.dynamics.solve import SolverConfig
    from elphdynamics_tpu.lattice import Lattice, UnitCell
    from elphdynamics_tpu.measure.greens import sample_greens
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

    cfg = HMCConfig(dt=0.05, trajectory_time=1.0, Nb=4, tol=1e-5,
                    maxiter=1000, construct_guess=True, guess_order=3)
    vstep = jax.jit(jax.vmap(make_hmc_step(ops, mass, cfg, precond),
                             in_axes=(None, 0, 0)))
    keys = jax.random.split(jax.random.PRNGKey(0), args.chains)
    xs = jnp.stack([init_phonons_half_filled(ops, params, k)[0] for k in keys])
    st = HMCState(x=xs, v=jnp.zeros_like(xs))
    t0 = time.time()
    for _ in range(args.equil):
        st, stats, keys = vstep(params, st, keys)
    jax.block_until_ready(st.x)
    print(f"device={jax.devices()[0]} L={args.L} beta={args.beta} "
          f"Ltau={spec.Ltau} chains={args.chains} nv={args.nv} "
          f"(equil {args.equil} updates, {time.time()-t0:.0f}s)")

    # --- measurement convolution stage: FFT vs DFT-matmul lowering
    from elphdynamics_tpu.measure import greens as GR

    scfg0 = SolverConfig(tol=1e-5, maxiter=1000, kind="cg")
    gd, _ = jax.jit(jax.vmap(
        lambda x, k: sample_greens(ops, params, x, k, args.nv, scfg0, precond)
    ))(st.x, jax.random.split(jax.random.PRNGKey(2), args.chains))
    for dft in (False, True):
        GR.DFT_MATMUL = dft
        vconv = jax.jit(jax.vmap(lambda R, M: GR.pair_tensor_sums(lat, R, M)))
        pt = vconv(gd.R, gd.MinvR)
        jax.block_until_ready(pt.G)
        tb = time.time()
        for _ in range(args.steps):
            pt = vconv(gd.R, gd.MinvR)
        jax.block_until_ready(pt.G)
        run_s = time.time() - tb
        print(f"conv dft_matmul={str(dft):>5}: {args.steps*args.chains/run_s:>8.1f} "
              f"pair-tensor builds/s ({run_s:.2f}s)", flush=True)
    GR.DFT_MATMUL = False

    # near-null two-level arms (ops/nearnull.py): the estimator solves are
    # FROM-ZERO (no warm start to pre-remove the slow modes), the regime the
    # dense studies show the coarse correction cuts hardest; the per-x setup
    # amortizes over all nv solves
    from elphdynamics_tpu.ops.nearnull import NearNullConfig, make_nearnull_precond

    ARMS = [("kpm", False, None), ("kpm+blk", True, None),
            ("nn", False, NearNullConfig(refresh_iters=0,
                                         refresh_mode="assemble")),
            ("nn+blk", True, NearNullConfig(refresh_iters=0,
                                            refresh_mode="assemble"))]
    print(f"{'arm':>8} {'meas/s':>8} {'iters/solve':>12} {'run_s':>7}")
    for label, block, ncfg in ARMS:
        scfg = SolverConfig(tol=1e-5, maxiter=1000, kind="cg", block=block)
        parm = (precond if ncfg is None
                else make_nearnull_precond(ops, kpm.KPMConfig(
                    max_order=args.max_order), ncfg))

        def meas(x, key):
            gd, key = sample_greens(ops, params, x, key, args.nv, scfg, parm)
            return gd.iters, gd.flag, key

        vmeas = jax.jit(jax.vmap(meas))
        mkeys = jax.random.split(jax.random.PRNGKey(1), args.chains)
        it, fl, mkeys = vmeas(st.x, mkeys)   # compile + warm
        jax.block_until_ready(it)
        tb = time.time()
        for _ in range(args.steps):
            it, fl, mkeys = vmeas(st.x, mkeys)
        jax.block_until_ready(it)
        run_s = time.time() - tb
        iters = float(jnp.mean(it.astype(jnp.float32)))
        rate = args.steps * args.chains / run_s
        print(f"{label:>8} {rate:>8.1f} {iters:>12.1f} {run_s:>7.2f} "
              f"maxflag={int(jnp.max(fl))}", flush=True)


if __name__ == "__main__":
    main()
