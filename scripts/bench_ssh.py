"""SSH headline benchmark: optical SSH 8×8, β=4, α=0.25, ω=0.5, KPM-CG HMC
(the BASELINE.md SSH row). Run from the repo root on the GPU."""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np


def main():
    from elphdynamics_tpu.dynamics.hmc import HMCConfig, HMCState, make_hmc_step
    from elphdynamics_tpu.dynamics.init_phonons import init_phonons_half_filled
    from elphdynamics_tpu.lattice import Lattice, UnitCell
    from elphdynamics_tpu.models.ssh import build_ssh
    from elphdynamics_tpu.models.adapter import make_model_ops
    from elphdynamics_tpu.ops import kpm
    from elphdynamics_tpu.ops.fourier_accel import build_mass

    uc = UnitCell.create(2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
    lat = Lattice.create(uc, 8)
    hop = dict(t=1.0, t_std=0.0, alpha=0.25, alpha_std=0.0,
               alpha2=0.0, alpha2_std=0.0, omega=0.5, omega_std=0.0,
               omega4=0.0, omega4_std=0.0, dL=(1, 0, 0), o1=0, o2=0, name="x")
    hop_y = dict(hop, dL=(0, 1, 0), name="y")
    spec, params = build_ssh(lat, beta=4.0, dtau=0.1,
                             hoppings=[hop, hop_y],
                             mu_assignments=[(0.0, 0.0, None)])
    ops = make_model_ops(spec)
    mass = build_mass(np.asarray(params.omega), spec.dtau, spec.Ltau,
                      [dict(omega_min=0.0, omega_max=10.0, mass=0.5)])
    cfg = HMCConfig(dt=0.05, trajectory_time=1.0, Nb=4, tol=1e-5, maxiter=500,
                    construct_guess=True, guess_order=3)
    precond = kpm.make_symmetric_precond(ops, kpm.KPMConfig(max_order=8))
    step = make_hmc_step(ops, mass, cfg, precond)

    chains, steps = 64, 6
    keys = jax.random.split(jax.random.PRNGKey(0), chains)
    xs = jnp.stack([init_phonons_half_filled(ops, params, k)[0] for k in keys])
    state = HMCState(x=xs, v=jnp.zeros_like(xs))
    vstep = jax.jit(jax.vmap(step, in_axes=(None, 0, 0)))
    for _ in range(2):
        state, stats, keys = vstep(params, state, keys)
    jax.block_until_ready(state.x)
    t0 = time.time()
    for _ in range(steps):
        state, stats, keys = vstep(params, state, keys)
    jax.block_until_ready(state.x)
    dt = time.time() - t0
    print(f"ssh_8x8 chains={chains}: {steps * chains / dt:.1f} sweeps/s "
          f"iters={float(jnp.mean(stats.iters.astype(jnp.float32))):.1f} "
          f"acc={float(jnp.mean(stats.accepted)):.3f} device={jax.devices()[0]}")


if __name__ == "__main__":
    main()
