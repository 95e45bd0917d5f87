"""Does parallel tempering actually unstick strong-coupling CDW order?

At strong coupling the Holstein ground state is a (π,π) CDW with two
degenerate sign sectors; HMC tunnels between them exponentially slowly
(the ergodicity stall the reference's reflection update targets,
SpecialUpdates.jl:58-165). This study measures the tunneling rate of the
staggered phonon order parameter X_stag = Σ_i (−1)^i x̄_i on rung-0
chains, with and without `[tempering]` exchanges down a coupling ladder
(weaker-coupling rungs are disordered and mix freely).

CPU-valid: tunneling counts are platform-independent.

Run from the repo root:
    python scripts/study_tempering.py [lam] [L] [beta] [updates]
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"  # a host study: counts, not times
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from elphdynamics_tpu.dynamics.hmc import HMCConfig, HMCState, make_hmc_step
from elphdynamics_tpu.dynamics.init_phonons import init_phonons_half_filled
from elphdynamics_tpu.dynamics.tempering import (TemperingConfig,
                                                 ladder_params,
                                                 make_exchange_step,
                                                 target_mask)
from elphdynamics_tpu.lattice import Lattice, UnitCell
from elphdynamics_tpu.models.adapter import make_model_ops
from elphdynamics_tpu.models.holstein import build_holstein
from elphdynamics_tpu.ops import kpm
from elphdynamics_tpu.ops.fourier_accel import build_mass


def main():
    lam = float(sys.argv[1]) if len(sys.argv) > 1 else 1.5
    L = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    beta = float(sys.argv[3]) if len(sys.argv) > 3 else 4.0
    updates = int(sys.argv[4]) if len(sys.argv) > 4 else 400
    ladder = (tuple(float(v) for v in sys.argv[5].split(","))
              if len(sys.argv) > 5 else (1.0, 0.85, 0.7, 0.55))

    uc = UnitCell.create(2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
    lat = Lattice.create(uc, L)
    spec, params = build_holstein(
        lat, beta=beta, dtau=0.1,
        t_assignments=[(1.0, 0.0, 0, 0, (1, 0, 0)),
                       (1.0, 0.0, 0, 0, (0, 1, 0))],
        omega=1.0, lam=lam, mu=0.0)
    ops = make_model_ops(spec)
    mass = build_mass(np.asarray(params.omega), spec.dtau, spec.Ltau,
                      [dict(omega_min=0.0, omega_max=10.0, mass=0.5)])
    precond = kpm.make_symmetric_precond(ops, kpm.KPMConfig(max_order=8))
    cfg = HMCConfig(dt=0.05, trajectory_time=1.0, Nb=4, tol=1e-5, maxiter=2000,
                    construct_guess=True, guess_order=3)

    # (-1)^(l1+l2) over sites of the square lattice (one orbit per cell)
    loc = lat.cell_loc[:, lat.site_to_cell]          # [3, Nsites]
    stag = jnp.asarray((-1.0) ** (loc[0] + loc[1]))

    tcfg = TemperingConfig(ladder=ladder, freq=2)
    K = len(tcfg.ladder)
    M = 2                       # chains per rung
    C = K * M
    mask = target_mask(tcfg, C)

    def run(use_exchange):
        ps = ladder_params(params, tcfg, C)
        step = make_hmc_step(ops, mass, cfg, precond)
        vstep = jax.jit(jax.vmap(step, in_axes=(0, 0, 0)))
        ex = jax.jit(make_exchange_step(ops, tcfg, C, precond),
                     static_argnames="parity")
        keys = jax.random.split(jax.random.PRNGKey(0), C)
        xs = jnp.stack([init_phonons_half_filled(ops, params, k)[0]
                        for k in keys])
        st = HMCState(x=xs, v=jnp.zeros_like(xs))
        signs, flips, acc_ex = [], 0, []
        prev = None
        for n in range(updates):
            st, stats, keys = vstep(ps, st, keys)
            if use_exchange and (n + 1) % tcfg.freq == 0:
                xn, vn, acc, _, fl, keys = ex(ps, st.x, st.v, keys,
                                              parity=(n // tcfg.freq) % 2)
                st = HMCState(x=xn, v=vn)
                acc_ex.append(float(acc))
            if n >= updates // 5:
                Xs = jnp.einsum("i,cit->c", stag,
                                st.x)[jnp.asarray(mask)] / (ops.Nsites
                                                            * ops.Ltau)
                s = np.sign(np.asarray(Xs))
                if prev is not None:
                    flips += int(np.sum(s != prev))
                prev = s
                signs.append(s)
        signs = np.array(signs)
        occ = np.abs(signs.mean(axis=0))     # |mean sign| per chain: 1 = stuck
        label = "tempering" if use_exchange else "plain HMC"
        ex_note = (f"  exch acc {np.mean(acc_ex):.2f}" if acc_ex else "")
        print(f"{label:>10}: sign flips (rung 0, {signs.shape[0]} sweeps × "
              f"{M} chains) = {flips:4d}   |mean sign|/chain = "
              f"{np.array2string(occ, precision=2)}{ex_note}", flush=True)
        return flips

    f_plain = run(False)
    f_pt = run(True)
    print(f"\nlam={lam} L={L} beta={beta}: tempering tunneling gain "
          f"{f_pt / max(f_plain, 1):.1f}x", flush=True)


if __name__ == "__main__":
    main()
