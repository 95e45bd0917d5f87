"""Op-level XLA profile of the HMC hot loop on the GPU.

Captures a ``jax.profiler.trace`` of a few north-star HMC steps at a given
lattice size, then parses the xplane protobuf with the installed xprof
tooling and prints the top ops by self time — the profile-backed version of
BASELINE.md's analytic throughput decomposition (what fraction of the
per-CG-iteration wall time is fermion-operator matmul, Chebyshev
recurrence, DFT transforms, elementwise/reduction glue, or gaps).

Run from the repo root:
  python scripts/profile_hmc.py [--L 32] [--steps 3] [--top 25]
                                [--dense-threshold 2048] [--keep DIR]
"""

import argparse
import glob
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np


def build_step(L, dense_threshold, max_order):
    from elphdynamics_tpu.dynamics.hmc import HMCConfig, HMCState, make_hmc_step
    from elphdynamics_tpu.dynamics.init_phonons import init_phonons_half_filled
    from elphdynamics_tpu.lattice import Lattice, UnitCell
    from elphdynamics_tpu.models.holstein import build_holstein
    from elphdynamics_tpu.models.adapter import make_model_ops
    from elphdynamics_tpu.ops import kpm
    from elphdynamics_tpu.ops.fourier_accel import build_mass

    chains_of = {8: 128, 16: 64, 32: 32, 64: 16}
    dt_of = {8: 0.05, 16: 0.05, 32: 0.05, 64: 0.025}
    chains = chains_of.get(L, 32)

    uc = UnitCell.create(2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
    lat = Lattice.create(uc, L)
    spec, params = build_holstein(
        lat, beta=4.0, dtau=0.1,
        t_assignments=[(1.0, 0.0, 0, 0, (1, 0, 0)), (1.0, 0.0, 0, 0, (0, 1, 0))],
        omega=1.0, lam=1.0, mu=0.0, dense_threshold=dense_threshold)
    ops = make_model_ops(spec)
    mass = build_mass(np.asarray(params.omega), spec.dtau, spec.Ltau,
                      [dict(omega_min=0.0, omega_max=10.0, mass=0.5)])
    cfg = HMCConfig(dt=dt_of.get(L, 0.05), trajectory_time=1.0, Nb=4,
                    tol=1e-5, maxiter=500, construct_guess=True, guess_order=3)
    precond = kpm.make_symmetric_precond(ops, kpm.KPMConfig(max_order=max_order))
    step = make_hmc_step(ops, mass, cfg, precond)

    keys = jax.random.split(jax.random.PRNGKey(0), chains)
    xs = jnp.stack([init_phonons_half_filled(ops, params, k)[0] for k in keys])
    state = HMCState(x=xs, v=jnp.zeros_like(xs))
    vstep = jax.jit(jax.vmap(step, in_axes=(None, 0, 0)))
    return vstep, params, state, keys, chains


def parse_trace(logdir, top):
    """Print the op-stats table from the captured xplane trace."""
    paths = sorted(glob.glob(os.path.join(
        logdir, "plugins", "profile", "*", "*.xplane.pb")))
    if not paths:
        print(f"no xplane.pb under {logdir}", file=sys.stderr)
        return
    import json

    from xprof.convert import raw_to_tool_data

    data, _ = raw_to_tool_data.xspace_to_tool_data(
        [paths[-1]], "framework_op_stats", {"tqx": "out:json"})
    if isinstance(data, bytes):
        data = data.decode()
    tbls = json.loads(data)
    for tbl in tbls:
        cols = [c["id"] for c in tbl["cols"]]
        rows = [[c.get("v") for c in r["c"]] for r in tbl.get("rows", [])]
        if not rows:
            continue
        i_dev = cols.index("host_or_device")
        i_type = cols.index("type")
        i_name = cols.index("operation")
        i_self = cols.index("total_self_time")
        i_occ = cols.index("occurrences")
        i_bound = cols.index("bound_by") if "bound_by" in cols else None
        drows = [r for r in rows if r[i_dev] == "Device"]
        if not drows:
            continue
        total = sum(r[i_self] or 0 for r in drows)
        drows.sort(key=lambda r: -(r[i_self] or 0))
        print(f"\n{'self µs':>10} {'%':>6} {'cum%':>6} {'occ':>6}  op (bound)")
        cum = 0.0
        for r in drows[:top]:
            s = r[i_self] or 0.0
            cum += s
            b = r[i_bound] if i_bound is not None else ""
            print(f"{s:>10.0f} {100 * s / total:>6.1f} {100 * cum / total:>6.1f}"
                  f" x{r[i_occ]:>5.0f}  [{r[i_type]}] {r[i_name][:84]} ({b})")
        print(f"{total:>10.0f}  total device self time (µs)")
        break


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--L", type=int, default=32)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--dense-threshold", type=int, default=2048)
    ap.add_argument("--max-order", type=int, default=4)
    ap.add_argument("--keep", default=None,
                    help="keep the trace under this dir (default: tmp)")
    args = ap.parse_args()

    vstep, params, state, keys, chains = build_step(
        args.L, args.dense_threshold, args.max_order)
    # compile + warm the warm-start history outside the trace
    for _ in range(3):
        state, stats, keys = vstep(params, state, keys)
    jax.block_until_ready(state.x)

    logdir = args.keep or tempfile.mkdtemp(prefix="hmcprof_")
    t0 = time.time()
    with jax.profiler.trace(logdir):
        for _ in range(args.steps):
            state, stats, keys = vstep(params, state, keys)
        jax.block_until_ready(state.x)
    dt = time.time() - t0
    iters = float(jnp.mean(stats.iters.astype(jnp.float32)))
    print(f"L={args.L} chains={chains} steps={args.steps}: "
          f"{args.steps * chains / dt:.1f} sweeps/s, {iters:.1f} CG iters/solve "
          f"(traced; trace dir {logdir})")
    parse_trace(logdir, args.top)


if __name__ == "__main__":
    main()
