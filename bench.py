"""North-star benchmark: Holstein 8×8 square lattice, β=4, Δτ=0.1 (Lτ=40),
KPM-preconditioned-CG HMC (BASELINE.md / BASELINE.json), plus a 32×32
companion row for the compute-bound regime.

The headline number is the ABSOLUTE sweeps/s/chip. ``vs_baseline`` divides
by the FROZEN round-1 single-chain CPU-f64 proxy of the same algorithm
(0.92 sweeps/s — BASELINE.md; the Julia reference is not installable in
this zero-egress image). Earlier rounds re-measured the proxy each run with
the then-current algorithm, which made the ratio fall as the algorithm
improved — a denominator that drifts with the numerator measures nothing,
so it is now a constant (VERDICT r3 item 9).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "secondary"}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

import __graft_entry__ as graft
from elphdynamics_tpu.dynamics.hmc import HMCConfig, HMCState, make_hmc_step
from elphdynamics_tpu.dynamics.init_phonons import init_phonons_half_filled
from elphdynamics_tpu.ops import kpm
from elphdynamics_tpu.ops.fourier_accel import build_mass

WARMUP = 3
STEPS = 10
# frozen round-1 denominator: single chain, CPU, f64, the same
# checkerboard+KPM-CG HMC algorithm (BASELINE.md "CPU proxy")
RECORDED_CPU_F64 = 0.92


def _build_step(L):
    ops, params, _, _, spec = graft._build(L=L, beta=4.0, dtau=0.1)
    mass = build_mass(np.asarray(params.omega), spec.dtau, spec.Ltau,
                      [dict(omega_min=0.0, omega_max=10.0, mass=0.5)])
    cfg = HMCConfig(dt=0.05, trajectory_time=1.0, Nb=4, tol=1e-5, maxiter=500,
                    construct_guess=True, guess_order=3)
    precond = kpm.make_symmetric_precond(ops, kpm.KPMConfig(max_order=4))
    step = make_hmc_step(ops, mass, cfg, precond)
    return ops, params, spec, step


def _throughput(L, n_chains, device):
    ops, params, spec, step = _build_step(L)
    params_d = jax.device_put(params, device)
    keys = jax.random.split(jax.random.PRNGKey(0), max(n_chains, 2))[:n_chains]
    xs = jnp.stack([init_phonons_half_filled(ops, params, k)[0] for k in keys])
    state = HMCState(x=xs, v=jnp.zeros_like(xs))
    state = jax.device_put(state, device)
    keys = jax.device_put(keys, device)
    vstep = jax.jit(jax.vmap(step, in_axes=(None, 0, 0)))
    for _ in range(WARMUP):
        state, stats, keys = vstep(params_d, state, keys)
    jax.block_until_ready(state.x)
    t0 = time.time()
    for _ in range(STEPS):
        state, stats, keys = vstep(params_d, state, keys)
    jax.block_until_ready(state.x)
    elapsed = time.time() - t0
    return (STEPS * n_chains / elapsed,
            float(jnp.mean(stats.accepted)),
            float(jnp.mean(stats.iters.astype(jnp.float32))))


def main():
    from elphdynamics_tpu.utils.compile_cache import enable_compile_cache

    accel = jax.devices()[0]
    if accel.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {accel.platform}")
    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"# device: platform={accel.platform} kind={accel.device_kind} "
          f"count={len(jax.devices())} nvidia-smi: {card}", flush=True)
    value, acc, iters = _throughput(8, 128, accel)
    value32, acc32, iters32 = _throughput(32, 32, accel)

    print(json.dumps({
        "metric": "holstein_8x8_beta4_hmc_kpmcg_sweeps_per_sec_per_chip",
        "value": round(value, 3),
        "unit": "sweeps/s",
        "vs_baseline": round(value / RECORDED_CPU_F64, 2),
        "secondary": {
            "holstein_32x32_beta4_sweeps_per_sec_per_chip": round(value32, 3),
            "baseline_frozen_cpu_f64_sweeps_per_sec": RECORDED_CPU_F64,
        },
    }))
    print(f"# 8x8: chains=128 acceptance={acc:.3f} iters={iters:.1f}; "
          f"32x32: chains=32 acceptance={acc32:.3f} iters={iters32:.1f} "
          f"device={accel}", file=sys.stderr)


if __name__ == "__main__":
    main()
