"""CLI entry point.

The reference is driven as
``julia -O3 -e "using ElPhDynamics; simulate(ARGS)" -- input.toml [run_id]``
(ElPhDynamics.jl:68-69); the equivalent here is

    python -m elphdynamics_tpu input.toml [run_id] [--chains N] [--x64]
"""

from __future__ import annotations

import argparse


def main():
    ap = argparse.ArgumentParser(prog="elphdynamics_tpu")
    ap.add_argument("input", help="TOML input file (reference-compatible schema)")
    ap.add_argument("run_id", nargs="?", type=int, default=None,
                    help="datafolder suffix id (auto-incremented if omitted)")
    ap.add_argument("--chains", type=int, default=1,
                    help="independent Markov chains batched on device "
                         "(0 = auto: a heuristic batch for the lattice "
                         "size, simulation.auto_chains)")
    ap.add_argument("--devices", type=int, default=1,
                    help="devices to shard the chains over (0 = all local "
                         "devices); chains must be a multiple of devices")
    ap.add_argument("--site-devices", type=int, default=1,
                    help="shard ONE chain's spatial lattice over this many "
                         "devices (Holstein HMC; for lattices that outgrow "
                         "a single chip; 0 = all local devices)")
    ap.add_argument("--x64", action="store_true",
                    help="enable float64 (CPU parity mode; accelerator "
                         "runs use f32)")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="capture an XLA profiler trace (TensorBoard format) "
                         "of the whole run into DIR")
    ap.add_argument("--multihost", action="store_true",
                    help="initialize jax.distributed (one process per host; "
                         "cluster settings as in parallel/multihost.py). "
                         "Every process runs this same command; host "
                         "IO happens on process 0 only. Combine with "
                         "--devices 0 to span all global devices.")
    args = ap.parse_args()

    import jax

    from elphdynamics_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.x64:
        jax.config.update("jax_enable_x64", True)

    from elphdynamics_tpu.simulation import simulate

    if args.profile:
        with jax.profiler.trace(args.profile):
            stats = simulate(args.input, run_id=args.run_id,
                             n_chains=args.chains, n_devices=args.devices,
                             site_devices=args.site_devices,
                             multihost=args.multihost)
    else:
        stats = simulate(args.input, run_id=args.run_id,
                         n_chains=args.chains, n_devices=args.devices,
                         site_devices=args.site_devices,
                         multihost=args.multihost)
    print(stats)


if __name__ == "__main__":
    main()
