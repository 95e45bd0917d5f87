"""Top-level simulation driver.

Reference: ElPhDynamics.jl (``simulate``, :71-136) + RunSimulation.jl. One
call runs: config → datafolder naming (auto-incrementing ``-<id>`` suffix,
:166-186) → new-run vs resume dispatch (:102) → thermalize → sample →
measure → bin → write, with wall-clock checkpointing and timing stats →
summary.

Differences from the reference forced by the accelerator execution model:

* the sampler update, measurement sweep, special updates and bin
  post-processing are each ONE jitted program; the Python loop only
  orchestrates and does file IO;
* optional ``n_chains`` runs multiple independent Markov chains batched on
  the device (vmapped step) — the batched version of the reference's
  launch-N-processes fleet story (ElPhDynamics.jl:90-95). Measurements
  average over chains within each bin (solver-flagged chains are masked
  out of the average and logged);
* optional ``n_devices`` shards those chains over a 1-D ``jax.sharding.Mesh``
  (axis ``chain``): the sampler trajectory is chip-local SPMD, and the only
  cross-chip collective is the measurement mean over chains, inserted by XLA
  where the jitted program reduces over the sharded axis.
"""

from __future__ import annotations

import logging
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from elphdynamics_tpu.dynamics.hmc import HMCState, make_hmc_step
from elphdynamics_tpu.dynamics.init_phonons import init_phonons_half_filled
from elphdynamics_tpu.dynamics.langevin import make_langevin_step
from elphdynamics_tpu.dynamics.special_updates import (
    make_reflection_update,
    make_swap_update,
)
from elphdynamics_tpu.io import checkpoint as ckpt
from elphdynamics_tpu.io import output as out_io
from elphdynamics_tpu.io.config import SimulationSetup, build_setup, load_toml
from elphdynamics_tpu.io.summary import write_summary
from elphdynamics_tpu.measure.measurements import (
    make_measurement_step,
    process_bin,
    zero_container,
)
from elphdynamics_tpu.measure.mufinder import MuTuner
from elphdynamics_tpu.ops import kpm

logger = logging.getLogger("elphdynamics_tpu")


def name_datafolder(filepath: str, foldername: str, run_id: int | None = None) -> str:
    """Auto-incrementing ``<foldername>-<id>`` naming (ElPhDynamics.jl:166-186).
    An existing folder WITH a checkpoint is reused (resume); otherwise the id
    increments past every existing folder."""
    if run_id is not None:
        return os.path.join(filepath, f"{foldername}-{run_id}")
    i = 1
    while True:
        cand = os.path.join(filepath, f"{foldername}-{i}")
        if not os.path.isdir(cand) or ckpt.has_checkpoint(cand):
            return cand
        i += 1


def auto_chains(Nsites: int, Ltau: int, n_devices: int = 1,
                is_holstein: bool = True) -> int:
    """Chain batch per device: 1024/√N·40/Lτ for Holstein, half that for
    SSH, capped at 128 — the throughput peaks measured on the accelerator
    this program was first written for (README; larger batches lose to
    batch-max CG iteration waste). A heuristic from that era until ROADMAP
    S1 re-derives it on the H100. Returns the TOTAL chain count:
    ``n_devices`` devices each get the same local batch."""
    base = 1024.0 if is_holstein else 512.0
    per_chip = int(base / max(Nsites, 1) ** 0.5 * 40.0 / max(Ltau, 1))
    per_chip = max(1, min(per_chip, 128))
    return per_chip * max(n_devices, 1)


def simulate(config, run_id: int | None = None, n_chains: int = 1,
             n_devices: int = 1, site_devices: int = 1,
             multihost: bool = False) -> dict:
    """Run a full simulation from a TOML path or parsed config dict
    (the reference CLI entry, ElPhDynamics.jl:68-136).

    ``n_devices > 1`` shards the ``n_chains`` Markov chains over a device
    mesh (``n_devices = 0`` auto-detects all local devices — under
    multihost, all GLOBAL devices).
    ``site_devices > 1`` shards the spatial lattice of each chain over the
    mesh (SURVEY §5's context-parallel analog) — for problems whose
    ``N·Lτ`` footprint outgrows a single chip. Both may be combined:
    a 2-D ``(chain × site)`` mesh of ``n_devices · site_devices`` chips
    (HMC and Langevin; ``tune_dt``, ``[solver.deflation]``, ``[tempering]``,
    ``--multihost`` and complex hopping (``twist``) all compose with the
    site axis — under multihost the site mesh spans the global device set
    and the off-hot-loop gathers become XLA all-gathers to a replicated
    sharding. The one remaining carve-out: ``[solver.deflation]`` with
    complex hopping, gated in either sharding mode).

    ``multihost=True`` initializes ``jax.distributed`` (one process per
    host; see parallel/multihost.py for the contract): every process runs
    the same call, the mesh spans the global device set, host IO happens
    on process 0 only."""
    if multihost:
        from elphdynamics_tpu.parallel.multihost import init_multihost
        init_multihost()
    from elphdynamics_tpu.parallel.multihost import (bcast_int, bcast_str,
                                                     is_multihost, is_primary)
    mh = is_multihost()
    primary = not mh or is_primary()
    if n_devices == 0:
        n_devices = len(jax.devices())
    if site_devices == 0:
        site_devices = len(jax.devices())
    if n_chains == 0 and site_devices > 1:
        raise ValueError("--chains 0 (auto) needs an explicit chain count "
                         "when composing with --site-devices")
    if n_devices > 1 and n_chains:
        if n_chains % n_devices != 0:
            raise ValueError(
                f"n_chains={n_chains} must be a multiple of n_devices={n_devices}")
    if site_devices > 1 and n_chains > 1 and n_devices < 1:
        raise ValueError("invalid n_devices")
    if isinstance(config, str):
        cfg = load_toml(config)
    else:
        cfg = dict(config)
    sim = cfg["simulation"]
    if mh:
        # every process must agree on the RNG seed (fresh entropy is drawn
        # per process otherwise) and on the auto-incremented datafolder
        if "random_seed" not in sim:
            sim = cfg["simulation"] = dict(sim)
            sim["random_seed"] = bcast_int(
                int(np.random.SeedSequence().entropy % (2 ** 31)))
        datafolder = bcast_str(name_datafolder(
            sim.get("filepath", "."), sim["foldername"], run_id))
    else:
        datafolder = name_datafolder(sim.get("filepath", "."),
                                     sim["foldername"], run_id)
    setup = build_setup(cfg, datafolder)
    if n_chains == 0:
        # heuristic batch for this lattice (auto_chains)
        n_chains = auto_chains(setup.ops.Nsites, setup.ops.spec.Ltau,
                               n_devices, setup.ops.is_holstein)
    if primary:
        os.makedirs(datafolder, exist_ok=True)
        # persist the input config into the datafolder (the reference copies
        # the verbatim TOML file, ProcessInputFile.jl:50; config.json
        # additionally so load_model can rebuild without a TOML parser
        # round trip)
        import json
        with open(os.path.join(datafolder, "config.json"), "w") as f:
            json.dump(cfg, f, indent=1)
        import shutil
        if isinstance(config, str) and os.path.isfile(config):
            shutil.copy(config, os.path.join(datafolder, os.path.basename(config)))
        else:
            from elphdynamics_tpu.io.output import dump_toml
            with open(os.path.join(datafolder, "input.toml"), "w") as f:
                f.write(dump_toml(cfg))

    # run log (ProcessInputFile.jl:574-583); file handler on process 0 only
    handler = None
    if primary:
        handler = logging.FileHandler(os.path.join(
            datafolder, f"{setup.sim_params.foldername}.log"))
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
        logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        import elphdynamics_tpu
        logger.info("elphdynamics_tpu version: %s", elphdynamics_tpu.__version__)
        logger.info("Random Seed: %d", setup.sim_params.random_seed)
        logger.info("Devices: %s (using %d chain / %d site)", jax.devices(),
                    n_devices, site_devices)
        logger.info("Markov chains: %d", n_chains)
        return _run(setup, n_chains, n_devices, site_devices)
    finally:
        if handler is not None:
            logger.removeHandler(handler)


def _check_mh_mesh_coverage(mh: bool, mesh) -> None:
    """Multihost meshes must span the GLOBAL device set: a mesh built from
    a device prefix that misses some process's local devices leaves that
    process with no addressable shard, and its shard_map fails with an
    opaque runtime error — catch the misconfiguration up front."""
    if not mh:
        return
    used = mesh.devices.size
    total = len(jax.devices())
    if used != total:
        raise ValueError(
            f"multihost run: the device mesh uses {used} of {total} global "
            "devices. Choose --devices/--site-devices so their product "
            "covers every process's devices (e.g. --devices 0 for all).")


def _run(setup: SimulationSetup, n_chains: int, n_devices: int = 1,
         site_devices: int = 1) -> dict:
    ops = setup.ops
    params = setup.params
    sp = setup.sim_params
    datafolder = sp.datafolder
    resume = ckpt.has_checkpoint(datafolder)

    # ---- multihost (parallel/multihost.py): every process runs this same
    # function in lockstep; fetch() is the symmetric host-pull (a collective
    # gather for cross-process shardings) and file IO is primary-only
    from elphdynamics_tpu.parallel.multihost import (bcast_int, fetch,
                                                     fetch_tree, is_multihost,
                                                     is_primary)
    mh = is_multihost()
    primary = not mh or is_primary()

    # ---- device mesh for chain-sharded execution (SURVEY §5; the reference's
    # N-independent-processes fleet, ElPhDynamics.jl:90-95, done SPMD)
    mesh = None
    chain_sharding = None
    if n_devices > 1 and site_devices == 1:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from elphdynamics_tpu.parallel.chains import chain_mesh
        mesh = chain_mesh(n_devices)
        chain_sharding = NamedSharding(mesh, P("chain"))
        _check_mh_mesh_coverage(mh, mesh)

    def constrain(tree):
        """Pin chain-batched arrays to the mesh inside jitted programs."""
        if chain_sharding is None:
            return tree
        return jax.tree.map(
            lambda a: jax.lax.with_sharding_constraint(a, chain_sharding), tree)

    def place(tree):
        """Shard chain-batched host/device arrays onto the mesh."""
        if chain_sharding is None:
            return tree
        return jax.tree.map(lambda a: jax.device_put(a, chain_sharding), tree)

    # ---- parallel tempering over the coupling ladder ([tempering],
    # dynamics/tempering.py — beyond reference scope). Chains carry
    # per-rung params, so the chain-batched vmaps take params in_axes=0;
    # only rung-0 (physical-coupling) chains enter the measurement bins.
    tcfg_t = setup.tempering_cfg
    tempering = tcfg_t is not None
    if tempering:
        if n_chains < 2:
            raise ValueError("[tempering] needs --chains = K*M (>1)")
        from elphdynamics_tpu.dynamics.tempering import (
            ladder_params, make_exchange_step, target_mask)
    p_ax = 0 if tempering else None

    # ---- preconditioner
    from elphdynamics_tpu.utils.dtypes import params_are_complex
    model_cplx = params_are_complex(setup.params)
    precond = None
    if setup.kpm_cfg is not None:
        # complex hopping (twist / Peierls) included: kpm.setup detects the
        # complex operator and builds the full-spectrum complex pipeline
        # (ops/kpm.py:_apply_complex); stacked/exact_lowfreq degrade to the
        # plain complex recurrence there
        precond = kpm.make_precond(ops, setup.kpm_cfg)
    if setup.nearnull_cfg is not None:
        if setup.kpm_cfg is None:
            raise ValueError("[solver.nearnull] needs [solver.preconditioner]"
                             " (the KPM smoother it augments)")
        if model_cplx:
            raise NotImplementedError(
                "[solver.nearnull] with complex hopping: the near-null "
                "chop/Galerkin einsums are real-only (ops/nearnull.py)")
        if site_devices > 1:
            raise NotImplementedError(
                "[solver.nearnull] with --site-devices: the sharded step "
                "closures build their own preconditioner applies; the "
                "two-level state is not yet threaded through them")
        from elphdynamics_tpu.ops.nearnull import make_nearnull_precond
        precond = make_nearnull_precond(ops, setup.kpm_cfg, setup.nearnull_cfg)

    # ---- step functions
    combined = site_devices > 1 and n_chains > 1
    if site_devices > 1:
        # spatial lattice sharding: each chain's [N, Lτ] field lives
        # partitioned over the site mesh; measurements/special updates run
        # on the (automatically gathered) global field. With n_chains > 1
        # the mesh is 2-D (chain × site).
        from elphdynamics_tpu.parallel.lattice_shard import (
            build_shard_plan, chain_site_mesh, make_sharded_greens_sampler,
            make_sharded_hmc_step, make_sharded_langevin_step,
            make_sharded_ssh_greens_sampler, make_sharded_ssh_hmc_step,
            make_sharded_ssh_langevin_step, site_mesh)
        plan = build_shard_plan(ops.spec.ckb, site_devices)
        if combined:
            smesh = chain_site_mesh(max(n_devices, 1), site_devices)
        else:
            smesh = site_mesh(site_devices)
        _check_mh_mesh_coverage(mh, smesh)

        from jax.sharding import NamedSharding, PartitionSpec as _P
        _rep = NamedSharding(smesh, _P())
        # Holstein shards the [N, Lτ] site field; SSH keeps the bond-phonon
        # field replicated (the sharded state is the electron vectors inside
        # the step) — see parallel/lattice_shard.py. With a leading chain
        # axis (combined mode) that axis shards over 'chain'.
        if combined:
            _xsh = NamedSharding(
                smesh, _P("chain", "site", None) if ops.is_holstein
                else _P("chain"))
            _ksh = NamedSharding(smesh, _P("chain"))
        else:
            _xsh = (NamedSharding(smesh, _P("site", None)) if ops.is_holstein
                    else _rep)
            _ksh = _rep

        # deflation-basis shardings ([solver.deflation] composes with
        # --site-devices: the [k, N, Lτ] basis rows partition over 'site',
        # the k×k factor and λmax replicate; parallel/lattice_shard.py
        # threads the state through the step as a trailing in/out)
        _defl_on = (setup.dynamics_type == "hmc" and setup.hmc_cfg is not None
                    and setup.hmc_cfg.deflate_k > 0)
        if _defl_on:
            _dW = NamedSharding(
                smesh, _P("chain", None, "site", None) if combined
                else _P(None, "site", None))
            _dpv = NamedSharding(
                smesh, _P("chain", "site", None) if combined
                else _P("site", None))
            _dsc = NamedSharding(smesh, _P("chain") if combined else _P())

            def _place_defl(defl):
                return defl._replace(
                    W=jax.device_put(defl.W, _dW),
                    chol=jax.device_put(defl.chol, _dsc),
                    pvec=jax.device_put(defl.pvec, _dpv),
                    lam_max=jax.device_put(defl.lam_max, _dsc))

        # params placement cache: re-place onto the mesh only when the
        # params object actually changes (μ-tuner updates), NOT every step.
        # Tempering's stacked ladder params carry a leading chain axis and
        # shard over 'chain' (combined mesh only — the gate above).
        _pcache = {}
        _prm_sh = (NamedSharding(smesh, _P("chain"))
                   if (tempering and combined) else _rep)

        def _place_params(params):
            # identity check holds a strong reference to the source object,
            # so the id cannot be recycled while the cache entry lives
            if _pcache.get("src") is not params:
                _pcache["src"] = params
                _pcache["val"] = jax.tree.map(
                    lambda a: jax.device_put(a, _prm_sh) if a is not None else a,
                    params)
            return _pcache["val"]

        def _adapt(raw_step):
            def step(params, state, key):
                # steady state: x/v/key are already mesh-resident from the
                # previous sharded step and these device_puts are no-ops;
                # they only move data on the first step or right after an
                # (unsharded, off-hot-loop) special update touched the state
                params = _place_params(params)
                key = jax.device_put(key, _ksh)
                x = jax.device_put(state.x, _xsh)
                v = jax.device_put(state.v, _xsh)
                if _defl_on:
                    defl = _place_defl(state.defl)
                    x, v, stats, key, defl = raw_step(params, x, v, key, defl)
                    return HMCState(x=x, v=v, defl=defl), stats, key
                x, v, stats, key = raw_step(params, x, v, key)
                # key stays mesh-replicated: the sharded measurement sampler
                # consumes it in place; special updates re-place on demand
                return HMCState(x=x, v=v), stats, key
            return step

        if setup.dynamics_type == "hmc":
            _maker = (make_sharded_hmc_step if ops.is_holstein
                      else make_sharded_ssh_hmc_step)
            _ca = "chain" if combined else None
            sim_step = _adapt(_maker(
                ops.spec, plan, smesh, setup.fa_mass, setup.hmc_cfg,
                kpm_cfg=setup.kpm_cfg, chains_axis=_ca, params_axis=p_ax))
            # without [hmc.burnin] overrides the burnin program is the
            # sampling program — reuse it (one big remote compile saved)
            burnin_step = (
                sim_step if setup.hmc_burnin_cfg == setup.hmc_cfg
                else _adapt(_maker(
                    ops.spec, plan, smesh, setup.fa_mass,
                    setup.hmc_burnin_cfg, kpm_cfg=setup.kpm_cfg,
                    chains_axis=_ca, params_axis=p_ax)))
        else:
            _lmaker = (make_sharded_langevin_step if ops.is_holstein
                       else make_sharded_ssh_langevin_step)
            _ca = "chain" if combined else None
            _lraw = _lmaker(ops.spec, plan, smesh, setup.fa_Q,
                            setup.langevin_dt, setup.langevin_method,
                            setup.solver_cfg, kpm_cfg=setup.kpm_cfg,
                            chains_axis=_ca, params_axis=p_ax)

            def _lwrap(params, state, key):
                params = _place_params(params)
                key = jax.device_put(key, _ksh)
                x = jax.device_put(state.x, _xsh)
                x, stats, key = _lraw(params, x, key)
                acc = jnp.ones(stats["flag"].shape, dtype=bool)
                return HMCState(x=x, v=state.v), \
                    {"accepted": acc, "iters": stats["iters"],
                     "flag": stats["flag"]}, key

            sim_step = burnin_step = _lwrap
    elif setup.dynamics_type == "hmc":
        sim_step = make_hmc_step(ops, setup.fa_mass, setup.hmc_cfg, precond)
        # identical burnin config ⇒ reuse the sampling program (the jit
        # sites below propagate the identity, saving a full compile)
        burnin_step = (
            sim_step if setup.hmc_burnin_cfg == setup.hmc_cfg
            else make_hmc_step(ops, setup.fa_mass, setup.hmc_burnin_cfg,
                               precond))
    else:
        lstep = make_langevin_step(ops, setup.fa_Q, setup.langevin_dt,
                                   setup.langevin_method, setup.solver_cfg, precond)

        def _wrap(params, state, key):
            x, stats, key = lstep(params, state.x, key)
            return HMCState(x=x, v=state.v), \
                {"accepted": jnp.asarray(True), "iters": stats.iters,
                 "flag": stats.flag}, key

        sim_step = burnin_step = _wrap

    mstep = make_measurement_step(ops, setup.mspec, setup.solver_cfg, precond)
    reflect = make_reflection_update(ops, setup.reflect_cfg, precond)
    swap = make_swap_update(ops, setup.swap_cfg, precond)

    # site-sharded measurement sampling: the nᵥ estimator solves — the
    # dominant measurement cost (GreensFunctions.jl:201-234) — run through
    # the sharded halo-fold CG; only the pair-convolution/estimator stage
    # runs on gathered vectors (bounded per-pair FFT work, off the hot loop)
    sharded_sampler = None
    sharded_reflect = sharded_swap = None
    if site_devices > 1 and not combined:
        _gmaker = (make_sharded_greens_sampler if ops.is_holstein
                   else make_sharded_ssh_greens_sampler)
        sharded_sampler = _gmaker(ops.spec, plan, smesh, setup.mspec.nv,
                                  setup.solver_cfg, kpm_cfg=setup.kpm_cfg)
    if site_devices > 1:
        # sharded special updates: the tol² Metropolis solves ride the same
        # halo-fold CG as the sampler instead of gathering to one device
        # (SpecialUpdates.jl:233-366); on the combined 2-D mesh they vmap
        # over the local chain block (per-chain keys ⇒ per-chain moves)
        from elphdynamics_tpu.parallel.lattice_shard import (
            make_sharded_reflection_update, make_sharded_swap_update)
        _sca = "chain" if combined else None
        # under tempering the stacked per-rung params map over the chain
        # axis inside the sharded update (params_axis=0, same threading as
        # make_sharded_hmc_step); tempering requires n_chains > 1 so the
        # site-sharded tempering case is always the combined 2-D mesh
        if (ops.is_holstein and setup.reflect_cfg.n_moves
                and setup.reflect_cfg.freq):
            sharded_reflect = make_sharded_reflection_update(
                ops.spec, plan, smesh, setup.reflect_cfg,
                kpm_cfg=setup.kpm_cfg, chains_axis=_sca, params_axis=p_ax)
        if setup.swap_cfg.n_moves and setup.swap_cfg.freq:
            sharded_swap = make_sharded_swap_update(
                ops.spec, plan, smesh, setup.swap_cfg,
                kpm_cfg=setup.kpm_cfg, is_holstein=ops.is_holstein,
                chains_axis=_sca, params_axis=p_ax)

    def _stats_of(s):
        if isinstance(s, dict):
            return s["accepted"], s["iters"], s["flag"]
        return s.accepted, s.iters, s.flag

    if n_chains > 1:
        def _sharded(fn):
            """Chain-batched step: plain vmap on one device; shard_map over
            the mesh so each chip's solver while_loops see only local chains
            (zero collectives in the sampler hot loop)."""
            vf = jax.vmap(fn, in_axes=(p_ax, 0, 0))
            if mesh is None:
                return jax.jit(vf)
            from jax.sharding import PartitionSpec as P
            # tempering stacks per-rung params with a leading chain axis —
            # those shard with the chains; plain params stay replicated
            return jax.jit(jax.shard_map(
                vf, mesh=mesh,
                in_specs=(P("chain") if tempering else P(),
                          P("chain"), P("chain")),
                out_specs=P("chain"),
                check_vma=False,
            ))

        if combined:
            # the chain×site-sharded steps are already jitted, chain-batched
            # shard_map programs over the 2-D mesh
            sim_step_j = sim_step
            burnin_step_j = burnin_step
        else:
            sim_step_j = _sharded(sim_step)
            burnin_step_j = (sim_step_j if burnin_step is sim_step
                             else _sharded(burnin_step))
        _mstep_v = jax.vmap(mstep, in_axes=(p_ax, 0, 0))
        # bin mask: with tempering only rung-0 (physical λ) chains bin
        _tmask = (jnp.asarray(target_mask(tcfg_t, n_chains)) if tempering
                  else jnp.ones(n_chains, dtype=bool))

        def _mstep_mean(params, x, keys):
            inc, ms, snaps, keys = _mstep_v(params, constrain(x), constrain(keys))
            # chains whose estimator solves failed are masked out of the
            # bin average (Models.jl logs every solver anomaly :106-172;
            # here contaminated chains additionally do not bias the bin)
            # bin weight: unflagged AND (under tempering) physical-rung
            ok = (ms["flag"] == 0) & _tmask
            w = ok.astype(jnp.float32)
            denom = jnp.maximum(jnp.sum(w), 1.0)
            any_ok = jnp.any(ok)

            def chain_mean(a):
                wa = w.reshape((-1,) + (1,) * (a.ndim - 1)).astype(a.dtype)
                masked = jnp.sum(a * wa, axis=0) / denom.astype(a.dtype)
                return jnp.where(any_ok, masked, jnp.mean(a, axis=0))

            inc = jax.tree.map(chain_mean, inc)
            # snapshots are a realizable single configuration, not a
            # cross-chain average (Measurements.jl:1349-1460 dumps the
            # current configuration): take the first unflagged chain
            first_ok = jnp.argmax(ok)
            snaps = jax.tree.map(lambda a: a[first_ok], snaps)
            ms = dict(ms)
            # count SOLVER failures only — masked-by-design non-target
            # tempering rungs are not anomalies
            ms["n_flagged"] = jnp.sum(_tmask & (ms["flag"] != 0))
            return inc, ms, snaps, keys

        mstep_j = jax.jit(_mstep_mean)
        # combined 2-D mesh: the sharded special updates (already jitted
        # chain-vmapped shard_map programs) replace the gather fallback
        reflect_j = (sharded_reflect if sharded_reflect is not None
                     else _sharded(reflect))
        swap_j = (sharded_swap if sharded_swap is not None
                  else _sharded(swap))
    else:
        if site_devices > 1:
            # the site-sharded steps are already jitted shard_map programs
            # over their own (sub)mesh — re-jitting over the default device
            # set must be avoided
            sim_step_j = sim_step
            burnin_step_j = burnin_step
        else:
            sim_step_j = jax.jit(sim_step)
            burnin_step_j = (sim_step_j if burnin_step is sim_step
                             else jax.jit(burnin_step))

        if sharded_sampler is not None:
            from elphdynamics_tpu.measure.greens import GreensData
            analyze_j = jax.jit(mstep.analyze)
            # single-process: gather the bounded convolution stage to one
            # device. Multihost: a single device is not addressable from
            # every process — gather to the replicated mesh sharding
            # instead (an XLA all-gather; analyze_j then runs replicated)
            _dev0 = _rep if mh else jax.devices()[0]

            def _mstep_one(params, x, keys):
                # the solves run sharded over the site mesh; R/M⁻¹R gather
                # to one device only for the convolution/estimator stage.
                # The key stays mesh-resident (the next sampler step
                # consumes it in place).
                params_m = _place_params(params)
                x_m = jax.device_put(x, _xsh)
                keys_m = jax.device_put(keys, _rep)
                R, MinvR, iters, flag, keys = sharded_sampler(
                    params_m, x_m, keys_m)
                put0 = lambda a: jax.device_put(a, _dev0)
                gd = GreensData(R=put0(R), MinvR=put0(MinvR),
                                iters=put0(iters), flag=put0(flag))
                inc, ms, snaps = analyze_j(jax.tree.map(put0, params),
                                           put0(x), gd)
                ms = dict(ms)
                ms["n_flagged"] = jnp.sum(jnp.asarray(ms["flag"]) != 0)
                return inc, ms, snaps, keys

            mstep_j = _mstep_one
        else:
            def _mstep_one(params, x, keys):
                inc, ms, snaps, keys = mstep(params, x, keys)
                ms = dict(ms)
                ms["n_flagged"] = jnp.sum(jnp.asarray(ms["flag"]) != 0)
                return inc, ms, snaps, keys

            mstep_j = jax.jit(_mstep_one)
        # already-jitted shard_map programs when site-sharded (mesh-resident
        # x; no gather) — otherwise the single-device jits
        reflect_j = (sharded_reflect if sharded_reflect is not None
                     else jax.jit(reflect))
        swap_j = (sharded_swap if sharded_swap is not None
                  else jax.jit(swap))

    # ---- burnin dt tuning ([hmc] tune_dt — dual averaging toward
    # target_acceptance, dynamics/hmc.py; beyond reference scope, which
    # fixes dt by hand, HMC.jl:26). The tuner state lives on device inside
    # one jitted program (zero per-update host syncs); after burnin the
    # sampling step is rebuilt ONCE with the frozen averaged dt and the
    # trajectory length Nt re-derived from the configured trajectory_time.
    dt_tuner = None
    burnin_tuned_j = None
    _bcfg = setup.hmc_burnin_cfg
    if (setup.dynamics_type == "hmc" and _bcfg is not None and _bcfg.tune_dt
            and sp.burnin > 0):
        from elphdynamics_tpu.dynamics.hmc import (DtTunerState,
                                                   dt_tuner_init,
                                                   dt_tuner_update)
        _target = _bcfg.target_acceptance
        if site_devices > 1:
            # sharded dynamic-dt step (make_sharded_*hmc_step dynamic_dt):
            # the tuner update runs eagerly on device scalars — no extra
            # compiles, one tiny dispatch per burnin update
            _raw_sbt = _maker(ops.spec, plan, smesh, setup.fa_mass, _bcfg,
                              kpm_cfg=setup.kpm_cfg, chains_axis=_ca,
                              dynamic_dt=True, params_axis=p_ax)

            def _burnin_tuned(params, state, keys, tuner):
                params_m = _place_params(params)
                keys_m = jax.device_put(keys, _ksh)
                x = jax.device_put(state.x, _xsh)
                v = jax.device_put(state.v, _xsh)
                if _defl_on:
                    defl = _place_defl(state.defl)
                    x, v, stats, keys, defl = _raw_sbt(
                        params_m, x, v, keys_m, defl, jnp.exp(tuner.log_dt))
                    st_new = HMCState(x=x, v=v, defl=defl)
                else:
                    x, v, stats, keys = _raw_sbt(params_m, x, v, keys_m,
                                                 jnp.exp(tuner.log_dt))
                    st_new = HMCState(x=x, v=v)
                p = jnp.minimum(1.0, jnp.exp(-stats["delta_H"]))
                p = jnp.where(jnp.isfinite(p) & (stats["flag"] == 0), p, 0.0)
                tuner = dt_tuner_update(tuner, jnp.mean(p), _target)
                return st_new, stats, keys, tuner

            burnin_tuned_j = _burnin_tuned
        else:
            _raw_bt = make_hmc_step(ops, setup.fa_mass, _bcfg, precond,
                                    dynamic_dt=True)
            if n_chains > 1:
                _vbt = jax.vmap(_raw_bt, in_axes=(p_ax, 0, 0, None))
                if mesh is not None:
                    from jax.sharding import PartitionSpec as P
                    _vbt = jax.shard_map(
                        _vbt, mesh=mesh,
                        in_specs=(P("chain") if tempering else P(),
                                  P("chain"), P("chain"), P()),
                        out_specs=P("chain"), check_vma=False)
            else:
                _vbt = _raw_bt

            def _burnin_tuned(params, state, keys, tuner):
                st, stats, keys = _vbt(params, state, keys,
                                       jnp.exp(tuner.log_dt))
                # flagged (solver-aborted) trajectories are auto-rejected:
                # count them at probability 0 so they push dt down too
                p = jnp.minimum(1.0, jnp.exp(-stats.delta_H))
                p = jnp.where(jnp.isfinite(p) & (stats.flag == 0), p, 0.0)
                tuner = dt_tuner_update(tuner, jnp.mean(p), _target)
                return st, stats, keys, tuner

            burnin_tuned_j = jax.jit(_burnin_tuned)
        dt_tuner = dt_tuner_init(_bcfg.dt)

    def _freeze_tuned_dt(tuned_dt: float):
        """Rebuild the sampling-phase step with the tuned dt (one recompile;
        Nt = round(trajectory_time / dt) restores the configured trajectory
        time that the fixed-Nt burnin tuner traded away)."""
        nonlocal sim_step_j
        cfg2 = setup.hmc_cfg._replace(dt=float(tuned_dt))
        if site_devices > 1:
            sim_step_j = _adapt(_maker(
                ops.spec, plan, smesh, setup.fa_mass, cfg2,
                kpm_cfg=setup.kpm_cfg, chains_axis=_ca, params_axis=p_ax))
        else:
            s2 = make_hmc_step(ops, setup.fa_mass, cfg2, precond)
            sim_step_j = _sharded(s2) if n_chains > 1 else jax.jit(s2)
        sim_stats["tuned_dt"] = float(tuned_dt)
        logger.info(
            "tune_dt: frozen dt=%.6g Nt=%d (configured dt=%.6g Nt=%d, "
            "target acceptance %.2f)", cfg2.dt, cfg2.Nt, setup.hmc_cfg.dt,
            setup.hmc_cfg.Nt, _bcfg.target_acceptance)

    # the container accumulate and bin post-processing run jitted: one
    # dispatch each instead of one per leaf
    accum_j = jax.jit(lambda c, inc: jax.tree.map(lambda a, b: a + b, c, inc))
    process_bin_j = jax.jit(
        lambda c: process_bin(ops, setup.mspec, c, sp.bin_size))

    # ---- state init / resume (ProcessInputFile.jl:122-177)
    sim_stats = {
        "simulation_time": 0.0, "measurement_time": 0.0, "write_time": 0.0,
        "iters": 0.0, "acceptance_rate": 0.0,
        "reflect_acceptance_rate": 0.0, "swap_acceptance_rate": 0.0,
    }
    container = zero_container(ops, setup.mspec)
    mu_tuner = MuTuner(
        active=setup.tune_density is not None,
        init_mu=float(np.mean(np.asarray(params.mu))),
        target_N=(setup.tune_density or {}).get("density", 1.0) * ops.Nsites,
        N=ops.Nsites, beta=ops.beta, dtau=ops.dtau,
        forgetful_c=(setup.tune_density or {}).get("memory", 0.75),
        kappa_min=(setup.tune_density or {}).get("kappa_min", 0.1) * ops.Nsites,
        logfile=(os.path.join(datafolder, "mu_tuner_log.out") if primary
                 else None),
    )
    key = jax.random.PRNGKey(sp.random_seed)
    burnin_start, sim_start = 0, 0

    if resume:
        st = ckpt.load_checkpoint(datafolder)
        x = jnp.asarray(st["x"])
        v = jnp.asarray(st["v"])
        key = jnp.asarray(st["key"])
        # merge over the zero container: empty groups are dropped by the
        # flattened npz round trip
        loaded = st["container"]
        container = {
            group: {k: jnp.asarray(loaded.get(group, {}).get(k, z))
                    for k, z in zs.items()}
            for group, zs in container.items()
        }
        params = type(params)(**{k: (jnp.asarray(st["params"][k])
                                     if k in st["params"] else getattr(params, k))
                                 for k in params._fields})
        sim_stats.update(st["sim_stats"])
        mu_tuner.load_state_dict(st["mu_tuner"])
        burnin_start = st["counters"]["burnin_start"]
        sim_start = st["counters"]["sim_start"]
        logger.info("resumed from checkpoint: burnin_start=%d sim_start=%d",
                    burnin_start, sim_start)
        # dt tuner: mid-burnin resumes restore the dual-averaging state;
        # post-burnin resumes re-freeze the tuned sampling step from the
        # persisted value
        _dt_saved = (st.get("extras") or {}).get("dt_tuner")
        if dt_tuner is not None and _dt_saved is not None:
            dt_tuner = DtTunerState(
                *[jnp.asarray(vv, jnp.float32) for vv in _dt_saved])
        if (setup.dynamics_type == "hmc" and "tuned_dt" in sim_stats
                and burnin_start >= sp.burnin):
            _freeze_tuned_dt(sim_stats["tuned_dt"])
    else:
        if setup.read_phonon_config:
            x0 = jnp.asarray(out_io.read_phonons(ops, setup.read_phonon_config))
        else:
            x0, key = init_phonons_half_filled(ops, params, key)
        if n_chains > 1:
            keys = jax.random.split(key, n_chains + 1)
            key = keys[0]
            xs = []
            for i in range(n_chains):
                xi, _ = init_phonons_half_filled(ops, params, keys[i + 1])
                xs.append(xi)
            x = jnp.stack(xs) if not setup.read_phonon_config else jnp.broadcast_to(
                x0, (n_chains,) + x0.shape).copy()
        else:
            x = x0
        v = jnp.zeros_like(x)
        if primary:
            out_io.init_measurement_folders(datafolder, container,
                                            setup.snapshots)
            out_io.write_key_files(datafolder, ops, setup.mspec, container)

    if n_chains > 1 and key.ndim == 1:
        chain_keys = jax.random.split(key, n_chains)
    else:
        chain_keys = key

    exchange_j = None
    if tempering:
        # fresh runs stack the per-rung ladder here (AFTER phonon init,
        # which wants the unbatched physical params); resumed runs loaded
        # the already-stacked ladder from the checkpoint
        if not resume:
            params = ladder_params(params, tcfg_t, n_chains)
        exchange_j = jax.jit(
            make_exchange_step(ops, tcfg_t, n_chains, precond),
            static_argnames="parity")
        sim_stats.setdefault("tempering_acceptance_rate", 0.0)
        logger.info("parallel tempering: ladder=%s freq=%d (%d chains/rung)",
                    list(tcfg_t.ladder), tcfg_t.freq,
                    n_chains // len(tcfg_t.ladder))

    # incremental slow-mode deflation state ([solver.deflation], the deep-β
    # lever — ops/deflation.py). Not checkpointed: the basis is a solver aid
    # that reconverges within ~20 updates after resume.
    defl = None
    _hcfg = setup.hmc_cfg
    if (setup.dynamics_type == "hmc" and _hcfg is not None
            and _hcfg.deflate_k > 0):
        from elphdynamics_tpu.dynamics.hmc import init_deflation
        # independent seed: keeps the main RNG stream identical with or
        # without deflation, and works on resume (key is per-chain there)
        dkey = jax.random.PRNGKey(sp.random_seed + 7919)
        _prm = setup.params  # complex hopping → complex deflation basis
        if n_chains > 1:
            dkeys = jax.random.split(dkey, n_chains)
            defl = jax.vmap(lambda kk: init_deflation(
                ops, _hcfg, kk, params=_prm))(dkeys)
        else:
            defl = init_deflation(ops, _hcfg, dkey, params=_prm)

    state = HMCState(x=x, v=v, defl=defl)
    if n_chains > 1:
        state = place(state)
        chain_keys = place(chain_keys)
    t_ckpt = time.time()

    def maybe_checkpoint(bstart, sstart, force=False, min_interval=None):
        """``min_interval`` throttles the reference's every-bin-boundary
        checkpoint (RunSimulation.jl:271-277): with many short bins the
        host-transfer cost dominated write_time; skipping a bin-boundary
        checkpoint only means a crash replays those deterministic bins."""
        nonlocal t_ckpt
        interval = sp.chckpnt_freq_s if min_interval is None else min_interval
        want = force or (time.time() - t_ckpt) > interval
        if mh:
            # clocks differ per process: process 0's decision governs so the
            # collective state gather below stays symmetric
            want = bool(bcast_int(int(want)))
        if want:
            flush_stats()  # checkpointed sim_stats must include the window
            t0 = time.time()
            data = {"x": state.x, "v": state.v, "key": chain_keys}
            if mh:
                # symmetric collective gather of the cross-process shards;
                # single-process keeps the one-packed-transfer path inside
                # save_checkpoint
                data = fetch_tree(data)
            extras = {}
            if dt_tuner is not None and bstart < sp.burnin:
                # mid-burnin dual-averaging state: 7 f32 scalars, one
                # packed transfer
                extras["dt_tuner"] = np.asarray(
                    fetch(jnp.stack(list(dt_tuner)))).tolist()
            if primary:
                ckpt.save_checkpoint(
                    datafolder, x=data["x"], v=data["v"], key=data["key"],
                    params=params, container=container,
                    counters={"burnin_start": bstart, "sim_start": sstart},
                    sim_stats=sim_stats, mu_tuner_state=mu_tuner.state_dict(),
                    extras=extras)
            sim_stats["write_time"] += time.time() - t0
            t_ckpt = time.time()

    def apply_mu(params, new_mu):
        delta = new_mu - float(np.mean(np.asarray(params.mu)))
        return params._replace(mu=params.mu + delta)

    def gather_x(x):
        """Site-sharded fields are gathered to one device before the
        special updates (their Metropolis scans need the whole lattice; they
        are off the hot loop). The next sampler step re-shards via its
        shard_map in_specs. Under multihost the gather target is the
        replicated mesh sharding (a collective all-gather — one process's
        device is not addressable from the others)."""
        if site_devices > 1:
            return jax.device_put(x, _rep if mh else jax.devices()[0])
        return x

    def meas_x(x):
        """Measurement input: stays sharded when the sharded Green's-function
        sampler runs the estimator solves on the mesh."""
        return x if sharded_sampler is not None else gather_x(x)

    def meas_keys(keys):
        """Chain keys returned by the 2-D-mesh (combined) sampler live on
        the whole mesh; the unsharded measurement jit needs every argument
        on one device. Gather them there (the next sampler step re-shards
        via its shard_map in_specs, like ``gather_x``)."""
        if combined:
            return jax.device_put(keys, _rep if mh else jax.devices()[0])
        return keys

    def do_special(params, state, keys, n):
        nonlocal sim_stats
        fire_reflect = (setup.reflect_cfg.n_moves and setup.reflect_cfg.freq
                        and n % setup.reflect_cfg.freq == 0)
        fire_swap = (setup.swap_cfg.n_moves and setup.swap_cfg.freq
                     and n % setup.swap_cfg.freq == 0)
        specials_sharded = sharded_reflect is not None or sharded_swap is not None
        if site_devices > 1 and (fire_reflect or fire_swap) \
                and not specials_sharded:
            # unsharded special-update jits (combined 2-D mesh): gather the
            # (mesh-resident) key only when one actually fires — never on
            # the per-step hot path
            keys = jax.device_put(keys, _rep if mh else jax.devices()[0])

        def sp_x(x, sharded_fn):
            if sharded_fn is not None:
                # mesh-resident: a no-op re-place in steady state
                return jax.device_put(x, _xsh)
            return gather_x(x)

        def sp_args(params, keys, sharded_fn):
            if sharded_fn is not None:
                return _place_params(params), jax.device_put(keys, _ksh)
            return params, keys

        if fire_reflect:
            t0 = time.time()
            p_, keys = sp_args(params, keys, sharded_reflect)
            xn, acc, keys = reflect_j(p_, sp_x(state.x, sharded_reflect), keys)
            state = state._replace(x=xn)
            sim_stats["simulation_time"] += time.time() - t0
            _accs["reflect"] = _fold(_accs["reflect"], float(n), acc, 0.0, 0)
        if fire_swap:
            t0 = time.time()
            p_, keys = sp_args(params, keys, sharded_swap)
            xn, acc, keys = swap_j(p_, sp_x(state.x, sharded_swap), keys)
            state = state._replace(x=xn)
            sim_stats["simulation_time"] += time.time() - t0
            _accs["swap"] = _fold(_accs["swap"], float(n), acc, 0.0, 0)
        return state, keys

    def do_exchange(params, state, keys, n):
        """Parallel-tempering exchange attempt (alternating pair parity)."""
        nonlocal sim_stats
        if exchange_j is None or n % tcfg_t.freq != 0:
            return state, keys
        t0 = time.time()
        xn, vn, acc, _, flag, keys = exchange_j(
            params, state.x, state.v, keys,
            parity=(n // tcfg_t.freq) % 2)
        # under --devices the exchange runs as one global jit (the partner
        # gathers are XLA collectives); re-place the outputs onto the chain
        # mesh so the next sharded sampler step takes them in place
        state = state._replace(x=place(xn), v=place(vn))
        keys = place(keys)
        sim_stats["simulation_time"] += time.time() - t0
        _accs["tempering"] = _fold(_accs["tempering"], float(n),
                                   acc, 0.0, flag)
        return state, keys

    mu_update_freq = max(sp.meas_freq, 1)

    # per-update HMC energy log, column-compatible with the reference
    # (HMC.jl:236-243,285-304): non-verbose writes one t=-1 row per update
    # per chain with outcome ∈ {0,1}; verbose adds one row per leapfrog
    # timestep (outcome −1, energies at that timestep).
    hmc_log = None
    hmc_verbose = bool(setup.config.get("hmc", {}).get("verbose", False))
    hmc_want = (setup.dynamics_type == "hmc"
                and bool(setup.config.get("hmc", {}).get("log", False)))
    if hmc_want and primary:
        hmc_log_path = os.path.join(datafolder, "hmc_sim_log.out")
        new = not os.path.isfile(hmc_log_path)
        hmc_log = open(hmc_log_path, "a")
        if new:
            hmc_log.write("updates accepted timestep tot_energy action kin_energy iters\n")

    def log_hmc(n, stats):
        # sharded steps report stats as a dict, the unsharded step as
        # HMCStats — the log columns are identical either way. The fetches
        # happen on every process (the gating flags are config-symmetric,
        # keeping the multihost collectives in lockstep); only the file
        # write is primary-only.
        get = (stats.get if isinstance(stats, dict)
               else lambda k, d=None: getattr(stats, k, d))
        if not hmc_want or get("H") is None:
            return
        acc = np.atleast_1d(fetch(get("accepted")))
        H = np.atleast_1d(fetch(get("H")))
        S = np.atleast_1d(fetch(get("S")))
        K = np.atleast_1d(fetch(get("K")))
        iters = np.atleast_1d(fetch(get("iters")))
        traj_H = get("traj_H", np.nan)
        if hmc_verbose and np.ndim(traj_H) > 0:
            tH = np.atleast_2d(fetch(traj_H))               # [chains, Nt]
            tS = np.atleast_2d(fetch(get("traj_S")))
            tK = np.atleast_2d(fetch(get("traj_K")))
            tI = np.atleast_2d(fetch(get("traj_iters")))
            if hmc_log is not None:
                for c in range(tH.shape[0]):
                    for t in range(tH.shape[1]):
                        if not np.isfinite(tH[c, t]):
                            continue  # aborted (flagged) trajectory step
                        hmc_log.write(
                            f"{n} -1 {t + 1} {tH[c, t]:.8f} {tS[c, t]:.8f} "
                            f"{tK[c, t]:.8f} {int(tI[c, t])}\n")
        if hmc_log is None:
            return
        for c in range(acc.shape[0]):
            hmc_log.write(
                f"{n} {int(acc[c])} -1 {H[c]:.8f} {S[c]:.8f} {K[c]:.8f} "
                f"{int(iters[c])}\n")

    def log_solver_flags(kind, n, flag):
        """Surface solver failures into the run log (Models.jl:106-172) and
        the sim_stats counters."""
        flags = np.atleast_1d(fetch(flag))
        nf = int(np.sum(flags != 0))
        if nf:
            sim_stats["solver_failures"] = sim_stats.get("solver_failures", 0) + nf
            logger.warning(
                "solver failure during %s update %d: %d/%d chains flagged "
                "(flags=%s)", kind, n, nf, flags.size,
                np.unique(flags[flags != 0]).tolist())

    # ---- deferred statistics (async dispatch pipeline). Every host sync
    # drains the device queue, and the loop used to pay 3-6 of them per
    # update for scalars nobody reads until the summary. The per-update
    # acceptance/iteration/flag scalars therefore fold into DEVICE-side
    # accumulators (one tiny async dispatch) and come back as a single
    # packed transfer only at
    # checkpoint / bin / finalize boundaries, so the device pipeline never
    # drains between measurements. ``[hmc] log = true`` (per-update energy
    # rows, HMC.jl:236-243) stays async too: the row data lands in a
    # device-side RING BUFFER drained as one packed transfer every LOGB
    # updates. Only ``verbose = true`` (per-TIMESTEP rows, a deep-debug
    # mode whose trajectory arrays change shape between the burnin and
    # sampling phases) keeps the synchronous per-update path.
    stats_sync = hmc_want and hmc_verbose
    LOGB = 64

    _logdt = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32

    @jax.jit
    def _log_push(buf, i, n, acc, H, S, K, iters):
        def put(k, v):
            return buf[k].at[i].set(
                jnp.atleast_1d(jnp.asarray(v).astype(_logdt)))
        return {"n": buf["n"].at[i].set(jnp.asarray(n, _logdt)),
                "acc": put("acc", acc), "H": put("H", H), "S": put("S", S),
                "K": put("K", K), "iters": put("iters", iters)}

    _lb = {"buf": None, "cnt": 0}

    def push_log_row(n, stats):
        """Queue one per-update energy-log row on device (no host sync)."""
        get = (stats.get if isinstance(stats, dict)
               else lambda k, d=None: getattr(stats, k, d))
        if not hmc_want or get("H") is None:
            return
        if _lb["buf"] is None:
            C = max(n_chains, 1)
            z = jnp.zeros((LOGB, C), _logdt)
            _lb["buf"] = {"n": jnp.zeros(LOGB, _logdt), "acc": z,
                          "H": z, "S": z, "K": z, "iters": z}
        _lb["buf"] = _log_push(_lb["buf"], _lb["cnt"], float(n),
                               get("accepted"), get("H"), get("S"),
                               get("K"), get("iters"))
        _lb["cnt"] += 1
        if _lb["cnt"] >= LOGB:
            drain_log_rows()

    def drain_log_rows():
        """One packed transfer for up to LOGB queued log rows (collective
        fetch under multihost — drain points are config-derived), written
        in update order by the primary process."""
        if _lb["cnt"] == 0:
            return
        from elphdynamics_tpu.utils.transfer import tree_to_host
        h = fetch_tree(_lb["buf"]) if mh else tree_to_host(_lb["buf"])
        h = {k: np.asarray(v) for k, v in h.items()}
        if hmc_log is not None:
            for i in range(_lb["cnt"]):
                nrow = int(h["n"][i])
                for c in range(h["acc"].shape[1]):
                    hmc_log.write(
                        f"{nrow} {int(h['acc'][i, c])} -1 {h['H'][i, c]:.8f} "
                        f"{h['S'][i, c]:.8f} {h['K'][i, c]:.8f} "
                        f"{int(h['iters'][i, c])}\n")
        _lb["cnt"] = 0

    def _zero_acc():
        return {"n": 0.0, "acc": 0.0, "iters": 0.0, "nflag": 0.0,
                "first": 1e30, "last": -1.0, "fmax": 0.0}

    @jax.jit
    def _fold(s, n, acc, iters, flag):
        acc = jnp.asarray(acc, jnp.float32)
        iters = jnp.asarray(iters, jnp.float32)
        flag = jnp.atleast_1d(jnp.asarray(flag))
        nf = jnp.sum((flag != 0).astype(jnp.float32))
        has = nf > 0
        return {
            "n": s["n"] + 1.0,
            "acc": s["acc"] + jnp.mean(acc),
            "iters": s["iters"] + jnp.mean(iters),
            "nflag": s["nflag"] + nf,
            "first": jnp.where(has, jnp.minimum(s["first"], n), s["first"]),
            "last": jnp.where(has, jnp.maximum(s["last"], n), s["last"]),
            "fmax": jnp.maximum(s["fmax"], jnp.max(flag).astype(jnp.float32)),
        }

    @jax.jit
    def _fold_count(s, n, cnt):
        # measurement stage: ``n_flagged`` is already the masked count
        cnt = jnp.asarray(cnt, jnp.float32)
        has = cnt > 0
        return {**s, "n": s["n"] + 1.0, "nflag": s["nflag"] + cnt,
                "first": jnp.where(has, jnp.minimum(s["first"], n),
                                   s["first"]),
                "last": jnp.where(has, jnp.maximum(s["last"], n), s["last"])}

    # one accumulator per statistic stream: each stream's arrays keep one
    # consistent device placement, so the folds never mix committed sets
    _accs = {k: _zero_acc() for k in
             ("update", "reflect", "swap", "tempering", "measurement")}
    _acc_key = {"update": ("iters", "acceptance_rate"),
                "reflect": (None, "reflect_acceptance_rate"),
                "swap": (None, "swap_acceptance_rate"),
                "tempering": (None, "tempering_acceptance_rate"),
                "measurement": (None, None)}

    def flush_stats():
        """Drain the device-side accumulators: one packed transfer per
        active stream (collective fetch under multihost — flush points are
        config-derived, so every process reaches them in lockstep), then
        the host-side bookkeeping. Solver-failure warnings aggregate over
        the window; ``[hmc] verbose`` restores per-update granularity."""
        from elphdynamics_tpu.utils.transfer import tree_to_host
        t0 = time.time()
        drain_log_rows()
        moved = False
        for kind, s in _accs.items():
            if isinstance(s["n"], float):
                if s["n"] == 0.0:
                    continue
                h = dict(s)
            else:
                h = {k: float(v) for k, v in
                     (fetch_tree(s) if mh else tree_to_host(s)).items()}
                moved = True
            _accs[kind] = _zero_acc()
            it_key, acc_key = _acc_key[kind]
            if it_key:
                sim_stats[it_key] += h["iters"]
            if acc_key:
                sim_stats[acc_key] += h["acc"]
            nf = int(round(h["nflag"]))
            if nf:
                sim_stats["solver_failures"] = \
                    sim_stats.get("solver_failures", 0) + nf
                logger.warning(
                    "solver failure during %s, updates %d..%d: %d flagged "
                    "(max flag %d)", kind, int(h["first"]), int(h["last"]),
                    nf, int(h["fmax"]))
        if moved:
            # the drain waits on all outstanding sampling compute: attribute
            # it to simulation time (async loops record only dispatch time)
            sim_stats["simulation_time"] += time.time() - t0

    # ---- thermalization (RunSimulation.jl:171-204)
    for n in range(burnin_start, sp.burnin):
        maybe_checkpoint(n, 0)
        t0 = time.time()
        if dt_tuner is not None:
            state, stats, chain_keys, dt_tuner = burnin_tuned_j(
                params, state, chain_keys, dt_tuner)
        else:
            state, stats, chain_keys = burnin_step_j(params, state, chain_keys)
        acc, iters, flag = _stats_of(stats)
        sim_stats["simulation_time"] += time.time() - t0
        if stats_sync:
            sim_stats["iters"] += float(np.mean(fetch(iters)))
            sim_stats["acceptance_rate"] += float(np.mean(fetch(acc)))
            log_solver_flags("burnin", n + 1, flag)
            log_hmc(n + 1, stats)
        else:
            _accs["update"] = _fold(_accs["update"], float(n + 1),
                                    acc, iters, flag)
            push_log_row(n + 1, stats)
        state, chain_keys = do_special(params, state, chain_keys, n + 1)
        state, chain_keys = do_exchange(params, state, chain_keys, n + 1)
        if mu_tuner.active and (n + 1) % mu_update_freq == 0:
            t0 = time.time()
            inc, mstats, snaps, chain_keys = mstep_j(
                    params, meas_x(state.x), meas_keys(chain_keys))
            npairs = setup.mspec.nv * (setup.mspec.nv - 1) // 2
            Nm = float(inc["global"]["density"]) / npairs * ops.Nsites
            N2m = float(inc["global"]["Nsqr"]) / npairs
            new_mu = mu_tuner.update(Nm, N2m)
            params = apply_mu(params, new_mu)
            sim_stats["simulation_time"] += time.time() - t0

    # freeze the tuned dt into the sampling step (one scalar fetch + one
    # recompile; skipped when a post-burnin resume already froze it)
    if dt_tuner is not None and "tuned_dt" not in sim_stats:
        _freeze_tuned_dt(float(np.exp(fetch(dt_tuner.log_dt_avg))))

    # ---- sampling + measurements (RunSimulation.jl:214-280)
    for n in range(sim_start, sp.nsteps):
        maybe_checkpoint(sp.burnin, n)
        t0 = time.time()
        state, stats, chain_keys = sim_step_j(params, state, chain_keys)
        acc, iters, flag = _stats_of(stats)
        sim_stats["simulation_time"] += time.time() - t0
        if stats_sync:
            sim_stats["iters"] += float(np.mean(fetch(iters)))
            sim_stats["acceptance_rate"] += float(np.mean(fetch(acc)))
            log_solver_flags("simulation", n + 1, flag)
            log_hmc(sp.burnin + n + 1, stats)
        else:
            _accs["update"] = _fold(_accs["update"], float(n + 1),
                                    acc, iters, flag)
            push_log_row(sp.burnin + n + 1, stats)
        state, chain_keys = do_special(params, state, chain_keys, n + 1)
        state, chain_keys = do_exchange(params, state, chain_keys, n + 1)

        if (n + 1) % sp.meas_freq == 0:
            nmeas = (n + 1) // sp.meas_freq
            t0 = time.time()
            inc, mstats, snaps, chain_keys = mstep_j(
                    params, meas_x(state.x), meas_keys(chain_keys))
            container = accum_j(container, {k: inc[k] for k in container})
            sim_stats["measurement_time"] += time.time() - t0
            _accs["measurement"] = _fold_count(
                _accs["measurement"], float(nmeas),
                mstats.get("n_flagged", 0))
            if mu_tuner.active:
                npairs = setup.mspec.nv * (setup.mspec.nv - 1) // 2
                Nm = float(inc["global"]["density"]) / npairs * ops.Nsites
                N2m = float(inc["global"]["Nsqr"]) / npairs
                params = apply_mu(params, mu_tuner.update(Nm, N2m))
            # snapshots: one packed transfer for the whole dict, not one
            # fetch per kind
            if snaps:
                t0 = time.time()
                from elphdynamics_tpu.utils.transfer import tree_to_host
                snaps_h = fetch_tree(snaps) if mh else tree_to_host(snaps)
                if primary:
                    for sname, svals in snaps_h.items():
                        out_io.write_snapshot(datafolder, sname,
                                              np.asarray(svals), nmeas)
                sim_stats["write_time"] += time.time() - t0

            if nmeas % sp.bin_size == 0:
                bin_idx = nmeas // sp.bin_size
                flush_stats()  # drain the window's deferred stats/warnings
                t0 = time.time()
                processed = process_bin_j(container)
                from elphdynamics_tpu.utils.transfer import tree_to_host
                processed = tree_to_host(processed)
                sim_stats["measurement_time"] += time.time() - t0
                t0 = time.time()
                if primary:
                    out_io.write_bin(datafolder, processed, bin_idx, ops)
                sim_stats["write_time"] += time.time() - t0
                container = zero_container(ops, setup.mspec)
                maybe_checkpoint(sp.burnin, n + 1,
                                 min_interval=min(10.0, sp.chckpnt_freq_s))

    # ---- finalize (RunSimulation.jl:282-306; SimulationSummary.jl:23-140)
    flush_stats()
    # final checkpoint BEFORE the rate normalization below: checkpointed
    # sim_stats are raw accumulating counters everywhere else, and a resume
    # of a completed run re-enters this normalization — a post-division
    # checkpoint would hand it already-normalized rates to divide again
    maybe_checkpoint(sp.burnin, sp.nsteps, force=True)
    total = sp.burnin + sp.nsteps
    sim_stats["iters"] /= max(total, 1)
    sim_stats["acceptance_rate"] /= max(total, 1)
    for kname, scfg in (("reflect_acceptance_rate", setup.reflect_cfg),
                        ("swap_acceptance_rate", setup.swap_cfg)):
        if scfg.n_moves and scfg.freq:
            napplied = sp.burnin // scfg.freq + sp.nsteps // scfg.freq
            sim_stats[kname] /= max(napplied, 1)
    if tempering:
        nex = sp.burnin // tcfg_t.freq + sp.nsteps // tcfg_t.freq
        sim_stats["tempering_acceptance_rate"] /= max(nex, 1)
    for k in ("simulation_time", "measurement_time", "write_time"):
        sim_stats[k + "_min"] = sim_stats[k] / 60.0

    xh = fetch(state.x) if mh else state.x
    x_final = xh if n_chains == 1 else xh[0]
    if primary:
        out_io.write_phonons(ops, x_final,
                             os.path.join(datafolder, "final_phonon_config.out"))
    if sp.write_M_matrix and primary:
        params_w = (jax.tree.map(lambda a: a[0], params) if tempering
                    else params)
        out_io.write_M_matrix(ops, params_w, x_final,
                              os.path.join(datafolder, "M_matrix.out"))
    mu_tuner.estimate_mu()
    if hmc_log is not None:
        hmc_log.close()
    if primary:
        write_summary(setup, sim_stats, mu_tuner)
    logger.info("simulation complete: %s", sim_stats)
    return sim_stats


def load_model(datafolder: str):
    """Reload a finished/checkpointed run: rebuild the model from the stored
    config and return (setup, params, x) with the final phonon configuration
    (the role of ``load_model``, ElPhDynamics.jl:143-157)."""
    import json

    import jax.numpy as jnp

    with open(os.path.join(datafolder, "config.json")) as f:
        cfg = json.load(f)
    setup = build_setup(cfg, datafolder)
    st = ckpt.load_checkpoint(datafolder)
    params = type(setup.params)(
        **{k: (jnp.asarray(st["params"][k]) if k in st["params"]
               else getattr(setup.params, k))
           for k in setup.params._fields})
    x = jnp.asarray(st["x"])
    return setup, params, x
