"""Multi-process (multi-host) execution: parallel/multihost.py + the
primary-gated IO / symmetric-fetch paths of the driver.

The reference has no distributed execution at all (ElPhDynamics.jl:90-95);
this asserts the jax.distributed leg of the parallel backend: two OS
processes, each owning 2 virtual CPU devices, run ONE driver invocation
over the 4-device global chain mesh and must reproduce the single-process
run's bins with the same seed.
"""

import copy
import os
import socket
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CFG = {
    "lattice": {"ndim": 2, "norbits": 1,
                "lattice_vectors": [[1.0, 0.0], [0.0, 1.0]],
                "basis_vectors": [[0.0, 0.0]], "L": 2},
    "holstein": {"beta": 1.0, "dtau": 0.1,
                 "t": [{"val": 1.0, "orbit": [1, 1], "dL": [1, 0, 0]},
                       {"val": 1.0, "orbit": [1, 1], "dL": [0, 1, 0]}],
                 "omega": [{"orbit": [1], "val": 1.0}],
                 "lambda": [{"orbit": [1], "val": 0.8}],
                 "mu": [{"orbit": [1], "val": 0.0}]},
    "fourier_acceleration": [
        {"omega_min": 0.0, "omega_max": 10.0, "mass": 0.5}],
    "hmc": {"burnin_updates": 2, "simulation_updates": 4,
            "trajectory_time": 0.3, "dt": 0.1, "num_multitimesteps": 2,
            "meas_freq": 2, "log": True,
            "reflection_update": {"freq": 2, "nsites": 1}},
    # tempering composes with multihost: the per-rung params shard with
    # their chains across processes, the exchange gathers cross-process
    "tempering": {"ladder": [1.0, 1.4], "freq": 2},
    "simulation": {"foldername": "mh", "num_bins": 2, "random_seed": 5,
                   "checkpoint_freq": 10},
    "solver": {"type": "CG", "tol": 1e-5, "maxiter": 800,
               "preconditioner": {"n": 8}},
    "measurements": {"num_random_vectors": 4,
                     "Greens": {"measure": True, "time_dependent": True},
                     "DenDen": {"measure": True, "time_dependent": False}},
}

RUNNER = textwrap.dedent("""
    import json, os, sys
    proc, port, filepath = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    import jax
    jax.config.update("jax_enable_x64", True)
    from elphdynamics_tpu.parallel.multihost import init_multihost
    init_multihost(coordinator_address="127.0.0.1:" + port,
                   num_processes=2, process_id=proc)
    cfg = json.load(open(sys.argv[4]))
    cfg["simulation"]["filepath"] = filepath
    from elphdynamics_tpu.simulation import simulate
    stats = simulate(cfg, n_chains=4, n_devices=0)
    print("MH_DONE", proc, stats["acceptance_rate"], flush=True)
""")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_multihost_driver_matches_single_process(tmp_path):
    import json

    import numpy as np

    # --- single-process baseline (in this pytest process, 4 vmapped chains)
    from elphdynamics_tpu.simulation import simulate

    cfg1 = copy.deepcopy(CFG)
    cfg1["simulation"]["filepath"] = str(tmp_path / "one")
    os.makedirs(str(tmp_path / "one"))
    simulate(cfg1, n_chains=4)

    # --- two-process run over a 4-device global mesh
    cfgf = str(tmp_path / "cfg.json")
    json.dump(CFG, open(cfgf, "w"))
    runf = str(tmp_path / "runner.py")
    open(runf, "w").write(RUNNER)
    mhdir = str(tmp_path / "mh")
    os.makedirs(mhdir)
    port = str(_free_port())
    env = dict(os.environ,
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, runf, str(p), port, mhdir, cfgf],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for p in (0, 1)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=900)
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
        assert "MH_DONE" in out, out[-3000:]

    # primary wrote the full datafolder; bins match the single-process run
    one = os.path.join(str(tmp_path / "one"), "mh-1")
    mh = os.path.join(mhdir, "mh-1")
    assert os.path.isfile(os.path.join(mh, "checkpoint.npz"))
    assert os.path.isfile(os.path.join(mh, "hmc_sim_log.out"))
    for b in (1, 2):
        fn = f"global_measurements_{b:05d}.out"
        g1 = {l.split()[0]: float(l.split()[1])
              for l in open(os.path.join(one, "global_measurements_f", fn))}
        g2 = {l.split()[0]: float(l.split()[1])
              for l in open(os.path.join(mh, "global_measurements_f", fn))}
        for k in g1:
            assert abs(g1[k] - g2[k]) < 5e-6 * (1.0 + abs(g1[k])), \
                (b, k, g1[k], g2[k])

    # the HMC energy logs agree (symmetric fetch + primary-only write):
    # same rows, accept decisions identical, energies to solver tolerance
    l1 = open(os.path.join(one, "hmc_sim_log.out")).read().splitlines()
    l2 = open(os.path.join(mh, "hmc_sim_log.out")).read().splitlines()
    assert len(l1) == len(l2) and len(l1) > 1
    for a, b_ in zip(l1[1:], l2[1:]):
        ca, cb = a.split(), b_.split()
        assert ca[:3] == cb[:3], (a, b_)          # update, accepted, timestep
        assert abs(float(ca[3]) - float(cb[3])) < 1e-6 * (
            1.0 + abs(float(ca[3]))), (a, b_)     # total energy


def _slim_site_cfg():
    """The site-sharded legs pay hot-loop collectives over gloo with two
    processes pinned to ONE host core — slim the lattice/updates hard so
    each leg stays inside a ~10-min chunk window."""
    cfg = copy.deepcopy(CFG)
    del cfg["tempering"]  # needs >=2 chains/rung; these legs run 1-2 chains
    # 4-way site sharding needs >=4 sites per row so bonds cross at most
    # one block boundary (lattice_shard.build_shard_plan)
    cfg["lattice"]["L"] = 4
    cfg["holstein"]["beta"] = 0.5
    cfg["hmc"].update(burnin_updates=2, simulation_updates=2, meas_freq=1,
                      num_multitimesteps=1)
    cfg["solver"]["maxiter"] = 300
    cfg["measurements"]["num_random_vectors"] = 2
    cfg["simulation"]["num_bins"] = 2
    return cfg


def _run_site_leg(tmp_path, cfg, leg, n_chains, site_devices,
                  devs_per_proc=1, n_devices=1, num_processes=2):
    """One multihost x site-devices leg: single-process baseline on the
    8-virtual-device pytest process vs the same sharded program spanning
    two OS processes (devs_per_proc devices each); bins must match."""
    import json

    from elphdynamics_tpu.simulation import simulate

    cfg1 = copy.deepcopy(cfg)
    cfg1["simulation"]["filepath"] = str(tmp_path / "one")
    os.makedirs(str(tmp_path / "one"))
    simulate(cfg1, n_chains=n_chains, n_devices=n_devices,
             site_devices=site_devices)

    cfgf = str(tmp_path / "cfg.json")
    json.dump(cfg, open(cfgf, "w"))
    runner = textwrap.dedent(f"""
        import json, os, sys
        proc, port, filepath = int(sys.argv[1]), sys.argv[2], sys.argv[3]
        import jax
        jax.config.update("jax_enable_x64", True)
        from elphdynamics_tpu.parallel.multihost import init_multihost
        init_multihost(coordinator_address="127.0.0.1:" + port,
                       num_processes={num_processes}, process_id=proc)
        cfg = json.load(open(sys.argv[4]))
        cfg["simulation"]["filepath"] = filepath
        from elphdynamics_tpu.simulation import simulate
        stats = simulate(cfg, n_chains={n_chains}, n_devices={n_devices},
                         site_devices={site_devices})
        print("LEG_DONE", proc, stats["acceptance_rate"], flush=True)
    """)
    runf = str(tmp_path / "runner.py")
    open(runf, "w").write(runner)
    mhdir = str(tmp_path / "mh")
    os.makedirs(mhdir)
    port = str(_free_port())
    env = dict(os.environ,
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count="
                         + str(devs_per_proc),
               PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, runf, str(p), port, mhdir, cfgf],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for p in range(num_processes)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=1500)
            outs.append(out)
    finally:
        for p in procs:  # a timeout must not leave orphaned runners
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, (leg, out[-4000:])
        assert "LEG_DONE" in out, (leg, out[-4000:])

    od = os.path.join(str(tmp_path / "one"), "mh-1")
    md = os.path.join(mhdir, "mh-1")
    assert os.path.isfile(os.path.join(md, "checkpoint.npz")), leg
    for b in (1, 2):
        fn = f"global_measurements_{b:05d}.out"
        g1 = {l.split()[0]: float(l.split()[1])
              for l in open(os.path.join(od, "global_measurements_f", fn))}
        g2 = {l.split()[0]: float(l.split()[1])
              for l in open(os.path.join(md, "global_measurements_f", fn))}
        for k in g1:
            assert abs(g1[k] - g2[k]) < 5e-6 * (1.0 + abs(g1[k])), \
                (leg, b, k, g1[k], g2[k])


@pytest.mark.slow
def test_multihost_site_sharded_matches_single_process(tmp_path):
    """--site-devices composes with --multihost (the last composition
    carve-out): a 1-D site mesh over 4 global devices spans two OS
    processes; the checkerboard halo ppermutes cross the process boundary,
    the sharded special updates run on the cross-process mesh, and the
    sharded-sampler convolution stage gathers to a replicated sharding
    instead of one device. Bins must match the single-process run of the
    SAME sharded program (identical seed and collective partition)."""
    cfg = _slim_site_cfg()
    # one device per process: the 2-way site mesh is exactly the
    # cross-process boundary; extra virtual devices only thrash the
    # single host core
    _run_site_leg(tmp_path, cfg, "site", n_chains=1, site_devices=2)


@pytest.mark.slow
def test_multihost_combined_mesh_matches_single_process(tmp_path):
    """The combined 2-D (chain x site) mesh under --multihost: 2 chains x
    2 site shards over the 4 cross-process devices; the combined-mode
    measurement gathers (meas_x / meas_keys) ride replicated-sharding
    all-gathers."""
    cfg = _slim_site_cfg()
    # no special updates: this leg targets the combined-mode measurement
    # gather path; specials x multihost are the site leg's job
    del cfg["hmc"]["reflection_update"]
    # the 2-D mesh must span ALL processes' devices: 2 chain ranks x
    # 2 site ranks = 4 global devices (2 per process)
    _run_site_leg(tmp_path, cfg, "comb", n_chains=2, site_devices=2,
                  devs_per_proc=2, n_devices=2)


@pytest.mark.slow
def test_multihost_4proc_combined_mesh(tmp_path):
    """FOUR processes, one device each, spanning the combined 2-D mesh
    (2 chain ranks x 2 site ranks = 4 cross-process devices) — every mesh
    edge is a process boundary (VERDICT r4 item 8). Bins must match the
    single-process run of the same sharded program."""
    cfg = _slim_site_cfg()
    del cfg["hmc"]["reflection_update"]
    _run_site_leg(tmp_path, cfg, "4proc", n_chains=2, site_devices=2,
                  devs_per_proc=1, n_devices=2, num_processes=4)


@pytest.mark.slow
def test_multihost_checkpoint_resume(tmp_path):
    """Multihost checkpoint-resume (VERDICT r4 item 8): process 0 writes the
    checkpoint; a SECOND 2-process invocation restores consistent sharded
    state on every process (counters rewound by hand, as the single-process
    resume regression does) and rewrites the final bin."""
    import json

    cfg = copy.deepcopy(CFG)
    cfgf = str(tmp_path / "cfg.json")
    json.dump(cfg, open(cfgf, "w"))
    runf = str(tmp_path / "runner.py")
    open(runf, "w").write(RUNNER)
    mhdir = str(tmp_path / "mh")
    os.makedirs(mhdir)
    env = dict(os.environ,
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=REPO)

    def run_pair():
        port = str(_free_port())
        procs = [subprocess.Popen(
            [sys.executable, runf, str(p), port, mhdir, cfgf],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for p in (0, 1)]
        outs = []
        try:
            for p in procs:
                out, _ = p.communicate(timeout=1200)
                outs.append(out)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for p, out in zip(procs, outs):
            assert p.returncode == 0, out[-4000:]
            assert "MH_DONE" in out, out[-4000:]

    run_pair()
    folder = os.path.join(mhdir, "mh-1")
    meta = json.load(open(os.path.join(folder, "checkpoint.json")))
    assert meta["counters"]["sim_start"] == CFG["hmc"]["simulation_updates"]
    # rewind to mid-run; the resume must redo the second half and rewrite
    # the final bin on process 0
    meta["counters"]["sim_start"] = CFG["hmc"]["simulation_updates"] // 2
    json.dump(meta, open(os.path.join(folder, "checkpoint.json"), "w"))
    binf = os.path.join(folder, "global_measurements_f",
                        "global_measurements_00002.out")
    before = os.path.getmtime(binf)
    run_pair()
    assert os.path.getmtime(binf) >= before
    # final counters restored to a completed run
    meta2 = json.load(open(os.path.join(folder, "checkpoint.json")))
    assert meta2["counters"]["sim_start"] == CFG["hmc"]["simulation_updates"]
