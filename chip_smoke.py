#!/usr/bin/env python3
"""Smoke run of the main path on NVIDIA GPUs, in one process.

    python chip_smoke.py            # one card: phases a, b, c
    python chip_smoke.py --gpus 4   # four cards: phase d only

a. Parity at production widths against a float64 numpy reference built from
   dense per-slice exp(−Δτ·K) (ops/checkerboard.dense_matrix, the scheme of
   tests/dense_reference.py): Holstein 32×32 (dense route) at HIGHEST and at
   the resolved ``loop_precision``, Holstein 64×64 (group fold), SSH 32×32
   (fold), the measurement FFTs, and KPM-preconditioned CG convergence.
b. µs per exp(−Δτ·K) application at N=4096, 16 chains × Lτ=40 columns: the
   XLA group fold against the dense matmul at HIGHEST and at DEFAULT (the
   KPM's precision). A CUDA fold holding a column tile in shared memory
   across all groups was measured here and lost; see PERF.md.
c. ``simulate()`` end to end (Holstein and SSH HMC with measurements, bins
   and checkpoints; Holstein 64×64 HMC; Holstein Langevin), each in a fresh
   temporary datafolder.
d. (``--gpus 4``) chain sharding over four cards against one card, and the
   site-sharded 64×64 HMC step against the unsharded step.

Every result line names the card (``nvidia-smi`` name and power limit), the
JAX version and the compile-cache directory. A failed check raises; nothing
is caught. The last line is ``{"ok": true, "device": {...}}``. Without a GPU
the script exits non-zero before any phase runs.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
EXAMPLES = REPO / "examples"

# parity tolerances (max |got − ref| / max |ref| against float64)
TOL_F32 = 1e-5      # f32 operands, f32 products and sums
# 3-pass bf16 keeps ~16 mantissa bits per product (2^-16 ≈ 1.5e-5); a
# one-pass TF32 product keeps 11 (2^-11 ≈ 4.9e-4) and would fail this
TOL_LOOP_HIGH = 1e-4
TOL_FFT = 1e-5

HMC_SCHEDULE = dict(burnin_updates=5, simulation_updates=10, meas_freq=5)
# XLA compilations run one after another, so their durations add up;
# tracing events nest (an inner jit is traced inside the outer one) and
# are left in the run time
_COMPILE_EVENT = "/jax/core/compile/backend_compile_duration"
_compile_secs = [0.0]
_listening = [False]


def _count_compile(event, duration, **_):
    if event == _COMPILE_EVENT:
        _compile_secs[0] += duration


def compile_seconds() -> float:
    """Seconds XLA has spent compiling in this process so far."""
    import jax

    if not _listening[0]:
        jax.monitoring.register_event_duration_secs_listener(_count_compile)
        _listening[0] = True
    return _compile_secs[0]


def nvidia_smi() -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def make_log(card: str, cache: str):
    import jax

    tail = f"card: {card} | jax {jax.__version__} | cache: {cache}"

    def log(phase: str, msg: str):
        print(f"[{phase}] {msg} | {tail}", flush=True)

    return log


def _rel(got, ref) -> float:
    got = np.asarray(got, np.float64 if not np.iscomplexobj(got)
                     else np.complex128)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _check(log, phase, name, err, tol, failures):
    ok = err <= tol
    log(phase, f"{name}: max rel err {err:.3e} tol {tol:.0e} "
               f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{name}: {err:.3e} > {tol:.0e}")


# ---------------------------------------------------------------------------
# models (parameters of examples/holstein_hmc_square.toml and
# examples/ssh_hmc_square.toml) and the float64 reference
# ---------------------------------------------------------------------------

def _square(L):
    from elphdynamics_tpu.lattice import Lattice, UnitCell

    uc = UnitCell.create(2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
    return Lattice.create(uc, L)


def holstein(L, beta=4.0, dtau=0.1, dense_threshold=2048):
    from elphdynamics_tpu.models.adapter import make_model_ops
    from elphdynamics_tpu.models.holstein import build_holstein

    spec, params = build_holstein(
        _square(L), beta, dtau,
        t_assignments=[(1.0, 0.0, 0, 0, (1, 0, 0)),
                       (1.0, 0.0, 0, 0, (0, 1, 0))],
        omega=1.0, lam=1.0, mu=0.0, dense_threshold=dense_threshold,
        rng=np.random.default_rng(0), dtype=np.float32)
    return spec, params, make_model_ops(spec)


def ssh(L, beta=4.0, dtau=0.1):
    from elphdynamics_tpu.models.adapter import make_model_ops
    from elphdynamics_tpu.models.ssh import build_ssh

    hop = dict(t=1.0, alpha=0.25, alpha2=0.0, omega=0.5, o1=0, o2=0)
    spec, params = build_ssh(
        _square(L), beta, dtau,
        hoppings=[dict(hop, dL=(1, 0, 0), name="ssh_x"),
                  dict(hop, dL=(0, 1, 0), name="ssh_y")],
        mu_assignments=[(0.0, 0.0, None)], rng=np.random.default_rng(0),
        dtype=np.float32)
    return spec, params, make_model_ops(spec)


def _sign(L, at):
    s = -np.ones(L)
    s[at] = 1.0
    return s


def _apply_K(K, u, transpose=False):
    """K is [N, N] (time-independent) or [Lτ, N, N] (per slice); u [N, Lτ]."""
    if K.ndim == 2:
        return (K.T if transpose else K) @ u
    return np.einsum("tji,jt->it" if transpose else "tij,jt->it", K, u)


def ref_M(K, d, v):
    """M·v = v(τ) − K(τ)·d(τ)·v(τ−1), + at the antiperiodic wrap."""
    return v + _sign(v.shape[-1], 0) * _apply_K(K, d * np.roll(v, 1, -1))


def ref_MT(K, d, v):
    return v + _sign(v.shape[-1], -1) * np.roll(
        d * _apply_K(K, v, transpose=True), -1, -1)


def holstein_reference(spec, params, x):
    """(K [N, N], d [N, Lτ]) in float64 for the Holstein operator."""
    from elphdynamics_tpu.ops.checkerboard import dense_matrix

    K = dense_matrix(spec.ckb, np.asarray(params.cosht, np.float64),
                     np.asarray(params.sinht, np.float64))
    f64 = lambda a: np.asarray(a, np.float64)[:, None]
    x = np.asarray(x, np.float64)
    d = np.exp(-spec.dtau * (f64(params.lam) * x + f64(params.lam2) * x * x
                             - f64(params.mu)))
    return K, d


def ssh_reference(spec, params, derived):
    from elphdynamics_tpu.ops.checkerboard import dense_matrix

    c = np.asarray(derived.cosh, np.float64)
    s = np.asarray(derived.sinh, np.float64)
    K = np.stack([dense_matrix(spec.ckb, c[:, t], s[:, t])
                  for t in range(spec.Ltau)])
    d = np.exp(spec.dtau * np.asarray(params.mu, np.float64))[:, None]
    return K, np.broadcast_to(d, (spec.Nsites, spec.Ltau))


# ---------------------------------------------------------------------------
# phase a: parity
# ---------------------------------------------------------------------------

def phase_parity(log, L_dense=32, L_fold=64, L_ssh=32, beta=4.0,
                 fold_threshold=2048):
    """Operators, transforms and the KPM-CG solve against float64."""
    import jax
    import jax.numpy as jnp

    from elphdynamics_tpu import solvers
    from elphdynamics_tpu.dynamics.init_phonons import init_phonons_half_filled
    from elphdynamics_tpu.measure import greens
    from elphdynamics_tpu.models import holstein as H
    from elphdynamics_tpu.ops import checkerboard as ckb
    from elphdynamics_tpu.ops import kpm

    failures = []
    rng = np.random.default_rng(1)

    # -- Holstein, dense exp(−Δτ·K) route
    spec, params, ops = holstein(L_dense, beta)
    x = init_phonons_half_filled(ops, params, jax.random.PRNGKey(0))[0]
    v = jnp.asarray(rng.standard_normal((spec.Nsites, spec.Ltau)),
                    jnp.float32)
    env = ops.derived(params, x)
    K, d = holstein_reference(spec, params, x)
    vh = np.asarray(v, np.float64)
    refs = {"mulM": ref_M(K, d, vh), "mulMT": ref_MT(K, d, vh)}
    refs["mulMTM"] = ref_MT(K, d, refs["mulM"])
    tag = f"Holstein {L_dense}x{L_dense} N={spec.Nsites} Ltau={spec.Ltau}"
    route = "dense" if spec.dense_ckb else "fold"
    high = H.resolve_precision("high", jnp.float32)
    for prec, tol, label in ((None, TOL_F32, "HIGHEST"),
                             ("high", TOL_LOOP_HIGH, f"high={high}")):
        for name, ref in refs.items():
            fn = jax.jit(lambda e, u, f=getattr(H, name), p=prec:
                         f(spec, params, e, u, p))
            _check(log, "a", f"{tag} {route} {name} {label}",
                   _rel(fn(env, v), ref), tol, failures)
    single = jax.jit(lambda e, u: H.mulMTM(spec, params, e, u, "default"))
    log("a", f"{tag} mulMTM at DEFAULT (one-pass, for contrast): max rel err "
             f"{_rel(single(env, v), refs['mulMTM']):.3e}")
    hlo = jax.jit(lambda e, u: H.mulMTM(spec, params, e, u, "high")).lower(
        env, v).as_text()
    algo = re.search(r"algorithm = <[^>]*>", hlo)
    log("a", f"{tag} loop_precision='high' lowers to "
             f"{algo.group(0) if algo else 'no dot algorithm'}")
    if spec.dense_ckb and "num_primitive_operations = 3" not in hlo:
        failures.append("loop_precision 'high' is not a 3-pass algorithm")

    # -- KPM-preconditioned CG on this operator vs unpreconditioned
    b = H.mulMT(spec, params, env, v)
    mtm = lambda u: H.mulMTM(spec, params, env, u)
    pre = kpm.make_symmetric_precond(ops, kpm.KPMConfig(max_order=8))
    st = pre.setup(params, x)
    solve = jax.jit(lambda bb, s: solvers.solve_checked(
        mtm, bb, apply_P=lambda u: pre.symmetric(s, u), tol=1e-5,
        maxiter=5000, fallback=False))
    plain = jax.jit(lambda bb: solvers.solve_checked(
        mtm, bb, tol=1e-5, maxiter=20000, fallback=False))
    rp, r0 = solve(b, st), plain(b)
    log("a", f"{tag} KPM-CG iters {int(rp.iters)} (flag {int(rp.flag)}, "
             f"residual {float(rp.residual):.2e}) vs unpreconditioned CG "
             f"iters {int(r0.iters)} (flag {int(r0.flag)})")
    if int(rp.flag) != 0 or not int(rp.iters) < int(r0.iters):
        failures.append("KPM-preconditioned CG did not converge faster")

    # -- Holstein, group-fold route
    spec, params, ops = holstein(L_fold, beta, dense_threshold=fold_threshold)
    x = init_phonons_half_filled(ops, params, jax.random.PRNGKey(1))[0]
    env = ops.derived(params, x)
    K, d = holstein_reference(spec, params, x)
    Kinv = ckb.dense_matrix(spec.ckb, np.asarray(params.cosht, np.float64),
                            np.asarray(params.sinht, np.float64),
                            inverse=True)
    v = jnp.asarray(rng.standard_normal((spec.Nsites, spec.Ltau)),
                    jnp.float32)
    vh = np.asarray(v, np.float64)
    tag = f"Holstein {L_fold}x{L_fold} N={spec.Nsites} Ltau={spec.Ltau}"
    if spec.dense_ckb:
        failures.append(f"{tag}: expected the group-fold route")
    fold_refs = {"ckb_mul": K @ vh, "ckb_transpose_mul": K.T @ vh,
                 "ckb_inverse_mul": Kinv @ vh,
                 "ckb_inverse_transpose_mul": Kinv.T @ vh}
    for name, ref in fold_refs.items():
        fn = jax.jit(lambda cc, ss, u, f=getattr(ckb, name):
                     f(spec.ckb, cc, ss, u))
        _check(log, "a", f"{tag} XLA fold {name}",
               _rel(fn(params.cosht, params.sinht, v), ref), TOL_F32,
               failures)
    ref = ref_MT(K, d, ref_M(K, d, vh))
    fn = jax.jit(lambda e, u: H.mulMTM(spec, params, e, u))
    _check(log, "a", f"{tag} mulMTM (XLA fold)", _rel(fn(env, v), ref),
           TOL_F32, failures)

    # -- SSH, group fold with per-slice coefficients
    spec, params, ops = ssh(L_ssh, beta)
    x = init_phonons_half_filled(ops, params, jax.random.PRNGKey(2))[0]
    derived = ops.derived(params, x)
    K, d = ssh_reference(spec, params, derived)
    v = jnp.asarray(rng.standard_normal((spec.Nsites, spec.Ltau)),
                    jnp.float32)
    ref = ref_MT(K, d, ref_M(K, d, np.asarray(v, np.float64)))
    fn = jax.jit(lambda dd, u: ops.mulMTM(params, dd, u))
    _check(log, "a", f"SSH {L_ssh}x{L_ssh} N={spec.Nsites} Ltau={spec.Ltau} "
                     f"mulMTM (XLA fold)", _rel(fn(derived, v), ref),
           TOL_F32, failures)

    # -- measurement convolution transforms: 2Lτ and L axes
    T2 = 2 * int(round(beta / 0.1))
    z = (rng.standard_normal((2, L_dense, L_dense, T2))
         + 1j * rng.standard_normal((2, L_dense, L_dense, T2)))
    zj = jnp.asarray(z, jnp.complex64)
    old = greens.DFT_MATMUL
    try:
        for flag in (False, True):
            greens.DFT_MATMUL = flag
            for axis, n in ((-1, T2), (-2, L_dense)):
                for inv in (False, True):
                    fn = jax.jit(lambda a, ax=axis, i=inv:
                                 greens._fft_axis(a, ax, i))
                    ref = (np.fft.ifft if inv else np.fft.fft)(z, axis=axis)
                    _check(log, "a", f"_fft_axis n={n} "
                                     f"{'inverse' if inv else 'forward'} "
                                     f"{'DFT matmul' if flag else 'FFT'}",
                           _rel(fn(zj), ref), TOL_FFT, failures)
    finally:
        greens.DFT_MATMUL = old
    if failures:
        raise AssertionError("phase a: " + "; ".join(failures))


# ---------------------------------------------------------------------------
# phase b: fold timing
# ---------------------------------------------------------------------------

def time_apply(fn, args, inner=20, reps=5) -> float:
    """µs per application of ``fn(*args[:-1], v)``: ``inner`` applications
    chained (unrolled, so no loop control between them) in one jitted call,
    after a warm-up call."""
    import jax

    @jax.jit
    def run(*a):
        u = a[-1]
        for _ in range(inner):
            u = fn(*a[:-1], u)
        return u

    jax.block_until_ready(run(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = run(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / (reps * inner) * 1e6


def phase_fold_timing(log, L=64, chains=16, beta=4.0, inner=20, reps=5):
    """exp(−Δτ·K)·v on the [chains, N, Lτ] field: XLA fold against the
    dense matmul (HIGHEST, and DEFAULT as the KPM uses it)."""
    import jax
    import jax.numpy as jnp

    from elphdynamics_tpu.ops import checkerboard as ckb

    spec, params, _ = holstein(L, beta, dense_threshold=0)
    N, Lt = spec.Nsites, spec.Ltau
    v = jax.random.normal(jax.random.PRNGKey(0), (chains, N, Lt), jnp.float32)
    c, s = params.cosht, params.sinht
    K = jnp.asarray(ckb.dense_matrix(spec.ckb, np.asarray(c, np.float64),
                                     np.asarray(s, np.float64)), jnp.float32)
    tag = f"N={N} K={chains}x{Lt}"
    times = {}
    times["XLA group fold"] = time_apply(
        lambda cc, ss, u: ckb.ckb_mul(spec.ckb, cc, ss, u), (c, s, v),
        inner, reps)
    for prec in ("HIGHEST", "DEFAULT"):
        p = getattr(jax.lax.Precision, prec)
        times[f"dense matmul {prec}"] = time_apply(
            lambda k, u, p=p: jnp.einsum("ij,...jt->...it", k, u,
                                         precision=p), (K, v), inner, reps)
    for name, us in times.items():
        log("b", f"{tag} {name}: {us:.2f} us/apply")
    return times


# ---------------------------------------------------------------------------
# phase c: simulate() end to end
# ---------------------------------------------------------------------------

def example_config(name, L, beta, folder, seed=11, **hmc):
    """An example TOML with the lattice, β, schedule and output folder
    replaced."""
    from elphdynamics_tpu.io.config import load_toml

    cfg = load_toml(EXAMPLES / name)
    cfg["lattice"]["L"] = L
    cfg["holstein" if "holstein" in cfg else "ssh"]["beta"] = beta
    cfg["hmc" if "hmc" in cfg else "langevin"].update(hmc)
    cfg["simulation"].update(filepath=str(folder), num_bins=2,
                             random_seed=seed)
    return cfg


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def run_simulation(log, label, cfg, n_chains, n_devices=1, hmc=True):
    """simulate() in cfg's folder; checks outputs and returns its stats."""
    from elphdynamics_tpu.simulation import simulate

    c0, t0 = compile_seconds(), time.perf_counter()
    stats = simulate(cfg, run_id=1, n_chains=n_chains, n_devices=n_devices)
    wall = time.perf_counter() - t0
    comp = compile_seconds() - c0
    name = cfg["simulation"]["foldername"]
    folder = Path(cfg["simulation"]["filepath"]) / f"{name}-1"
    summary = folder / f"{name}_summary.out"
    bins = sorted(folder.glob("global_measurements_f/global_measurements_*"))
    problems = []
    if not summary.is_file():
        problems.append("no summary file")
    if len(bins) != cfg["simulation"]["num_bins"]:
        problems.append(f"{len(bins)} global bin files")
    if not (folder / "checkpoint.npz").is_file():
        problems.append("no checkpoint")
    for f in [summary, *folder.glob("*_f/*.out")]:
        if f.is_file() and re.search(r"(?i)\bnan\b", f.read_text()):
            problems.append(f"NaN in {f.relative_to(folder)}")
    if hmc and not stats["acceptance_rate"] > 0:
        problems.append("acceptance 0")
    if stats.get("solver_failures", 0):
        problems.append(f"{stats['solver_failures']} solver failures")
    log("c", f"{label}: wall {wall:.1f} s = XLA compile {comp:.1f} s + "
             f"the rest {wall - comp:.1f} s; acceptance {stats['acceptance_rate']:.3f};"
             f" mean CG iters/solve {stats['iters']:.1f}; solver failures "
             f"{stats.get('solver_failures', 0)}; process peak device bytes "
             f"so far {_peak_bytes()}")
    if problems:
        raise AssertionError(f"phase c {label}: " + "; ".join(problems))
    stats["run_seconds"] = wall - comp
    return stats


def phase_end_to_end(log, workdir, L_main=32, L_ssh=16, L_big=64, L_lang=8,
                     beta=4.0, chains=16, lang_chains=32, nv=10):
    def cfg(name, L, sub, **hmc):
        return example_config(name, L, beta, Path(workdir) / sub, **hmc)

    c1 = cfg("holstein_hmc_square.toml", L_main, "c1", **HMC_SCHEDULE)
    c1["measurements"]["num_random_vectors"] = nv
    run_simulation(log, f"c.1 Holstein HMC {L_main}x{L_main} beta={beta} "
                        f"{chains} chains, measurements nv={nv}", c1, chains)

    c2 = cfg("ssh_hmc_square.toml", L_ssh, "c2", **HMC_SCHEDULE)
    c2["measurements"]["num_random_vectors"] = nv
    run_simulation(log, f"c.2 SSH HMC {L_ssh}x{L_ssh} beta={beta} "
                        f"{chains} chains", c2, chains)

    # large-N operator route (group fold): correlation measurements off,
    # the global measurements (2 vectors) kept for the bin files
    c3 = cfg("holstein_hmc_square.toml", L_big, "c3", burnin_updates=1,
             simulation_updates=4, meas_freq=2)
    c3["measurements"] = {"num_random_vectors": 2}
    run_simulation(log, f"c.3 Holstein HMC {L_big}x{L_big} beta={beta} "
                        f"{chains} chains, no correlation measurements",
                   c3, chains)

    c4 = cfg("holstein_langevin_square.toml", L_lang, "c4",
             burnin_timesteps=2, simulation_timesteps=8, meas_freq=4)
    run_simulation(log, f"c.4 Holstein Langevin {L_lang}x{L_lang} "
                        f"beta={beta} {lang_chains} chains", c4,
                   lang_chains, hmc=False)


# ---------------------------------------------------------------------------
# phase d: four cards
# ---------------------------------------------------------------------------

def _first_update(folder):
    """(accepted, H) per chain of update 1 from hmc_sim_log.out."""
    rows = [line.split() for line in
            (Path(folder) / "hmc_sim_log.out").read_text().splitlines()[1:]]
    first = [r for r in rows if r[0] == "1" and r[2] == "-1"]
    return (np.array([int(r[1]) for r in first]),
            np.array([float(r[3]) for r in first]))


def _globals(folder, b):
    path = Path(folder) / "global_measurements_f" / f"global_measurements_{b:05d}.out"
    return {k: float(v) for k, v in
            (line.split() for line in path.read_text().splitlines())}


def phase_multi(log, workdir, n_devices=4, L_chain=32, L_site=64, beta=4.0,
                chains=16, nv=10):
    """Chain sharding and site sharding over ``n_devices`` cards, each
    against the same computation on one card."""
    import jax
    import jax.numpy as jnp

    from elphdynamics_tpu.dynamics.hmc import HMCConfig, HMCState, make_hmc_step
    from elphdynamics_tpu.dynamics.init_phonons import init_phonons_half_filled
    from elphdynamics_tpu.ops import kpm
    from elphdynamics_tpu.ops.fourier_accel import build_mass
    from elphdynamics_tpu.parallel.chains import (chain_mesh,
                                                  make_sharded_chain_step,
                                                  shard_chain_tree)
    from elphdynamics_tpu.parallel.lattice_shard import (build_shard_plan,
                                                         make_sharded_hmc_step,
                                                         site_mesh)

    if len(jax.devices()) < n_devices:
        raise RuntimeError(f"--gpus {n_devices} needs {n_devices} devices, "
                           f"found {len(jax.devices())}")
    failures = []

    # -- d.1 chains over the mesh: the c.1 configuration, short schedule
    folders = {}
    for nd in (1, n_devices):
        cfg = example_config("holstein_hmc_square.toml", L_chain, beta,
                             Path(workdir) / f"d1-{nd}", burnin_updates=1,
                             simulation_updates=2, meas_freq=1)
        cfg["measurements"]["num_random_vectors"] = nv
        run_simulation(log, f"d.1 Holstein HMC {L_chain}x{L_chain} {chains} "
                            f"chains on {nd} device(s)", cfg, chains, nd)
        folders[nd] = (Path(workdir) / f"d1-{nd}"
                       / f"{cfg['simulation']['foldername']}-1")
    acc1, H1 = _first_update(folders[1])
    accn, Hn = _first_update(folders[n_devices])
    dH = float(np.max(np.abs(Hn - H1) / np.abs(H1)))
    log("d", f"d.1 update 1 per-chain acceptance {acc1.tolist()} vs "
             f"{accn.tolist()}; max rel diff of H {dH:.2e} (tol 1e-4)")
    if not np.array_equal(acc1, accn) or not dH <= 1e-4:
        failures.append("d.1 first update differs between 1 and "
                        f"{n_devices} devices")
    for b in (1, 2):
        g1, gn = _globals(folders[1], b), _globals(folders[n_devices], b)
        worst = max(abs(gn[k] - g1[k]) / max(abs(g1[k]), 1e-3) for k in g1)
        log("d", f"d.1 bin {b} global observables: max rel diff {worst:.2e} "
                 f"(tol 1e-2)")
        if not worst <= 1e-2:
            failures.append(f"d.1 bin {b} observables differ")
    spec, params, ops = holstein(L_chain, beta)
    mass = build_mass(np.asarray(params.omega), spec.dtau, spec.Ltau,
                      [dict(omega_min=0.0, omega_max=10.0, mass=0.1)])
    cfg = HMCConfig(dt=0.01, trajectory_time=0.05, Nb=10, tol=1e-5,
                    maxiter=2000)
    step = make_hmc_step(ops, mass, cfg, kpm.make_symmetric_precond(
        ops, kpm.KPMConfig(max_order=8)))
    mesh = chain_mesh(n_devices)
    keys = jax.random.split(jax.random.PRNGKey(3), chains)
    xs = jnp.stack([init_phonons_half_filled(ops, params, k)[0]
                    for k in keys])
    state = shard_chain_tree(mesh, HMCState(x=xs, v=jnp.zeros_like(xs)))
    state, _, _ = make_sharded_chain_step(mesh, step)(
        params, state, shard_chain_tree(mesh, keys))
    ndev = len(state.x.sharding.device_set)
    log("d", f"d.1 chain-sharded state spans {ndev} devices")
    if ndev != n_devices:
        failures.append(f"d.1 chain-sharded state on {ndev} devices")

    # -- d.2 one chain's lattice over the mesh vs the unsharded step
    spec, params, ops = holstein(L_site, beta)
    mass = build_mass(np.asarray(params.omega), spec.dtau, spec.Ltau,
                      [dict(omega_min=0.0, omega_max=10.0, mass=0.1)])
    kcfg = kpm.KPMConfig(max_order=8)
    plan = build_shard_plan(spec.ckb, n_devices)
    smesh = site_mesh(n_devices)
    ref_step = jax.jit(make_hmc_step(ops, mass, cfg,
                                     kpm.make_symmetric_precond(ops, kcfg)))
    sh_step = make_sharded_hmc_step(spec, plan, smesh, mass, cfg,
                                    kpm_cfg=kcfg)
    x = init_phonons_half_filled(ops, params, jax.random.PRNGKey(4))[0]
    v = 0.1 * jax.random.normal(jax.random.PRNGKey(5), x.shape, x.dtype)
    key = jax.random.PRNGKey(6)
    ref_state, ref_stats, _ = ref_step(params, HMCState(x=x, v=v), key)
    xs, _, stats, _ = sh_step(params, x, v, key)
    ndev = len(xs.sharding.device_set)
    d_ref, d_sh = float(ref_stats.delta_H), float(stats["delta_H"])
    it_ref, it_sh = int(ref_stats.iters), int(stats["iters"])
    # H ≈ 1e5 in f32 and psum reorders its sums: ΔH agrees to
    # 2e-2·|ΔH| + 5e-2
    ok_dh = abs(d_sh - d_ref) <= 2e-2 * abs(d_ref) + 5e-2
    log("d", f"d.2 site-sharded HMC {L_site}x{L_site} over {ndev} devices: "
             f"dH {d_sh:.5f} vs unsharded {d_ref:.5f} (tol 2e-2*|dH|+5e-2); "
             f"CG iters {it_sh} vs {it_ref} (tol 2); accepted "
             f"{bool(stats['accepted'])} vs {bool(ref_stats.accepted)}")
    if ndev != n_devices:
        failures.append(f"d.2 site-sharded field on {ndev} devices")
    if not ok_dh or abs(it_sh - it_ref) > 2:
        failures.append("d.2 sharded step differs from unsharded")
    if failures:
        raise AssertionError("phase d: " + "; ".join(failures))


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gpus", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-card phase d")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devices[0].platform}); "
              "nothing run", file=sys.stderr)
        return 1

    from elphdynamics_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    cards = nvidia_smi()
    for line in cards:
        print(f"nvidia-smi: {line}", flush=True)
    log = make_log(cards[0], cache)
    compile_seconds()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        if args.gpus == 4:
            phase_multi(log, work, n_devices=4)
        else:
            phase_parity(log)
            phase_fold_timing(log)
            phase_end_to_end(log, work)
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
