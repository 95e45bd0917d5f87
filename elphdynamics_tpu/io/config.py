"""TOML configuration ingestion — schema-compatible with the reference.

Reference: ProcessInputFile.jl + SimulationParams.jl. The same input files
(`examples/*.toml` of the reference) drive this framework: [lattice],
[holstein]⊻[ssh], [[fourier_acceleration]], [hmc]⊻[langevin] (+ burnin
overrides, reflection/swap updates), [simulation], [solver]
(+ [solver.preconditioner]), [tune_density], [measurements].

Orbit indices are 1-based in the files (Julia convention) and converted to
0-based here.
"""

from __future__ import annotations

import tomllib
from dataclasses import dataclass
from typing import Any

import numpy as np

from elphdynamics_tpu.dynamics.force import SolverConfig
from elphdynamics_tpu.dynamics.hmc import HMCConfig
from elphdynamics_tpu.dynamics.special_updates import SpecialUpdateConfig
from elphdynamics_tpu.lattice import Lattice, UnitCell
from elphdynamics_tpu.measure.measurements import MeasurementSpec
from elphdynamics_tpu.models.adapter import make_model_ops
from elphdynamics_tpu.models.holstein import build_holstein
from elphdynamics_tpu.models.ssh import build_ssh
from elphdynamics_tpu.ops.fourier_accel import build_Q, build_mass
from elphdynamics_tpu.ops.kpm import KPMConfig


@dataclass
class SimulationParams:
    """Immutable run parameters (SimulationParams.jl:5-63)."""

    burnin: int
    nsteps: int
    meas_freq: int
    num_bins: int
    bin_size: int
    chckpnt_freq_s: float
    filepath: str
    foldername: str
    datafolder: str
    write_M_matrix: bool = False
    random_seed: int = 0

    def __post_init__(self):
        assert self.nsteps % self.meas_freq == 0
        n_meas = self.nsteps // self.meas_freq
        assert n_meas % self.num_bins == 0, (n_meas, self.num_bins)


@dataclass
class SimulationSetup:
    """Everything needed to run: the output of config processing
    (ProcessInputFile.jl:34-120)."""

    ops: Any
    params: Any
    sim_params: SimulationParams
    model_type: str           # "holstein" | "ssh"
    dynamics_type: str        # "hmc" | "langevin"
    hmc_cfg: HMCConfig | None
    hmc_burnin_cfg: HMCConfig | None
    langevin_dt: float | None
    langevin_method: str | None
    fa_Q: np.ndarray
    fa_mass: np.ndarray
    solver_cfg: SolverConfig
    kpm_cfg: KPMConfig | None
    mspec: MeasurementSpec
    reflect_cfg: SpecialUpdateConfig
    swap_cfg: SpecialUpdateConfig
    tune_density: dict | None
    snapshots: tuple
    read_phonon_config: str | None
    config: dict
    # [tempering] parallel-tempering ladder (beyond reference scope,
    # dynamics/tempering.py); None = off
    tempering_cfg: Any = None
    # [solver.nearnull] two-level near-null preconditioner (ops/nearnull.py,
    # beyond reference scope); None = KPM only
    nearnull_cfg: Any = None


def load_toml(path: str) -> dict:
    with open(path, "rb") as f:
        return tomllib.load(f)


def _build_lattice(cfg: dict) -> Lattice:
    lat = cfg["lattice"]
    uc = UnitCell.create(lat["ndim"], lat["norbits"],
                         lat["lattice_vectors"], lat["basis_vectors"])
    return Lattice.create(uc, lat["L"])


def _per_orbit(blocks):
    out = {}
    for d in blocks:
        std = d.get("stddev", 0.0)
        for orbit in d["orbit"]:
            out[orbit - 1] = (d["val"], std)
    return out


def _build_model(cfg: dict, rng: np.random.Generator, dtype):
    lattice = _build_lattice(cfg)
    if "holstein" in cfg:
        h = cfg["holstein"]
        # [[holstein.t]] imag: per-bond complex hopping (Peierls phase) —
        # TOML has no complex literal, so t = val + i·imag (an addition;
        # the reference's type surface admits complex t, Models.jl:20, but
        # its TOML cannot express it)
        t_assign = [
            (d["val"] + (1j * d["imag"] if d.get("imag", 0.0) else 0.0),
             d.get("stddev", 0.0), d["orbit"][0] - 1, d["orbit"][1] - 1,
             tuple(list(d["dL"]) + [0] * (3 - len(d["dL"]))))
            for d in h.get("t", [])
        ]
        # [holstein] twist = [θ1, θ2(, θ3)] — twisted boundary conditions in
        # radians: a uniform Peierls phase θ_d/L_d per bond crossing in
        # lattice direction d. Switches the whole stack to the complex TRS
        # ensemble (spin ↓ sees the conjugate phases; |det M|² weight).
        twist = h.get("twist", None)
        per_orbit = {
            name: _per_orbit(h.get(key, []))
            for name, key in (("omega", "omega"), ("mu", "mu"), ("lambda", "lambda"),
                              ("lambda2", "lambda2"), ("omega4", "omega4"))
        }
        # [[holstein.omega_ij]] dispersive phonon coupling: the reference
        # implements assign_ωᵢⱼ! (HolsteinModels.jl:449-464) but never
        # reads it from the TOML — wired for real here (beyond reference).
        # Fields: val, stddev, sign (±1), orbit = [o1, o2], dL.
        wij_assign = [
            (d["val"], d.get("stddev", 0.0), int(d.get("sign", 1)),
             d["orbit"][0] - 1, d["orbit"][1] - 1,
             tuple(list(d["dL"]) + [0] * (3 - len(d["dL"]))))
            for d in h.get("omega_ij", [])
        ]
        spec, params = build_holstein(
            lattice, h["beta"], h["dtau"],
            t_assignments=t_assign,
            wij_assignments=wij_assign,
            per_orbit={k: v for k, v in per_orbit.items() if v},
            twist=twist,
            rng=rng, dtype=dtype,
        )
        return "holstein", spec, params
    s = cfg["ssh"]
    hoppings = []
    for d in s.get("hopping", []):
        dL = list(d["dL"]) + [0] * (3 - len(d["dL"]))
        hoppings.append(dict(
            t=d.get("t_avg", 0.0), t_std=d.get("t_std", 0.0),
            alpha=d.get("alpha_avg", 0.0), alpha_std=d.get("alpha_std", 0.0),
            alpha2=d.get("alpha2_avg", 0.0), alpha2_std=d.get("alpha2_std", 0.0),
            omega=d.get("omega_avg", 0.0), omega_std=d.get("omega_std", 0.0),
            omega4=d.get("omega4_avg", 0.0), omega4_std=d.get("omega4_std", 0.0),
            o1=d["orbits"][0] - 1, o2=d["orbits"][1] - 1, dL=tuple(dL),
            name=d.get("name", ""),
        ))
    mu_assign = []
    for d in s.get("mu", []):
        std = d.get("stddev", 0.0)
        for orbit in d["orbit"]:
            mu_assign.append((d["val"], std, orbit - 1))
    # [ssh] twist = [θ1, θ2(, θ3)] — twisted boundary conditions, exactly as
    # [holstein] twist: uniform Peierls phases multiply the whole
    # phonon-modulated bond amplitude (models/ssh.py)
    spec, params = build_ssh(lattice, s["beta"], s["dtau"],
                             hoppings=hoppings, mu_assignments=mu_assign,
                             twist=s.get("twist", None),
                             rng=rng, dtype=dtype)
    return "ssh", spec, params


def _measurement_spec(cfg: dict, model_type: str) -> tuple[MeasurementSpec, tuple]:
    m = cfg.get("measurements", {})
    nv = m.get("num_random_vectors", 10)

    def corr_list(kinds):
        out = []
        for kind in kinds:
            info = m.get(kind)
            if info and info.get("measure", False):
                pairs = info.get("pairs")
                if pairs is not None:
                    pairs = tuple((int(a) - 1, int(b) - 1) for a, b in pairs)
                out.append((kind, bool(info.get("time_dependent", False)), pairs))
        return tuple(out)

    # PhononGreens is on-site for Holstein (site phonons) but inter-site for
    # SSH (bond phonons) — Measurements.jl:881-882 vs :901-902
    onsite_kinds = ["Greens", "DenDen", "SpinSpin", "PairGreens"]
    inter_kinds = ["BondBond", "CurrentCurrent", "BondPairGreens"]
    (onsite_kinds if model_type == "holstein" else inter_kinds).append("PhononGreens")
    onsite = corr_list(tuple(onsite_kinds))
    inter = corr_list(tuple(inter_kinds))
    snaps = tuple(k for k, v in m.get("Snapshots", {}).items() if v)
    return MeasurementSpec(nv=nv, onsite_corr=onsite, intersite_corr=inter,
                           snapshots=snaps), snaps


def build_setup(cfg: dict, datafolder: str, dtype=None) -> SimulationSetup:
    """Construct all simulation objects from a parsed config dict
    (the role of ``process_input_file``, ProcessInputFile.jl:34-120)."""
    import jax.numpy as jnp

    if dtype is None:
        import jax
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32

    assert ("hmc" in cfg) != ("langevin" in cfg), "need exactly one of [hmc]/[langevin]"
    assert ("holstein" in cfg) != ("ssh" in cfg), "need exactly one of [holstein]/[ssh]"

    sim = cfg["simulation"]
    seed = sim.get("random_seed", np.random.SeedSequence().entropy % (2 ** 31))
    rng = np.random.default_rng(seed)

    model_type, spec, params = _build_model(cfg, rng, dtype)
    ops = make_model_ops(spec)

    # run parameters (ProcessInputFile.jl:541-567)
    if "hmc" in cfg:
        meas_freq = cfg["hmc"]["meas_freq"]
        nsteps = cfg["hmc"]["simulation_updates"]
        burnin = cfg["hmc"]["burnin_updates"]
    else:
        meas_freq = cfg["langevin"]["meas_freq"]
        nsteps = cfg["langevin"]["simulation_timesteps"]
        burnin = cfg["langevin"]["burnin_timesteps"]
    num_bins = sim["num_bins"]
    bin_size = (nsteps // meas_freq) // num_bins
    sim_params = SimulationParams(
        burnin=burnin, nsteps=nsteps, meas_freq=meas_freq, num_bins=num_bins,
        bin_size=bin_size,
        chckpnt_freq_s=60.0 * sim.get("checkpoint_freq", 10),
        filepath=sim.get("filepath", "."),
        foldername=sim.get("foldername", "run"),
        datafolder=datafolder,
        write_M_matrix=sim.get("write_M_matrix", False),
        random_seed=int(seed),
    )

    # solver (+ preconditioner)
    sol = cfg["solver"]
    solver_cfg = SolverConfig(tol=sol.get("tol", 1e-5),
                              maxiter=sol.get("maxiter", 1000),
                              kind=sol.get("type", "CG").lower(),
                              restart=sol.get("restart", 20),
                              # addition: block CG over the nᵥ estimator
                              # systems (solvers.block_cg)
                              block=bool(sol.get("block", False)),
                              # addition: split in-loop operator
                              # precision ("high" = 3-pass bf16 in the CG loop,
                              # HIGHEST verification/endpoints — see
                              # dynamics/solve._cg_operators; "highest"
                              # restores the reference-faithful operator)
                              loop_precision=sol.get("loop_precision", "high"))
    kpm_cfg = None
    if "preconditioner" in sol:
        p = sol["preconditioner"]
        # max_order: static cap on the per-ω Chebyshev orders (an addition —
        # the reference's orders are fully dynamic; jit needs a static bound).
        # Small caps trade preconditioner quality for per-apply cost; see
        # BASELINE.md for the measured sweep.
        kpm_cfg = KPMConfig(n_power=p.get("n", 20), buf=p.get("buf", 0.05),
                            c1=p.get("c1", 1.0), c2=p.get("c2", 1.0),
                            max_order=p.get("max_order", 64),
                            # additions (see ops/kpm.py): DFT-matmul
                            # τ↔ω transforms (auto by Lτ) and the flattened
                            # Chebyshev stack experiment
                            dft_matmul=p.get("dft_matmul", None),
                            stacked=p.get("stacked", False),
                            # exact-low-frequency hybrid: dense-LU the k
                            # lowest Matsubara blocks, Chebyshev the rest.
                            # Helps when the per-ω polynomial degree is the
                            # binding constraint (mild/weakly-τ-varying
                            # fields at long Lτ); measured NOT to help on
                            # equilibrated strong-coupling deep-β ensembles,
                            # where the τ-averaged block-diagonal
                            # approximation itself is what breaks down —
                            # see BASELINE.md. Off by default.
                            exact_lowfreq=int(p.get("exact_lowfreq", 0)))
    # [solver.deflation]: incremental slow-mode deflation (ops/deflation.py,
    # beyond reference parity; experimental, off by default). Measured on
    # chip to HURT at deep β — the slow subspace rotates with the field
    # faster than the once-per-update refresh (BASELINE.md §deep-β) — but
    # the knob, like exact_lowfreq, is kept wired so the study is
    # reproducible from a stock TOML.
    dfl = sol.get("deflation", {})
    deflate_k = int(dfl.get("k", 0))
    deflate_filter = int(dfl.get("filter_degree", 8))
    deflate_power = int(dfl.get("power_iters", 4))
    deflate_cutoff = float(dfl.get("cutoff", 1 / 16))

    # [solver.nearnull]: adaptive two-level near-null preconditioner
    # (ops/nearnull.py, beyond reference scope — the deep-β conditioning
    # lever; BASELINE.md §deep-β route 7 for the measured A/B)
    nearnull_cfg = None
    if "nearnull" in sol:
        from elphdynamics_tpu.ops.nearnull import NearNullConfig
        nn = sol["nearnull"]
        nearnull_cfg = NearNullConfig(
            k=int(nn.get("k", 16)), c=int(nn.get("c", 4)),
            setup_iters=int(nn.get("setup_iters", 10)),
            setup_passes=int(nn.get("setup_passes", 2)),
            refresh_iters=int(nn.get("refresh_iters", 3)),
            refresh_mode=str(nn.get("refresh_mode", "smooth")),
            reg=float(nn.get("reg", 1e-6)))
        if solver_cfg.kind != "cg":
            raise ValueError("[solver.nearnull] requires the CG solver "
                             "(it provides the symmetric preconditioner)")

    # Fourier acceleration tables
    fa_blocks = cfg.get("fourier_acceleration", [])
    omega = np.asarray(params.omega) if spec.Nph > 0 else np.zeros(0)
    fa_Q = build_Q(omega, spec.dtau, spec.Ltau, fa_blocks)
    fa_mass = build_mass(omega, spec.dtau, spec.Ltau, fa_blocks)

    # dynamics (ProcessInputFile.jl:629-704)
    hmc_cfg = hmc_burnin_cfg = None
    langevin_dt = langevin_method = None
    reflect_cfg = SpecialUpdateConfig(freq=0, n_moves=0)
    swap_cfg = SpecialUpdateConfig(freq=0, n_moves=0)
    if "hmc" in cfg:
        h = cfg["hmc"]
        dynamics_type = "hmc"
        hmc_cfg = HMCConfig(dt=h["dt"], trajectory_time=h["trajectory_time"],
                            alpha=h.get("momentum_conservation_fraction", 0.0),
                            Nb=h.get("num_multitimesteps", 1),
                            tol=solver_cfg.tol, maxiter=solver_cfg.maxiter,
                            solver_kind=solver_cfg.kind, restart=solver_cfg.restart,
                            block=solver_cfg.block,
                            loop_precision=solver_cfg.loop_precision,
                            integrator=str(h.get("integrator", "leapfrog")).lower(),
                            log_verbose=bool(h.get("verbose", False)),
                            construct_guess=bool(h.get("construct_guess", False)),
                            guess_order=int(h.get("guess_order", 3)),
                            deflate_k=deflate_k, deflate_filter=deflate_filter,
                            deflate_power=deflate_power,
                            deflate_cutoff=deflate_cutoff,
                            tune_dt=bool(h.get("tune_dt", False)),
                            target_acceptance=float(
                                h.get("target_acceptance", 0.8)))
        b = h.get("burnin", {})
        hmc_burnin_cfg = HMCConfig(
            dt=b.get("dt", h["dt"]),
            trajectory_time=b.get("trajectory_time", h["trajectory_time"]),
            alpha=b.get("momentum_conservation_fraction",
                        h.get("momentum_conservation_fraction", 0.0)),
            Nb=b.get("num_multitimesteps", h.get("num_multitimesteps", 1)),
            tol=solver_cfg.tol, maxiter=solver_cfg.maxiter,
            solver_kind=solver_cfg.kind, restart=solver_cfg.restart,
            block=solver_cfg.block,
            loop_precision=solver_cfg.loop_precision,
            integrator=str(b.get("integrator", h.get("integrator", "leapfrog"))).lower(),
            log_verbose=bool(h.get("verbose", False)),
            construct_guess=bool(h.get("construct_guess", False)),
            guess_order=int(h.get("guess_order", 3)),
            deflate_k=deflate_k, deflate_filter=deflate_filter,
            deflate_power=deflate_power, deflate_cutoff=deflate_cutoff,
            tune_dt=bool(b.get("tune_dt", h.get("tune_dt", False))),
            target_acceptance=float(b.get("target_acceptance",
                                          h.get("target_acceptance", 0.8))))
        if "reflection_update" in h and model_type == "holstein":
            reflect_cfg = SpecialUpdateConfig(
                freq=h["reflection_update"]["freq"],
                n_moves=h["reflection_update"]["nsites"],
                tol=solver_cfg.tol, maxiter=solver_cfg.maxiter)
        if "swap_update" in h:
            swap_cfg = SpecialUpdateConfig(
                freq=h["swap_update"]["freq"],
                n_moves=h["swap_update"]["nbonds"],
                tol=solver_cfg.tol, maxiter=solver_cfg.maxiter)
    else:
        dynamics_type = "langevin"
        langevin_dt = cfg["langevin"]["dt"]
        langevin_method = {1: "euler", 2: "rk", 3: "heun"}[
            cfg["langevin"].get("update_method", 1)]

    mspec, snapshots = _measurement_spec(cfg, model_type)

    tune = cfg.get("tune_density")

    model_cfg = cfg.get("holstein", cfg.get("ssh", {}))
    read_phonons = (model_cfg.get("phonon_config_file")
                    if model_cfg.get("read_phonon_config", False) else None)

    tempering_cfg = None
    if "tempering" in cfg:
        from elphdynamics_tpu.dynamics.tempering import TemperingConfig
        t = cfg["tempering"]
        tempering_cfg = TemperingConfig(
            ladder=tuple(float(v) for v in t["ladder"]),
            freq=int(t.get("freq", 5)),
            tol=solver_cfg.tol, maxiter=solver_cfg.maxiter)

    return SimulationSetup(
        ops=ops, params=params, sim_params=sim_params, model_type=model_type,
        dynamics_type=dynamics_type, hmc_cfg=hmc_cfg, hmc_burnin_cfg=hmc_burnin_cfg,
        langevin_dt=langevin_dt, langevin_method=langevin_method,
        fa_Q=fa_Q, fa_mass=fa_mass, solver_cfg=solver_cfg, kpm_cfg=kpm_cfg,
        nearnull_cfg=nearnull_cfg,
        mspec=mspec, reflect_cfg=reflect_cfg, swap_cfg=swap_cfg,
        tune_density=tune, snapshots=snapshots, read_phonon_config=read_phonons,
        config=cfg, tempering_cfg=tempering_cfg,
    )
