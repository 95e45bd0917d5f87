"""Datafolder output: per-bin measurement files, phonon configs, M matrix.

Mirrors the reference's datafolder layout (Measurements.jl:343-540,1175-1274):
one folder per measurement with per-bin text files, `*_key.out` index files,
phonon-config text dumps (HolsteinModels.jl:764-853, SSHModels.jl:838-913)
and the optional dense-M dump (Models.jl:347-367).
"""

from __future__ import annotations

import os

import numpy as np

from elphdynamics_tpu.models.adapter import ModelOps


def init_measurement_folders(datafolder: str, container: dict, snapshots=()):
    """Create the per-measurement folder tree (Measurements.jl:343-540)."""
    os.makedirs(datafolder, exist_ok=True)
    for name in ("global_measurements_f", "onsite_measurements_f",
                 "intersite_measurements_f"):
        os.makedirs(os.path.join(datafolder, name), exist_ok=True)
    for group in ("onsite_corr", "intersite_corr"):
        for kind in container[group]:
            for space in ("position", "momentum"):
                os.makedirs(os.path.join(datafolder, f"{kind}_{space}_f"), exist_ok=True)
    susc_map = {"PairGreens": "PairSusc", "DenDen": "ChargeSusc",
                "SpinSpin": "SpinSusc", "BondPairGreens": "BondPairSusc"}
    for group in ("onsite_corr", "intersite_corr"):
        for kind in container[group]:
            if kind in susc_map and container[group][kind].shape[-1] > 1:
                for space in ("position", "momentum"):
                    os.makedirs(os.path.join(datafolder, f"{susc_map[kind]}_{space}_f"),
                                exist_ok=True)
    for snap in snapshots:
        os.makedirs(os.path.join(datafolder, f"{snap}_snapshots_f"), exist_ok=True)


def _flatten_reference_order(arr: np.ndarray) -> np.ndarray:
    """[p, L1, L2, L3, T] -> flat with T fastest, then L1, L2, L3, p —
    the reference's column-major (T,L1,L2,L3,p) iteration order
    (Measurements.jl:1266-1271)."""
    return np.transpose(arr, (0, 3, 2, 1, 4)).reshape(-1)


def write_bin(datafolder: str, processed: dict, bin_index: int, model_ops: ModelOps):
    """Write one bin of processed measurements (Measurements.jl:681-693)."""
    b = bin_index
    path = os.path.join(datafolder, "global_measurements_f",
                        f"global_measurements_{b:05d}.out")
    with open(path, "w") as f:
        for k, v in processed["global"].items():
            f.write(f"{k} {float(np.real(v)):.8f}\n")

    path = os.path.join(datafolder, "onsite_measurements_f",
                        f"onsite_measurements_{b:05d}.out")
    with open(path, "w") as f:
        f.write("measurement orbit value\n")
        for k, v in processed["onsite"].items():
            for o, val in enumerate(np.asarray(v)):
                f.write(f"{k} {o + 1} {float(np.real(val)):.8f}\n")

    path = os.path.join(datafolder, "intersite_measurements_f",
                        f"intersite_measurements_{b:05d}.out")
    with open(path, "w") as f:
        f.write("measurement bond value\n")
        for k, v in processed["intersite"].items():
            for o, val in enumerate(np.asarray(v)):
                f.write(f"{k} {o + 1} {float(np.real(val)):.8f}\n")

    for group in ("onsite_corr", "intersite_corr", "onsite_susc", "intersite_susc"):
        for kind, spaces in processed.get(group, {}).items():
            for space, arr in spaces.items():
                name = f"{kind}_{space}"
                path = os.path.join(datafolder, f"{name}_f", f"{name}_{b:05d}.out")
                a = np.asarray(arr)
                if a.ndim == 4:  # susceptibility: [p, L1, L2, L3]
                    flat = np.transpose(a, (0, 3, 2, 1)).reshape(-1)
                else:
                    flat = _flatten_reference_order(a)
                with open(path, "w") as f:
                    f.write(f"index {name}_real {name}_imag\n")
                    for i, val in enumerate(flat):
                        f.write(f"{i + 1} {val.real:.8f} {val.imag:.8f}\n")


def write_key_files(datafolder: str, ops: ModelOps, mspec, container: dict):
    """``*_key.out`` index files mapping every flattened row of the per-bin
    correlation/susceptibility files to its (pair, r/k displacement[, τ])
    labels (Measurements.jl:385-540). Row order matches
    :func:`_flatten_reference_order` (τ fastest, then r1, r2, r3, pair)."""
    from elphdynamics_tpu.measure.measurements import (
        _corr_pairs, _normalize_kinds)

    lat = ops.spec.lattice
    no = lat.unit_cell.norbits
    ndefs = len(ops.spec.bond_defs)
    susc_map = {"PairGreens": "PairSusc", "DenDen": "ChargeSusc",
                "SpinSpin": "SpinSusc", "BondPairGreens": "BondPairSusc"}

    def rows(f, pairs, dims, lbl, with_tau, T=1):
        L1, L2, L3 = dims
        tau_col = " tau" if with_tau else ""
        i = 1
        for p in range(pairs.shape[0]):
            o1, o2 = int(pairs[p, 0]) + 1, int(pairs[p, 1]) + 1
            for l3 in range(L3):
                for l2 in range(L2):
                    for l1 in range(L1):
                        for tau in range(T):
                            tcol = f" {tau}" if with_tau else ""
                            f.write(f"{i} {o1} {o2} {l3} {l2} {l1}{tcol}\n")
                            i += 1

    for group, nbase, label, entries, default_pairs in (
        ("onsite_corr", no, "orbit", mspec.onsite_corr, mspec.onsite_pairs),
        ("intersite_corr", ndefs, "bond", mspec.intersite_corr,
         mspec.intersite_pairs),
    ):
        for kind, (td, kp) in _normalize_kinds(entries).items():
            pairs = _corr_pairs(nbase, kp if kp is not None else default_pairs)
            # only the shape is needed — avoid a host transfer
            _, L1, L2, L3, T = container[group][kind].shape
            for space, lbl in (("position", "r"), ("momentum", "k")):
                folder = os.path.join(datafolder, f"{kind}_{space}_f")
                if not os.path.isdir(folder):
                    continue
                with open(os.path.join(folder, f"{kind}_{space}_key.out"), "w") as f:
                    f.write(f"index {label}1 {label}2 {lbl}3 {lbl}2 {lbl}1 tau\n")
                    rows(f, pairs, (L1, L2, L3), lbl, True, T)
            if kind in susc_map and T > 1:
                sname = susc_map[kind]
                for space, lbl in (("position", "r"), ("momentum", "k")):
                    folder = os.path.join(datafolder, f"{sname}_{space}_f")
                    if not os.path.isdir(folder):
                        continue
                    with open(os.path.join(folder,
                                           f"{sname}_{space}_key.out"), "w") as f:
                        f.write(f"index {label}1 {label}2 {lbl}3 {lbl}2 {lbl}1\n")
                        rows(f, pairs, (L1, L2, L3), lbl, False)


def write_snapshot(datafolder: str, name: str, values: np.ndarray, nmeas: int):
    """Per-measurement snapshot dump (Measurements.jl:1349-1460)."""
    path = os.path.join(datafolder, f"{name}_snapshots_f",
                        f"{name}_snapshot_{nmeas:06d}.out")
    with open(path, "w") as f:
        f.write(f"{name}\n")
        for v in np.asarray(values).reshape(-1):
            f.write(f"{float(v):.8f}\n")


# ---------------------------------------------------------------------------
# phonon-field text IO
# ---------------------------------------------------------------------------

def write_phonons(ops: ModelOps, x, filename: str):
    """Holstein format: 'L3 L2 L1 orbit tau x' (HolsteinModels.jl:764-808);
    SSH format: 'type loc tau x' (SSHModels.jl:838-871)."""
    x = np.asarray(x)
    if ops.is_holstein:
        lat = ops.spec.lattice
        no = lat.unit_cell.norbits
        with open(filename, "w") as f:
            f.write("L3 L2 L1 orbit tau x\n")
            for l3 in range(lat.L3):
                for l2 in range(lat.L2):
                    for l1 in range(lat.L1):
                        for orbit in range(no):
                            site = lat.loc_to_site(orbit, l1, l2, l3)
                            for tau in range(ops.Ltau):
                                f.write(f"{l3} {l2} {l1} {orbit + 1} {tau + 1} "
                                        f"{x[site, tau]:.6f}\n")
    else:
        nph_types = max(len([d for d in ops.spec.bond_defs if d[3]]), 1)
        per_type = ops.Nph // nph_types if ops.Nph else 0
        with open(filename, "w") as f:
            f.write("type loc tau x\n")
            for ptype in range(nph_types):
                for i in range(per_type):
                    ph = ptype * per_type + i
                    for tau in range(ops.Ltau):
                        f.write(f"{ptype + 1} {i + 1} {tau + 1} {x[ph, tau]:.6f}\n")


def read_phonons(ops: ModelOps, filename: str) -> np.ndarray:
    """Inverse of :func:`write_phonons` (HolsteinModels.jl:813-853,
    SSHModels.jl:876-913)."""
    x = np.zeros((ops.Nph, ops.Ltau))
    with open(filename) as f:
        header = f.readline()
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if ops.is_holstein:
                l3, l2, l1, orbit, tau = (int(p) for p in parts[:5])
                site = ops.spec.lattice.loc_to_site(orbit - 1, l1, l2, l3)
                x[site, tau - 1] = float(parts[5])
            else:
                ptype, loc, tau = (int(p) for p in parts[:3])
                nph_types = max(len([d for d in ops.spec.bond_defs if d[3]]), 1)
                per_type = ops.Nph // nph_types
                x[(ptype - 1) * per_type + (loc - 1), tau - 1] = float(parts[3])
    return x


def write_K_matrix(ops: ModelOps, params, x, filename: str, tau: int = 0):
    """Write the SSH hopping matrix K[τ] incl. on-site energies
    (SSHModels.jl:916-943)."""
    from elphdynamics_tpu.models import ssh as Sm
    import numpy as np

    spec = ops.spec
    cplx = getattr(params, "t_phase", None) is not None
    with open(filename, "w") as f:
        f.write("col row real imag\n" if cplx else "col row val\n")
        mu = np.asarray(params.mu)
        for i in range(spec.Nsites):
            f.write(f"{i + 1} {i + 1} {-mu[i]} 0.0\n" if cplx
                    else f"{i + 1} {i + 1} {-mu[i]}\n")
        tp = np.asarray(Sm.hopping_t_prime(spec, params, x))
        if cplx:
            tp = np.asarray(params.t_phase)[:, None] * tp    # twisted SSH
        for b in range(spec.Nbonds):
            n = spec.bond_to_ckb[b]
            s1, s2 = spec.ckb.neighbor_table[:, n]
            val = -tp[b, tau]
            if np.iscomplexobj(tp):
                # K is Hermitian: conj on the reversed entry
                f.write(f"{s1 + 1} {s2 + 1} {val.real} {val.imag}\n")
                f.write(f"{s2 + 1} {s1 + 1} {val.real} {-val.imag}\n")
            else:
                f.write(f"{s1 + 1} {s2 + 1} {val}\n")
                f.write(f"{s2 + 1} {s1 + 1} {val}\n")


def write_M_matrix(ops: ModelOps, params, x, filename: str, threshold=1e-10,
                   chunk: int = 512):
    """Densify M column-by-column and write nonzeros (Models.jl:300-367).

    Columns are produced in fixed-size batches of ``chunk`` unit vectors so
    peak memory stays O(chunk·N·Lτ) instead of O((N·Lτ)²) — a 32×32 β=16
    dump fits on one chip."""
    import jax
    import jax.numpy as jnp

    derived = ops.derived(params, x)
    N, L = ops.Nsites, ops.Ltau
    NL = N * L
    chunk = min(chunk, NL)

    @jax.jit
    def mul_cols(flat_idx):
        eye = jnp.zeros((chunk, NL), dtype=np.asarray(x).dtype)
        eye = eye.at[jnp.arange(chunk), flat_idx].set(1.0)
        out = ops.mulM(params, derived, eye.reshape(chunk, N, L))
        return out.reshape(chunk, NL)

    with open(filename, "w") as f:
        f.write("col row real imag\n")
        for start in range(0, NL, chunk):
            # pad the final batch by repeating the last column; extras skipped
            idx = np.minimum(np.arange(start, start + chunk), NL - 1)
            cols = np.asarray(mul_cols(jnp.asarray(idx)))
            for j in range(min(chunk, NL - start)):
                colv = cols[j]
                nz = np.nonzero(np.abs(colv) > threshold)[0]
                for row in nz:
                    v = complex(colv[row])  # real entries get imag = 0.0
                    f.write(f"{start + j + 1} {row + 1} "
                            f"{v.real:.10f} {v.imag:.10f}\n")


def _toml_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, str):
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_toml_value(x) for x in v) + "]"
    raise TypeError(f"cannot TOML-serialize {type(v)}")


def dump_toml(cfg: dict) -> str:
    """Minimal TOML rendering of a parsed config dict, for persisting the
    input file verbatim-equivalent into the datafolder when the caller passed
    a dict instead of a path (the reference stores the original TOML,
    ProcessInputFile.jl:50). Round-trips through ``tomllib`` for every config
    shape the schema uses (scalars, arrays, tables, arrays-of-tables)."""
    lines: list[str] = []

    def emit_table(prefix: str, d: dict):
        scalars = {k: v for k, v in d.items()
                   if not isinstance(v, dict)
                   and not (isinstance(v, list) and v
                            and isinstance(v[0], dict))}
        if prefix and (scalars or not d):
            lines.append(f"[{prefix}]")
        for k, v in scalars.items():
            lines.append(f"{k} = {_toml_value(v)}")
        if scalars:
            lines.append("")
        for k, v in d.items():
            if isinstance(v, dict):
                emit_table(f"{prefix}.{k}" if prefix else k, v)
            elif isinstance(v, list) and v and isinstance(v[0], dict):
                name = f"{prefix}.{k}" if prefix else k
                for item in v:
                    lines.append(f"[[{name}]]")
                    for kk, vv in item.items():
                        lines.append(f"{kk} = {_toml_value(vv)}")
                    lines.append("")

    emit_table("", cfg)
    return "\n".join(lines) + "\n"
