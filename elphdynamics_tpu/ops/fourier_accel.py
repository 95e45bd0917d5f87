"""Fourier acceleration: diagonal-in-(phonon, ω) mass matrices applied by FFT.

Reference: FourierAcceleration.jl. Two conventions coexist:

* ``Q`` (Langevin, FourierAcceleration.jl:213-217):
    Q[k] = (m² + Δτω² + 4/Δτ) / (m² + Δτω² + (2−2cos(2πk/L))/Δτ)
* ``M`` (HMC dynamical mass, FourierAcceleration.jl:260-266), with an
  optional Gaussian k-damped mass m(k) = m₀·exp(−(c·k′/L)²):
    M[k] = Δτ·(m(k)² + ω² + (2−2cos(2πk′/L))/Δτ²) / (m(k)² + ω²)

Both are per-phonon ``[Nph, Lτ]`` tables precomputed on the host; application
is ``ifft(table^power · fft(v))`` along the τ axis, real part taken
(FourierAcceleration.jl:91-143). Rows default to 1 (identity) for phonons not
covered by any ``[[fourier_acceleration]]`` block.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def build_Q(omega: np.ndarray, dtau: float, Ltau: int, blocks) -> np.ndarray:
    """Langevin-convention acceleration table.

    ``blocks`` is an iterable of dicts with keys ``omega_min, omega_max,
    mass`` (ProcessInputFile.jl:524-533 applies each block to phonons whose
    frequency lies in the open interval).
    """
    omega = np.asarray(omega, dtype=np.float64)
    Nph = omega.shape[0]
    k = np.arange(Ltau)
    Q = np.ones((Nph, Ltau))
    for blk in blocks:
        m = float(blk["mass"])
        sel = (omega > blk["omega_min"]) & (omega < blk["omega_max"])
        om2 = (omega[sel] ** 2)[:, None]
        num = m ** 2 + dtau * om2 + 4.0 / dtau
        den = m ** 2 + dtau * om2 + (2.0 - 2.0 * np.cos(2 * np.pi * k / Ltau))[None, :] / dtau
        Q[sel] = num / den
    return Q


def build_mass(omega: np.ndarray, dtau: float, Ltau: int, blocks) -> np.ndarray:
    """HMC-convention dynamical-mass table (``use_mass=true`` path)."""
    omega = np.asarray(omega, dtype=np.float64)
    Nph = omega.shape[0]
    k = np.arange(Ltau)
    kp = np.minimum(k, Ltau - k)
    M = np.ones((Nph, Ltau))
    for blk in blocks:
        m0 = float(blk["mass"])
        c = float(blk.get("c", 0.0))
        sel = (omega > blk["omega_min"]) & (omega < blk["omega_max"])
        om2 = (omega[sel] ** 2)[:, None]
        mk = m0 * np.exp(-((c * kp / Ltau) ** 2))[None, :]
        num = dtau * (mk ** 2 + om2 + (2.0 - 2.0 * np.cos(2 * np.pi * kp / Ltau))[None, :] / dtau ** 2)
        den = mk ** 2 + om2
        M[sel] = num / den
    return M


# ``table^power`` spectra are symmetric in k (both conventions use
# cos(2πk/L)), so the circulant F⁻¹·diag·F is REAL — one [Lτ, Lτ] matmul per
# phonon replaces the FFT pair: one fused matmul instead of a small
# non-power-of-2 FFT pair (the crossover is not measured on H100). Built
# once per (table, power) at trace time — the tables are trace-time
# constants everywhere except inside shard_map (tracer → FFT).
_CIRCULANT_MAX_LTAU = 256
_circ_cache: dict = {}


def _circulant(table_np: np.ndarray, power: float):
    """Per-UNIQUE-spectrum circulants + phonon grouping. Distinct per-phonon
    spectra are rare (one per `[[fourier_acceleration]]` ω-window in
    practice, usually exactly one), so deduplicating rows shrinks the
    would-be [Nph, Lτ, Lτ] table to [U, Lτ, Lτ] — without it the embedded
    constant reaches 100+ MB at 32×32/β=16 (breaking the remote-compile
    payload limit) and every apply re-streams it from HBM as Nph separate
    [Lτ]·[Lτ,Lτ] matvecs instead of U proper matmuls."""
    key = (table_np.tobytes(), table_np.shape, float(power))
    out = _circ_cache.get(key)
    if out is None:
        uniq, inv = np.unique(table_np, axis=0, return_inverse=True)
        spec = uniq.astype(np.float64) ** power            # [U, Lτ]
        col = np.real(np.fft.ifft(spec, axis=-1))          # first columns
        Lt = table_np.shape[-1]
        idx = (np.arange(Lt)[:, None] - np.arange(Lt)[None, :]) % Lt
        C = col[:, idx]                                    # [U, Lτ, Lτ]
        groups = [np.where(inv == u)[0] for u in range(len(uniq))]
        unperm = np.argsort(np.concatenate(groups))
        out = (C, groups, unperm)
        _circ_cache[key] = out
    return out


def accelerate(table, v, power):
    """v' = F⁻¹ · table^power · F · v along the τ (last) axis; real output."""
    Lt = v.shape[-1]
    if not isinstance(table, jax.core.Tracer) and Lt <= _CIRCULANT_MAX_LTAU \
            and v.ndim >= 2:
        C, groups, unperm = _circulant(np.asarray(table), power)
        parts = []
        for u, g in enumerate(groups):
            vg = v if len(groups) == 1 else jnp.take(v, g, axis=-2)
            parts.append(jnp.einsum(
                "tk,...nt->...nk", jnp.asarray(C[u], v.dtype), vg,
                precision=jax.lax.Precision.HIGHEST))
        if len(parts) == 1:
            return parts[0].astype(v.dtype)
        out = jnp.concatenate(parts, axis=-2)
        return jnp.take(out, unperm, axis=-2).astype(v.dtype)
    vw = jnp.fft.fft(v, axis=-1)
    vw = vw * (jnp.asarray(table, vw.real.dtype) ** power)
    return jnp.real(jnp.fft.ifft(vw, axis=-1)).astype(v.dtype)
