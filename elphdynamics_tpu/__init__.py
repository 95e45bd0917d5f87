"""elphdynamics_tpu — a JAX/XLA electron-phonon QMC framework for accelerators.

A from-scratch rebuild of the capabilities of the reference package
``cohensbw/ElPhDynamics`` (Julia), re-architected for accelerators:

* space-time fields live as ``[N_site, L_tau]`` arrays (imaginary time on the
  fast, contiguous axis) with an optional leading Markov-chain
  batch axis mapped over a ``jax.sharding.Mesh``;
* the checkerboard decomposition of the hopping matrix is host-preprocessed
  into per-group partner *permutations* so that each group application is one
  static gather plus a fused multiply-add over the whole space-time block;
* iterative solvers (CG/BiCGStab/GMRES) are ``lax.while_loop`` programs with
  batched right-hand sides;
* the KPM (Chebyshev) preconditioner applies all Matsubara frequencies as one
  batched recurrence;
* Fourier-accelerated Langevin and HMC samplers are pure jitted functions with
  explicit ``jax.random`` key threading.

Reference layer map: see SURVEY.md in the repository root. Citations in
docstrings of the form ``file.jl:line`` point into the reference sources.
"""

__version__ = "0.1.0"

from elphdynamics_tpu.utils.dtypes import default_real_dtype, set_x64

__all__ = [
    "default_real_dtype",
    "set_x64",
    "__version__",
]
