"""Multi-chip parallelism: independent Markov chains over a device mesh.

The reference has NO distributed execution — parallelism across chains is N
separate OS processes writing to different datafolders
(ElPhDynamics.jl:90-95,166-186). The replacement here (SURVEY §5):

* a 1-D ``jax.sharding.Mesh`` with axis ``"chain"``;
* sampler state carries a leading chain axis sharded over that axis
  (pure data parallelism: zero communication in the hot loop — each chain's
  CG/FFT/checkerboard work is chip-local);
* model parameters are replicated;
* metric reductions (acceptance, iteration counts, measurement averages)
  are the only cross-chip collectives, inserted automatically by XLA when
  the jitted step reduces over the chain axis.

Chains-per-chip > 1 is encouraged: the per-chain working set (a few
[N, Lτ] fields) is far below device-memory limits, and batching chains turns the
bandwidth-bound checkerboard/elementwise work into larger fused kernels.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def chain_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D mesh over all (or the first n) devices with axis ``chain``."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise RuntimeError(
                f"chain_mesh needs {n_devices} devices, found {len(devices)}."
                " For virtual CPU devices set XLA_FLAGS=--xla_force_host_"
                "platform_device_count and JAX_PLATFORMS=cpu BEFORE the "
                "first jax use — the platform cannot be switched once a "
                "backend is initialised.")
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), axis_names=("chain",))


def shard_chain_tree(mesh: Mesh, tree):
    """Place a pytree with leading chain axes onto the mesh."""
    sharding = NamedSharding(mesh, P("chain"))
    return jax.tree.map(lambda a: jax.device_put(a, sharding), tree)


def replicate(mesh: Mesh, tree):
    sharding = NamedSharding(mesh, P())
    return jax.tree.map(lambda a: jax.device_put(a, sharding), tree)


def init_chain_states(ops, params, key, n_chains: int, init_fn):
    """Stack ``n_chains`` independent initial states ``init_fn(key) -> x``."""
    keys = jax.random.split(key, n_chains)
    xs = [init_fn(k) for k in keys]
    return jnp.stack(xs), keys


def make_sharded_chain_step(mesh: Mesh, step: Callable):
    """Jit a per-chain step ``(params, state, key) -> (state, stats, key)``
    as a chain-sharded SPMD program.

    The state/keys carry a leading chain axis sharded over ``mesh``; params
    are replicated. Built with ``shard_map`` so each device runs the vmapped
    step over ONLY its local chains: the solver ``while_loop`` terminates on
    the local batch's max iteration count and no collective is inserted
    anywhere in the trajectory — chips neither sync per CG iteration nor pay
    other chips' slow solves (the per-chain divergence trade of SURVEY §7).
    """
    vstep = jax.vmap(step, in_axes=(None, 0, 0))

    def local(params, states, keys):
        return vstep(params, states, keys)

    sharded = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(), P("chain"), P("chain")),
        out_specs=(P("chain"), P("chain"), P("chain")),
        check_vma=False,
    )
    return jax.jit(sharded)
