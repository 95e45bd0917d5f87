"""Multi-process (multi-host) execution support.

SURVEY §5's "distributed backend" leg: the reference is strictly
single-process by design (ElPhDynamics.jl:90-95 — its whole fleet story is
N independent processes writing to ``datafolder-<id>``); here ONE driver
invocation spans hosts. ``jax.distributed`` connects the processes, the
chain mesh covers the GLOBAL device set, every process executes the
identical SPMD program (same config, same broadcast seed, so all host-side
control flow stays in lockstep), and host IO — datafolder, logs,
checkpoints, bin files, summary — happens on process 0 only.

Contract:

* call :func:`init_multihost` (or ``simulate(..., multihost=True)`` /
  CLI ``--multihost``) BEFORE any other jax use in the process; pass the
  coordinator explicitly or rely on a cluster environment that
  ``jax.distributed.initialize()`` autodetects (a GPU cluster without
  one needs ``coordinator_address``/``num_processes``/``process_id``);
* every process runs the same ``simulate()`` call; ``--devices 0``
  (all global devices) is the normal choice;
* resume needs the datafolder reachable from every process (shared
  filesystem, e.g. NFS);
* ``--site-devices`` (lattice sharding) composes: the site (or combined
  chain × site) mesh spans the global device set, the halo ppermutes ride
  the cross-process links, and the off-hot-loop gathers (special updates,
  measurement convolution stage) target the replicated mesh sharding
  instead of one device (simulation.py ``gather_x``).

Collective discipline: :func:`fetch` and the broadcast helpers are
collectives — every process must reach them the same number of times.
The driver keeps this true by gating only the WRITES on process 0, never
the fetches (simulation.py).
"""

from __future__ import annotations

import jax
import numpy as np

__all__ = ["init_multihost", "is_multihost", "is_primary", "fetch",
           "fetch_tree", "bcast_int", "bcast_str"]


def init_multihost(**kwargs) -> None:
    """Idempotent ``jax.distributed.initialize`` (autodetects the cluster
    from the environment when called without arguments where the cluster
    manager supports it; otherwise pass ``coordinator_address``/
    ``num_processes``/``process_id`` explicitly)."""
    try:
        state = jax.distributed.global_state
        if getattr(state, "client", None) is not None:
            return  # already initialized
    except Exception:
        pass
    jax.distributed.initialize(**kwargs)


def is_multihost() -> bool:
    return jax.process_count() > 1


def is_primary() -> bool:
    return jax.process_index() == 0


def fetch(a) -> np.ndarray:
    """``np.asarray`` that also works on cross-process shardings.

    Fully-addressable and fully-replicated arrays pull directly; arrays
    sharded across processes (e.g. the per-chain stats of a global chain
    mesh) are gathered with ``process_allgather`` — a COLLECTIVE, so every
    process must call this at the same point. The sharding of a given
    array is identical on every process (same program), which makes the
    branch decision symmetric by construction.
    """
    if (isinstance(a, jax.Array) and not a.is_fully_addressable
            and not a.is_fully_replicated):
        from jax.experimental import multihost_utils
        return np.asarray(multihost_utils.process_allgather(a, tiled=True))
    return np.asarray(a)


def fetch_tree(tree):
    """:func:`fetch` over a pytree (symmetric collective, see fetch)."""
    return jax.tree.map(fetch, tree)


def bcast_int(value: int) -> int:
    """Broadcast a host int from process 0 to all (collective)."""
    from jax.experimental import multihost_utils
    return int(multihost_utils.broadcast_one_to_all(
        np.asarray(value, np.int64)))


def bcast_str(value: str, maxlen: int = 1024) -> str:
    """Broadcast a host string from process 0 to all (collective)."""
    from jax.experimental import multihost_utils
    buf = np.zeros(maxlen, np.uint8)
    raw = value.encode()
    if len(raw) > maxlen:
        raise ValueError(f"string longer than {maxlen} bytes")
    buf[:len(raw)] = np.frombuffer(raw, np.uint8)
    out = np.asarray(multihost_utils.broadcast_one_to_all(buf))
    return bytes(out[out != 0]).decode()
