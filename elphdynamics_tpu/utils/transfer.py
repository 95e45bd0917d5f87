"""Packed device→host transfer of a whole pytree.

``tree_to_host`` concatenates every float/complex leaf into one flat real
buffer on the device and fetches it with a single transfer, instead of one
synchronising copy per leaf (checkpoints and bin snapshots hold ~30 leaves).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


@jax.jit
def _pack_tree_flat(leaves):
    """Concatenate every leaf (complex → interleaved re/im) into ONE flat
    real buffer, so that a single host fetch replaces one per leaf. The
    packing dtype is the widest real dtype present."""
    wide = any(jnp.asarray(a).dtype in (jnp.float64, jnp.complex128)
               for a in leaves)
    dt = jnp.float64 if wide else jnp.float32
    parts = []
    for a in leaves:
        a = jnp.asarray(a)
        if jnp.iscomplexobj(a):
            parts.append(jnp.stack([jnp.real(a), jnp.imag(a)],
                                   axis=-1).reshape(-1).astype(dt))
        else:
            parts.append(a.reshape(-1).astype(dt))
    return jnp.concatenate(parts)


def tree_to_host(tree):
    leaves, treedef = jax.tree.flatten(tree)
    if not leaves or all(isinstance(a, np.ndarray) or np.isscalar(a)
                         for a in leaves):
        return tree
    if not all(jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating)
               or jnp.issubdtype(jnp.asarray(a).dtype, jnp.complexfloating)
               for a in leaves):
        # non-float leaves (ints/bools): per-leaf fallback
        return jax.tree.map(np.asarray, tree)
    # leaves committed to different device sets (e.g. a site-sharded field
    # next to a default-device scalar after a special update gathered one of
    # them) cannot feed one jitted pack — normalize placement first
    device_sets = {tuple(sorted(d.id for d in a.sharding.device_set))
                   for a in leaves if hasattr(a, "sharding")}
    if len(device_sets) > 1:
        dev0 = jax.devices()[0]
        leaves = [jax.device_put(a, dev0) if hasattr(a, "sharding") else a
                  for a in leaves]
    flat = np.asarray(_pack_tree_flat(leaves))
    out = []
    pos = 0
    for a in leaves:
        shape = np.shape(a)
        n = int(np.prod(shape)) if shape else 1
        if np.iscomplexobj(a):
            seg = flat[pos:pos + 2 * n]
            out.append((seg[0::2] + 1j * seg[1::2]).reshape(shape))
            pos += 2 * n
        else:
            dt = np.dtype(jnp.asarray(a).dtype)
            out.append(flat[pos:pos + n].reshape(shape).astype(dt))
            pos += n
    return jax.tree.unflatten(treedef, out)
