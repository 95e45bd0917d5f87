"""Checkpoint / resume.

Reference behavior (RunSimulation.jl:54-59,120-126,303-306;
ProcessInputFile.jl:122-177): a checkpoint is serialized on a wall-clock
cadence and at every bin boundary; resume is triggered purely by the
datafolder (and checkpoint file) existing, restoring the phonon field, RNG
state, μ-tuner state, measurement accumulators, loop counters, and timing
stats so a killed run continues exactly.

Here: a flattened-pytree ``.npz`` (fields, key, container) plus a
JSON sidecar (counters, stats, μ-tuner history).
"""

from __future__ import annotations

import json
import os

import numpy as np


def _flatten(tree, prefix=""):

    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat):
    tree: dict = {}
    for k, v in flat.items():
        parts = k.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_checkpoint(datafolder: str, *, x, v, key, params, container,
                    counters: dict, sim_stats: dict, mu_tuner_state: dict,
                    extras: dict | None = None):
    # fetch the whole float/complex state in ONE packed host transfer
    # instead of one synchronising copy per leaf (~30 leaves per save)
    from elphdynamics_tpu.utils.transfer import tree_to_host

    batched = tree_to_host({
        "x": x, "v": v,
        "params": {k: val for k, val in params._asdict().items()
                   if val is not None},
        "container": container,
    })
    arrays = {
        "x": np.asarray(batched["x"]),
        "v": np.asarray(batched["v"]),
        "key": np.asarray(key),
    }
    arrays.update({f"params/{k}": np.asarray(v)
                   for k, v in batched["params"].items()})
    arrays.update({f"container/{k}": v
                   for k, v in _flatten(batched["container"]).items()})
    tmp = os.path.join(datafolder, "checkpoint_tmp.npz")  # np.savez appends .npz
    np.savez(tmp, **arrays)
    os.replace(tmp, os.path.join(datafolder, "checkpoint.npz"))
    meta = {"counters": counters, "sim_stats": sim_stats,
            "mu_tuner": mu_tuner_state, "extras": extras or {}}
    tmp = os.path.join(datafolder, "checkpoint.json.tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, os.path.join(datafolder, "checkpoint.json"))


def has_checkpoint(datafolder: str) -> bool:
    return (os.path.isfile(os.path.join(datafolder, "checkpoint.npz"))
            and os.path.isfile(os.path.join(datafolder, "checkpoint.json")))


def load_checkpoint(datafolder: str):
    data = np.load(os.path.join(datafolder, "checkpoint.npz"))
    with open(os.path.join(datafolder, "checkpoint.json")) as f:
        meta = json.load(f)
    flat = {k: data[k] for k in data.files}
    x = flat.pop("x")
    v = flat.pop("v")
    key = flat.pop("key")
    params = {k[len("params/"):]: v for k, v in flat.items() if k.startswith("params/")}
    container = _unflatten({k[len("container/"):]: v for k, v in flat.items()
                            if k.startswith("container/")})
    return {
        "x": x, "v": v, "key": key, "params": params, "container": container,
        "counters": meta["counters"], "sim_stats": meta["sim_stats"],
        "mu_tuner": meta["mu_tuner"], "extras": meta.get("extras", {}),
    }
