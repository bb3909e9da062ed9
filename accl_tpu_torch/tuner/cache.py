"""Versioned JSON tuning-table persistence.

The port of ``accl_tpu/tuner/cache.py``: the same schema, version and
environment variable, so a table saved by one package loads into the
other.

A tuning table is the distilled output of a measurement sweep
(``python -m benchmarks --tune``): one chosen algorithm per
``(op, world_size, nbytes-bucket)`` key, plus the topology it was measured
on. Loading a table pins those choices in a :class:`~accl_tpu_torch.tuner.Tuner`
so production runs skip both the cost model and exploration for covered
keys — the NCCL tuning-file workflow.

Schema (``SCHEMA_VERSION`` guards it):

.. code-block:: json

    {"version": 1,
     "topology": {"world_size": 4, "alpha_us": 20.0, "beta_gbps": 4.0,
                  "incast": 2.0, "tier": "emu"},
     "entries": [{"op": "allreduce", "world": 4, "bucket": 21,
                  "algorithm": "FUSED_RING", "expected_us": 1834.2,
                  "samples": 6}]}

The default path comes from the ``ACCL_TPU_TUNING_CACHE`` environment
variable, so a fleet can point every job at a shared table without code
changes.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile

from ..constants import CollectiveAlgorithm
from .cost import Topology

__all__ = ["SCHEMA_VERSION", "ENV_VAR", "default_cache_path",
           "save", "load", "load_into"]

SCHEMA_VERSION = 1
ENV_VAR = "ACCL_TPU_TUNING_CACHE"


def default_cache_path() -> str | None:
    """The ``ACCL_TPU_TUNING_CACHE`` override, or None."""
    return os.environ.get(ENV_VAR) or None


def save(tuner, path: str | None = None) -> str:
    """Serialize ``tuner.entries()`` to ``path`` (default: the env
    override). Atomic: writes a sibling temp file and renames, so a
    reader never sees a torn table."""
    path = path or default_cache_path()
    if not path:
        raise ValueError(
            f"no tuning-cache path: pass one or set ${ENV_VAR}")
    doc = {"version": SCHEMA_VERSION, "entries": tuner.entries()}
    if tuner.topology is not None:
        doc["topology"] = dataclasses.asdict(tuner.topology)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def load(path: str | None = None, strict: bool = False) -> dict:
    """Read and validate a tuning table; returns the parsed document.

    A wrong ``version`` (or a structurally alien file) raises when
    ``strict`` else returns an empty table — a stale cache must not take
    a production job down.
    """
    path = path or default_cache_path()
    if not path:
        raise ValueError(
            f"no tuning-cache path: pass one or set ${ENV_VAR}")
    with open(path) as f:
        doc = json.load(f)
    if (not isinstance(doc, dict)
            or doc.get("version") != SCHEMA_VERSION
            or not isinstance(doc.get("entries"), list)):
        if strict:
            raise ValueError(
                f"{path}: tuning-table version "
                f"{doc.get('version') if isinstance(doc, dict) else '?'} "
                f"incompatible with schema {SCHEMA_VERSION}")
        return {"version": SCHEMA_VERSION, "entries": []}
    return doc


def load_into(tuner, path: str | None = None, strict: bool = False) -> int:
    """Pin a saved table's entries into ``tuner``; adopts the table's
    topology when the tuner has none. Returns the number of entries
    pinned (0 for a version-incompatible table unless ``strict``).

    Tier guard: a table measured on one fabric tier must not pin
    decisions on another (a winner measured over one tier's hop cost says
    nothing of another tier's). When both the tuner and the
    table carry a topology and the tiers differ, nothing is pinned —
    raise instead under ``strict``.
    """
    doc = load(path, strict=strict)
    topo = doc.get("topology")
    table_tier = topo.get("tier") if isinstance(topo, dict) else None
    if tuner.topology is None and isinstance(topo, dict):
        try:
            tuner.topology = Topology(**topo)
        except TypeError:
            pass  # foreign topology fields: selection still works
    elif (tuner.topology is not None and table_tier
            and tuner.topology.tier != table_tier):
        if strict:
            raise ValueError(
                f"tuning table was measured on tier '{table_tier}' but "
                f"this tuner runs on '{tuner.topology.tier}'")
        return 0
    n = 0
    for e in doc["entries"]:
        try:
            tuner.pin(e["op"], e["world"], e["bucket"],
                      CollectiveAlgorithm[e["algorithm"]])
            n += 1
        except (KeyError, TypeError, ValueError):
            if strict:
                raise
    return n
