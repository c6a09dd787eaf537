"""Trace-time sharding context: lets the operator layer pick shard-aware kernels.

GSPMD partitions everything in the solver automatically EXCEPT ``pl.pallas_call``
(opaque to the partitioner: sharded operands would be all-gathered).  The power
iteration is traced once under ``jit``; while ``sharding_scope`` is active, the
A-solve call sites (ops/apply.py) wrap the local line solve in ``jax.shard_map``
for directions whose mesh lines are NOT cut by the decomposition (each shard owns
complete lines — a purely local solve), and fall back to the partitionable
``associative_scan`` path for the direction along the cut.

The context is consulted only at TRACE time (it stores the Mesh and the map
{spatial grid axis in (nz, ny, nx) order -> mesh axis name}); nothing here touches
runtime state.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

from jax.sharding import Mesh

_CURRENT: Optional[Tuple[Mesh, Dict[int, str]]] = None

__all__ = ["sharding_scope", "current_sharding"]


@contextlib.contextmanager
def sharding_scope(mesh: Mesh, axis_map: Dict[int, str]):
    """axis_map: spatial grid axis (0=nz, 1=ny, 2=nx) -> mesh axis name."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = (mesh, dict(axis_map))
    try:
        yield
    finally:
        _CURRENT = prev


def current_sharding() -> Optional[Tuple[Mesh, Dict[int, str]]]:
    return _CURRENT
