"""Multi-process initialization.

SURVEY.md §5 prescribes `jax.distributed.initialize` for multi-host runs
(one process group over the network). The GridMesh/GSPMD machinery is
host-count agnostic — once initialized, `jax.devices()` spans every
process's devices and everything else works unchanged.
"""

from __future__ import annotations

from typing import Optional

import jax


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> int:
    """Join (or bootstrap) a multi-process JAX runtime; returns the global
    device count. Without arguments this is a no-op: the cluster is given
    explicitly (mirrors jax.distributed.initialize)."""
    try:
        if coordinator_address or num_processes:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
            )
    except RuntimeError as e:
        # calling twice is fine (idempotent join); anything else — bad
        # coordinator, port clash, heartbeat failure — must surface, not
        # silently leave the process single-host
        if "already initialized" not in str(e).lower():
            raise
    return len(jax.devices())

