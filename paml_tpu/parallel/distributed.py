"""Multi-host execution (SURVEY.md section 5.8).

The reference has no distributed runtime (files are its only IPC); here
it is one SPMD program per host joined through
`jax.distributed.initialize`, with XLA collectives (NCCL over NVLink
within a host, the network across hosts).  This module is the single
entry point: call `initialize()` on every host before building meshes;
`global_data_mesh()` then lays the site-pattern axis over every GPU in
the job.

The only collectives the likelihood needs are psum (lnL, gradients) and
occasional all_gathers (site posteriors for output), both inserted by XLA
from the shardings — there is no custom transport layer.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join the multi-host job (idempotent).

    Without arguments JAX looks for a cluster it can detect (a scheduler
    such as SLURM); elsewhere pass the coordinator address
    (`host:port`), the number of processes and this process's id.
    Single-host runs may skip this entirely.
    """
    # NOTE: do not probe jax.process_count() here — it initializes the
    # XLA backend, after which jax.distributed.initialize refuses to run
    if jax.distributed.is_initialized():
        return                     # already joined
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id)
    except (ValueError, RuntimeError) as e:
        if "already" in str(e).lower():
            return
        if num_processes not in (None, 1):
            raise
        # single-process run without cluster metadata: nothing to join


def global_data_mesh(axis: str = "data") -> Mesh:
    """1-D mesh over every device in the job (all hosts)."""
    return Mesh(np.asarray(jax.devices()), (axis,))


def is_primary() -> bool:
    """True on the process that should write output files."""
    return jax.process_index() == 0
