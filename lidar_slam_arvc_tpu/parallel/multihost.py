"""Multi-host scaling entry points (jax.distributed).

The reference is strictly single-process (SURVEY.md §2.3).  This module
provides the coordination layer for running the pipeline across hosts:
each process loads and preprocesses its shard of scans locally (PCD I/O is
per-host), the pair batches shard over the global mesh, and the pose-graph
assembly reduces with psum across devices and hosts (parallel/dist_solver.py works
unchanged on a multi-host mesh — shard_map + psum compile to the right
collectives).

CI cannot exercise real multi-host; the sharding-level tests run
on a virtual 8-device mesh (tests/test_parallel.py), and this module keeps
the host-coordination logic isolated and small.
"""

from __future__ import annotations

import numpy as np


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> dict:
    """Initialize jax.distributed (no-op when single-process).

    Where the cluster environment describes the job, all arguments
    auto-detect; pass them explicitly otherwise (one host of GPUs needs
    ``coordinator_address='localhost:<port>'``).  Returns a topology report.
    """
    import jax
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id)
    elif coordinator_address is not None:
        jax.distributed.initialize(coordinator_address=coordinator_address)
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }


def assemble_global_scans(mesh, local_arrays: dict, n_total: int,
                          axis: str = "data"):
    """Per-host loaded scan tensors -> globally sharded jax.Arrays.

    Each process loads ONLY its host_scan_shard slice of the PCDs (disk I/O
    is per-host) and passes the stacked local tensors here;
    jax.make_array_from_process_local_data assembles the global (n_total,
    ...) arrays whose scan axis is sharded over the mesh — no host ever
    materializes the full stack.  ``local_arrays`` maps name -> (n_local,
    ...) numpy array; n_total must be a mesh-size multiple (pad with copies
    of the last scan).  Single-process (tests, one host) degenerates to a
    device_put of the full stack, so the call sites are identical either
    way.  Returns the dict with jax.Arrays.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P(axis))
    out = {}
    for name, a in local_arrays.items():
        out[name] = jax.make_array_from_process_local_data(
            sharding, np.asarray(a), (n_total,) + a.shape[1:])
    return out


def host_scan_shard(n_scans: int, process_index: int | None = None,
                    process_count: int | None = None) -> np.ndarray:
    """Scan indices this host is responsible for loading/preprocessing.

    Contiguous blocks keep consecutive-pair ICP local to one host except at
    shard boundaries (boundary scans are loaded by both neighbors).
    """
    import jax
    pi = jax.process_index() if process_index is None else process_index
    pc = jax.process_count() if process_count is None else process_count
    bounds = np.linspace(0, n_scans, pc + 1).astype(int)
    lo, hi = bounds[pi], bounds[pi + 1]
    # include one overlap scan on the left so pair (lo-1, lo) is computable
    lo_ext = max(lo - 1, 0)
    return np.arange(lo_ext, hi)
