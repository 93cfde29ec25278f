"""Multi-host initialization helper.

The reference has no distributed runtime (SURVEY.md §2.3); this design
shards overlap records by A-read ranges across hosts exactly like `--mlas`
parts map to sequential single-host runs.  On a multi-host cluster this
module initializes `jax.distributed` and hands each host its read range;
collectives (psum/all_gather in parallel.sharding) then run globally over
the ('reads','recs') mesh spanning all hosts' devices.

Not executable in this single-host environment — covered by the virtual
multi-device tests (tests/test_sharding.py) plus dryrun_multichip.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[int, int]:
    """Initialize jax.distributed (no-op on a single process).

    Returns (process_index, process_count)."""
    import jax

    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return jax.process_index(), jax.process_count()


def host_read_range(n_reads: int, process_index: int, process_count: int) -> Tuple[int, int]:
    """Contiguous A-read range owned by this host (the --mlas axis)."""
    chunk = -(-n_reads // process_count)
    lo = process_index * chunk
    hi = min(lo + chunk, n_reads)
    return lo, hi
