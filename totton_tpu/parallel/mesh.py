"""Device mesh construction for the ('channel', 'time') sharding layout."""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh


def make_mesh(
    n_channel: int | None = None,
    n_time: int | None = None,
    devices=None,
) -> Mesh:
    """Build a 2D Mesh with axes ('channel', 'time').

    Defaults: all channels on one shard, all devices along 'time' (time
    parallelism scales with the device count; channel count is fixed by
    the audio format). Within one host every card reaches every other over
    NVLink, so the order of devices along 'time' does not matter there.
    On multi-host, each process's devices form one contiguous block of the
    grid (jax.devices() order groups by host), so the 'time' halo crosses
    the network only at process boundaries.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if n_channel is None and n_time is None:
        n_channel, n_time = 1, n
    elif n_channel is None:
        n_channel = n // n_time
    elif n_time is None:
        n_time = n // n_channel
    need = n_channel * n_time
    if need > n:
        raise ValueError(
            f"mesh {n_channel}x{n_time} does not cover {n} devices"
        )
    if jax.process_count() > 1:
        # Multi-host contract (ShardedUpsampler validates it): every
        # process's devices must form a contiguous (channel rows x time
        # cols) RECTANGLE of the grid, so each host feeds exactly the
        # channel/time block its own devices compute. jax.devices() groups
        # by process, so:
        #  - column-major (whole time columns per process) satisfies it
        #    when each process's share is a multiple of n_channel — the
        #    layout for time-sharded streaming (halo exchange stays
        #    on-host except at span boundaries);
        #  - row-major (whole channel rows per process) covers the
        #    channel-heavy corner (e.g. n_time=1 multi-host channel
        #    sharding), where column-major would split a time column
        #    across processes.
        flat = np.asarray(devices[:need])
        grid = flat.reshape(n_time, n_channel).T
        if not _process_blocks_rectangular(grid):
            grid = flat.reshape(n_channel, n_time)
            if not _process_blocks_rectangular(grid):
                raise ValueError(
                    f"no ({n_channel}x{n_time}) grid over these {need} "
                    "devices gives every process a contiguous channel x "
                    "time rectangle; choose axis sizes so each process's "
                    "device count is a multiple of n_channel or of n_time"
                )
    else:
        grid = np.asarray(devices[:need]).reshape(n_channel, n_time)
    return Mesh(grid, axis_names=("channel", "time"))


def _process_blocks_rectangular(grid: np.ndarray) -> bool:
    """True iff every process's cells form a full contiguous rectangle."""
    cells_by_proc: dict[int, list[tuple[int, int]]] = {}
    n_rows, n_cols = grid.shape
    for r in range(n_rows):
        for t in range(n_cols):
            cells_by_proc.setdefault(
                grid[r, t].process_index, []).append((r, t))
    for cells in cells_by_proc.values():
        rows = sorted({c[0] for c in cells})
        cols = sorted({c[1] for c in cells})
        if rows != list(range(rows[0], rows[0] + len(rows))):
            return False
        if cols != list(range(cols[0], cols[0] + len(cols))):
            return False
        if len(cells) != len(rows) * len(cols):
            return False
    return True
