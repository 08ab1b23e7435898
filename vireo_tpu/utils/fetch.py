"""Host fetch that works for multi-process (globally sharded) arrays,
and chunked concurrent host<->device transfers.

In a jax.distributed run, cell-sharded arrays span devices of several
processes; `np.asarray` on such an array raises. `host_fetch` all-
gathers the global value in that case (each process ends with the full
array — the result-boundary semantics of the reference's single-node
API).

Large single-process transfers are split on the leading axis into
concurrent streams. Values are exact (chunking is row slicing).
VIREO_FETCH_STREAMS / VIREO_PUT_STREAMS set the stream counts
(default 4; <=1 disables). Whether more than one stream helps over a
local PCIe link is not yet measured.
"""

import os

import numpy as np
import jax

__all__ = ["host_fetch", "host_put"]

_MIN_PARALLEL_BYTES = 2 << 20


def host_put(x, dtype=None):
    """device_put for large HOST arrays, split on the leading axis into
    concurrent streams and concatenated on device (the upload side of
    `host_fetch`). VIREO_PUT_STREAMS sets the count (default 4; <=1
    disables)."""
    x = np.asarray(x)
    if dtype is not None:
        x = x.astype(dtype, copy=False)
    streams = int(os.environ.get("VIREO_PUT_STREAMS", 4))
    if streams <= 1 or x.nbytes < _MIN_PARALLEL_BYTES \
            or x.ndim == 0 or x.shape[0] < streams:
        return jax.device_put(x)
    import jax.numpy as jnp
    from concurrent.futures import ThreadPoolExecutor
    bounds = np.linspace(0, x.shape[0], streams + 1).astype(int)
    chunks = [x[lo:hi] for lo, hi in zip(bounds[:-1], bounds[1:])
              if hi > lo]
    with ThreadPoolExecutor(len(chunks)) as ex:
        parts = list(ex.map(jax.device_put, chunks))
    return jnp.concatenate(parts, axis=0)


def host_fetch(x):
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        from jax.experimental import multihost_utils
        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    if not isinstance(x, jax.Array) or x.ndim == 0:
        return np.asarray(x)
    streams = int(os.environ.get("VIREO_FETCH_STREAMS", 4))
    nbytes = x.size * np.dtype(x.dtype).itemsize
    if streams <= 1 or nbytes < _MIN_PARALLEL_BYTES \
            or x.shape[0] < streams:
        return np.asarray(x)
    from concurrent.futures import ThreadPoolExecutor
    bounds = np.linspace(0, x.shape[0], streams + 1).astype(int)
    slices = [x[lo:hi] for lo, hi in zip(bounds[:-1], bounds[1:])
              if hi > lo]
    with ThreadPoolExecutor(len(slices)) as ex:
        parts = list(ex.map(np.asarray, slices))
    return np.concatenate(parts, axis=0)
