"""Pure-XLA SWTPG backend: ``lax.scan`` over time with ChanState carry.

Jit-able on any backend (CPU, GPU); bit-exact vs the numpy
oracle because both call :func:`ops.step.tpg_tick`.  Produces dense per-tick
(T, C) closed masks + record fields; use :func:`ops.hits.decode_dense` or
:func:`compact_hits_device` (device-side fixed-capacity compaction, the
fixed-capacity replacement for the reference's MAGIC-sentinel stream).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .chanstate import FIELDS
from .config import TPGConfig
from .step import dispatch_tick

STATE_KEYS = FIELDS + ("rs_memory_factor", "fir_prev")


def state_to_jnp(state) -> dict:
    return {k: jnp.asarray(state[k], dtype=jnp.int32) for k in STATE_KEYS}


@functools.partial(jax.jit, static_argnames=("cfg",))
def process_window_scan(adcs, state: dict, cfg: TPGConfig):
    """(T, C) int32 window -> (closed (T,C) bool, records dict, new_state).

    ``state`` must be a dict of (C,) int32 arrays (STATE_KEYS).
    """
    adcs = adcs.astype(jnp.int32)
    carry0 = {k: jnp.asarray(state[k], dtype=jnp.int32) for k in STATE_KEYS}

    def body(st, s_row):
        st, closed, rec = dispatch_tick(st, s_row, cfg, jnp)
        return st, (closed, rec["charge"], rec["tover"], rec["peak_adc"],
                    rec["peak_time"])

    new_state, (closed, charge, tover, peak_adc, peak_time) = jax.lax.scan(
        body, carry0, adcs)
    records = {"charge": charge, "tover": tover,
               "peak_adc": peak_adc, "peak_time": peak_time}
    return closed, records, new_state


@functools.partial(jax.jit, static_argnames=("max_hits",))
def compact_hits_device(closed, records, max_hits: int = 1024):
    """Device-side compaction of dense (T, C) hit outputs to fixed capacity.

    Prefix-sum assigns each closed (t, c) a slot in close order; overflow
    beyond ``max_hits`` is dropped and counted (the reference drops at its
    100k-entry buffer similarly, WIBEthFrameProcessor.cpp:78).

    Returns (hits (max_hits, 6) int32 [channel, end_tick, charge, tover,
    peak_adc, peak_time], n_hits, n_dropped).
    """
    T, C = closed.shape
    flat = closed.reshape(-1)
    pos = jnp.cumsum(flat.astype(jnp.int32)) - 1
    n = jnp.sum(flat.astype(jnp.int32))
    t_idx = jnp.arange(T * C, dtype=jnp.int32) // C
    c_idx = jnp.arange(T * C, dtype=jnp.int32) % C
    fields = [c_idx, t_idx] + [records[f].reshape(-1).astype(jnp.int32)
                               for f in ("charge", "tover", "peak_adc",
                                         "peak_time")]
    dest = jnp.where(flat & (pos < max_hits), pos, max_hits)  # OOB -> dropped
    out = jnp.zeros((max_hits + 1, 6), dtype=jnp.int32)
    vals = jnp.stack(fields, axis=-1)
    out = out.at[dest].set(vals, mode="drop")
    n_kept = jnp.minimum(n, max_hits)
    return out[:max_hits], n_kept, n - n_kept


def compact_to_numpy(hits_arr, n_hits):
    """Convert device compaction output to the canonical structured array."""
    import numpy as np
    from .hits import HIT_DTYPE, sort_hits
    arr = np.asarray(hits_arr)[: int(n_hits)]
    hits = np.zeros(len(arr), dtype=HIT_DTYPE)
    for i, f in enumerate(("channel", "end_tick", "charge", "tover",
                           "peak_adc", "peak_time")):
        hits[f] = arr[:, i]
    return sort_hits(hits)
