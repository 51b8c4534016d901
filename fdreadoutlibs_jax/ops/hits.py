"""Hit records: decode, compaction, canonical ordering.

The reference streams hits as MAGIC-terminated 7-register dumps
(ProcessAVX2.hpp:174-196 decoded in WIBEthFrameProcessor.cpp:479-521).  Here
every backend produces the same canonical structured array; the Pallas
backend's sparse row-dumps and the scan backend's dense (T, C) masks both
decode into it.
"""

from __future__ import annotations

import numpy as np

HIT_DTYPE = np.dtype([
    ("channel", np.int32),     # channel index within the processed array
    ("end_tick", np.int32),    # tick at which the hit *closed* (first not-over)
    ("charge", np.int32),
    ("tover", np.int32),
    ("peak_adc", np.int32),
    ("peak_time", np.int32),   # tover value at the peak sample
])


def empty_hits() -> np.ndarray:
    return np.zeros(0, dtype=HIT_DTYPE)


def sort_hits(hits: np.ndarray) -> np.ndarray:
    """Canonical order: (end_tick, channel)."""
    return hits[np.lexsort((hits["channel"], hits["end_tick"]))]


def decode_dense(closed: np.ndarray, records: dict, tick_offset: int = 0) -> np.ndarray:
    """Decode dense per-tick outputs: closed (T, C) bool, records dict of
    (T, C) arrays -> canonical hit array."""
    t_idx, c_idx = np.nonzero(np.asarray(closed))
    hits = np.zeros(len(t_idx), dtype=HIT_DTYPE)
    hits["channel"] = c_idx
    hits["end_tick"] = t_idx + tick_offset
    for f in ("charge", "tover", "peak_adc", "peak_time"):
        hits[f] = np.asarray(records[f])[t_idx, c_idx]
    return sort_hits(hits)


def decode_rows(rows: np.ndarray, count: int, channel_base: int = 0,
                tick_offset: int = 0) -> np.ndarray:
    """Decode Pallas row-dumps.

    rows: (MAX_ROWS, 6, CB) int32 where field axis is
    [tick, charge, tover, peak_adc, peak_time, closed_mask] — the
    vectorized analogue of the reference's 7-register dump (channels are implicit:
    ``channel_base + lane``).
    """
    rows = np.asarray(rows)[:count]
    if rows.size == 0:
        return empty_hits()
    tick, charge, tover, peak_adc, peak_time, mask = (rows[:, i] for i in range(6))
    r_idx, c_idx = np.nonzero(mask)
    hits = np.zeros(len(r_idx), dtype=HIT_DTYPE)
    hits["channel"] = c_idx + channel_base
    hits["end_tick"] = tick[r_idx, c_idx] + tick_offset
    hits["charge"] = charge[r_idx, c_idx]
    hits["tover"] = tover[r_idx, c_idx]
    hits["peak_adc"] = peak_adc[r_idx, c_idx]
    hits["peak_time"] = peak_time[r_idx, c_idx]
    return sort_hits(hits)


def apply_slot_capacity(hits: np.ndarray, tc: int, k_slots: int):
    """The hit-finding kernel's capacity rule applied to a canonical hit
    list from a backend without it: per channel and per tc-tick chunk
    (end_tick // tc), the first k_slots closes are kept and the rest are
    dropped.  Returns (kept hits, dropped count)."""
    hits = sort_hits(hits)
    key = hits["channel"].astype(np.int64) * (1 << 32) + hits["end_tick"] // tc
    order = np.lexsort((hits["end_tick"], key))
    k_sorted = key[order]
    first = np.r_[0, np.flatnonzero(np.diff(k_sorted)) + 1]
    rank = np.arange(len(order)) - np.repeat(first, np.diff(
        np.r_[first, len(order)]))
    keep = np.zeros(len(hits), bool)
    keep[order[rank < k_slots]] = True
    return hits[keep], int((~keep).sum())


def concat_hits(parts) -> np.ndarray:
    parts = [p for p in parts if len(p)]
    if not parts:
        return empty_hits()
    return sort_hits(np.concatenate(parts))


# ---- device-side compaction -----------------------------------------------

def compact_slot_words(w0, w1, w2, max_hits: int, channel_base: int = 0,
                       tick_offset: int = 0):
    """jit-able decode of K-slot record words -> (max_hits, 6) int32 hits
    [channel, end_tick, charge, tover, peak_adc, peak_time] in canonical
    (end_tick, channel) order, plus the valid count.

    w0/w2: (K, C) packed words ([charge<<16|tover], [end_tick+1]); ``w1``
    may be None (no-peak record layout) — peak fields emit as zero.
    Shrinks device->host traffic from the full slot buffers to the hit
    list itself (the multi-chip per-link decode and StreamingIngest's
    device_compact path both ride this).
    """
    import jax
    import jax.numpy as jnp
    K, C = w2.shape
    valid = (w2 != 0).reshape(-1)
    chan = jnp.tile(jnp.arange(C, dtype=jnp.int32), (K, 1)).reshape(-1)
    end = (w2 - 1).reshape(-1)
    if w1 is None:
        w1 = jnp.zeros_like(w0)
    # order by (end_tick, channel); invalid entries sort last.  Valid keys
    # are unique (a hit closes once per channel per tick), so any
    # deterministic tie rule only ever applies to the all-identical
    # invalid keys, whose rows are zeroed below.
    key = jnp.where(valid, end * jnp.int32(C) + chan,
                    jnp.iinfo(jnp.int32).max)
    take = min(max_hits, K * C)
    # top_k of the negated key == the first `take` rows of a full
    # ascending sort (XLA TopK breaks ties lowest-index-first, matching a
    # stable argsort) — but it's a partial reduction, not an O(n log n)
    # comparator sort over every slot, and the 6-field record gather only
    # materializes for the `take` survivors instead of all K*C slots.
    # Hits are sparse (~1e3 valid in ~1e5 slots at APA shapes).
    _, order = jax.lax.top_k(-key, take)
    valid_t = valid[order]
    fields = jnp.stack([
        chan[order] + jnp.int32(channel_base),
        end[order] + jnp.int32(tick_offset),
        w0.reshape(-1)[order] >> 16, w0.reshape(-1)[order] & 0xFFFF,
        w1.reshape(-1)[order] >> 16, w1.reshape(-1)[order] & 0xFFFF],
        axis=-1)
    n = jnp.sum(valid.astype(jnp.int32))
    out = jnp.zeros((max_hits, 6), jnp.int32)
    out = out.at[:take].set(jnp.where(valid_t[:, None], fields, 0))
    return out, jnp.minimum(n, max_hits)


def compact_pallas_slots(slots, nclose, n_channels: int, max_hits: int,
                         tick_offset: int = 0):
    """jit-able: process_window_pallas outputs -> (max_hits, 6) canonical
    hits + valid count + dropped count, entirely on device."""
    import jax.numpy as jnp
    nb, nch, K, nw, sub, lanes = slots.shape
    C = nb * sub * lanes
    flat = slots.transpose(1, 2, 3, 0, 4, 5).reshape(nch * K, nw, C)
    counts = nclose.transpose(1, 0, 2, 3).reshape(nch, C)
    flat = flat[:, :, :n_channels]
    counts = counts[:, :n_channels]
    w1 = flat[:, 1] if nw == 3 else None
    out, n = compact_slot_words(flat[:, 0], w1, flat[:, -1], max_hits,
                                tick_offset=tick_offset)
    dropped = jnp.sum(jnp.maximum(counts - K, 0))
    # hits beyond the output capacity are also drops (visible, counted)
    total_valid = jnp.sum((flat[:, -1] != 0).astype(jnp.int32))
    dropped = dropped + jnp.maximum(total_valid - max_hits, 0)
    return out, n, dropped


def hits_from_compact(rows: np.ndarray, count: int) -> np.ndarray:
    """(max_hits, 6) int32 device-compact output -> canonical hit array."""
    rows = np.asarray(rows)[:int(count)]
    hits = np.zeros(len(rows), dtype=HIT_DTYPE)
    for i, f in enumerate(HIT_DTYPE.names):
        hits[f] = rows[:, i]
    return hits
