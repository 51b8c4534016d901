"""Checkpoint / resume for streaming state.

The reference has NO checkpointing — ChanState is re-seeded at every run
start (SURVEY.md §5).  Because this framework carries all streaming state
as explicit arrays (ChanState pytree + processor bookkeeping), a checkpoint
is a single npz; a processor can resume mid-stream bit-exactly.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..ops.chanstate import ChanState

_META_KEYS = ("previous_ts", "previous_seq_id", "last_processed_daq_ts")


def save_state(path, state: dict, **meta) -> Path:
    """Save a ChanState-like dict of arrays (+ scalar metadata) to npz."""
    arrays = {f"state/{k}": np.asarray(v) for k, v in state.items()}
    arrays.update({f"meta/{k}": np.asarray(v) for k, v in meta.items()})
    np.savez_compressed(str(path), **arrays)
    return Path(path)


def load_state(path):
    """Returns (state dict, meta dict)."""
    blob = np.load(str(path))
    state, meta = {}, {}
    for k in blob.files:
        kind, name = k.split("/", 1)
        if kind == "state":
            state[name] = blob[k]
        else:
            v = blob[k]
            meta[name] = v.item() if v.shape == () else v
    return ChanState(state), meta


def checkpoint_processor(proc, path) -> Path:
    """Checkpoint a frame processor's full streaming context."""
    meta = {k: getattr(proc, k, 0) for k in _META_KEYS}
    meta["first_hit"] = getattr(proc, "_first_hit", True)
    if hasattr(proc, "current_state"):   # lazily-materialized device state
        state = proc.current_state() or {}
    else:
        state = getattr(proc, "_state", None) or {}
    if getattr(proc, "register_channels", None) is not None:
        meta["register_channels"] = np.asarray(proc.register_channels)
        meta["register_memory_factor"] = np.asarray(proc.register_memory_factor)
    return save_state(path, state, **meta)


def save_sharded_state(path, state: dict) -> None:
    """Checkpoint a *sharded* state dict of jax arrays (e.g.
    APAPipeline.state): every process writes the shards it can address,
    one per distinct index, to ``path/shards_<process>.npz`` (numpy only;
    no checkpoint library).  load_sharded_state re-shards onto the
    current mesh."""
    import jax
    out = Path(path)
    out.mkdir(parents=True, exist_ok=True)
    arrays = {}
    for key, arr in state.items():
        arrays[f"{key}/shape"] = np.asarray(arr.shape, dtype=np.int64)
        seen = set()
        for shard in arr.addressable_shards:
            bounds = tuple((sl.start or 0,
                            arr.shape[d] if sl.stop is None else sl.stop)
                           for d, sl in enumerate(shard.index))
            if bounds in seen:          # replicated copy of a stored piece
                continue
            seen.add(bounds)
            i = len(seen) - 1
            arrays[f"{key}/{i}/bounds"] = np.asarray(bounds, dtype=np.int64)
            arrays[f"{key}/{i}/data"] = np.asarray(shard.data)
    np.savez(out / f"shards_{jax.process_index()}.npz", **arrays)


def load_sharded_state(path, like: dict) -> dict:
    """Restore a sharded state dict saved by save_sharded_state; ``like``
    provides shapes, dtypes and shardings (e.g. a freshly initialized
    APAPipeline.state).  Bit-exact: shards are copied, never converted."""
    import jax
    full = {}
    for f in sorted(Path(path).glob("shards_*.npz")):
        with np.load(f) as blob:
            for name in blob.files:
                key, rest = name.rsplit("/", 1)
                if rest != "data":
                    continue
                key, _ = key.rsplit("/", 1)
                if key not in full:
                    full[key] = np.zeros(tuple(blob[f"{key}/shape"]),
                                         dtype=like[key].dtype)
                bounds = blob[name[:-len("data")] + "bounds"]
                full[key][tuple(slice(a, b) for a, b in bounds)] = blob[name]
    if set(full) != set(like):
        raise ValueError(f"checkpoint at {path} holds {sorted(full)}, "
                         f"expected {sorted(like)}")
    return {key: jax.make_array_from_callback(
                like[key].shape, like[key].sharding,
                lambda idx, a=full[key]: a[idx])
            for key in like}


def restore_processor(proc, path) -> None:
    """Restore a checkpoint into a conf()'d + start()'d processor."""
    state, meta = load_state(path)
    if len(state):
        proc._state = state
        proc._pallas_stack = None
        proc._state_stale = False
    for k in _META_KEYS:
        if k in meta:
            setattr(proc, k, int(meta[k]))
    if "register_channels" in meta:
        proc.register_channels = np.asarray(meta["register_channels"])
        proc.register_memory_factor = np.asarray(meta["register_memory_factor"])
        proc._first_hit = bool(meta.get("first_hit", False))
    proc._first_ts_check = False
    proc._first_seq_check = False
