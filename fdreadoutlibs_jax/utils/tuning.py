"""Launch parameters of the GPU hit-finding kernel, with a tuned-file
override.

``KERNEL_KNOBS`` holds the shipped values per algorithm family.  Pointing
``FDREADOUT_TUNED`` at a JSON file {algorithm_name: {field: int}} (or
passing ``path``) overrides them field by field; absent, partial or
malformed files fall back to the shipped values, so a tuned file is always
safe to deploy.

Fields:
  sub         channel-block rows: SUB*128 channels per program (a power
              of two up to pallas_tpg.ROW_GRANULE, so it tiles the padded
              container)
  num_warps   Triton warps per program
  num_stages  Triton pipeline stages
  tc          ticks per emission chunk (K-slot buffer period)
  unroll      ticks per inner-loop iteration (one prefetched load group)
  k           K-slot capacity for the kernel-speed consumers
"""

from __future__ import annotations

import json
import os
from typing import Optional

from ..ops.config import Algorithm

_ENV = "FDREADOUT_TUNED"
_cache: dict[tuple, dict] = {}

# One setting serves every family: in a sweep at one APA (2560 channels,
# 8192 ticks) on an H100, 4 warps over 128-channel blocks beat 1, 2 and 8
# warps and 256-channel blocks for AbsRS, SimpleThreshold and FIR alike;
# 512-tick chunks matched or beat 256 and 1024; unroll 16 beat 8 and
# equalled 32 at a quarter of its compile time; extra pipeline stages
# gained nothing outside the noise (PERF.md).
_DEFAULT = {"sub": 1, "num_warps": 4, "num_stages": 1, "tc": 512,
            "unroll": 16, "k": 1}
KERNEL_KNOBS = {alg: dict(_DEFAULT) for alg in Algorithm}


def load_tuned(path: Optional[str] = None) -> dict:
    """Return {algorithm_name: {field: value}} from ``path`` or the
    FDREADOUT_TUNED env var; {} when neither is set or readable.

    Cached per (path, mtime): rewriting the file is picked up by
    long-running processes on the next call.
    """
    path = path or os.environ.get(_ENV)
    if not path:
        return {}
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError:
        mtime = None
    key = (path, mtime)
    if key not in _cache:
        try:
            with open(path) as f:
                data = json.load(f)
            _cache[key] = data if isinstance(data, dict) else {}
        except (OSError, ValueError):
            from .logging import log
            log.warning("ignoring unreadable tuned-config file %s", path)
            _cache[key] = {}
    return _cache[key]


def _tuned_int(tuned: dict, key: str, minimum: int):
    """A tuned field, or None when absent/malformed (bad fields fall back
    per-field — a tuned file must always be safe to deploy)."""
    v = tuned.get(key)
    if isinstance(v, bool) or not isinstance(v, int) or v < minimum:
        if v is not None:
            from .logging import log
            log.warning("ignoring tuned %s=%r (not an int >= %d)",
                        key, v, minimum)
        return None
    return v


def kernel_knobs(cfg, n_channels: int, tc: Optional[int] = None,
                 unroll: Optional[int] = None,
                 path: Optional[str] = None) -> dict:
    """Resolve the kernel launch parameters for ``cfg``, in precedence
    order: explicit ``tc``/``unroll`` arguments -> tuned-file values (when
    one names this algorithm and the field is well-formed) -> KERNEL_KNOBS.

    Returns {"tc", "unroll", "k_slots", "block_sublanes", "num_warps",
    "num_stages"} ready for process_window_pallas / pack_state.

    ``k_slots`` is the PERFORMANCE default (kernel-speed consumers).
    Streaming processors deliberately do NOT take it from here: their
    ``tpg_k_slots`` config is a per-batch hit CAPACITY choice (short
    batches need headroom for pathological channels), so a speed-tuned k
    must never silently cut it.
    """
    shipped = KERNEL_KNOBS[cfg.algorithm]
    tuned = load_tuned(path).get(getattr(cfg.algorithm, "value",
                                         str(cfg.algorithm)), {})
    if not isinstance(tuned, dict):
        tuned = {}

    def pick(key, minimum):
        v = _tuned_int(tuned, key, minimum)
        return shipped[key] if v is None else v

    from ..ops.pallas_tpg import ROW_GRANULE
    sub = pick("sub", 1)
    if ROW_GRANULE % sub:
        # not a power of two that tiles every padded container: fall back
        from .logging import log
        log.warning("ignoring tuned sub=%r (must divide %d)", sub,
                    ROW_GRANULE)
        sub = shipped["sub"]
    return {"tc": tc if tc is not None else pick("tc", 1),
            "unroll": unroll if unroll is not None else pick("unroll", 1),
            "k_slots": pick("k", 1),
            "block_sublanes": sub,
            "num_warps": pick("num_warps", 1),
            "num_stages": pick("num_stages", 1)}
