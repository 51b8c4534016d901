"""SWTPG model-family registry.

| family          | reference kernel                      | filter stage      |
|-----------------|---------------------------------------|-------------------|
| SimpleThreshold | process_window_avx2 (wibeth)          | none (fixed thr)  |
| AbsRS           | process_window_rs_avx2                | |s| running sum   |
| StandardRS      | process_window_standard_rs_avx2       | signed running sum|
| FIR             | process_window_avx2 (wib), AVX2FIR    | 8-tap FIR + IQR   |
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..formats.trigprim import TPAlgorithm
from ..ops import Algorithm, TPGConfig
from ..ops.chanstate import init_chanstate, seed_chanstate


@dataclass(frozen=True)
class ModelFamily:
    name: str
    algorithm: Algorithm
    tp_algorithm: TPAlgorithm
    description: str
    uses_rs_state: bool = False
    uses_fir_state: bool = False
    dynamic_threshold: bool = False


MODEL_FAMILIES = {
    "SimpleThreshold": ModelFamily(
        "SimpleThreshold", Algorithm.SIMPLE_THRESHOLD,
        TPAlgorithm.kSimpleThreshold,
        "Frugal pedestal subtraction + fixed threshold "
        "(wibeth/tpg/ProcessAVX2.hpp)"),
    "AbsRS": ModelFamily(
        "AbsRS", Algorithm.ABS_RS, TPAlgorithm.kAbsRunningSum,
        "Absolute running sum, x10 fixed point "
        "(wibeth/tpg/ProcessAbsRSAVX2.hpp)", uses_rs_state=True),
    "StandardRS": ModelFamily(
        "StandardRS", Algorithm.STANDARD_RS, TPAlgorithm.kRunningSum,
        "Signed running sum (wibeth/tpg/ProcessStandardRSAVX2.hpp)",
        uses_rs_state=True),
    "FIR": ModelFamily(
        "FIR", Algorithm.FIR, TPAlgorithm.kSimpleThreshold,
        "8-tap FIR + IQR dynamic threshold (wib/wib2 legacy kernels)",
        uses_fir_state=True, dynamic_threshold=True),
}


def get_model(name: str) -> ModelFamily:
    if name not in MODEL_FAMILIES:
        from ..stream.errors import TPGAlgorithmInexistent
        raise TPGAlgorithmInexistent(
            f"unknown TPG algorithm {name!r} "
            f"(available: {sorted(MODEL_FAMILIES)})")
    return MODEL_FAMILIES[name]


def run_model(adcs: np.ndarray, cfg: TPGConfig, backend: str = "scan",
              state: Optional[dict] = None, rs_memory_factor=None,
              interpret: bool = False):
    """One-call model execution over a (T, C) stream; returns (hits, state).

    ``backend``: "reference", "scan", "pallas" or "auto"
    (ops.backend.hit_backend).  ``interpret=True`` runs the Pallas kernel
    through the interpreter (CPU tests).  Convenience wrapper used by the
    CLI/validation tools; production streaming goes through the stream/
    processors or parallel/APAPipeline.
    """
    from ..ops.backend import resolve_backend
    backend = resolve_backend(backend)
    adcs = np.asarray(adcs, dtype=np.int32)
    T, C = adcs.shape
    if rs_memory_factor is None:
        rs_memory_factor = cfg.rs_memory_factor_x10
    if state is None:
        cfg.check_memory_factors(rs_memory_factor)
        state = seed_chanstate(init_chanstate(C), adcs[0], rs_memory_factor)

    if backend == "reference":
        from ..ops.reference import process_window_reference
        return process_window_reference(adcs, state, cfg)
    if backend == "scan":
        import jax.numpy as jnp
        from ..ops.hits import decode_dense
        from ..ops.scan import process_window_scan, state_to_jnp
        closed, records, new_state = process_window_scan(
            jnp.asarray(adcs), state_to_jnp(state), cfg)
        state = dict(state)
        state.update({k: np.asarray(v) for k, v in new_state.items()})
        return decode_dense(closed, records), state
    if backend == "pallas":
        import jax.numpy as jnp
        from ..ops.pallas_tpg import (decode_pallas_hits, pack_adcs,
                                      pack_state, process_window_pallas,
                                      unpack_state)
        from ..ops.hits import concat_hits
        from ..utils.tuning import kernel_knobs
        knobs = kernel_knobs(cfg, C)
        stack = pack_state(state, C, block_sublanes=knobs["block_sublanes"])
        u = 1 if interpret else knobs["unroll"]
        packed = pack_adcs(adcs)
        parts = []
        t0 = 0
        while t0 < T:
            w = min(512, T - t0)
            slots, nclose, stack = process_window_pallas(
                jnp.asarray(packed[t0:t0 + w]), stack, cfg, tc=w, k_slots=8,
                unroll=u if w % u == 0 else 1, interpret=interpret)
            h, _ = decode_pallas_hits(slots, nclose, C, tick_offset=t0)
            parts.append(h)
            t0 += w
        state = dict(state)
        state.update(unpack_state(stack, C))
        return concat_hits(parts), state
    raise ValueError(f"unknown backend {backend!r}")
