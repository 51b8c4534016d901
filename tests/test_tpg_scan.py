"""Bit-exactness of the XLA lax.scan backend vs the numpy oracle."""

import numpy as np
import pytest

from fdreadoutlibs_jax.ops import TPGConfig, Algorithm
from fdreadoutlibs_jax.ops import patterns
from fdreadoutlibs_jax.ops.chanstate import init_chanstate, seed_chanstate
from fdreadoutlibs_jax.ops.hits import decode_dense, concat_hits
from fdreadoutlibs_jax.ops.reference import run_reference
from fdreadoutlibs_jax.ops.scan import (process_window_scan, state_to_jnp,
                                        compact_hits_device, compact_to_numpy)


def run_scan(adcs, cfg, rs_memory_factor=None, window=64):
    """Scan-backend equivalent of reference.run_reference."""
    adcs = np.asarray(adcs, dtype=np.int32)
    T, C = adcs.shape
    if rs_memory_factor is None:
        rs_memory_factor = cfg.rs_memory_factor_x10
    state = state_to_jnp(seed_chanstate(init_chanstate(C), adcs[0],
                                        rs_memory_factor))
    parts = []
    for t0 in range(0, T, window):
        closed, records, state = process_window_scan(adcs[t0:t0 + window],
                                                     state, cfg)
        parts.append(decode_dense(closed, records, tick_offset=t0))
    return concat_hits(parts), state


def random_stream(T, C, seed, noise=30, base=900, n_signals=40):
    rng = np.random.default_rng(seed)
    adcs = (base + rng.normal(0, noise, size=(T, C))).astype(np.int32)
    for _ in range(n_signals):
        c = rng.integers(0, C)
        t = rng.integers(1, T - 12)
        w = rng.integers(1, 10)
        amp = rng.integers(200, 4000)
        adcs[t:t + w, c] += amp
    return np.clip(adcs, 0, (1 << 14) - 1)


CONFIGS = [
    TPGConfig(algorithm=Algorithm.SIMPLE_THRESHOLD, threshold=120),
    TPGConfig(algorithm=Algorithm.ABS_RS, threshold=150),
    TPGConfig(algorithm=Algorithm.STANDARD_RS, threshold=150),
    TPGConfig(algorithm=Algorithm.SIMPLE_THRESHOLD, threshold=120,
              peak_gated=True),
    TPGConfig(algorithm=Algorithm.ABS_RS, threshold=150,
              accumulator_limit=5),
]


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: f"{c.algorithm.value}"
                         f"{'-gated' if c.peak_gated else ''}"
                         f"-acc{c.accumulator_limit}")
def test_scan_matches_reference_random(cfg):
    adcs = random_stream(256, 32, seed=hash(cfg) % 2**31)
    h_ref, st_ref = run_reference(adcs, cfg)
    h_scan, st_scan = run_scan(adcs, cfg)
    assert len(h_ref) > 0, "test stream produced no hits — not probing anything"
    np.testing.assert_array_equal(h_scan, h_ref)
    for k in st_ref:
        if k in ("fir_prev", "fir_phase"):
            continue
        np.testing.assert_array_equal(np.asarray(st_scan[k]),
                                      np.asarray(st_ref[k]), err_msg=k)


def test_scan_golden_pattern():
    adcs = patterns.golden(n_frames=3, channel=5, offset=30)
    cfg = TPGConfig(threshold=patterns.GOLDEN_THRESHOLD)
    h_ref, _ = run_reference(adcs, cfg)
    h_scan, _ = run_scan(adcs, cfg)
    np.testing.assert_array_equal(h_scan, h_ref)


def test_scan_window_invariance():
    """State carry across chunk boundaries: different chunkings, same hits."""
    adcs = random_stream(384, 16, seed=7)
    cfg = TPGConfig(threshold=100)
    h64, _ = run_scan(adcs, cfg, window=64)
    h128, _ = run_scan(adcs, cfg, window=128)
    h384, _ = run_scan(adcs, cfg, window=384)
    np.testing.assert_array_equal(h64, h128)
    np.testing.assert_array_equal(h64, h384)


def test_device_compaction_matches_decode():
    adcs = random_stream(256, 32, seed=11)
    cfg = TPGConfig(threshold=100)
    state = state_to_jnp(seed_chanstate(init_chanstate(32), adcs[0], 8))
    closed, records, _ = process_window_scan(adcs, state, cfg)
    dense = decode_dense(closed, records)
    arr, n, dropped = compact_hits_device(closed, records, max_hits=4096)
    assert int(dropped) == 0
    compacted = compact_to_numpy(arr, n)
    np.testing.assert_array_equal(compacted, dense)


def test_device_compaction_overflow():
    adcs = random_stream(256, 32, seed=13)
    cfg = TPGConfig(threshold=60)
    state = state_to_jnp(seed_chanstate(init_chanstate(32), adcs[0], 8))
    closed, records, _ = process_window_scan(adcs, state, cfg)
    total = int(np.asarray(closed).sum())
    assert total > 4
    cap = max(1, total // 2)
    arr, n, dropped = compact_hits_device(closed, records, max_hits=cap)
    assert int(n) == cap
    assert int(dropped) == total - cap
