"""Shared cases for the kernel-vs-oracle tests (test_kernel_plain.py,
test_kernel_time2.py): every algorithm family, one or several channel
blocks, one window or three chained windows, with K-slot overflow.

The expected output is the numpy oracle's hit list with the kernel's
capacity rule applied: per channel and per tc-tick chunk, the first
k_slots closes are kept and the rest are counted as dropped.
"""

import zlib

import numpy as np

from fdreadoutlibs_jax.ops import Algorithm, TPGConfig
from fdreadoutlibs_jax.ops.hits import apply_slot_capacity
from fdreadoutlibs_jax.ops.reference import run_reference
from tests.test_tpg_pallas import run_pallas

FAMILIES = {
    "SimpleThreshold": TPGConfig(algorithm=Algorithm.SIMPLE_THRESHOLD,
                                 threshold=60),
    "AbsRS": TPGConfig(algorithm=Algorithm.ABS_RS, threshold=100),
    "StandardRS": TPGConfig(algorithm=Algorithm.STANDARD_RS, threshold=60),
    "FIR": TPGConfig(algorithm=Algorithm.FIR, threshold=5,
                     track_peaks=False),
}
BLOCKS = {"one-block": 8, "four-blocks": 2}       # channel-block rows
WINDOWS = {"one-window": 1, "three-windows": 3}
C, T_WINDOW, TC, K = 300, 64, 32, 1


def stream(seed: int) -> np.ndarray:
    """(3*T_WINDOW, C) ADCs: noise plus short pulses, and one channel
    that closes two hits in every tc chunk (more than K)."""
    rng = np.random.default_rng(seed)
    T = 3 * T_WINDOW
    adcs = (900 + rng.normal(0, 6, size=(T, C))).astype(np.int32)
    for _ in range(400):
        c, t = rng.integers(0, C), rng.integers(1, T - 6)
        adcs[t:t + rng.integers(1, 4), c] += rng.integers(150, 2000)
    for t in range(3, T - 3, TC // 2):       # two closes per chunk
        adcs[t, 7] += 400
    return np.clip(adcs, 0, (1 << 14) - 1)


def check_case(family: str, blocks: str, windows: str, time_packed: bool):
    cfg = FAMILIES[family]
    n_win = WINDOWS[windows]
    adcs = stream(seed=zlib.crc32(f"{family}/{blocks}/{windows}".encode()))
    adcs = adcs[: n_win * T_WINDOW]
    h_ref, st_ref = run_reference(adcs, cfg)
    h_exp, d_exp = apply_slot_capacity(h_ref, TC, K)
    h_pal, st_pal, dropped = run_pallas(
        adcs, cfg, tc=TC, k_slots=K, window=T_WINDOW,
        block_sublanes=BLOCKS[blocks], time_packed=time_packed)
    assert len(h_ref) > 0
    assert d_exp > 0                          # the case exercises overflow
    assert dropped == d_exp
    np.testing.assert_array_equal(h_pal, h_exp)
    for k in st_ref:
        if k == "fir_phase":
            continue
        np.testing.assert_array_equal(np.asarray(st_pal[k]),
                                      np.asarray(st_ref[k]), err_msg=k)
