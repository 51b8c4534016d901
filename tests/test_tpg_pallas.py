"""Pallas kernel bit-exactness vs the numpy oracle (interpret mode on the
CPU; the same kernel runs compiled on the GPU in chip_smoke.py)."""

import numpy as np
import pytest

from fdreadoutlibs_jax.ops import TPGConfig, Algorithm
from fdreadoutlibs_jax.ops import patterns
from fdreadoutlibs_jax.ops.chanstate import init_chanstate, seed_chanstate
from fdreadoutlibs_jax.ops.hits import concat_hits
from fdreadoutlibs_jax.ops.reference import run_reference
from fdreadoutlibs_jax.ops.pallas_tpg import (
    pack_adcs, pack_adcs_time2, pack_state, unpack_state,
    process_window_pallas, decode_pallas_hits)
from tests.test_tpg_scan import random_stream


def run_pallas(adcs, cfg, rs_memory_factor=None, tc=32, k_slots=8,
               window=None, block_sublanes=None, time_packed=False):
    """Pallas-backend equivalent of reference.run_reference (interpret
    mode).  Returns (hits, state, dropped)."""
    import jax.numpy as jnp
    adcs = np.asarray(adcs, dtype=np.int32)
    T, C = adcs.shape
    if rs_memory_factor is None:
        rs_memory_factor = cfg.rs_memory_factor_x10
    state = seed_chanstate(init_chanstate(C), adcs[0], rs_memory_factor)
    packed = pack_adcs_time2(adcs) if time_packed else pack_adcs(adcs)
    rows = 2 if time_packed else 1
    stack = pack_state(state, C, block_sublanes=block_sublanes)
    window = window or T
    parts = []
    dropped = 0
    for t0 in range(0, T, window):
        slots, nclose, stack = process_window_pallas(
            jnp.asarray(packed[t0 // rows:(t0 + window) // rows]), stack,
            cfg, tc=tc, k_slots=k_slots, interpret=True,
            unroll=2 if time_packed else 1, time_packed=time_packed)
        h, d = decode_pallas_hits(slots, nclose, C, tick_offset=t0)
        parts.append(h)
        dropped += d
    return concat_hits(parts), unpack_state(stack, C), dropped


CONFIGS = [
    TPGConfig(algorithm=Algorithm.SIMPLE_THRESHOLD, threshold=120),
    TPGConfig(algorithm=Algorithm.ABS_RS, threshold=150),
    TPGConfig(algorithm=Algorithm.STANDARD_RS, threshold=150),
]


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c.algorithm.value)
def test_pallas_matches_reference(cfg):
    adcs = random_stream(128, 48, seed=21)      # pads 48 -> 128 lanes
    h_ref, st_ref = run_reference(adcs, cfg, window=128)
    h_pal, st_pal, dropped = run_pallas(adcs, cfg)
    assert dropped == 0
    assert len(h_ref) > 0
    np.testing.assert_array_equal(h_pal, h_ref)
    for k in st_ref:
        if k in ("fir_prev", "fir_phase"):
            continue
        np.testing.assert_array_equal(st_pal[k], np.asarray(st_ref[k]),
                                      err_msg=k)


def test_pallas_multiblock():
    """More channels than one block: exercises the block grid axis."""
    C = 1024 + 256
    adcs = random_stream(64, C, seed=23, n_signals=300)
    cfg = TPGConfig(threshold=120)
    h_ref, _ = run_reference(adcs, cfg)
    h_pal, _, dropped = run_pallas(adcs, cfg, block_sublanes=8, k_slots=16)
    assert dropped == 0
    np.testing.assert_array_equal(h_pal, h_ref)
    assert h_ref["channel"].max() >= 1024  # hits beyond the first block


def test_pallas_state_carry_across_calls():
    """Hits spanning kernel launches close correctly (window invariance)."""
    adcs = patterns.golden(n_frames=4, channel=11, offset=60)
    cfg = TPGConfig(threshold=patterns.GOLDEN_THRESHOLD)
    h_ref, _ = run_reference(adcs, cfg)
    h_one, _, _ = run_pallas(adcs, cfg, tc=64)                # one launch
    h_many, _, _ = run_pallas(adcs, cfg, tc=64, window=64)    # 4 launches
    np.testing.assert_array_equal(h_one, h_ref)
    np.testing.assert_array_equal(h_many, h_ref)


def test_pallas_slot_overflow_counts():
    """Closes beyond k_slots per channel per window are dropped and counted."""
    adcs = random_stream(256, 16, seed=29, n_signals=120)
    cfg = TPGConfig(threshold=80)
    h_ref, _ = run_reference(adcs, cfg)
    per_chan = np.bincount(h_ref["channel"], minlength=16)
    assert per_chan.max() > 2
    k = 2
    h_pal, _, dropped = run_pallas(adcs, cfg, tc=256, k_slots=k)
    assert dropped == int(np.maximum(per_chan - k, 0).sum())
    # the kept hits are each channel's first k closes
    kept = []
    for c in range(16):
        hc = h_ref[h_ref["channel"] == c]
        kept.append(hc[np.argsort(hc["end_tick"])][:k])
    np.testing.assert_array_equal(h_pal, concat_hits(kept))


def test_pallas_slot_capacity_scales_with_window():
    """Per-chunk slot buffers: a channel closing far more than k_slots hits
    across a long window loses NOTHING as long as each tc-tick chunk holds
    <= k_slots closes (VERDICT round-1 item 4; the reference's shared 100k
    buffer never drops per channel, WIBEthFrameProcessor.cpp:78)."""
    T, C = 512, 8
    rng = np.random.default_rng(31)
    adcs = (900 + rng.normal(0, 5, size=(T, C))).astype(np.int32)
    # channel 3: one hit every 32 ticks -> 16 hits in the window
    for t0 in range(8, T - 8, 32):
        adcs[t0:t0 + 4, 3] += 2000
    cfg = TPGConfig(threshold=150)
    h_ref, _ = run_reference(adcs, cfg)
    assert (h_ref["channel"] == 3).sum() == 16
    # k_slots=1 with tc=32: one slot per chunk is enough for all 16 hits
    h_pal, _, dropped = run_pallas(adcs, cfg, tc=32, k_slots=1)
    assert dropped == 0
    np.testing.assert_array_equal(h_pal, h_ref)


def test_pallas_slot_overflow_within_chunk_counts():
    """Two closes in ONE tc-chunk with k_slots=1 drop exactly one, and the
    drop is visible in the counts."""
    T, C = 64, 4
    adcs = np.full((T, C), 900, np.int32)
    adcs[10:12, 2] += 2000
    adcs[20:22, 2] += 2000     # same chunk (tc=64)
    cfg = TPGConfig(threshold=150)
    h_pal, _, dropped = run_pallas(adcs, cfg, tc=64, k_slots=1)
    assert dropped == 1
    assert len(h_pal[h_pal["channel"] == 2]) == 1


def test_rs_mf_shift_specialization_bitexact():
    """rs_mf_shift (masked-shift memory-factor multiply) is bit-exact vs
    the generic mullo path for mf in {0, 8}, across oracle and Pallas."""
    adcs = random_stream(128, 32, seed=77, n_signals=20)
    rmf = np.where(np.arange(32) % 3 == 0, 0, 8)
    for alg in (Algorithm.ABS_RS, Algorithm.STANDARD_RS):
        generic = TPGConfig(algorithm=alg, threshold=150)
        spec = TPGConfig(algorithm=alg, threshold=150, rs_mf_shift=3)
        h_g, st_g = run_reference(adcs, generic, rs_memory_factor=rmf)
        h_s, st_s = run_reference(adcs, spec, rs_memory_factor=rmf)
        np.testing.assert_array_equal(h_s, h_g)
        np.testing.assert_array_equal(np.asarray(st_s["rs"]),
                                      np.asarray(st_g["rs"]))
        h_p, _, _ = run_pallas(adcs, spec, rs_memory_factor=rmf)
        np.testing.assert_array_equal(h_p, h_g)


def test_from_raw_auto_enables_mf_shift():
    cfg = TPGConfig.from_raw("AbsRS", rs_memory_factor=0.8)
    assert cfg.rs_mf_shift == 3 and cfg.rs_memory_factor_x10 == 8
    cfg7 = TPGConfig.from_raw("AbsRS", rs_memory_factor=0.7)
    assert cfg7.rs_mf_shift is None       # 7 is not a power of two


def test_pallas_mixed_memory_factor():
    """Per-channel RS memory factors (threshold-on-collection mixing,
    WIBEthFrameProcessor.cpp:441-450) through the Pallas kernel."""
    adcs = random_stream(128, 32, seed=51, n_signals=15)
    rmf = np.where(np.arange(32) % 2 == 0, 0, 8)   # even channels memoryless
    cfg = TPGConfig(algorithm=Algorithm.ABS_RS, threshold=150)
    h_ref, _ = run_reference(adcs, cfg, rs_memory_factor=rmf, window=128)
    h_pal, _, dropped = run_pallas(adcs, cfg, rs_memory_factor=rmf)
    assert dropped == 0 and len(h_ref) > 0
    np.testing.assert_array_equal(h_pal, h_ref)


def test_time_packed_matches_unpacked():
    """time_packed=True (two samples per int32 word, half the ADC bytes)
    is bit-exact vs the plain layout for every algorithm family."""
    import jax.numpy as jnp
    from fdreadoutlibs_jax.ops.config import Algorithm
    from fdreadoutlibs_jax.ops.pallas_tpg import (decode_pallas_hits,
                                                  pack_adcs, pack_adcs_time2,
                                                  pack_state,
                                                  process_window_pallas)
    rng = np.random.default_rng(21)
    C, T = 200, 128
    for alg in Algorithm:
        cfg = TPGConfig(algorithm=alg,
                        threshold=60 if alg == Algorithm.FIR else 150)
        adcs = (800 + rng.normal(0, 25, (T, C))).astype(np.int32)
        for _ in range(20):
            c, t = rng.integers(0, C), rng.integers(0, T - 10)
            adcs[t:t + 9, c] += rng.integers(300, 1500)
        st = seed_chanstate(init_chanstate(C), adcs[0],
                            cfg.rs_memory_factor_x10)
        stack = pack_state(st, C)
        a = process_window_pallas(jnp.asarray(pack_adcs(adcs)), stack, cfg,
                                  tc=64, k_slots=8, interpret=True, unroll=1)
        b = process_window_pallas(jnp.asarray(pack_adcs_time2(adcs)), stack,
                                  cfg, tc=64, k_slots=8, interpret=True,
                                  unroll=2, time_packed=True)
        ha, da = decode_pallas_hits(a[0], a[1], C)
        hb, db = decode_pallas_hits(b[0], b[1], C)
        np.testing.assert_array_equal(ha, hb)
        assert da == db
        np.testing.assert_array_equal(np.asarray(a[2]), np.asarray(b[2]))
