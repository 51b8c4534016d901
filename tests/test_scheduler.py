"""Multi-APA time-multiplexing scheduler (apps/scheduler.py)."""

import numpy as np

from fdreadoutlibs_jax.apps.scheduler import MultiAPAScheduler
from fdreadoutlibs_jax.formats import wibeth
from fdreadoutlibs_jax.ops import TPGConfig
from fdreadoutlibs_jax.ops.chanstate import init_chanstate, seed_chanstate
from fdreadoutlibs_jax.ops.hits import sort_hits
from fdreadoutlibs_jax.ops.reference import process_window_reference


def _make_batch(rng, n_links, n_frames, hot=None):
    frames = np.zeros((n_links, n_frames, wibeth.FRAME_SIZE), np.uint8)
    adcs = (800 + rng.normal(0, 8, (n_links, n_frames, 64, 64))) \
        .astype(np.uint16)
    if hot is not None:
        l, c, t = hot
        adcs[l, 0, t:t + 9, c] += np.array(
            [500, 502, 504, 505, 506, 505, 504, 502, 500], np.uint16)
    for l in range(n_links):
        wibeth.set_adcs(frames[l], adcs[l])
    return frames, adcs


def test_two_apas_interleaved_bit_exact():
    """Interleaved submits from two APAs keep their streams independent and
    both match the single-stream numpy oracle, including state carried
    across the APA's own batches (the other APA's batches in between)."""
    rng = np.random.default_rng(0)
    L, NF, NB = 2, 2, 3
    C = L * 64
    cfg = TPGConfig(threshold=480)
    sched = MultiAPAScheduler(cfg, n_apas=2, n_links=L, interpret=True,
                              k_slots=4)

    per_apa_adcs = {0: [], 1: []}
    got = {0: [], 1: []}
    for b in range(NB):
        for apa in range(2):
            hot = (apa, 3 + apa, 10 * (b + 1)) if b != 1 else None
            frames, adcs = _make_batch(rng, L, NF, hot=hot)
            per_apa_adcs[apa].append(adcs)
            out = sched.submit(apa, frames)
            if out is not None:
                got[apa].append(out[0])
    for apa, (hits, dropped) in sched.flush().items():
        got[apa].append(hits)
        assert dropped == 0

    for apa in range(2):
        stream = np.concatenate(
            [a.transpose(1, 2, 0, 3).reshape(NF * 64, C)
             for a in per_apa_adcs[apa]]).astype(np.int32)
        state = seed_chanstate(init_chanstate(C), stream[0],
                               cfg.rs_memory_factor_x10)
        ref_hits, _ = process_window_reference(stream, state, cfg)
        assert len(ref_hits) == 2          # one pulse in batches 0 and 2
        mine = sort_hits(np.concatenate(got[apa]))
        np.testing.assert_array_equal(mine, sort_hits(ref_hits))
        # hits landed on this APA's hot channel only
        assert set(mine["channel"]) == {apa * 64 + 3 + apa}

    info = sched.get_info()
    assert info["batches"] == [NB, NB]
    assert info["ticks"] == [NB * NF * 64, NB * NF * 64]


def test_per_channel_memory_factors():
    """Scheduler seeds per-APA state with shared per-channel memory factors
    (production threshold-on-collection), matching the oracle."""
    rng = np.random.default_rng(3)
    L = 1
    C = L * 64
    cfg = TPGConfig.from_raw("AbsRS", threshold=150)
    rmf = np.where(np.arange(C) % 2 == 0, 0, cfg.rs_memory_factor_x10)
    sched = MultiAPAScheduler(cfg, n_apas=1, n_links=L, tc=64, k_slots=8,
                              interpret=True, rs_memory_factor=rmf)
    frames, adcs = _make_batch(rng, L, 1, hot=(0, 5, 10))
    sched.submit(0, frames)
    hits, dropped = sched.flush()[0]
    stream = adcs.reshape(L, 64, 64).transpose(1, 0, 2) \
        .reshape(64, C).astype(np.int32)
    st = seed_chanstate(init_chanstate(C), stream[0], rmf)
    ref, _ = process_window_reference(stream, st, cfg)
    assert len(ref) > 0 and dropped == 0
    np.testing.assert_array_equal(sort_hits(hits), sort_hits(ref))
    import pytest
    with pytest.raises(ValueError, match="rs_memory_factor"):
        MultiAPAScheduler(cfg, n_apas=1, n_links=L,
                          rs_memory_factor=rmf[:5])


def test_geometry_mismatch_rejected():
    sched = MultiAPAScheduler(TPGConfig(), n_apas=1, n_links=4,
                              interpret=True)
    frames = np.zeros((2, 1, wibeth.FRAME_SIZE), np.uint8)
    try:
        sched.submit(0, frames)
        assert False, "expected ValueError"
    except ValueError as e:
        assert "expected 4 links" in str(e)


def test_random_interleaving_keeps_streams_isolated():
    """APAs submitted in a random, unfair order (including back-to-back
    repeats) still produce per-stream oracle-exact hits."""
    rng = np.random.default_rng(5)
    L, NF = 1, 2
    C = L * 64
    cfg = TPGConfig(threshold=480)
    n_apas = 3
    sched = MultiAPAScheduler(cfg, n_apas=n_apas, n_links=L, interpret=True,
                              k_slots=4)
    per_apa_adcs = {a: [] for a in range(n_apas)}
    got = {a: [] for a in range(n_apas)}
    order = list(rng.integers(0, n_apas, size=18))
    # make sure every APA appears at least twice
    order += [0, 0, 1, 1, 2, 2]
    for apa in order:
        b = len(per_apa_adcs[apa])
        hot = (0, apa, 20 + 3 * b) if b % 2 == 0 else None
        frames, adcs = _make_batch(rng, L, NF, hot=hot)
        per_apa_adcs[apa].append(adcs)
        out = sched.submit(apa, frames)
        if out is not None:
            got[apa].append(out[0])
    for apa, (hits, _) in sched.flush().items():
        got[apa].append(hits)

    for apa in range(n_apas):
        stream = np.concatenate(
            [a.transpose(1, 2, 0, 3).reshape(NF * 64, C)
             for a in per_apa_adcs[apa]]).astype(np.int32)
        state = seed_chanstate(init_chanstate(C), stream[0],
                               cfg.rs_memory_factor_x10)
        ref_hits, _ = process_window_reference(stream, state, cfg)
        mine = sort_hits(np.concatenate(got[apa])) if got[apa] else ref_hits[:0]
        np.testing.assert_array_equal(mine, sort_hits(ref_hits))
        assert set(ref_hits["channel"]) <= {apa}
