"""Randomized-config semantic fuzz: oracle vs XLA-scan backend.

The fixed-seed parity suites (test_tpg_scan/test_tpg_fir) pin specific
configurations; this sweep draws the CONFIG SPACE at random — algorithm,
thresholds, accumulator limit, scale factor, mixed per-channel memory
factors, peak tracking — and additionally splits the stream at UNEVEN
random batch boundaries, asserting hits and carried state are identical
to the whole-run oracle.  Seeds are fixed per case so failures reproduce.
"""

import numpy as np
import pytest

from fdreadoutlibs_jax.ops import Algorithm, TPGConfig
from fdreadoutlibs_jax.ops.chanstate import init_chanstate, seed_chanstate
from fdreadoutlibs_jax.ops.hits import concat_hits, decode_dense
from fdreadoutlibs_jax.ops.reference import run_reference
from fdreadoutlibs_jax.ops.scan import process_window_scan, state_to_jnp

T, C = 192, 40


def _case(seed):
    rng = np.random.default_rng(seed)
    alg = Algorithm(rng.choice(["SimpleThreshold", "AbsRS", "StandardRS",
                                "FIR"]))
    fir = alg == Algorithm.FIR
    cfg = TPGConfig(
        algorithm=alg,
        threshold=int(rng.integers(3, 9)) if fir
        else int(rng.integers(80, 301)),
        accumulator_limit=int(rng.choice([5, 10, 20])),
        rs_scale_factor_x10=int(rng.choice([5, 10, 20])),
        track_peaks=bool(rng.integers(0, 2)) if fir else True,
    )
    rmf = rng.choice([0, 2, 8, 10], size=C).astype(np.int32)
    noise = int(rng.integers(3, 31))
    adcs = (900 + rng.normal(0, noise, size=(T, C))).astype(np.int32)
    for _ in range(30):
        c, t = rng.integers(0, C), rng.integers(1, T - 12)
        adcs[t:t + rng.integers(2, 10), c] += rng.integers(150, 4000)
    adcs = np.clip(adcs, 0, (1 << 14) - 1)
    # uneven batch boundaries (2-4 splits at arbitrary ticks)
    cuts = np.sort(rng.choice(np.arange(8, T - 8), size=rng.integers(2, 5),
                              replace=False))
    return cfg, rmf, adcs, [0, *cuts.tolist(), T]


@pytest.mark.parametrize("seed", [101, 202, 303, 404, 505,
                                  606, 707, 808, 909, 1010])
def test_random_config_uneven_batches(seed):
    cfg, rmf, adcs, bounds = _case(seed)
    h_ref, st_ref = run_reference(adcs, cfg, rs_memory_factor=rmf)
    state = state_to_jnp(seed_chanstate(init_chanstate(C), adcs[0], rmf))
    parts = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        closed, records, state = process_window_scan(adcs[a:b], state, cfg)
        parts.append(decode_dense(closed, records, tick_offset=a))
    h_scan = concat_hits(parts)
    np.testing.assert_array_equal(h_scan, h_ref), (cfg, bounds)
    for k, v in st_ref.items():
        if k in state:
            np.testing.assert_array_equal(np.asarray(state[k]), v,
                                          err_msg=f"{cfg} state[{k}]")


@pytest.mark.parametrize("seed", [101, 404, 707])  # 404 draws FIR
def test_random_config_pallas_interpret(seed):
    """One fuzz case also through the Pallas kernel (interpret mode,
    uneven 2-window split) — the same randomized config space reaches
    the third backend, at every channel-block width."""
    import jax.numpy as jnp

    from fdreadoutlibs_jax.ops.pallas_tpg import (decode_pallas_hits,
                                                  pack_adcs, pack_state,
                                                  process_window_pallas)
    cfg, rmf, adcs, bounds = _case(seed)
    h_ref, st_ref = run_reference(adcs, cfg, rs_memory_factor=rmf)
    packed = pack_adcs(adcs)
    cut = bounds[len(bounds) // 2]              # one uneven split
    for sub in (1, 8):
        stack = pack_state(seed_chanstate(init_chanstate(C), adcs[0], rmf),
                           C, block_sublanes=sub)
        parts, dropped = [], 0
        for a, b in ((0, cut), (cut, T)):
            slots, nclose, stack = process_window_pallas(
                jnp.asarray(packed[a:b]), stack, cfg, tc=b - a, k_slots=32,
                interpret=True)
            h, d = decode_pallas_hits(slots, nclose, C, tick_offset=a)
            parts.append(h)
            dropped += d
        assert dropped == 0
        np.testing.assert_array_equal(concat_hits(parts), h_ref,
                                      err_msg=f"block_sublanes={sub}")
