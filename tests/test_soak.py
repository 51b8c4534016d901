"""Long-stream soak tests: state stability and chunking invariance over
tens of thousands of ticks (the streaming regimes the reference only ever
meets in deployment)."""

import numpy as np
import pytest

from fdreadoutlibs_jax.ops import TPGConfig, Algorithm
from tests.test_tpg_scan import random_stream, run_scan


@pytest.mark.parametrize("alg", [Algorithm.SIMPLE_THRESHOLD,
                                 Algorithm.ABS_RS, Algorithm.FIR])
def test_long_stream_state_stability(alg):
    """32k ticks with slow pedestal drift: the frugal pedestal must track,
    hit production must not diverge, state stays in int16 range."""
    T, C = 32_768, 8
    rng = np.random.default_rng(7)
    drift = np.linspace(0, 600, T)[:, None]          # slow upward drift
    adcs = (900 + drift + rng.normal(0, 15, size=(T, C))).astype(np.int32)
    for t0 in range(1000, T - 40, 2048):
        adcs[t0:t0 + 12, rng.integers(0, C)] += 800
    cfg = TPGConfig(algorithm=alg, threshold=200 if alg != Algorithm.FIR else 5)
    hits, state = run_scan(adcs, cfg, window=2048)
    # pedestal tracked the drift
    ped = np.asarray(state["pedestals"])
    assert (np.abs(ped - (900 + 600)) < 60).all()
    # every signal window produced hits; no runaway hit inflation
    assert 10 <= len(hits) <= 400
    # all state fields remain int16-representable
    for k, v in state.items():
        v = np.asarray(v)
        assert v.max() <= 32767 and v.min() >= -32768, k


def test_chunking_invariance_long():
    adcs = random_stream(8192, 16, seed=9, noise=25, base=1200, n_signals=200)
    cfg = TPGConfig(algorithm=Algorithm.STANDARD_RS, threshold=140)
    h_a, _ = run_scan(adcs, cfg, window=512)
    h_b, _ = run_scan(adcs, cfg, window=8192)
    np.testing.assert_array_equal(h_a, h_b)
