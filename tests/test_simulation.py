"""Physics-like simulation: algorithm behavior under realistic conditions."""

import numpy as np

from fdreadoutlibs_jax.ops import TPGConfig, Algorithm
from fdreadoutlibs_jax.ops.reference import run_reference
from fdreadoutlibs_jax.stream.simulation import (bipolar_pulse,
                                                 simulate_stream,
                                                 unipolar_pulse)


class TestPulseShapes:
    def test_unipolar_positive(self):
        p = unipolar_pulse(12, 500)
        assert p.max() == 500 and (p >= 0).all()

    def test_bipolar_zero_integral(self):
        p = bipolar_pulse(16, 500)
        assert p.max() > 0 and p.min() < 0
        assert abs(p.sum()) < 0.2 * np.abs(p).sum()


class TestAlgorithmPhysics:
    def test_absrs_recovers_induction_tracks_threshold_misses(self):
        """The reason AbsRS exists: bipolar induction pulses have weak
        single-sample excursions but a strong |s| running sum."""
        induction = np.ones(32, dtype=bool)
        adcs, truth = simulate_stream(
            2048, 32, seed=3, n_tracks=5, track_charge=260,
            white_noise=2.5, coherent_noise=2.0, induction_planes=induction)
        assert len(truth) > 8
        hit_channels = {c for c, _, _ in truth}

        thr_cfg = TPGConfig(threshold=400)          # above any single lobe
        rs_cfg = TPGConfig(algorithm=Algorithm.ABS_RS, threshold=130)
        h_thr, _ = run_reference(adcs, thr_cfg)
        h_rs, _ = run_reference(adcs, rs_cfg)
        found_rs = set(h_rs["channel"].tolist()) & hit_channels
        found_thr = set(h_thr["channel"].tolist()) & hit_channels
        # AbsRS recovers a markedly larger fraction of the deposited channels
        assert len(found_rs) > 2 * max(1, len(found_thr))

    def test_pedestal_tracks_coherent_noise(self):
        """The frugal pedestal absorbs the common-mode drift: a collection
        track stands out even under coherent noise."""
        collection = np.zeros(16, dtype=bool)
        adcs, truth = simulate_stream(
            2048, 16, seed=5, n_tracks=2, track_charge=800,
            coherent_noise=15.0, induction_planes=collection)
        cfg = TPGConfig(threshold=300)
        hits, state = run_reference(adcs, cfg)
        hit_channels = {c for c, _, _ in truth}
        assert hit_channels & set(hits["channel"].tolist())
        # pedestal settled near the true baseline despite the drift
        assert np.abs(np.asarray(state["pedestals"]) - 900).max() < 80

    def test_truth_matching(self):
        """Most deposited collection pulses are found with sane times."""
        collection = np.zeros(24, dtype=bool)
        adcs, truth = simulate_stream(
            4096, 24, seed=7, n_tracks=4, track_charge=700,
            induction_planes=collection)
        cfg = TPGConfig(threshold=250)
        hits, _ = run_reference(adcs, cfg)
        matched = 0
        for c, t, amp in truth:
            hc = hits[hits["channel"] == c]
            begin = hc["end_tick"] - hc["tover"]
            if ((np.abs(begin - t) < 8)).any():
                matched += 1
        assert matched >= 0.7 * len(truth)
