"""Golden-pattern and semantics tests for the numpy SWTPG oracle."""

import numpy as np

from fdreadoutlibs_jax.ops import TPGConfig, Algorithm, fixedpoint
from fdreadoutlibs_jax.ops import patterns
from fdreadoutlibs_jax.ops.reference import run_reference
from fdreadoutlibs_jax.ops.chanstate import init_chanstate, seed_chanstate


class TestFixedPoint:
    def test_mulhrs_matches_avx_div(self):
        # div by 10 via mulhrs(x, 3276): spot values incl. rounding quirks
        for x in [0, 1, 5, 9, 10, 11, 99, 100, 1000, 32767, -1, -10, -32768]:
            got = fixedpoint.div16_const(np.int32(x), 10)
            # exact scalar emulation of _mm256_mulhrs_epi16(x, 3276)
            prod = np.int64(x) * 3276
            expect = ((prod >> 14) + 1) >> 1
            expect = ((expect + 32768) & 0xFFFF) - 32768
            assert got == expect, x

    def test_wrap_and_sat(self):
        assert fixedpoint.wrap_i16(np.int32(32768)) == -32768
        assert fixedpoint.wrap_i16(np.int32(-32769)) == 32767
        assert fixedpoint.sat_i16(np.int32(40000)) == 32767
        assert fixedpoint.adds16(np.int32(32000), np.int32(2000)) == 32767

    def test_mullo_wraps(self):
        assert fixedpoint.mullo16(np.int32(3000), np.int32(100)) == \
            ((3000 * 100 + 32768) & 0xFFFF) - 32768

    def test_rs_div10_unwrapped_matches_composed_form(self):
        """The depth-optimized RS tail (deferred wraps, fused rounding add,
        dropped output wrap) is bit-identical to div16_const(wrap(x), 10)
        over the full int16 domain and congruent int32 aliases."""
        base = np.arange(-32768, 32768, dtype=np.int64)
        for offset in (0, 1 << 16, -(1 << 16), 3 << 16, -(7 << 16)):
            x = (base + offset).astype(np.int32)
            got = fixedpoint.rs_div10_unwrapped(x)
            expect = fixedpoint.div16_const(fixedpoint.wrap_i16(x), 10)
            np.testing.assert_array_equal(got, expect)
        # mulhrs result range claim that justifies dropping the final wrap
        assert fixedpoint.rs_div10_unwrapped(np.int32(-32768)) == -3276
        assert fixedpoint.rs_div10_unwrapped(np.int32(32767)) == 3276


class TestGoldenPattern:
    """docs/README.md:123-146: golden hill, threshold 499."""

    def test_first_hit_parameters(self):
        adcs = patterns.golden(n_frames=1, channel=3, offset=1)
        cfg = TPGConfig(algorithm=Algorithm.SIMPLE_THRESHOLD,
                        threshold=patterns.GOLDEN_THRESHOLD)
        hits, _ = run_reference(adcs, cfg)
        assert len(hits) == 1
        h = hits[0]
        assert h["channel"] == 3
        # hill occupies ticks 1..9 (9 samples over threshold on zero pedestal)
        assert h["tover"] == 9
        assert h["end_tick"] == 10          # first not-over tick
        assert h["charge"] == 4528          # docs: adc sum 4528
        assert h["peak_adc"] == 506         # docs: peak 506
        assert h["peak_time"] == 4          # peak is the 5th over-sample
        # absolute-time identity: begin = end - tover = offset
        assert h["end_tick"] - h["tover"] == 1

    def test_one_hit_per_frame(self):
        adcs = patterns.golden(n_frames=4, channel=0, offset=5)
        cfg = TPGConfig(threshold=patterns.GOLDEN_THRESHOLD)
        hits, _ = run_reference(adcs, cfg)
        assert len(hits) == 4
        # pedestal creep: later hits lose a bit of charge but stay hits
        assert (hits["charge"] >= 4000).all()
        assert (hits["peak_adc"] >= 500).all()

    def test_windowing_invariance(self):
        """Hits must not depend on how the stream is chunked (state carry)."""
        adcs = patterns.golden(n_frames=4, channel=7, offset=60)  # spans frames
        cfg = TPGConfig(threshold=patterns.GOLDEN_THRESHOLD)
        h64, _ = run_reference(adcs, cfg, window=64)
        h16, _ = run_reference(adcs, cfg, window=16)
        h256, _ = run_reference(adcs, cfg, window=256)
        np.testing.assert_array_equal(h64, h16)
        np.testing.assert_array_equal(h64, h256)


class TestEdgePatterns:
    def test_edge_square_spans_boundary(self):
        adcs = patterns.edge_square(amplitude=1000, width=16)
        cfg = TPGConfig(threshold=500)
        hits, _ = run_reference(adcs, cfg, window=64)
        assert len(hits) == 1
        h = hits[0]
        assert h["tover"] == 16
        assert h["end_tick"] == 64 + 8      # closes 8 ticks into frame 1
        # pedestal creeps +1 after 11 consecutive over-samples (acc limit 10):
        # 10 ticks at 1000 + 6 ticks at 999
        assert h["charge"] == 10 * 1000 + 6 * 999

    def test_edge_left_right_peaks(self):
        cfg = TPGConfig(threshold=400)
        hl, _ = run_reference(patterns.edge_left(), cfg)
        hr, _ = run_reference(patterns.edge_right(), cfg)
        assert len(hl) == 1 and len(hr) == 1
        # peak tick = end - tover + peak_time
        peak_l = hl[0]["end_tick"] - hl[0]["tover"] + hl[0]["peak_time"]
        peak_r = hr[0]["end_tick"] - hr[0]["tover"] + hr[0]["peak_time"]
        assert peak_l == 61 and peak_r == 66

    def test_pulse(self):
        adcs = patterns.pulse(tick=20, amplitude=5000, channel=9)
        cfg = TPGConfig(threshold=2000)
        hits, _ = run_reference(adcs, cfg)
        assert len(hits) == 1
        assert hits[0]["channel"] == 9
        assert hits[0]["tover"] == 1
        assert hits[0]["charge"] == 5000
        assert hits[0]["end_tick"] == 21


class TestRSAlgorithms:
    def test_absrs_finds_golden_hit(self):
        adcs = patterns.golden(n_frames=2, channel=1, offset=10, pedestal=800)
        cfg = TPGConfig(algorithm=Algorithm.ABS_RS, threshold=100)
        hits, _ = run_reference(adcs, cfg)
        assert len(hits) >= 1
        assert (hits["channel"] == 1).all()

    def test_standardrs_differs_from_absrs_on_negative(self):
        """StandardRS (signed) decays on negative excursions; AbsRS grows."""
        T, C = 128, 4
        adcs = np.full((T, C), 1000, dtype=np.int32)
        adcs[20:40, 0] = 700     # negative excursion
        abs_cfg = TPGConfig(algorithm=Algorithm.ABS_RS, threshold=120)
        std_cfg = TPGConfig(algorithm=Algorithm.STANDARD_RS, threshold=120)
        habs, _ = run_reference(adcs, abs_cfg)
        hstd, _ = run_reference(adcs, std_cfg)
        assert len(habs) >= 1      # |s| accumulates -> crosses threshold
        assert len(hstd) == 0      # signed sum goes negative, no hit

    def test_per_channel_memory_factor(self):
        """R=0 on 'collection' channels reduces AbsRS to scaled threshold
        (enable_simple_threshold_on_collection, WIBEthFrameProcessor.cpp:441-450)."""
        adcs = patterns.golden(n_frames=1, channel=0, offset=4)
        adcs[:, 1] = adcs[:, 0]   # same signal on ch 1
        cfg = TPGConfig(algorithm=Algorithm.ABS_RS, threshold=240)
        rmf = np.array([0, 8] + [8] * 62)   # ch0 memoryless
        hits, _ = run_reference(adcs, cfg, rs_memory_factor=rmf)
        h0 = hits[hits["channel"] == 0]
        h1 = hits[hits["channel"] == 1]
        assert len(h0) == 1 and len(h1) == 1
        # memoryless channel's RS ~ |s|/2, decaying channel accumulates more
        assert h1[0]["tover"] >= h0[0]["tover"]

    def test_naive_float_rs_close_to_fixed_point(self):
        """ProcessNaiveRS float semantics vs AVX x10 fixed point: same hits
        on a clean pattern (they are distinct implementations upstream)."""
        adcs = patterns.golden(n_frames=2, channel=2, offset=20)
        fixed = TPGConfig(algorithm=Algorithm.ABS_RS, threshold=100)
        flt = TPGConfig(algorithm=Algorithm.ABS_RS, threshold=100, rs_float=True)
        hf, _ = run_reference(adcs, fixed)
        hn, _ = run_reference(adcs, flt)
        assert len(hf) == len(hn)
        np.testing.assert_array_equal(hf["channel"], hn["channel"])


class TestStateSemantics:
    def test_seed_state(self):
        st = init_chanstate(4)
        st = seed_chanstate(st, [100, 200, 300, 400], 8)
        np.testing.assert_array_equal(st["pedestals"], [100, 200, 300, 400])
        np.testing.assert_array_equal(st["quantile25"], [80, 180, 280, 380])
        np.testing.assert_array_equal(st["quantile75"], [120, 220, 320, 420])
        assert (st["rs_memory_factor"] == 8).all()

    def test_peak_gated_vs_ungated(self):
        """AVX updates the peak ungated (ProcessAVX2.hpp:134-136 has no
        is_over gate; ProcessNaive.hpp:100-103 gates it).  For SimpleThreshold
        the two coincide (is_over and the peak track the same value); for the
        RS family they diverge: is_over is on the RS waveform while the peak
        tracks the pedestal-subtracted ADC, so a big isolated spike that does
        not push the RS over threshold still pollutes peak_adc in AVX mode."""
        T, C = 128, 1
        adcs = np.zeros((T, C), dtype=np.int32)
        adcs[5, 0] = 300                 # spike: RS bump ~150, no hit
        adcs[20:60, 0] = 100             # sustained: RS builds to a hit
        cfg_avx = TPGConfig(algorithm=Algorithm.ABS_RS, threshold=200,
                            peak_gated=False)
        cfg_naive = TPGConfig(algorithm=Algorithm.ABS_RS, threshold=200,
                              peak_gated=True)
        ha, _ = run_reference(adcs, cfg_avx)
        hn, _ = run_reference(adcs, cfg_naive)
        assert len(ha) == 1 and len(hn) == 1
        assert ha[0]["peak_adc"] == 300    # polluted by the pre-hit spike
        assert hn[0]["peak_adc"] == 100    # gated: only while over threshold
        assert ha[0]["charge"] == hn[0]["charge"]  # charge unaffected
