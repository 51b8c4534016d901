"""FIR+IQR family tests: filter design, oracle behavior, backend parity."""

import numpy as np

from fdreadoutlibs_jax.ops import TPGConfig, Algorithm
from fdreadoutlibs_jax.ops.fir import default_taps, firwin, firwin_int
from fdreadoutlibs_jax.ops.reference import run_reference
from tests.test_tpg_scan import random_stream, run_scan
from tests.test_tpg_pallas import run_pallas

FIR_CFG = TPGConfig(algorithm=Algorithm.FIR, threshold=5, tap_exponent=6)


class TestFilterDesign:
    def test_firwin_normalized(self):
        taps = firwin(7, 0.1)
        assert abs(sum(taps) - 1.0) < 1e-12
        np.testing.assert_allclose(taps, taps[::-1])   # symmetric lowpass

    def test_firwin_int_production_taps(self):
        """firwin_int(7, 0.1, 64) — the taps WIB2 installs
        (WIB2FrameProcessor.cpp:93-94)."""
        taps = firwin_int(7, 0.1, 64)
        assert taps == [1, 6, 15, 20, 15, 6, 1]
        assert sum(taps) == 64

    def test_default_taps_appends_zero(self):
        taps = default_taps(FIR_CFG)
        assert len(taps) == 8 and taps[-1] == 0


class TestFIROracle:
    def test_quiet_stream_no_hits(self):
        adcs = np.full((256, 16), 900, dtype=np.int32)
        hits, st = run_reference(adcs, FIR_CFG)
        assert len(hits) == 0

    def test_pulse_found_with_dynamic_threshold(self):
        """A pulse well above the noise IQR fires; threshold is in sigma
        units so the same pulse on a noisier channel must not fire."""
        rng = np.random.default_rng(0)
        T, C = 512, 16
        quiet = (900 + rng.normal(0, 2, size=(T, C)))
        noisy = (900 + rng.normal(0, 60, size=(T, C)))
        adcs = quiet.astype(np.int32)
        adcs[:, 8:] = noisy[:, 8:].astype(np.int32)
        adcs[300:306, 2] += 150    # pulse on quiet channel
        adcs[300:306, 10] += 150   # same pulse on noisy channel
        hits, _ = run_reference(adcs, FIR_CFG)
        assert (hits["channel"] == 2).any()
        assert not (hits["channel"] == 10).any()

    def test_charge_uses_tap_exponent(self):
        """charge adds filt >> tap_exponent: a clean rectangular pulse of
        height A gives charge ~ sum(filtered)/64 ~ n_over * A."""
        adcs = np.full((512, 4), 1000, dtype=np.int32)
        adcs[200:220, 1] += 400
        hits, _ = run_reference(adcs, FIR_CFG)
        h = hits[hits["channel"] == 1]
        assert len(h) == 1
        # filtered plateau = 400 * 64 >> 6 = 400 per sample; edges ramp
        assert 0.5 * 20 * 400 < h[0]["charge"] <= 20 * 400

    def test_avx_vs_naive_threshold_semantics(self):
        """fir_avx_semantics clamps sigma and wraps the int16 product; with
        threshold=5 and small sigma both agree."""
        adcs = random_stream(256, 8, seed=3, noise=3, base=800, n_signals=6)
        avx = TPGConfig(algorithm=Algorithm.FIR, threshold=5,
                        fir_avx_semantics=True)
        naive = TPGConfig(algorithm=Algorithm.FIR, threshold=5,
                          fir_avx_semantics=False)
        ha, _ = run_reference(adcs, avx)
        hn, _ = run_reference(adcs, naive)
        np.testing.assert_array_equal(ha, hn)


class TestFIRBackendParity:
    def test_scan_matches_reference(self):
        adcs = random_stream(256, 32, seed=31, noise=4, base=900,
                             n_signals=60, )
        h_ref, st_ref = run_reference(adcs, FIR_CFG)
        h_scan, st_scan = run_scan(adcs, FIR_CFG)
        assert len(h_ref) > 0
        np.testing.assert_array_equal(h_scan, h_ref)
        np.testing.assert_array_equal(np.asarray(st_scan["fir_prev"]),
                                      st_ref["fir_prev"])
        np.testing.assert_array_equal(np.asarray(st_scan["quantile75"]),
                                      st_ref["quantile75"])

    def test_pallas_matches_reference(self):
        adcs = random_stream(128, 48, seed=33, noise=4, base=900, n_signals=60)
        h_ref, st_ref = run_reference(adcs, FIR_CFG, window=128)
        h_pal, st_pal, dropped = run_pallas(adcs, FIR_CFG, tc=32)
        assert dropped == 0
        assert len(h_ref) > 0
        np.testing.assert_array_equal(h_pal, h_ref)
        np.testing.assert_array_equal(st_pal["fir_prev"][:, :48],
                                      st_ref["fir_prev"])

    def test_pallas_multiblock_default(self):
        """The blocked (nb>1) grid at the shipped channel block must stay
        bit-exact vs the oracle (utils.tuning.KERNEL_KNOBS)."""
        from fdreadoutlibs_jax.utils.tuning import kernel_knobs
        C = 1024 + 256
        sub = kernel_knobs(FIR_CFG, C)["block_sublanes"]
        adcs = random_stream(64, C, seed=37, noise=4, base=900, n_signals=400)
        h_ref, _ = run_reference(adcs, FIR_CFG)
        h_pal, _, dropped = run_pallas(adcs, FIR_CFG, tc=32, k_slots=4,
                                       block_sublanes=sub)
        assert dropped == 0
        assert len(h_ref) > 0
        assert h_ref["channel"].max() >= 1024   # hits beyond block 0
        np.testing.assert_array_equal(h_pal, h_ref)

    def test_pallas_multiblock_window_carry(self):
        """Blocked (nb>1) state write-back must carry bit-exactly across
        kernel launches — hits spanning a window boundary close right."""
        C = 1024 + 256
        adcs = random_stream(64, C, seed=43, noise=4, base=900, n_signals=300)
        h_one, st_one, _ = run_pallas(adcs, FIR_CFG, tc=32, k_slots=4,
                                      block_sublanes=8)
        h_two, st_two, _ = run_pallas(adcs, FIR_CFG, tc=32, k_slots=4,
                                      block_sublanes=8, window=32)
        np.testing.assert_array_equal(h_one, h_two)
        for k in st_one:
            np.testing.assert_array_equal(np.asarray(st_one[k]),
                                          np.asarray(st_two[k]), err_msg=k)

    def test_window_invariance_with_fir_state(self):
        """The FIR ring buffer must carry across window boundaries."""
        adcs = random_stream(384, 8, seed=35, noise=4, base=900, n_signals=30)
        h64, _ = run_scan(adcs, FIR_CFG, window=64)
        h384, _ = run_scan(adcs, FIR_CFG, window=384)
        np.testing.assert_array_equal(h64, h384)


class TestMergedQuantileEquivalence:
    """The round-3 merged active-quantile chain + deferred threshold wrap
    must be tick-for-tick identical to the round-2 formulation (two
    independent masked frugal chains, double-wrapped threshold product)
    over random streams and random API-reachable states."""

    @staticmethod
    def _r2_iqr_and_thr(st, s_raw, cfg):
        """Independent implementation of the old formulation."""
        from fdreadoutlibs_jax.ops.fixedpoint import I32Fx, wrap_i16
        from fdreadoutlibs_jax.ops.step import frugal_update
        fx = I32Fx.make(np)
        limit = cfg.accumulator_limit
        med0 = st["pedestals"]
        q25, a25 = frugal_update(st["quantile25"], s_raw, st["accum25"],
                                 limit, np, mask=s_raw < med0, fx=fx)
        q75, a75 = frugal_update(st["quantile75"], s_raw, st["accum75"],
                                 limit, np, mask=s_raw > med0, fx=fx)
        sigma = q75 - q25
        sigma_c = np.minimum(sigma,
                             np.int32((1 << 15) // (cfg.multiplier * 5)))
        thr = wrap_i16(wrap_i16(sigma_c << cfg.tap_exponent)
                       * np.int32(cfg.threshold))
        return q25, a25, q75, a75, thr

    def test_random_streams_and_states(self):
        from fdreadoutlibs_jax.ops import TPGConfig
        from fdreadoutlibs_jax.ops.fir import default_taps, tpg_tick_fir
        rng = np.random.default_rng(123)
        C = 512
        for threshold in (5, 100, 700):     # incl. a wrap-exercising one
            cfg = TPGConfig.from_raw("FIR", threshold=threshold,
                                     track_peaks=False)
            taps = default_taps(cfg)
            # random API-reachable state: |acc| <= limit, quantiles in
            # ADC range (seed_chanstate invariants)
            st = {
                "pedestals": rng.integers(0, 16384, C),
                "accum": rng.integers(-10, 11, C),
                "quantile25": rng.integers(0, 16384, C),
                "accum25": rng.integers(-10, 11, C),
                "quantile75": rng.integers(0, 16384, C),
                "accum75": rng.integers(-10, 11, C),
                "hit_charge": np.zeros(C, np.int64),
                "hit_tover": np.zeros(C, np.int64),
                "prev_was_over": rng.integers(0, 2, C),
                "fir_prev": tuple(rng.integers(-16384, 16384, C)
                                  for _ in range(8)),
            }
            for t in range(64):
                s_raw = rng.integers(0, 16384, C)
                q25, a25, q75, a75, thr = self._r2_iqr_and_thr(
                    st, s_raw, cfg)
                new_st, closed, rec = tpg_tick_fir(dict(st), s_raw, cfg,
                                                   np, taps)
                np.testing.assert_array_equal(new_st["quantile25"], q25)
                np.testing.assert_array_equal(new_st["accum25"], a25)
                np.testing.assert_array_equal(new_st["quantile75"], q75)
                np.testing.assert_array_equal(new_st["accum75"], a75)
                st = new_st

    def test_deferred_threshold_wrap_congruence(self):
        """wrap(wrap(a)*T) == wrap(a*T) whenever a*T fits int32 — the
        identity behind dropping the intermediate wrap in the threshold
        product (mod-2^16 congruence through mullo)."""
        from fdreadoutlibs_jax.ops.fixedpoint import wrap_i16
        rng = np.random.default_rng(5)
        # a spans the worst case |a| <= 2^16 << 6 used by the trace-time
        # guard; T up to the guard's 511 bound
        a = rng.integers(-(1 << 22), 1 << 22, 200_000)
        for T in (1, 5, 320, 511, -511):
            np.testing.assert_array_equal(
                wrap_i16(wrap_i16(a) * T), wrap_i16(a * T))
