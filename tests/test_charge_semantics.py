"""Charge saturation + uint16 TP decode semantics (PARITY.md rows 3/3b and
"TP decode types").

The reference's production kernels accumulate hit charge with
_mm256_adds_epi16 (saturating BOTH directions, ProcessAbsRSAVX2.hpp:204) and
every frontend decodes kernel output as uint16_t, skipping zero-charge
records and building adc_integral / adc_peak from the unsigned value
(WIBEthFrameProcessor.cpp:484,517,544-545; WIB2FrameProcessor.cpp:404,429,
453-454; WIBFrameProcessor.hpp:590,628,652-653).
"""

import numpy as np
import pytest

from fdreadoutlibs_jax.formats.trigprim import TP_DTYPE  # noqa: F401
from fdreadoutlibs_jax.ops import TPGConfig
from fdreadoutlibs_jax.ops.hits import HIT_DTYPE
from fdreadoutlibs_jax.ops.reference import run_reference
from fdreadoutlibs_jax.stream.transport import QueueSender


def deep_negative_stream(T=64):
    """One channel whose pedestal seeds on a 14-bit-max sample and then
    drops to ~0: s = raw - ped is deeply negative while the memoryless
    AbsRS waveform (mf=0, the production collection config: rs = 5|s|/10)
    stays far over threshold, so charge sums below -32768."""
    adcs = np.zeros((T, 1), np.int32)
    adcs[0, 0] = 16383          # seed pedestal at the pulse top
    adcs[20:, 0] = 16383        # return to pedestal -> the hit closes
    return adcs


class TestChargeFloor:
    def test_absrs_charge_saturates_at_int16_min(self):
        cfg = TPGConfig.from_raw("AbsRS", threshold=150)
        hits, _ = run_reference(deep_negative_stream(), cfg,
                                rs_memory_factor=np.array([0]))
        assert len(hits) >= 1
        h = hits[np.argmin(hits["charge"])]
        # 19 ticks of s = -16383 sum to -311k: the adds_epi16 floor holds
        assert h["charge"] == -32768
        assert h["tover"] > 2    # the floor was actually exercised

    def test_backends_agree_on_saturated_charge(self):
        import jax.numpy as jnp
        from fdreadoutlibs_jax.ops.chanstate import (init_chanstate,
                                                     seed_chanstate)
        from fdreadoutlibs_jax.ops.pallas_tpg import (decode_pallas_hits,
                                                      pack_adcs, pack_state,
                                                      process_window_pallas)
        cfg = TPGConfig.from_raw("AbsRS", threshold=150)
        adcs = deep_negative_stream()
        ref, _ = run_reference(adcs, cfg, rs_memory_factor=np.array([0]))
        st = seed_chanstate(init_chanstate(1), adcs[0], np.array([0]))
        slots, nclose, _ = process_window_pallas(
            jnp.asarray(pack_adcs(adcs)), pack_state(st, 1), cfg,
            tc=32, k_slots=4, interpret=True)
        got, dropped = decode_pallas_hits(slots, nclose, 1)
        assert dropped == 0
        np.testing.assert_array_equal(got, ref)
        assert got["charge"].min() == -32768

    def test_fir_charge_floor(self):
        """The FIR accumulate applies the same floor (filt can be negative
        while over under the wrapped AVX threshold product)."""
        from fdreadoutlibs_jax.ops.fixedpoint import I32Fx
        import jax.numpy as jnp  # noqa: F401
        fx = I32Fx.make(np)
        assert fx.add_clamp(np.int32(-30000), np.int32(-10000),
                            32767, floor=-32768) == -32768
        assert fx.add_clamp(np.int32(30000), np.int32(10000),
                            32767, floor=-32768) == 32767

    def test_add_clamp_matches_adds_epi16_property(self):
        """Property: add_clamp(floor=-32768) == _mm256_adds_epi16 for all
        int16 operand pairs (random sample over the full domain)."""
        from fdreadoutlibs_jax.ops.fixedpoint import I32Fx
        rng = np.random.default_rng(0)
        a = rng.integers(-32768, 32768, 10000).astype(np.int64)
        b = rng.integers(-32768, 32768, 10000).astype(np.int64)
        fx = I32Fx.make(np)
        got = fx.add_clamp(a, b, 32767, floor=-32768)
        want = np.clip(a + b, -32768, 32767)
        np.testing.assert_array_equal(got, want)


def _mk_hits(charges, tover=4):
    hits = np.zeros(len(charges), dtype=HIT_DTYPE)
    hits["channel"] = np.arange(len(charges))
    hits["end_tick"] = 10
    hits["charge"] = charges
    hits["tover"] = tover
    hits["peak_adc"] = 7
    hits["peak_time"] = 1
    return hits


class TestTPDecodeTypes:
    def _wibeth(self):
        from fdreadoutlibs_jax.stream import WIBEthFrameProcessor
        q = QueueSender()
        p = WIBEthFrameProcessor(tp_sink=q)
        p.conf({"enable_tpg": True, "tpg_algorithm": "AbsRS",
                "tpg_threshold": 150, "tp_timeout": 100_000})
        p.start()
        p.register_channels = np.arange(64)
        return p, q

    def test_wibeth_negative_charge_becomes_uint16(self):
        p, q = self._wibeth()
        p.process_swtpg_hits(_mk_hits([-880, 500]), timestamp=1000)
        tps = np.concatenate(q.drain())
        assert len(tps) == 2
        assert int(tps["adc_integral"][0]) == (-880) & 0xFFFF == 64656
        assert int(tps["adc_integral"][1]) == 500

    def test_wibeth_zero_charge_hit_skipped(self):
        p, q = self._wibeth()
        p.process_swtpg_hits(_mk_hits([0, 300]), timestamp=1000)
        tps = np.concatenate(q.drain())
        assert len(tps) == 1 and int(tps["adc_integral"][0]) == 300
        # the skip happens BEFORE metrics/send, like the reference's
        # record-level `if (hit_charge[i] &&` gate
        assert p.metrics.count("num_tps_sent") == 1

    def test_wib2_unsigned_peak_division(self):
        from fdreadoutlibs_jax.stream.wib2 import WIB2FrameProcessor
        q = QueueSender()
        p = WIB2FrameProcessor(tp_sink=q)
        p.conf({"enable_tpg": True, "tpg_algorithm": "AbsRS",
                "tpg_threshold": 150, "tp_timeout": 100_000})
        p.start()
        p.register_channels = np.arange(256)
        p.process_swtpg_hits(_mk_hits([-880, 0, 400]), timestamp=2000)
        tps = np.concatenate(q.drain())
        assert len(tps) == 2
        assert int(tps["adc_integral"][0]) == 64656
        assert int(tps["adc_peak"][0]) == 64656 // 20 == 3232
        assert int(tps["adc_peak"][1]) == 400 // 20


if __name__ == "__main__":
    pytest.main([__file__, "-v"])
