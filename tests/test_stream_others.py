"""Tests for the WIB2 / DAPHNE / TDE / SSP / TP-passthrough processors."""

import numpy as np

from fdreadoutlibs_jax.formats import daphne, ssp, tde, wib2
from fdreadoutlibs_jax.formats.trigprim import make_tps
from fdreadoutlibs_jax.ops import patterns
from fdreadoutlibs_jax.stream import (DAPHNEFrameProcessor,
                                      DAPHNEStreamFrameProcessor,
                                      SSPFrameProcessor,
                                      SWTriggerPrimitiveProcessor,
                                      TDEFrameProcessor, WIB2FrameProcessor)
from fdreadoutlibs_jax.stream.transport import QueueSender


class TestWIB2Processor:
    def make(self, **conf):
        sink = QueueSender()
        proc = WIB2FrameProcessor(tp_sink=sink)
        c = {"crate_id": 1, "slot_id": 2, "link_id": 3, "enable_tpg": True,
             "tpg_algorithm": "SimpleThreshold", "tpg_threshold": 499,
             "tp_timeout": 100_000, "tpg_backend": "reference"}
        c.update(conf)
        proc.conf(c)
        proc.start()
        return proc, sink

    def golden_superchunks(self, n=8, channel=100, ts0=100_000):
        """Golden hill across 12-tick superchunks on one of 256 channels."""
        T = n * wib2.FRAMES_PER_SUPERCHUNK
        adcs = np.zeros((T, 256), dtype=np.uint16)
        adcs[10:19, channel] = patterns.GOLDEN_ADCS
        sc = wib2.empty_superchunks(n)
        frames = wib2.superchunk_frames(sc)
        wib2.set_adcs(frames, adcs.reshape(n, 12, 256))
        wib2.fake_timestamps(sc, ts0)
        wib2.fake_geoid(sc, 1, 2, 3)
        return sc, adcs

    def test_golden_tp_wib2_variant(self):
        ts0 = 100_000
        proc, sink = self.make()
        sc, _ = self.golden_superchunks(ts0=ts0)
        proc.process(sc)
        tps = np.concatenate(sink.drain())
        assert len(tps) == 1
        tp = tps[0]
        # hill ticks 10..18, closes at tick 19, tover 9
        t_begin = ts0 + 32 * (19 - 9)
        t_end = ts0 + 32 * 19
        assert tp["time_start"] == t_begin
        assert tp["time_peak"] == (t_begin + t_end) // 2     # WIB2 variant
        assert tp["adc_integral"] == 4528
        assert tp["adc_peak"] == 4528 // 20                  # charge/20
        assert proc.metrics.count("num_ts_errors") == 0

    def test_superchunk_ts_gap(self):
        proc, sink = self.make()
        sc, _ = self.golden_superchunks()
        frames = wib2.superchunk_frames(sc)
        # shift the last 2 superchunks by one superchunk worth of ticks
        for i in (6, 7):
            ts = wib2.get_timestamp(frames[i])
            wib2.set_timestamp(frames[i], ts + 384)
        proc.process(sc)
        assert proc.metrics.count("num_ts_errors") == 1

    def test_link_misconfiguration(self):
        proc, sink = self.make(crate_id=7)
        sc, _ = self.golden_superchunks()
        proc.process(sc)
        assert proc.metrics.count("num_link_misconfigurations") == 1

    def test_emulator_mode(self):
        proc, sink = self.make(emulator_mode=True)
        sc, _ = self.golden_superchunks()
        wib2.fake_timestamps(sc, 999)   # break cadence; emulator must repair
        frames = wib2.superchunk_frames(sc)
        wib2.set_timestamp(frames.reshape(-1, 472),
                           np.arange(96, dtype=np.uint64) * 7)
        proc.process(sc)
        assert proc.metrics.count("num_ts_errors") == 0

    def test_backend_pallas_matches_reference(self):
        """WIB2 pallas backend takes the fused byte-ingest path."""
        proc_p, sink_p = self.make(tpg_backend="pallas",
                                   tpg_pallas_interpret=True)
        proc_r, sink_r = self.make(tpg_backend="reference")
        sc, _ = self.golden_superchunks(n=8, channel=200)
        proc_p.process(sc.copy())
        proc_r.process(sc.copy())
        got = np.concatenate(sink_p.drain())
        ref = np.concatenate(sink_r.drain())
        np.testing.assert_array_equal(got, ref)

    def test_time2_feed_matches_reference(self):
        """tpg_time2_feed on WIB2: the generic host relayout_time2
        (ch_per_link=256, nw=112) + plain time_packed datapath must match
        the reference backend, with state carried across batches."""
        proc_t, sink_t = self.make(tpg_backend="pallas",
                                   tpg_pallas_interpret=True,
                                   tpg_time2_feed=True)
        proc_r, sink_r = self.make(tpg_backend="reference")
        sc, _ = self.golden_superchunks(n=8, channel=200)
        # batch boundary at tick 12 lands inside the golden hill (ticks
        # 10-18): the carried feed state is load-bearing
        proc_t.process(sc[:1].copy())
        proc_t.process(sc[1:].copy())
        proc_r.process(sc.copy())
        got = np.concatenate(sink_t.drain())
        ref = np.concatenate(sink_r.drain())
        np.testing.assert_array_equal(got, ref)


class TestDAPHNEProcessors:
    def test_selftriggered_records_ts(self):
        proc = DAPHNEFrameProcessor()
        proc.conf({})
        proc.start()
        sc = daphne.empty_superchunks(3)
        daphne.fake_timestamps(sc[0:1], 5000, offset=16)
        daphne.fake_timestamps(sc[1:2], 7777, offset=16)
        daphne.fake_timestamps(sc[2:3], 9999, offset=16)
        proc.process(sc)
        assert proc.last_processed_daq_ts == 9999
        assert proc.metrics.count("num_ts_errors") == 0  # rate check disabled

    def test_selftriggered_emulator(self):
        proc = DAPHNEFrameProcessor()
        proc.conf({"emulator_mode": True})
        proc.start()
        sc = daphne.empty_superchunks(2)
        proc.process(sc)
        frames = daphne.superchunk_frames(sc)
        ts0 = daphne.get_timestamp(frames[0])
        ts1 = daphne.get_timestamp(frames[1])
        np.testing.assert_array_equal(ts0, 16 * np.arange(12))  # offset 16
        assert ts1[0] == ts0[0] + 192                            # +192/chunk

    def test_stream_cadence_check(self):
        proc = DAPHNEStreamFrameProcessor()
        proc.conf({})
        proc.start()
        sc = daphne.empty_superchunks(4, stream=True)
        for i in range(4):
            daphne.fake_timestamps(sc[i:i + 1], 1000 + i * 768, offset=64,
                                   stream=True)
        proc.process(sc)
        assert proc.metrics.count("num_ts_errors") == 0
        sc2 = daphne.empty_superchunks(2, stream=True)
        daphne.fake_timestamps(sc2[0:1], 1000 + 4 * 768, offset=64, stream=True)
        daphne.fake_timestamps(sc2[1:2], 1000 + 6 * 768, offset=64, stream=True)
        proc.process(sc2)   # gap of one superchunk
        assert proc.metrics.count("num_ts_errors") == 1


class TestTDEProcessor:
    def test_per_channel_timestamps(self):
        proc = TDEFrameProcessor()
        proc.conf({})
        proc.start()
        tick = tde.EXPECTED_TICK_DIFFERENCE
        # interleaved channels with correct per-channel cadence
        frames = tde.empty_frames(6)
        tde.set_channel(frames, [0, 1, 0, 1, 0, 1])
        tde.set_timestamp(frames, [100, 500, 100 + tick, 500 + tick,
                                   100 + 2 * tick, 500 + 2 * tick])
        proc.process(frames)
        assert proc.metrics.count("num_ts_errors") == 0
        # now a gap on channel 1 only
        frames2 = tde.empty_frames(2)
        tde.set_channel(frames2, [0, 1])
        tde.set_timestamp(frames2, [100 + 3 * tick, 500 + 4 * tick])
        proc.process(frames2)
        assert proc.metrics.count("num_ts_errors") == 1


class TestSSPAndPassthrough:
    def test_ssp_records_ts(self):
        proc = SSPFrameProcessor()
        proc.conf({})
        proc.start()
        frames = ssp.empty_frames(2)
        ssp.set_timestamp(frames, [111, 222])
        proc.process(frames)
        assert proc.last_processed_daq_ts == 222

    def test_tp_passthrough(self):
        sink = QueueSender()
        proc = SWTriggerPrimitiveProcessor(tp_sink=sink)
        proc.conf({})
        proc.start()
        tps = make_tps(5)
        tps["time_start"] = np.arange(5) + 100
        proc.process(tps)
        assert proc.last_processed_daq_ts == 104
        assert len(sink.drain()) == 1
