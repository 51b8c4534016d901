"""Raw-payload readout buffer + TDE waveform TPG tests."""

import numpy as np
import pytest

from fdreadoutlibs_jax.formats import tde, wibeth
from fdreadoutlibs_jax.formats.adapters import get_adapter
from fdreadoutlibs_jax.stream.tde import TDEFrameProcessor
from fdreadoutlibs_jax.stream.transport import QueueSender
from fdreadoutlibs_jax.tp.readout_buffer import ReadoutRequestHandler


class TestReadoutRequestHandler:
    def make(self, impl="ring", capacity=None):
        if impl in ("ring", "zerocopy"):
            return ReadoutRequestHandler(get_adapter("wibeth"),
                                         capacity=capacity, retention=impl)
        return ReadoutRequestHandler(get_adapter("wibeth"),
                                     capacity=capacity,
                                     prefer_native=(impl == "native"),
                                     ring=False)

    @pytest.mark.parametrize("impl", ["ring", "zerocopy", "python", "native"])
    def test_window_request(self, impl):
        h = self.make(impl)
        frames = wibeth.empty_frames(8)
        wibeth.fake_timestamps(frames, 10_000)       # +2048 each
        h.insert_payloads(frames)
        assert h.occupancy() == 8
        # request [12048, 16144): frames at 12048, 14096 start inside;
        # the frame at 10000 covers the window start -> included
        got = h.request(12_100, 16_145)
        ts = wibeth.get_timestamp(got)
        np.testing.assert_array_equal(ts, [12_048, 14_096, 16_144])

    @pytest.mark.parametrize("impl", ["ring", "zerocopy", "python"])
    def test_covering_payload_included(self, impl):
        h = self.make(impl)
        frames = wibeth.empty_frames(2)
        wibeth.fake_timestamps(frames, 10_000)
        h.insert_payloads(frames)
        got = h.request(10_500, 11_000)   # inside frame 0's 2048-tick span
        assert len(got) == 1
        assert wibeth.get_timestamp(got)[0] == 10_000

    @pytest.mark.parametrize("impl", ["ring", "zerocopy", "python"])
    def test_cleanup(self, impl):
        h = self.make(impl)
        frames = wibeth.empty_frames(10)
        wibeth.fake_timestamps(frames, 0)
        h.insert_payloads(frames)
        h.cleanup(max_occupancy=4)
        assert h.occupancy() == 4
        h.cleanup(max_ts_diff=2048)
        assert h.occupancy() == 2

    @pytest.mark.parametrize("impl", ["ring", "zerocopy"])
    def test_capacity_drops_new(self, impl):
        h = self.make(impl, capacity=3)
        frames = wibeth.empty_frames(5)
        wibeth.fake_timestamps(frames, 0)
        assert h.insert_payloads(frames) == 3
        assert h.occupancy() == 3
        assert h.metrics.count("num_payloads_dropped") == 2


def _payload_buffer(impl, size, capacity=None):
    """Both ordered payload buffers share one contract; the conformance
    tests below run against each (ring = copying arena, zerocopy =
    segment-reference retention)."""
    from fdreadoutlibs_jax.tp.readout_buffer import (PayloadRingBuffer,
                                                     SegmentedPayloadBuffer)
    cls = PayloadRingBuffer if impl == "ring" else SegmentedPayloadBuffer
    return cls(size, capacity=capacity)


@pytest.mark.parametrize("impl", ["ring", "zerocopy"])
class TestPayloadRingBuffer:
    def _mk(self, n, t0=0, step=10, size=16):
        keys = np.arange(t0, t0 + n * step, step, dtype=np.uint64)
        data = np.tile(np.arange(n, dtype=np.uint8)[:, None] + (t0 % 251),
                       (1, size))
        return keys, data

    def test_wrap_compaction_preserves_contents(self, impl):
        """Sustained insert/pop cycles past the array end (the memmove
        compaction path) keep keys+payloads consistent."""
        buf = _payload_buffer(impl, 16, capacity=32)
        t = 0
        for cycle in range(40):                  # >> 2x capacity appends
            keys, data = self._mk(8, t0=t, size=16)
            assert buf.insert(keys, data) == 8
            t += 80
            buf.pop_n(8 if cycle else 0)
        assert buf.occupancy() == 8              # steady state: +8 then -8
        assert buf.oldest_ts() is not None
        win = buf.extract_window(buf.oldest_ts(), t)
        assert len(win) == buf.occupancy()
        # newest batch's payload rows survived all compactions intact
        keys, data = self._mk(8, t0=t - 80, size=16)
        np.testing.assert_array_equal(win[-8:], data)

    def test_growth_unbounded(self, impl):
        buf = _payload_buffer(impl, 8)           # unbounded
        for i in range(40):
            keys, data = self._mk(100, t0=i * 1000, size=8)
            assert buf.insert(keys, data) == 100
        assert buf.occupancy() == 4000
        assert buf.key_at(0) == 0 and buf.newest_ts() == 39 * 1000 + 990

    def test_backward_jump_clamped(self, impl):
        """A timestamp that jumps backward (upstream flags it as a frame
        error) is clamped to keep the order invariant, not stored raw."""
        buf = _payload_buffer(impl, 4, capacity=16)
        buf.insert(np.array([100, 200], np.uint64), np.zeros((2, 4), np.uint8))
        buf.insert(np.array([50, 300], np.uint64), np.ones((2, 4), np.uint8))
        assert buf.newest_ts() == 300
        assert buf.key_at(2) == 200              # 50 clamped to 200
        assert len(buf.extract_window(0, 1 << 62)) == 4
        # the silent substitution is counted for operator correlation
        # (advisor r3): one key (the 50) was clamped
        assert buf.num_keys_clamped == 1
        # intra-batch backward jump also counts
        buf.insert(np.array([400, 350], np.uint64), np.zeros((2, 4), np.uint8))
        assert buf.num_keys_clamped == 2

    def test_zerocopy_retention_shares_memory(self, impl):
        """The zerocopy buffer must hold REFERENCES to the caller's rows
        (insert is O(keys), not O(bytes)); the ring must own a copy."""
        buf = _payload_buffer(impl, 16, capacity=64)
        keys, data = self._mk(8, size=16)
        buf.insert(keys, data)
        shared = any(np.shares_memory(seg, data) for seg in
                     (s[1] for s in getattr(buf, "_segs", []))) \
            if impl == "zerocopy" else np.shares_memory(buf._data, data)
        assert shared == (impl == "zerocopy")
        # eviction releases the slab reference
        if impl == "zerocopy":
            buf.pop_n(8)
            assert not buf._segs

    def test_pop_until_and_snapshot(self, impl):
        buf = _payload_buffer(impl, 4, capacity=16)
        keys, data = self._mk(10, size=4)
        buf.insert(keys, data)
        assert buf.pop_until(35) == 4
        assert buf.oldest_ts() == 40
        np.testing.assert_array_equal(buf.snapshot(), data[4:])
        assert buf.cleanup_max_ts_diff(20) == 3   # cutoff 90-20=70
        assert buf.occupancy() == 3
        assert buf.pop_n(-2) == 0                 # never resurrects rows
        assert buf.occupancy() == 3


class TestTDETPG:
    def make_cycle_frames(self, n_channels=4, pulse_chan=2, ts0=50_000):
        frames = tde.empty_frames(n_channels)
        tde.set_channel(frames, np.arange(n_channels))
        tde.set_timestamp(frames, np.full(n_channels, ts0))
        samples = np.full((n_channels, tde.TOT_ADC16_SAMPLES), 700,
                          dtype=np.uint16)
        samples[pulse_chan, 1000:1010] += 900
        tde.set_adc_samples(frames, samples)
        return frames

    def test_pulse_found(self):
        sink = QueueSender()
        proc = TDEFrameProcessor(tp_sink=sink)
        proc.conf({"enable_tpg": True, "tpg_threshold": 500})
        proc.start()
        proc.process(self.make_cycle_frames())
        tps = np.concatenate(sink.drain())
        assert len(tps) == 1
        tp = tps[0]
        assert tp["channel"] == 2
        assert tp["adc_integral"] == 10 * 900
        # samples are 32 ticks apart
        assert tp["time_start"] == 50_000 + 32 * 1000
        assert tp["time_over_threshold"] == 10 * 32

    def test_incomplete_batch_skipped(self):
        sink = QueueSender()
        proc = TDEFrameProcessor(tp_sink=sink)
        proc.conf({"enable_tpg": True, "tpg_threshold": 500})
        proc.start()
        frames = self.make_cycle_frames(n_channels=3)
        tde.set_channel(frames, [0, 1, 1])   # unbalanced channel counts
        proc.process(frames)
        assert proc.metrics.count("num_incomplete_tpg_batches") == 1
        assert len(sink) == 0


class TestRetentionSelection:
    def test_legacy_ring_kwarg_keeps_copying_semantics(self):
        """Explicit ring=True predates zero-copy retention and meant 'the
        copying PayloadRingBuffer'; it must still select it (a producer
        that recycles its frame buffers depends on the copy).  Only the
        no-kwargs default is zero-copy."""
        from fdreadoutlibs_jax.tp.readout_buffer import (
            PayloadRingBuffer, SegmentedPayloadBuffer)
        a = get_adapter("wibeth")
        assert isinstance(ReadoutRequestHandler(a).buffer,
                          SegmentedPayloadBuffer)
        assert isinstance(ReadoutRequestHandler(a, ring=True).buffer,
                          PayloadRingBuffer)
        assert ReadoutRequestHandler(a, ring=False).retention == "record"
        assert ReadoutRequestHandler(
            a, ring=True, retention="zerocopy").retention == "zerocopy"


class TestFragments:
    def test_request_fragment(self):
        from fdreadoutlibs_jax.formats.fragment import Fragment
        h = ReadoutRequestHandler(get_adapter("wibeth"), prefer_native=False)
        frames = wibeth.empty_frames(4)
        wibeth.fake_timestamps(frames, 10_000)
        h.insert_payloads(frames)
        frag = h.request_fragment(12_100, 16_145, run_number=7,
                                  trigger_number=42, source_id=3)
        assert isinstance(frag, Fragment)
        assert len(frag) == 3
        assert frag.header.run_number == 7
        assert frag.header.trigger_number == 42
        assert frag.header.window_begin == 12_100
        assert frag.header.fragment_type == "kWIBEth"
        assert frag.size_bytes == 3 * 7200


class TestFragmentRecorder:
    def test_write_read_roundtrip(self, tmp_path):
        from fdreadoutlibs_jax.tp.recorder import FragmentRecorder
        h = ReadoutRequestHandler(get_adapter("wibeth"), prefer_native=False)
        frames = wibeth.empty_frames(6)
        wibeth.fake_timestamps(frames, 10_000)
        h.insert_payloads(frames)
        rec = FragmentRecorder(tmp_path / "run", run_number=12)
        frag = h.request_fragment(10_000, 10_000 + 3 * 2048, run_number=12,
                                  trigger_number=1, source_id=4)
        rec.write(frag)
        frag2 = h.request_fragment(10_000 + 3 * 2048, 10_000 + 6 * 2048,
                                   run_number=12, trigger_number=2,
                                   source_id=4, sequence_number=1)
        rec.write(frag2)
        assert len(rec) == 2
        back = rec.read(0)
        assert back.header.trigger_number == 1
        assert back.header.fragment_type == "kWIBEth"
        np.testing.assert_array_equal(back.payloads, frag.payloads)
        idx = rec.index()
        assert idx[1]["trigger_number"] == 2
        assert idx[1]["n_payloads"] == len(frag2)
        # a new recorder instance resumes the index
        rec2 = FragmentRecorder(tmp_path / "run", run_number=12)
        assert len(rec2) == 2

    def test_structured_payloads_roundtrip_dtype(self, tmp_path):
        """Ring-retention fragments carry structured records; read()
        must restore the exact dtype, not uint8 rows (round-5 review)."""
        from fdreadoutlibs_jax.formats.fragment import build_fragment
        from fdreadoutlibs_jax.tp.recorder import FragmentRecorder
        dt = np.dtype([("time_start", "<u8"), ("payload", "u1", (16,))])
        recs = np.zeros(3, dtype=dt)
        recs["time_start"] = [10, 20, 30]
        recs["payload"] = np.arange(3 * 16, dtype=np.uint8).reshape(3, 16)
        frag = build_fragment(recs, run_number=5, trigger_number=9,
                              window_begin=10, window_end=31, source_id=2,
                              fragment_type="kWIBEth")
        rec = FragmentRecorder(tmp_path / "run", run_number=5)
        rec.write(frag)
        back = rec.read(0)
        assert back.payloads.dtype == dt
        np.testing.assert_array_equal(back.payloads, recs)


@pytest.mark.parametrize("impl", ["ring", "zerocopy"])
def test_payload_ring_concurrent_insert_and_request(impl):
    """Data requests read while the batch loop inserts (production shape);
    the buffer's lock keeps windows consistent — every extracted window is
    fully-formed rows from inserted batches."""
    import threading
    buf = _payload_buffer(impl, 64, capacity=256)
    stop = threading.Event()
    errs = []

    def inserter():
        t = 0
        pay = np.zeros((8, 64), np.uint8)
        while not stop.is_set():
            if impl == "zerocopy":
                # ownership contract: a fresh slab per batch (the apps'
                # calling convention), never mutated after insert
                pay = np.empty((8, 64), np.uint8)
            pay[:] = (t // 8) % 251          # whole batch one marker value
            keys = np.arange(t, t + 8, dtype=np.uint64)
            buf.insert(keys, pay)
            t += 8
            if buf.occupancy() > 128:
                buf.pop_n(buf.occupancy() - 128)

    def requester():
        while not stop.is_set():
            hi = buf.newest_ts()
            if hi is None:
                continue
            win = buf.extract_window(max(0, hi - 64), hi + 1)
            if len(win):
                # each row uniform (no torn rows across batches)
                mins = win.min(axis=1)
                maxs = win.max(axis=1)
                if not np.array_equal(mins, maxs):
                    errs.append("torn row")
                    stop.set()

    ths = [threading.Thread(target=inserter),
           threading.Thread(target=requester)]
    for th in ths:
        th.start()
    import time
    time.sleep(1.0)
    stop.set()
    for th in ths:
        th.join(timeout=5)
    assert not errs
