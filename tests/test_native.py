"""Native C++ runtime tests (skipped when no toolchain/library)."""

import numpy as np
import pytest

from fdreadoutlibs_jax import native
from fdreadoutlibs_jax.formats import wibeth
from fdreadoutlibs_jax.formats.trigprim import TP_DTYPE, make_tps
from fdreadoutlibs_jax.tp.latency_buffer import make_latency_buffer

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library unavailable")


class TestNativeCodec:
    def test_unpack_matches_numpy(self):
        rng = np.random.default_rng(0)
        frames = wibeth.empty_frames(4)
        adcs = rng.integers(0, 1 << 14, size=(4, 64, 64), dtype=np.uint16)
        wibeth.set_adcs(frames, adcs)
        out = native.wibeth_unpack(frames)
        np.testing.assert_array_equal(out.reshape(4, 64, 64), adcs)

    def test_pack_matches_numpy(self):
        rng = np.random.default_rng(1)
        adcs = rng.integers(0, 1 << 14, size=(3, 64, 64), dtype=np.uint16)
        f_native = wibeth.empty_frames(3)
        f_numpy = wibeth.empty_frames(3)
        native.wibeth_pack(f_native, adcs.reshape(-1, 64))
        wibeth.set_adcs(f_numpy, adcs)
        np.testing.assert_array_equal(f_native, f_numpy)

    def test_fake_headers(self):
        frames = wibeth.empty_frames(5)
        native.wibeth_fake_headers(frames, 1000, 2048, 0xFFE)
        np.testing.assert_array_equal(
            native.wibeth_timestamps(frames),
            1000 + 2048 * np.arange(5, dtype=np.uint64))
        np.testing.assert_array_equal(
            wibeth.get_header_field(frames, "seq_id"),
            [0xFFE, 0xFFF, 0, 1, 2])


class TestNativeLatencyBuffer:
    def test_same_semantics_as_python(self):
        """Drive native and Python buffers identically; results must match."""
        rng = np.random.default_rng(2)
        nat = make_latency_buffer(TP_DTYPE, prefer_native=True)
        py = make_latency_buffer(None, prefer_native=False)
        assert type(nat).__name__ == "NativeLatencyBufferAdapter"
        for seed in range(3):
            tps = make_tps(50)
            tps["time_start"] = rng.integers(0, 10_000, size=50)
            tps["channel"] = np.arange(50)
            nat.insert(tps)
            py.insert(tps)
        assert nat.occupancy() == py.occupancy() == 150
        assert nat.oldest_ts() == py.oldest_ts()
        assert nat.newest_ts() == py.newest_ts()
        w_nat = nat.extract_window(2_000, 8_000)
        w_py = py.extract_window(2_000, 8_000)
        np.testing.assert_array_equal(np.sort(w_nat, order=["time_start", "channel"]),
                                      np.sort(w_py, order=["time_start", "channel"]))
        assert nat.pop_until(5_000) == py.pop_until(5_000)
        assert nat.cleanup_max_ts_diff(1_000) == py.cleanup_max_ts_diff(1_000)
        assert nat.occupancy() == py.occupancy()

    def test_capacity(self):
        buf = make_latency_buffer(TP_DTYPE, capacity=3)
        tps = make_tps(5)
        tps["time_start"] = np.arange(5)
        assert buf.insert(tps) == 3
        assert buf.occupancy() == 3

    def test_request_handler_with_native_buffer(self):
        from fdreadoutlibs_jax.stream.transport import QueueSender
        from fdreadoutlibs_jax.tp import TPRequestHandler
        sink = QueueSender()
        h = TPRequestHandler(tpset_sink=sink,
                             latency_buffer=make_latency_buffer(TP_DTYPE))
        h.conf({"tpset_transmission_rate_hz": 1000,
                "tpset_min_latency_ticks": 100,
                "tardy_tp_quiet_time_at_start_sec": 0})
        h.start(run_number=1)
        tps = make_tps(3)
        tps["time_start"] = [1000, 1050, 1200]
        h.insert_tps(tps)
        tpset = h.send_tp_sets_once()
        assert tpset is not None
        np.testing.assert_array_equal(tpset.objects["time_start"], [1000, 1050])


class TestConcurrency:
    def test_concurrent_insert_extract(self):
        """The ordered buffer is shared between the ingest thread and the
        TPSet sender thread in deployment; hammer it from both sides."""
        import threading
        buf = make_latency_buffer(TP_DTYPE, prefer_native=True)
        errors = []

        def inserter(tid):
            try:
                rng = np.random.default_rng(tid)
                for i in range(50):
                    tps = make_tps(100)
                    tps["time_start"] = rng.integers(0, 1_000_000, size=100)
                    buf.insert(tps)
            except Exception as e:   # pragma: no cover
                errors.append(e)

        def extractor():
            try:
                for _ in range(100):
                    w = buf.extract_window(100_000, 900_000)
                    if len(w) > 1:
                        assert (np.diff(w["time_start"].astype(np.int64))
                                >= 0).all()
                    buf.pop_until(50_000)
            except Exception as e:   # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=inserter, args=(t,))
                   for t in range(3)] + [threading.Thread(target=extractor)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors
        assert buf.occupancy() <= 3 * 50 * 100


class TestRelayoutOutReuse:
    """Reusable-output API of the host relayout codecs: a fresh ~50 MB
    output per call page-faults every line (~3x the steady-state codec
    cost, BENCH_NOTES round-3 host codec), so streaming callers pass
    `out=`; 64-byte alignment additionally enables the non-temporal
    store path (2.1x)."""

    def _words(self, L=2, T=128, seed=3):
        rng = np.random.default_rng(seed)
        return rng.integers(0, 2 ** 32, size=(L, T, 28), dtype=np.uint32)

    def test_time2_out_reuse_aligned(self):
        words = self._words()
        fresh = native.relayout_time2(words)
        # the default allocation is NT-store eligible
        assert fresh.ctypes.data % 64 == 0
        out = native._aligned_empty(fresh.shape, np.int32)
        res = native.relayout_time2(words, out=out)
        assert res is out
        np.testing.assert_array_equal(res, fresh)
        # reuse: a second call over different data fully overwrites
        words2 = self._words(seed=4)
        res2 = native.relayout_time2(words2, out=out)
        np.testing.assert_array_equal(res2, native.relayout_time2(words2))

    def test_time2_cpl256_matches_numpy_oracle(self):
        """WIB2 shapes (ch_per_link=256, nw=112) through the generic
        codec vs an independent bitpack oracle — the differential behind
        the WIB2 tpg_time2_feed path."""
        from fdreadoutlibs_jax.formats.bitpack import unpack_14bit
        rng = np.random.default_rng(11)
        L, T, cpl = 3, 24, 256
        words = rng.integers(0, 2 ** 32, size=(L, T, 112), dtype=np.uint32)
        res = native.relayout_time2(words, ch_per_link=cpl)
        adcs = unpack_14bit(words, cpl).astype(np.int32)  # (L, T, 256)
        C = L * cpl
        S = native._pad_sublanes8(C)
        flat = np.zeros((T, S * 128), dtype=np.int32)
        flat[:, :C] = adcs.transpose(1, 0, 2).reshape(T, C)
        expect = (flat[0::2] | (flat[1::2] << 16)).reshape(T // 2, S, 128)
        np.testing.assert_array_equal(res, expect)

    def test_time2_unaligned_out_is_bit_exact(self):
        # a 4-byte-aligned (not 64) buffer takes the regular-store branch
        # of the C++ codec; results must be identical
        words = self._words()
        fresh = native.relayout_time2(words)
        n = fresh.size
        buf = np.empty(n * 4 + 128, dtype=np.uint8)
        off = (-buf.ctypes.data) % 64 + 16
        out = buf[off:off + n * 4].view(np.int32).reshape(fresh.shape)
        assert out.ctypes.data % 64 == 16
        res = native.relayout_time2(words, out=out)
        np.testing.assert_array_equal(res, fresh)

    def test_out_validation(self):
        words = self._words()
        with pytest.raises(ValueError):
            native.relayout_time2(words, out=np.empty((1, 2, 3), np.int32))
        good_shape = native.relayout_time2(words).shape
        with pytest.raises(ValueError):
            native.relayout_time2(
                words, out=np.empty(good_shape, np.int64))
        with pytest.raises(ValueError):
            native.relayout_time2(
                words, out=np.empty(good_shape, np.int32)[:, ::-1, :])

    def test_numpy_fallback_honors_out(self, monkeypatch):
        words = self._words()
        fresh = native.relayout_time2(words)
        monkeypatch.setattr(native, "load", lambda: None)
        out = np.zeros(fresh.shape, np.int32)
        res = native.relayout_time2(words, out=out)
        assert res is out
        np.testing.assert_array_equal(res, fresh)

    def test_daphne_out(self):
        rng = np.random.default_rng(5)
        dw = rng.integers(0, 2 ** 32, size=(3, 4, 112), dtype=np.uint32)
        dfresh = native.relayout_time2_daphne(dw)
        dout = native._aligned_empty(dfresh.shape, np.int32)
        np.testing.assert_array_equal(
            native.relayout_time2_daphne(dw, out=dout), dfresh)

    def test_streaming_ingest_double_buffers(self):
        from fdreadoutlibs_jax.ops import TPGConfig
        from fdreadoutlibs_jax.ops.ingest import StreamingIngest
        ing = StreamingIngest(TPGConfig.from_raw("SimpleThreshold",
                                                 threshold=150),
                              n_links=2, time2=True, interpret=True)
        w1, w2 = self._words(seed=6), self._words(seed=7)
        a = ing.host_relayout_time2(w1)
        b = ing.host_relayout_time2(w2)
        # the buffer handed out for batch N-1 is not overwritten by
        # batch N (its device transfer may still be in flight)
        assert a.ctypes.data != b.ctypes.data
        np.testing.assert_array_equal(a, native.relayout_time2(w1))
        np.testing.assert_array_equal(b, native.relayout_time2(w2))
        c = ing.host_relayout_time2(w1)     # third call recycles buffer 1
        assert c.ctypes.data == a.ctypes.data

    def test_multithreaded_relayout_parity(self):
        # nthreads fans 64-tick-aligned ranges over std::threads (disjoint
        # input/output ranges); results must be bit-identical for any
        # thread count, including counts that don't divide the tick blocks
        rng = np.random.default_rng(9)
        for L, T in [(3, 384), (5, 64)]:
            w = rng.integers(0, 2 ** 32, size=(L, T, 28), dtype=np.uint32)
            t2 = native.relayout_time2(w)
            for nt in (2, 3, 7):
                np.testing.assert_array_equal(
                    native.relayout_time2(w, nthreads=nt), t2)
