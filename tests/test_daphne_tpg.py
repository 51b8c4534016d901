"""DAPHNE PDS TP generation (superset of reference) + register-parity extras."""

import numpy as np

from fdreadoutlibs_jax.formats import daphne, wib2
from fdreadoutlibs_jax.formats.trigprim import TPType
from fdreadoutlibs_jax.stream.daphne import (DAPHNEFrameProcessor,
                                             DAPHNEStreamFrameProcessor)
from fdreadoutlibs_jax.stream.transport import QueueSender
from fdreadoutlibs_jax.utils.channel_map import (IdentityChannelMap,
                                                 register_map_via_expansion)


class TestSelfTriggeredPDS:
    def test_pulse_analysis(self):
        sink = QueueSender()
        proc = DAPHNEFrameProcessor(tp_sink=sink)
        proc.conf({"enable_tpg": True, "tpg_threshold": 50, "det_id": 2})
        proc.start()

        sc = daphne.empty_superchunks(1)
        frames = daphne.superchunk_frames(sc).reshape(-1, daphne.FRAME_SIZE)
        wf = np.full((12, 1024), 1000, dtype=np.uint16)
        # frame 3: clean pulse; others: flat (no TP)
        wf[3, 500:520] = 1000 + np.concatenate([
            np.linspace(0, 400, 10), np.linspace(400, 0, 10)]).astype(int)
        daphne.set_waveform(frames, wf)
        daphne.fake_timestamps(sc, 10_000, offset=16)
        daphne.set_header_field(frames, "link_id", np.arange(12))
        proc.process(sc)

        tps = np.concatenate(sink.drain())
        assert len(tps) == 1
        tp = tps[0]
        assert tp["type"] == TPType.kPDS
        assert tp["channel"] == 3
        assert tp["adc_peak"] == 400
        assert tp["time_peak"] == 10_000 + 3 * 16 + 509  # peak position
        assert tp["time_over_threshold"] > 10

    def test_no_pulse_no_tp(self):
        sink = QueueSender()
        proc = DAPHNEFrameProcessor(tp_sink=sink)
        proc.conf({"enable_tpg": True, "tpg_threshold": 50})
        proc.start()
        sc = daphne.empty_superchunks(2)
        frames = daphne.superchunk_frames(sc).reshape(-1, daphne.FRAME_SIZE)
        daphne.set_waveform(frames, np.full((24, 1024), 900, dtype=np.uint16))
        proc.process(sc)
        assert len(sink) == 0


class TestStreamingPDSTPG:
    def test_swtpg_over_stream(self):
        sink = QueueSender()
        proc = DAPHNEStreamFrameProcessor(tp_sink=sink)
        proc.conf({"enable_tpg": True, "tpg_threshold": 100})
        proc.start()
        sc = daphne.empty_superchunks(1, stream=True)
        frames = daphne.superchunk_frames(sc, stream=True) \
            .reshape(-1, daphne.STREAM_FRAME_SIZE)
        adcs = np.full((12, 64, 4), 800, dtype=np.uint16)
        adcs[5, 10:18, 2] += 500          # pulse on channel 2, frame 5
        daphne.stream_set_adcs(frames, adcs)
        daphne.fake_timestamps(sc, 20_000, offset=64, stream=True)
        proc.process(sc)
        tps = np.concatenate(sink.drain())
        assert len(tps) == 1
        tp = tps[0]
        assert tp["type"] == TPType.kPDS
        assert tp["channel"] == 2
        assert tp["adc_integral"] == 8 * 500
        # global tick of pulse start = 5*64 + 10
        assert tp["time_start"] == 20_000 + 5 * 64 + 10

    def test_state_carries(self):
        sink = QueueSender()
        proc = DAPHNEStreamFrameProcessor(tp_sink=sink)
        proc.conf({"enable_tpg": True, "tpg_threshold": 100})
        proc.start()
        for i in range(3):
            sc = daphne.empty_superchunks(1, stream=True)
            frames = daphne.superchunk_frames(sc, stream=True) \
                .reshape(-1, daphne.STREAM_FRAME_SIZE)
            adcs = np.full((12, 64, 4), 800, dtype=np.uint16)
            daphne.stream_set_adcs(frames, adcs)
            daphne.fake_timestamps(sc, 20_000 + i * 768, offset=64,
                                   stream=True)
            proc.process(sc)
        assert proc.metrics.count("num_ts_errors") == 0
        assert proc._state is not None


class TestRegisterParityExtras:
    def test_wib2_register_order(self):
        frames = wib2.empty_frames(1)
        wib2.set_adcs(frames, np.arange(256, dtype=np.uint16)[None])
        adcs = wib2.get_adcs(frames)
        indices = np.array([0, 1, 2, 3, 4, 5, 6, 7, 15, 8, 9, 10, 11, 12, 13, 14])
        for sel in (0, 1):
            reg = wib2.to_register_order(adcs, sel)[0]
            for i in range(128):
                expected = sel * 128 + 16 * (i // 16) + indices[i % 16]
                assert reg[i] == expected

    def test_register_map_via_expansion(self):
        cmap = IdentityChannelMap(channels_per_stream=64)
        out = register_map_via_expansion(cmap, crate=1, slot=2, stream=3)
        np.testing.assert_array_equal(
            out, cmap.offline_channels(1, 2, 3, 64))


class TestDaphneFusedIngest:
    def test_device_unpack_matches_numpy(self):
        import jax.numpy as jnp
        rng = np.random.default_rng(3)
        frames = daphne.stream_empty_frames(6)
        adcs = rng.integers(0, 1 << 14, size=(6, 64, 4), dtype=np.uint16)
        daphne.stream_set_adcs(frames, adcs)
        words = daphne.stream_frames_bytes_to_u32(frames)
        dev = np.asarray(daphne.stream_unpack_frames_jnp(jnp.asarray(words)))
        np.testing.assert_array_equal(dev, adcs.astype(np.int32))
        np.testing.assert_array_equal(daphne.stream_get_adcs(frames), adcs)

    def test_pallas_backend_matches_reference(self):
        """Packed-pallas DAPHNE stream path emits the same TPs as the
        reference backend across batches (state carried in both)."""
        rng = np.random.default_rng(7)
        batches = []
        ts = 40_000
        for b in range(3):
            sc = daphne.empty_superchunks(1, stream=True)
            frames = daphne.superchunk_frames(sc, stream=True) \
                .reshape(-1, daphne.STREAM_FRAME_SIZE)
            adcs = (800 + rng.normal(0, 10, (12, 64, 4))).astype(np.uint16)
            if b in (0, 2):
                f, t, c = rng.integers(2, 11), rng.integers(0, 50), b % 4
                adcs[f, t:t + 9, c] += np.array(
                    [500, 502, 504, 505, 506, 505, 504, 502, 500], np.uint16)
            daphne.stream_set_adcs(frames, adcs)
            daphne.fake_timestamps(sc, ts, offset=64, stream=True)
            batches.append(sc)
            ts += 12 * 64

        outs = {}
        for backend in ("reference", "pallas"):
            sink = QueueSender()
            proc = DAPHNEStreamFrameProcessor(tp_sink=sink)
            proc.conf({"enable_tpg": True, "tpg_threshold": 150,
                       "tpg_backend": backend, "tpg_pallas_interpret": True})
            proc.start()
            for sc in batches:
                proc.process(sc.copy())
            outs[backend] = np.concatenate(sink.drain()) if len(sink) \
                else np.zeros(0, dtype="V1")
        ref, pal = outs["reference"], outs["pallas"]
        assert len(ref) >= 2
        order = lambda t: np.argsort(t["time_start"], kind="stable")
        np.testing.assert_array_equal(ref[order(ref)], pal[order(pal)])

    def test_current_state_staleness_gate(self, monkeypatch):
        """current_state() unpacks the device stack once per batch, not
        once per call — repeated checkpoints without an intervening batch
        must not re-pay the device->host sync (round-3 review)."""
        import fdreadoutlibs_jax.ops.pallas_tpg as pt
        sc = daphne.empty_superchunks(1, stream=True)
        frames = daphne.superchunk_frames(sc, stream=True) \
            .reshape(-1, daphne.STREAM_FRAME_SIZE)
        adcs = (800 + np.random.default_rng(3)
                .normal(0, 10, (12, 64, 4))).astype(np.uint16)
        adcs[4, 10:19, 1] += 600
        daphne.stream_set_adcs(frames, adcs)
        daphne.fake_timestamps(sc, 40_000, offset=64, stream=True)
        proc = DAPHNEStreamFrameProcessor(tp_sink=QueueSender())
        proc.conf({"enable_tpg": True, "tpg_threshold": 150,
                   "tpg_backend": "pallas", "tpg_pallas_interpret": True})
        proc.start()
        calls = {"n": 0}
        real = pt.unpack_state

        def counting(*a, **kw):
            calls["n"] += 1
            return real(*a, **kw)
        monkeypatch.setattr(pt, "unpack_state", counting)
        proc.process(sc.copy())
        st1 = proc.current_state()
        assert st1 is not None and calls["n"] == 1
        st2 = proc.current_state()            # clean: no second unpack
        assert calls["n"] == 1 and st2 is st1
        proc.process(sc.copy())               # new batch -> stale again
        proc.current_state()
        assert calls["n"] == 2

    def test_streaming_ingest_daphne_format(self):
        """StreamingIngest(format='daphne_stream') over 2 links matches the
        reference oracle on the stacked channel set."""
        from fdreadoutlibs_jax.ops import TPGConfig
        from fdreadoutlibs_jax.ops.chanstate import (init_chanstate,
                                                     seed_chanstate)
        from fdreadoutlibs_jax.ops.ingest import StreamingIngest
        from fdreadoutlibs_jax.ops.reference import process_window_reference
        from fdreadoutlibs_jax.ops.hits import sort_hits
        rng = np.random.default_rng(11)
        cfg = TPGConfig(threshold=120)
        L, NB, NF = 2, 3, 4           # links, batches, frames/batch
        ing = StreamingIngest(cfg, n_links=L, interpret=True,
                              format="daphne_stream", k_slots=4)
        all_adcs = []
        got = []
        for b in range(NB):
            frames = np.zeros((L, NF, daphne.STREAM_FRAME_SIZE), np.uint8)
            adcs = (800 + rng.normal(0, 8, (L, NF, 64, 4))).astype(np.uint16)
            adcs[b % L, 1, 5:13, 3] += 400
            for l in range(L):
                daphne.stream_set_adcs(frames[l], adcs[l])
            all_adcs.append(adcs)
            out = ing.submit(frames)
            if out is not None:
                got.append(out[0])
        got.append(ing.flush()[0])
        hits = sort_hits(np.concatenate(got))

        # oracle over the stacked stream: channel = link*4 + c
        stacked = np.concatenate(
            [a.transpose(1, 2, 0, 3).reshape(NF * 64, L * 4)
             for a in all_adcs]).astype(np.int32)
        state = seed_chanstate(init_chanstate(L * 4), stacked[0],
                               cfg.rs_memory_factor_x10)
        ref_hits, _ = process_window_reference(stacked, state, cfg)
        np.testing.assert_array_equal(hits, sort_hits(ref_hits))
