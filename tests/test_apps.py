"""End-to-end application tests (CPU: the scan backend and the kernel
through the Pallas interpreter, small configs)."""

import numpy as np
import pytest

from fdreadoutlibs_jax.formats import wibeth

# interpret_ingest fixture: tests/conftest.py


@pytest.mark.parametrize("mode", ["plain", "interpret", "time2",
                                  "time2-interpret"])
def test_apa_readout_end_to_end(mode):
    from fdreadoutlibs_jax.apps.apa_readout import APAReadoutApp
    app = APAReadoutApp(n_links=2, threshold=499,
                        pallas_interpret=mode.endswith("interpret"),
                        time2_feed=mode.startswith("time2"))
    assert app.backend == ("pallas" if mode.endswith("interpret")
                           else "scan")
    ts = 100_000
    for b in range(3):
        frames = np.zeros((2, 1, wibeth.FRAME_SIZE), np.uint8)
        adcs = np.full((2, 1, 64, 64), 800, np.uint16)
        if b == 1:
            adcs[1, 0, 10:19, 7] += np.array(
                [500, 502, 504, 505, 506, 505, 504, 502, 500], np.uint16)
        for l in range(2):
            wibeth.set_adcs(frames[l], adcs[l])
            wibeth.fake_timestamps(frames[l], ts)
            wibeth.fake_seq_ids(frames[l], b)
            wibeth.fake_geoid(frames[l], 1, l // 8, l % 8)
        app.process_batch(frames)
        ts += 2048
    info = app.get_info()
    assert info["total_hits"] == 1
    assert info["total_tps_sent"] == 1
    assert info["ts_errors"] == 0
    assert info["raw_buffered"] == 6
    # trigger data request on the hit link returns the covering frames
    raw = app.request_raw(1, 100_000 + 2048, 100_000 + 2 * 2048)
    assert len(raw) >= 1
    # TP landed in the latency buffer with the right absolute time
    tps = app.handler.buffer.snapshot()
    assert len(tps) == 1
    assert tps["time_start"][0] == 100_000 + 2048 + 32 * 10

def test_apa_record_fragment_and_cli_dump(interpret_ingest, tmp_path, capsys):
    from fdreadoutlibs_jax.apps.apa_readout import APAReadoutApp
    from fdreadoutlibs_jax.tp.recorder import FragmentRecorder
    from fdreadoutlibs_jax.cli import main as cli_main
    app = APAReadoutApp(n_links=2, threshold=499, run_number=33)
    frames = np.zeros((2, 2, wibeth.FRAME_SIZE), np.uint8)
    for l in range(2):
        wibeth.fake_timestamps(frames[l], 100_000)
        wibeth.fake_seq_ids(frames[l], 0)
        wibeth.fake_geoid(frames[l], 1, l // 8, l % 8)
    app.process_batch(frames)
    rec = FragmentRecorder(tmp_path / "store", run_number=33)
    frag = app.record_fragment(1, 100_000, 100_000 + 2 * 2048, rec,
                               trigger_number=5)
    assert len(frag) == 2 and frag.header.run_number == 33
    assert len(rec) == 1
    # CLI: list then extract payloads back to a frame binary
    cli_main(["fragment-dump", str(tmp_path / "store")])
    listing = capsys.readouterr().out.strip().splitlines()
    assert len(listing) == 1 and '"trigger_number": 5' in listing[0]
    out = tmp_path / "frag.bin"
    cli_main(["fragment-dump", str(tmp_path / "store"), "-i", "0",
              "-o", str(out)])
    back = np.fromfile(out, np.uint8).reshape(-1, wibeth.FRAME_SIZE)
    np.testing.assert_array_equal(back, frag.payloads)


def test_exclusive_ingest_mode_guards():
    """The app runs the kernel or the scan path; the numpy oracle and
    unknown names are refused instead of silently falling back."""
    import pytest
    from fdreadoutlibs_jax.apps.apa_readout import APAReadoutApp
    with pytest.raises(ValueError):
        APAReadoutApp(n_links=1, backend="reference")
    with pytest.raises(ValueError):
        APAReadoutApp(n_links=1, backend="mosaic")


def test_batched_assembly_matches_per_link(interpret_ingest):
    """The whole-APA vectorized TP assembly (apa_readout._assemble_batch)
    produces the identical TP multiset and per-link counters as 40
    per-link process_swtpg_hits calls (the reference-shaped path)."""
    from fdreadoutlibs_jax.apps.apa_readout import APAReadoutApp

    def run(batched):
        from fdreadoutlibs_jax.utils.channel_map import make_map
        app = APAReadoutApp(n_links=3, threshold=200, algorithm="AbsRS",
                            batched_assembly=batched)
        # a mask on ONE link only: the batched path must match masks on
        # (link, channel) keys, not offline channel alone (link 1 =
        # crate 1, slot 0, stream 1 in the app's geometry)
        off1 = make_map("HDAPAChannelMap").offline_channels(1, 0, 1, 64)
        app.procs[1].channel_mask_set = {int(off1[17]), int(off1[33])}
        rng = np.random.default_rng(5)
        ts = 100_000
        for b in range(3):
            frames = np.zeros((3, 2, wibeth.FRAME_SIZE), np.uint8)
            adcs = (800 + rng.normal(0, 10, (3, 2, 64, 64))) \
                .astype(np.uint16)
            for _ in range(12):
                l, c = rng.integers(0, 3), rng.integers(0, 64)
                f, t = rng.integers(0, 2), rng.integers(0, 50)
                adcs[l, f, t:t + 6, c] += np.uint16(rng.integers(300, 900))
            for l in range(3):
                wibeth.set_adcs(frames[l], adcs[l])
                wibeth.fake_timestamps(frames[l], ts)
                wibeth.fake_seq_ids(frames[l], b * 2)
                wibeth.fake_geoid(frames[l], 1, l // 8, l % 8)
            app.process_batch(frames)
            ts += 2 * 2048
        tps = app.handler.buffer.snapshot()
        info = app.get_info()      # flushes the deferred per-link counters
        per_link_sent = [p.metrics.count("num_tps_sent") for p in app.procs]
        per_link_hits = [p.metrics.count("num_hits") for p in app.procs]
        return tps, per_link_sent, per_link_hits, info

    tps_b, sent_b, hits_b, info_b = run(True)
    tps_p, sent_p, hits_p, info_p = run(False)
    assert sum(sent_b) > 0
    assert sent_b == sent_p and hits_b == hits_p
    # buffer contents identical as a sorted multiset
    order = np.argsort(tps_b, order=("time_start", "channel", "time_peak"))
    order_p = np.argsort(tps_p, order=("time_start", "channel", "time_peak"))
    np.testing.assert_array_equal(tps_b[order], tps_p[order_p])
    assert info_b["total_tps_sent"] == info_p["total_tps_sent"]
    assert "apa_top_channels" in info_b


def test_pipelined_matches_unpipelined(interpret_ingest):
    """Depth-2 pipelined batching (submit batch N+1 before finishing
    batch N) produces the identical TP stream, hit counters, and raw
    retention as the synchronous path once flushed — overlap must change
    WHEN work happens, never WHAT comes out."""
    from fdreadoutlibs_jax.apps.apa_readout import APAReadoutApp

    def run(pipelined):
        app = APAReadoutApp(n_links=2, threshold=200, algorithm="AbsRS",
                            pipelined=pipelined)
        rng = np.random.default_rng(9)
        ts = 50_000
        for b in range(4):
            frames = np.zeros((2, 2, wibeth.FRAME_SIZE), np.uint8)
            adcs = (800 + rng.normal(0, 10, (2, 2, 64, 64))) \
                .astype(np.uint16)
            for _ in range(8):
                l, c = rng.integers(0, 2), rng.integers(0, 64)
                f, t = rng.integers(0, 2), rng.integers(0, 50)
                adcs[l, f, t:t + 6, c] += np.uint16(rng.integers(300, 900))
            for l in range(2):
                wibeth.set_adcs(frames[l], adcs[l])
                wibeth.fake_timestamps(frames[l], ts)
                wibeth.fake_seq_ids(frames[l], b * 2)
                wibeth.fake_geoid(frames[l], 1, l // 8, l % 8)
            app.process_batch(frames)
            ts += 2 * 2048
        app.flush()
        tps = app.handler.buffer.snapshot()
        info = app.get_info()
        return tps, info

    tps_s, info_s = run(False)
    tps_p, info_p = run(True)
    assert info_s["total_hits"] > 0
    for k in ("total_hits", "total_tps_sent", "ts_errors",
              "hits_dropped", "raw_buffered"):
        assert info_s[k] == info_p[k], k
    order_s = np.argsort(tps_s, order=("time_start", "channel", "time_peak"))
    order_p = np.argsort(tps_p, order=("time_start", "channel", "time_peak"))
    np.testing.assert_array_equal(tps_s[order_s], tps_p[order_p])


def test_batched_assembly_conf_change_applies(interpret_ingest):
    """A channel_mask_set change AFTER the first batch must take effect in
    batched mode (the lazily-built assembly tables are fingerprinted and
    invalidated on conf change — advisor r3), matching per-link mode."""
    from fdreadoutlibs_jax.apps.apa_readout import APAReadoutApp
    from fdreadoutlibs_jax.utils.channel_map import make_map

    def run(batched):
        app = APAReadoutApp(n_links=2, threshold=200, algorithm="AbsRS",
                            batched_assembly=batched)
        rng = np.random.default_rng(9)
        ts = 100_000
        for b in range(3):
            frames = np.zeros((2, 2, wibeth.FRAME_SIZE), np.uint8)
            adcs = (800 + rng.normal(0, 10, (2, 2, 64, 64))).astype(np.uint16)
            # deterministic pulses on channel 17 of both links every batch
            for l in range(2):
                adcs[l, 0, 20:30, 17] += 900
                wibeth.set_adcs(frames[l], adcs[l])
                wibeth.fake_timestamps(frames[l], ts)
                wibeth.fake_seq_ids(frames[l], b * 2)
                wibeth.fake_geoid(frames[l], 1, l // 8, l % 8)
            app.process_batch(frames)
            if b == 0:
                # conf change between batches: mask link 0's channel 17
                off0 = make_map("HDAPAChannelMap").offline_channels(
                    1, 0, 0, 64)
                app.procs[0].channel_mask_set = {int(off0[17])}
            ts += 2 * 2048
        app.get_info()
        return app.handler.buffer.snapshot()

    tps_b, tps_p = run(True), run(False)
    assert len(tps_b) > 0
    order_b = np.argsort(tps_b, order=("time_start", "channel", "time_peak"))
    order_p = np.argsort(tps_p, order=("time_start", "channel", "time_peak"))
    np.testing.assert_array_equal(tps_b[order_b], tps_p[order_p])


def test_batched_assembly_rejects_heterogeneous_conf(interpret_ingest):
    """Batched assembly applies ONE tp_max_width/tp_algo to all links; a
    heterogeneous conf must fail loudly, not silently use procs[0]'s."""
    import pytest
    from fdreadoutlibs_jax.apps.apa_readout import APAReadoutApp
    app = APAReadoutApp(n_links=2, threshold=200, algorithm="AbsRS",
                        batched_assembly=True)
    app.procs[1].tp_max_width = app.procs[0].tp_max_width + 1
    frames = np.zeros((2, 2, wibeth.FRAME_SIZE), np.uint8)
    adcs = np.full((2, 2, 64, 64), 800, np.uint16)
    adcs[:, 0, 20:30, 17] += 900
    for l in range(2):
        wibeth.set_adcs(frames[l], adcs[l])
        wibeth.fake_timestamps(frames[l], 100_000)
        wibeth.fake_seq_ids(frames[l], 0)
        wibeth.fake_geoid(frames[l], 1, l // 8, l % 8)
    with pytest.raises(ValueError, match="uniform"):
        app.process_batch(frames)


def test_batched_preprocess_error_parity(interpret_ingest):
    """The all-links vectorized header validation falls back to the exact
    per-link checks for anomalous links: error metrics and carried
    prev-seq/ts match the pure per-link path."""
    from fdreadoutlibs_jax.apps.apa_readout import APAReadoutApp

    def run(batched):
        app = APAReadoutApp(n_links=3, threshold=499,
                            batched_assembly=batched)
        ts = 100_000
        for b in range(3):
            frames = np.zeros((3, 2, wibeth.FRAME_SIZE), np.uint8)
            for l in range(3):
                wibeth.fake_timestamps(frames[l], ts)
                wibeth.fake_seq_ids(frames[l], b * 2)
                wibeth.fake_geoid(frames[l], 1, l // 8, l % 8)
            if b == 1:   # link 1: sequence jump + timestamp gap
                wibeth.set_header_field(frames[1], "seq_id",
                                        np.array([7, 8]))
                wibeth.set_timestamp(frames[1][1:], ts + 5 * 2048)
            if batched:
                app.process_batch(frames)
            else:
                # pure per-link path for comparison
                L, N, _ = frames.shape
                for l in range(L):
                    app.procs[l].sequence_check(frames[l])
                    app.procs[l].timestamp_check(frames[l])
            ts += 2 * 2048
        return app

    a = run(True)
    b = run(False)
    for l in range(3):
        for counter in ("num_seq_id_errors", "num_ts_errors"):
            assert a.procs[l].metrics.count(counter) == \
                b.procs[l].metrics.count(counter), (l, counter)
        assert a.procs[l].previous_seq_id == b.procs[l].previous_seq_id
        assert a.procs[l].previous_ts == b.procs[l].previous_ts
    assert a.procs[1].metrics.count("num_seq_id_errors") > 0
    assert a.procs[1].metrics.count("num_ts_errors") > 0
    assert a.procs[0].metrics.count("num_seq_id_errors") == 0


def test_raw_capacity_must_fit_batches(interpret_ingest):
    """An undersized --raw-capacity would silently drop the newest raw
    frames of every batch (cleanup trims to capacity/2 after insert);
    process_batch rejects it instead."""
    import pytest
    from fdreadoutlibs_jax.apps.apa_readout import APAReadoutApp
    app = APAReadoutApp(n_links=1, threshold=499, raw_capacity_frames=8)
    frames = np.zeros((1, 8, wibeth.FRAME_SIZE), np.uint8)
    wibeth.fake_timestamps(frames[0], 100_000)
    wibeth.fake_geoid(frames[0], 1, 0, 0)
    with pytest.raises(ValueError, match="raw_capacity"):
        app.process_batch(frames)


def test_batch_timings_and_latency_info(interpret_ingest):
    """Every processed batch records a stage-decomposed timing row, and
    latency_info derives the documented spec quantities: batch span from
    the DTS tick pitch and min_latency_ticks = 2x margin on the p95
    arrival->TP-available latency (README 'TP-emission latency')."""
    from fdreadoutlibs_jax.apps.apa_readout import APAReadoutApp
    app = APAReadoutApp(n_links=1, threshold=499)
    assert app.latency_info() == {}          # nothing recorded yet
    ts = 100_000
    for b in range(3):
        frames = np.zeros((1, 2, wibeth.FRAME_SIZE), np.uint8)
        wibeth.set_adcs(frames[0], np.full((2, 64, 64), 800, np.uint16))
        wibeth.fake_timestamps(frames[0], ts)
        wibeth.fake_seq_ids(frames[0], b * 2)
        wibeth.fake_geoid(frames[0], 1, 0, 0)
        app.process_batch(frames)
        ts += 2 * 2048
    assert len(app.batch_timings) == 3
    stage_keys = {"preprocess_ms", "retention_ms", "codec_ms",
                  "device_ms", "assembly_ms", "handler_ms", "total_ms"}
    for row in app.batch_timings:
        assert set(row) == stage_keys
        assert row["total_ms"] > 0
    info = app.latency_info(frames_per_batch=2)
    assert info["batches"] == 3
    assert info["proc_ms_p50"] <= info["proc_ms_p95"] <= info["proc_ms_max"]
    # span: 2 frames x 2048 DTS ticks x 16 ns (fields round to 3 dp)
    assert info["batch_span_ms"] == pytest.approx(2 * 2048 * 16e-6,
                                                  abs=1e-3)
    lat = info["batch_span_ms"] + info["proc_ms_p95"]
    assert info["latency_ms_p95"] == pytest.approx(lat, abs=2e-3)
    assert info["min_latency_ticks"] == pytest.approx(
        2.0 * lat * 62_500, abs=2e-3 * 2 * 62_500 + 1)


def test_pds_pipelined_matches_unpipelined(interpret_ingest):
    """PDS depth-2 pipelining: identical TP stream and counters as the
    synchronous path once flushed (same contract as the APA app)."""
    from fdreadoutlibs_jax.apps.pds_readout import PDSReadoutApp
    from fdreadoutlibs_jax.formats import daphne

    def run(pipelined):
        app = PDSReadoutApp(n_links=2, threshold=150,
                            raw_capacity_superchunks=16,
                            pipelined=pipelined)
        rng = np.random.default_rng(4)
        ts = 0x2000000
        T = daphne.STREAM_FRAMES_PER_SUPERCHUNK * daphne.STREAM_N_SAMPLES
        for b in range(3):
            scs = np.stack([daphne.empty_superchunks(1, stream=True)
                            for _ in range(2)])
            frames = daphne.superchunk_frames(scs, stream=True)
            adcs = (700 + rng.normal(0, 6, (2, T, 4))).astype(np.uint16)
            for _ in range(4):
                l, c = rng.integers(0, 2), rng.integers(0, 4)
                t0 = rng.integers(0, T - 30)
                adcs[l, t0:t0 + 12, c] += np.uint16(rng.integers(200, 900))
            for l in range(2):
                daphne.stream_set_adcs(
                    frames[l].reshape(-1, daphne.STREAM_FRAME_SIZE),
                    adcs[l].reshape(-1, daphne.STREAM_N_SAMPLES, 4))
                daphne.fake_timestamps(scs[l], ts, offset=64, stream=True)
            app.process_batch(scs)
            ts += T
        app.flush()
        return app.handler.buffer.snapshot(), app.get_info()

    tps_s, info_s = run(False)
    tps_p, info_p = run(True)
    assert info_s["total_hits"] > 0
    for k in ("total_hits", "total_tps_sent", "ts_errors",
              "hits_dropped", "raw_buffered"):
        assert info_s[k] == info_p[k], k
    order_s = np.argsort(tps_s, order=("time_start", "channel", "time_peak"))
    order_p = np.argsort(tps_p, order=("time_start", "channel", "time_peak"))
    np.testing.assert_array_equal(tps_s[order_s], tps_p[order_p])


def test_pds_readout_end_to_end(interpret_ingest):
    """PDS (DAPHNE-stream) composition: fused multi-link ingest, PDS TP
    assembly (1 clock/tick), TPSet windowing, raw data requests."""
    from fdreadoutlibs_jax.apps.pds_readout import PDSReadoutApp
    from fdreadoutlibs_jax.formats import daphne
    app = PDSReadoutApp(n_links=2, threshold=400, raw_capacity_superchunks=16)
    ts = 0x2000000
    T = daphne.STREAM_FRAMES_PER_SUPERCHUNK * daphne.STREAM_N_SAMPLES
    for b in range(3):
        scs = np.stack([daphne.empty_superchunks(1, stream=True)
                        for _ in range(2)])
        frames = daphne.superchunk_frames(scs, stream=True)
        adcs = np.full((2, T, 4), 700, np.uint16)
        if b == 1:
            adcs[1, 100:110, 2] += 900          # link 1, channel 2
        for l in range(2):
            daphne.stream_set_adcs(
                frames[l].reshape(-1, daphne.STREAM_FRAME_SIZE),
                adcs[l].reshape(-1, daphne.STREAM_N_SAMPLES, 4))
            daphne.fake_timestamps(scs[l], ts, offset=64, stream=True)
        app.process_batch(scs)
        ts += T
    info = app.get_info()
    assert info["ts_errors"] == 0
    assert info["total_hits"] == 1
    assert info["raw_buffered"] == 6
    tps = app.handler.buffer.snapshot()
    assert len(tps) == 1
    tp = tps[0]
    assert tp["channel"] == 1 * 4 + 2           # global link*4 + c
    # batch 1 started at 0x2000000 + T; pulse at tick 100, 10 over
    assert tp["time_start"] == 0x2000000 + T + 100
    assert tp["time_over_threshold"] == 10
    assert tp["adc_integral"] == 10 * 900
    # windowed raw request on the hit link returns covering superchunks
    raw = app.request_raw(1, int(tp["time_start"]), int(tp["time_start"]) + 1)
    assert len(raw) >= 1


def test_pds_corrupt_header_ts_no_overflow(interpret_ingest):
    """A DAPHNE-stream superchunk whose header timestamp has the top bit
    set (the corruption scripts/fuzz_frames.py injects) must degrade, not
    raise OverflowError — same uint64-ts class as the processors'
    ts_to_i64 fix (commit b924655)."""
    from fdreadoutlibs_jax.apps.pds_readout import PDSReadoutApp
    from fdreadoutlibs_jax.formats import daphne
    app = PDSReadoutApp(n_links=1, threshold=400, raw_capacity_superchunks=16)
    scs = daphne.empty_superchunks(1, stream=True)[None]      # (1, 1, 5664)
    frames = daphne.superchunk_frames(scs[0], stream=True)
    daphne.stream_set_timestamp(
        frames.reshape(-1, daphne.STREAM_FRAME_SIZE), (1 << 63) + 12345)
    app.process_batch(scs)                                    # must not raise
    assert app.get_info()["raw_buffered"] == 1
