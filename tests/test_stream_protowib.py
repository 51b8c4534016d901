"""ProtoWIB processor + legacy WIBTPHandler tests."""

import numpy as np

from fdreadoutlibs_jax.formats import protowib
from fdreadoutlibs_jax.formats.trigprim import make_tps
from fdreadoutlibs_jax.stream.protowib import WIBFrameProcessor
from fdreadoutlibs_jax.stream.transport import QueueSender
from fdreadoutlibs_jax.tp.wib_tp_handler import WIBTPHandler


def make_superchunks(n, pulse_chan=None, pulse_amp=600, base=800, seed=0):
    rng = np.random.default_rng(seed)
    T = n * protowib.FRAMES_PER_SUPERCHUNK
    adcs = (base + rng.normal(0, 3, size=(T, 256))).astype(np.uint16) & 0xFFF
    if pulse_chan is not None:
        adcs[40:52, pulse_chan] += pulse_amp
    sc = protowib.empty_superchunks(n)
    frames = protowib.superchunk_frames(sc)
    protowib.set_adcs(frames, adcs.reshape(n, 12, 256))
    protowib.fake_timestamps(sc, 50_000)
    return sc, adcs


def make_processor(**conf):
    handler = WIBTPHandler(tp_sink=QueueSender(), tpset_sink=QueueSender(),
                           tp_timeout=100_000, tpset_window_size=2_000)
    proc = WIBFrameProcessor(tp_handler=handler,
                             errored_frame_sink=QueueSender())
    c = {"crate_id": 0, "slot_id": 0, "link_id": 0, "enable_tpg": True}
    c.update(conf)
    proc.conf(c)
    proc.start()
    return proc, handler


class TestWIBTPHandler:
    def test_add_and_window(self):
        tp_q, tpset_q = QueueSender(), QueueSender()
        h = WIBTPHandler(tp_sink=tp_q, tpset_sink=tpset_q, tp_timeout=100,
                         tpset_window_size=50)
        tps = make_tps(3)
        tps["time_start"] = [120, 130, 210]
        for tp in tps:
            assert h.add_tp(tp, current_time=200)
        # too-old TP rejected (hpp:49-57)
        old = make_tps(1)
        old["time_start"] = [50]
        assert not h.add_tp(old[0], current_time=200)
        # window [100,150) closes once current > 120+50+100
        assert h.try_sending_tpsets(260) is None
        tpset = h.try_sending_tpsets(271)
        assert tpset is not None
        assert tpset.start_time == 100 and tpset.end_time == 150
        assert len(tpset.objects) == 2
        assert len(h) == 1          # the 210 TP remains

    def test_ordering(self):
        h = WIBTPHandler(tp_timeout=1000, tpset_window_size=1000)
        tps = make_tps(3)
        tps["time_start"] = [300, 100, 200]
        h.add_tps(tps, current_time=500)
        s = h.try_sending_tpsets(100 + 1000 + 1000 + 1)
        assert [int(t["time_start"]) for t in s.objects] == [100, 200, 300]


class TestWIBFrameProcessor:
    def test_collection_pulse_tp(self):
        pulse_chan = int(protowib.COLLECTION_INDEX_TO_CHAN[20])
        proc, handler = make_processor()
        sc, _ = make_superchunks(16, pulse_chan=pulse_chan)
        proc.process(sc)
        assert proc.metrics.count("num_hits") >= 1
        assert proc.metrics.count("num_tps_sent") >= 1
        # offline channel mapping: register 20 -> offline offset table
        top = proc.metrics.top_channels()[0][0]
        assert top == proc.collection_offlines[20]

    def test_induction_pulse_goes_to_induction_plane(self):
        pulse_chan = int(protowib.INDUCTION_INDEX_TO_CHAN[33])
        proc, handler = make_processor()
        sc, _ = make_superchunks(16, pulse_chan=pulse_chan)
        proc.process(sc)
        top = proc.metrics.top_channels()[0][0]
        assert top == proc.induction_offlines[33]

    def test_timestamp_gap(self):
        proc, _ = make_processor()
        sc, _ = make_superchunks(4)
        frames = protowib.superchunk_frames(sc)
        ts = protowib.get_timestamp(frames[2])
        protowib.set_timestamp(frames[2], ts + 300)
        protowib.set_timestamp(frames[3], ts + 600)
        proc.process(sc)
        assert proc.metrics.count("num_ts_errors") >= 1

    def test_frame_errors_forwarded(self):
        proc, _ = make_processor()
        sc, _ = make_superchunks(2)
        protowib.fake_frame_errors(sc[0:1], 0b101)
        proc.process(sc)
        # popcount semantics: 12 frames x 2 set bits (hpp:415-417)
        assert proc.metrics.count("num_frame_errors") == 24
        assert proc.metrics.count("num_frame_errors_bit0") == 12
        assert proc.metrics.count("num_frame_errors_bit2") == 12
        assert len(proc.errored_frame_sink) == 1
        assert len(proc.errored_frame_sink.drain()[0]) == 12

    def test_errored_frame_gating_and_decay(self):
        """Per-bit occurrence counters cap forwarding at the threshold and
        leak 1 per bit every 10000 frames (hpp:404-438)."""
        proc, _ = make_processor(error_counter_threshold=2)
        sc, _ = make_superchunks(1)
        protowib.fake_frame_errors(sc, 0b101)
        proc.process(sc)
        # 12 errored frames but each bit only forwards while counter < 2
        sent = proc.errored_frame_sink.drain()
        assert len(sent) == 1 and len(sent[0]) == 2
        # saturated: nothing more forwarded
        sc2, _ = make_superchunks(1)
        protowib.fake_frame_errors(sc2, 0b101)
        proc.process(sc2)
        assert len(proc.errored_frame_sink) == 0
        # cross a decay point: one unit of budget returns per bit
        proc._frames_processed = 9999
        sc3, _ = make_superchunks(1)
        protowib.fake_frame_errors(sc3, 0b101)
        proc.process(sc3)
        sent = proc.errored_frame_sink.drain()
        assert len(sent) == 1 and len(sent[0]) == 1

    def test_tp_times_use_25_tick_clock(self):
        pulse_chan = int(protowib.COLLECTION_INDEX_TO_CHAN[0])
        proc, handler = make_processor()
        sc, _ = make_superchunks(16, pulse_chan=pulse_chan, pulse_amp=800)
        proc.process(sc)
        # drain everything through the tpset path
        tpset = handler.try_sending_tpsets(10**12)
        tps = tpset.objects
        assert len(tps) >= 1
        tp = tps[0]
        # pulse at ticks 40..51 -> begin = 50_000 + 25 * begin_tick
        assert (int(tp["time_start"]) - 50_000) % 25 == 0
        begin_tick = (int(tp["time_start"]) - 50_000) // 25
        assert 38 <= begin_tick <= 46    # FIR group delay shifts it a bit
        assert tp["adc_peak"] == tp["adc_integral"] // 20


def test_backend_equivalence_protowib():
    """reference/scan/pallas backends agree through the WIB processor."""
    pulse_chan = int(protowib.COLLECTION_INDEX_TO_CHAN[10])
    results = {}
    for backend in ("reference", "scan", "pallas"):
        proc, handler = make_processor(
            tpg_backend=backend, tpg_pallas_interpret=backend == "pallas")
        sc, _ = make_superchunks(16, pulse_chan=pulse_chan, pulse_amp=700)
        proc.process(sc)
        tpset = handler.try_sending_tpsets(10**12)
        results[backend] = tpset.objects if tpset else []
    np.testing.assert_array_equal(np.array(list(results["scan"])),
                                  np.array(list(results["reference"])))
    np.testing.assert_array_equal(np.array(list(results["pallas"])),
                                  np.array(list(results["reference"])))


def test_protowib_device_codec_parity():
    """unpack_frames_jnp (static byte extraction) == host get_adcs."""
    import jax.numpy as jnp
    rng = np.random.default_rng(9)
    frames = np.zeros((24, protowib.FRAME_SIZE), np.uint8)
    adcs = rng.integers(0, 1 << 12, size=(24, 256), dtype=np.uint16)
    protowib.set_adcs(frames, adcs)
    dev = np.asarray(protowib.unpack_frames_jnp(
        jnp.asarray(protowib.frames_bytes_to_u32(frames))))
    np.testing.assert_array_equal(dev, adcs.astype(np.int32))
    np.testing.assert_array_equal(protowib.get_adcs(frames), adcs)


def test_pallas_fused_state_carries_across_batches():
    """The fused path's per-plane device stacks carry FIR ring + pedestal
    state across process() calls: TPs from 3 sequential batches equal the
    reference backend's, including a pulse spanning a batch boundary."""
    rng = np.random.default_rng(13)
    batches = []
    ts = 50_000
    pulse_chan = int(protowib.COLLECTION_INDEX_TO_CHAN[7])
    for b in range(3):
        sc = protowib.empty_superchunks(4)
        frames = protowib.superchunk_frames(sc).reshape(-1, protowib.FRAME_SIZE)
        adcs = (900 + rng.normal(0, 10, (len(frames), 256))).astype(np.uint16)
        if b == 1:
            adcs[44:48, pulse_chan] += 700          # tail end of batch 1...
        if b == 2:
            adcs[0:6, pulse_chan] += 700            # ...continues into batch 2
        protowib.set_adcs(frames, adcs)
        protowib.fake_timestamps(sc, ts)
        batches.append(sc)
        ts += 4 * 300

    results = {}
    for backend in ("reference", "pallas"):
        proc, handler = make_processor(tpg_backend=backend,
                                       tpg_pallas_interpret=True)
        for sc in batches:
            proc.process(sc.copy())
        # drain EVERY window — the boundary-spanning pulse's TP lands
        # beyond the first 2000-clock window (review r3)
        tps = []
        while (tpset := handler.try_sending_tpsets(10**12)) is not None:
            tps.extend(tpset.objects)
        results[backend] = np.array(tps) if tps else np.zeros(0)
    # the boundary-spanning pulse merges into ONE TP across the batches
    assert len(results["reference"]) >= 1
    key = ["time_start", "channel"]
    np.testing.assert_array_equal(np.sort(results["reference"], order=key),
                                  np.sort(results["pallas"], order=key))


def test_pallas_time2_feed_matches_packed():
    """The time2 host feed (native.relayout_time2_protowib: host 12-bit
    decode + time pairing -> plain time_packed dual-plane FIR datapath)
    produces the identical TP stream as the fused packed ingest, with
    carried state across batches."""
    rng = np.random.default_rng(29)
    batches = []
    ts = 50_000
    pulse_c = int(protowib.COLLECTION_INDEX_TO_CHAN[11])
    pulse_i = int(protowib.INDUCTION_INDEX_TO_CHAN[3])
    for b in range(2):
        sc = protowib.empty_superchunks(4)
        frames = protowib.superchunk_frames(sc).reshape(
            -1, protowib.FRAME_SIZE)
        adcs = (900 + rng.normal(0, 10, (len(frames), 256))).astype(np.uint16)
        adcs[20 + 10 * b:30 + 10 * b, pulse_c] += 700
        adcs[8:14, pulse_i] += 700
        protowib.set_adcs(frames, adcs)
        protowib.fake_timestamps(sc, ts)
        batches.append(sc)
        ts += 4 * 300

    results = {}
    for name, conf in (("packed", {}), ("time2", {"tpg_time2_feed": True})):
        proc, handler = make_processor(tpg_backend="pallas",
                                       tpg_pallas_interpret=True, **conf)
        for sc in batches:
            proc.process(sc.copy())
        # drain EVERY window, not just the first 2000-clock one — the
        # batch-1 pulse (the cross-batch carried-state case) lands in a
        # later window (review r3)
        tps = []
        while (tpset := handler.try_sending_tpsets(10**12)) is not None:
            tps.extend(tpset.objects)
        results[name] = np.array(tps) if tps else np.zeros(0)
    assert len(results["packed"]) >= 2
    key = ["time_start", "channel"]
    np.testing.assert_array_equal(np.sort(results["packed"], order=key),
                                  np.sort(results["time2"], order=key))


def test_protowib_time2_codec_parity():
    """native.relayout_time2_protowib == numpy fallback == direct decode,
    both planes, incl. out= reuse."""
    from fdreadoutlibs_jax import native
    rng = np.random.default_rng(5)
    T = 24
    frames = protowib.empty_frames(T)
    adcs = rng.integers(0, 1 << 12, size=(T, 256), dtype=np.uint16)
    protowib.set_adcs(frames, adcs)
    for chan in (protowib.COLLECTION_INDEX_TO_CHAN,
                 protowib.INDUCTION_INDEX_TO_CHAN):
        a = native.relayout_time2_protowib(frames, chan)
        orig = native.load
        native.load = lambda: None
        try:
            b = native.relayout_time2_protowib(frames, chan)
        finally:
            native.load = orig
        np.testing.assert_array_equal(a, b)
        C = len(chan)
        want = adcs[:, np.asarray(chan)].astype(np.int32)
        flat = a.reshape(T // 2, -1)[:, :C]
        np.testing.assert_array_equal(flat & 0xFFFF, want[0::2])
        np.testing.assert_array_equal((flat >> 16) & 0xFFFF, want[1::2])
        out = native._aligned_empty(a.shape, np.int32)
        np.testing.assert_array_equal(
            native.relayout_time2_protowib(frames, chan, out=out), a)


def test_handler_backlog_bounded_across_coarse_batches():
    """One try_sending_tpsets call drains one window; the processor must
    loop per batch or a multi-window batch grows the heap without bound
    (a 384-tick batch spans ~5 aligned 2000-clock windows)."""
    handler = WIBTPHandler(tp_sink=QueueSender(), tpset_sink=QueueSender(),
                           tp_timeout=10_000, tpset_window_size=2_000)
    proc = WIBFrameProcessor(tp_handler=handler,
                             errored_frame_sink=QueueSender())
    proc.conf({"crate_id": 0, "slot_id": 0, "link_id": 0,
               "enable_tpg": True, "tpg_backend": "reference"})
    proc.start()
    ts = 50_000
    rng = np.random.default_rng(41)
    chan = int(protowib.COLLECTION_INDEX_TO_CHAN[2])
    for b in range(3):
        n_sc = 32                              # 384 ticks = 9600 clocks
        sc = protowib.empty_superchunks(n_sc)
        frames = protowib.superchunk_frames(sc).reshape(
            -1, protowib.FRAME_SIZE)
        adcs = (900 + rng.normal(0, 3, (len(frames), 256))).astype(np.uint16)
        for t0 in range(16, 360, 48):          # a TP in most windows
            adcs[t0:t0 + 10, chan] += 700
        protowib.set_adcs(frames, adcs)
        protowib.fake_timestamps(sc, ts)
        proc.process(sc)
        ts += n_sc * 300
    # after each batch every window older than (current - timeout -
    # window) must have been drained: the heap holds at most the tail
    # windows still inside the tardy allowance, NOT the whole run
    assert handler.sent_tpsets >= 6, handler.sent_tpsets
    assert len(handler) <= 16, len(handler)
