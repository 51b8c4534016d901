"""Fused device-ingest pipeline tests (packed bytes -> unpack -> TPG)."""

import numpy as np

from fdreadoutlibs_jax.formats import wibeth
from fdreadoutlibs_jax.ops import TPGConfig
from fdreadoutlibs_jax.ops.hits import concat_hits
from fdreadoutlibs_jax.ops.ingest import StreamingIngest, host_words
from fdreadoutlibs_jax.ops.reference import run_reference


def make_frames(L, N, seed=0, pulse=None):
    rng = np.random.default_rng(seed)
    frames = np.zeros((L, N, wibeth.FRAME_SIZE), np.uint8)
    adcs = (900 + rng.normal(0, 30, size=(L, N, 64, 64))).astype(np.uint16)
    if pulse:
        l, f, t, c, amp = pulse
        adcs[l, f, t:t + 10, c] += amp
    for l in range(L):
        wibeth.set_adcs(frames[l], adcs[l])
    return frames, adcs


def link_major_stream(adcs):
    """(L, N, 64, 64) -> (N*64, L*64) the ingest channel layout."""
    L, N = adcs.shape[:2]
    return adcs.reshape(L, N * 64, 64).transpose(1, 0, 2) \
        .reshape(N * 64, L * 64).astype(np.int32)


class TestStreamingIngest:
    def test_matches_oracle_across_batches(self):
        L, N = 4, 2
        frames, adcs = make_frames(L, N, pulse=(1, 1, 10, 5, 2000))
        cfg = TPGConfig(threshold=150)      # 5 sigma: no K-slot overflow
        ing = StreamingIngest(cfg, n_links=L, tc=128, k_slots=8,
                              interpret=True)
        parts = []
        dropped = 0
        for _ in range(3):
            out = ing.submit(frames)
            if out:
                parts.append(out[0])
                dropped += out[1]
        out = ing.flush()
        parts.append(out[0])
        dropped += out[1]
        got = concat_hits(parts)
        stream = np.tile(link_major_stream(adcs), (3, 1))
        ref, _ = run_reference(stream, cfg, window=N * 64)
        assert len(ref) > 0
        assert dropped == 0
        np.testing.assert_array_equal(got, ref)

    def test_host_never_decodes(self):
        """host_words is a pure byte view: byte-identical to the ADC region."""
        frames, _ = make_frames(1, 2, seed=3)
        w = host_words(frames.reshape(-1, wibeth.FRAME_SIZE))
        assert w.dtype == np.uint32 and w.shape == (2, 64, 28)
        np.testing.assert_array_equal(
            w.view(np.uint8).reshape(2, -1),
            frames[0][:, 32:])

    def test_per_channel_memory_factors_match_oracle(self):
        """StreamingIngest(rs_memory_factor=per-channel) — the production
        threshold-on-collection mix — is bit-exact vs the oracle seeded
        with the same factors."""
        L, N = 1, 1      # minimal shapes: interpret mode is slow on 1 core
        frames, adcs = make_frames(L, N, seed=9, pulse=(0, 0, 20, 3, 1500))
        cfg = TPGConfig.from_raw("AbsRS", threshold=150)
        C = L * 64
        rmf = np.where(np.arange(C) % 2 == 0, 0, cfg.rs_memory_factor_x10)
        ing = StreamingIngest(cfg, n_links=L, tc=32, k_slots=4, unroll=1,
                              interpret=True, rs_memory_factor=rmf)
        ing.submit(frames)
        got, dropped = ing.flush()
        ref, _ = run_reference(link_major_stream(adcs), cfg,
                               rs_memory_factor=rmf)
        assert len(ref) > 0 and dropped == 0
        np.testing.assert_array_equal(got, ref)
        # shape and promise violations are rejected loudly
        import pytest
        # ValueError (not assert) so the check survives python -O
        with pytest.raises(ValueError, match="rs_memory_factor"):
            StreamingIngest(cfg, n_links=L, rs_memory_factor=rmf[:10])
        with pytest.raises(ValueError, match="rs_mf_shift"):
            StreamingIngest(cfg, n_links=L,
                            rs_memory_factor=np.full(C, 6))

    def test_pipelining_returns_previous_batch(self):
        L, N = 2, 1
        frames, _ = make_frames(L, N, seed=5)
        ing = StreamingIngest(TPGConfig(threshold=120), n_links=L,
                              interpret=True)
        assert ing.submit(frames) is None          # first: nothing pending
        out = ing.submit(frames)
        assert out is not None                      # second: batch 0's hits
        assert ing.flush() is not None              # batch 1's hits
        assert ing.flush() is None


class TestWIB2Ingest:
    def test_fused_wib2_matches_oracle(self):
        import jax.numpy as jnp
        from fdreadoutlibs_jax.formats import wib2
        from fdreadoutlibs_jax.ops.chanstate import (init_chanstate,
                                                     seed_chanstate)
        from fdreadoutlibs_jax.ops.ingest import process_packed_wib2
        from fdreadoutlibs_jax.ops.pallas_tpg import (decode_pallas_hits,
                                                      pack_state)
        rng = np.random.default_rng(1)
        L, T = 2, 48
        adcs = (800 + rng.normal(0, 20, size=(L, T, 256))).astype(np.uint16)
        adcs[1, 20:28, 100] += 900
        frames = wib2.empty_frames(L * T).reshape(L, T, wib2.FRAME_SIZE)
        for l in range(L):
            wib2.set_adcs(frames[l], adcs[l])
        words = np.ascontiguousarray(wib2.adc_region_u32(frames))
        C = L * 256
        cfg = TPGConfig(threshold=120)
        stream = adcs.transpose(1, 0, 2).reshape(T, C).astype(np.int32)
        stack = pack_state(seed_chanstate(init_chanstate(C), stream[0], 8), C)
        slots, nclose, _ = process_packed_wib2(
            jnp.asarray(words), stack, cfg, C, tc=48, unroll=1,
            interpret=True)
        got, dropped = decode_pallas_hits(slots, nclose, C)
        ref, _ = run_reference(stream, cfg, window=T)
        assert dropped == 0 and len(ref) > 0
        np.testing.assert_array_equal(got, ref)


def test_streaming_ingest_wib2_format():
    """StreamingIngest with format='wib2': 256-channel frames, 1 tick each."""
    import jax.numpy as jnp
    from fdreadoutlibs_jax.formats import wib2
    rng = np.random.default_rng(9)
    L, N = 2, 48          # 48 one-tick frames per link
    adcs = (800 + rng.normal(0, 20, size=(L, N, 256))).astype(np.uint16)
    adcs[0, 20:28, 77] += 900
    frames = wib2.empty_frames(L * N).reshape(L, N, wib2.FRAME_SIZE)
    for l in range(L):
        wib2.set_adcs(frames[l], adcs[l])
    cfg = TPGConfig(threshold=120)
    ing = StreamingIngest(cfg, n_links=L, tc=48, k_slots=8,
                          interpret=True, format="wib2")
    assert ing.submit(frames) is None
    hits, dropped = ing.flush()
    assert dropped == 0
    stream = adcs.transpose(1, 0, 2).reshape(N, L * 256).astype(np.int32)
    ref, _ = run_reference(stream, cfg, window=N)
    np.testing.assert_array_equal(hits, ref)


def test_streaming_ingest_device_compact_matches_host_decode():
    """device_compact=True (K-slot buffers compacted to a hit list ON
    device, ~40x smaller device->host transfer) yields exactly the host
    decode's hits — across multiple batches with carried tick offsets."""
    from fdreadoutlibs_jax.formats import wibeth as _w
    rng = np.random.default_rng(17)
    L, N = 2, 2
    cfg = TPGConfig(threshold=120)

    def make_batch(seed):
        r = np.random.default_rng(seed)
        adcs = (800 + r.normal(0, 15, size=(L, N, 64, 64))).astype(np.uint16)
        adcs[0, 1, 10:18, 7] += 900
        adcs[1, 0, 30:35, 40] += 700
        frames = np.zeros((L, N, _w.FRAME_SIZE), np.uint8)
        for l in range(L):
            _w.set_adcs(frames[l], adcs[l])
        return frames

    runs = {}
    for compact in (False, True):
        ing = StreamingIngest(cfg, n_links=L, tc=64, k_slots=8,
                              interpret=True, device_compact=compact)
        parts = []
        for b in range(3):
            got = ing.submit(make_batch(b))
            if got is not None:
                parts.append(got)
        parts.append(ing.flush())
        assert all(d == 0 for _, d in parts)
        runs[compact] = np.concatenate([h for h, _ in parts])
    np.testing.assert_array_equal(runs[True], runs[False])
    assert len(runs[True]) >= 6      # both pulses found in all 3 batches


def test_device_compact_counts_output_overflow_as_dropped():
    import jax.numpy as jnp
    from fdreadoutlibs_jax.ops.hits import compact_pallas_slots
    # 3 valid records, room for 2
    slots = np.zeros((1, 1, 4, 3, 8, 128), np.int32)
    nclose = np.zeros((1, 1, 8, 128), np.int32)
    for k, ch in [(0, 3), (1, 3), (0, 5)]:
        slots[0, 0, k, :, ch // 128, ch % 128] = [(10 << 16) | 1, 0, 7]
        nclose[0, 0, ch // 128, ch % 128] += 1
    rows, n, dropped = compact_pallas_slots(jnp.asarray(slots),
                                            jnp.asarray(nclose), 128, 2)
    assert int(n) == 2 and int(dropped) == 1


def test_pack_time2_jnp_matches_host():
    import jax.numpy as jnp
    from fdreadoutlibs_jax.ops.pallas_tpg import (pack_adcs, pack_adcs_time2,
                                                  pack_time2_jnp)
    rng = np.random.default_rng(2)
    adcs = rng.integers(0, 1 << 14, size=(64, 200), dtype=np.int32)
    host = pack_adcs_time2(adcs)
    dev = np.asarray(pack_time2_jnp(jnp.asarray(pack_adcs(adcs))))
    np.testing.assert_array_equal(host, dev)


def test_fused_ingest_fuzz_all_formats():
    """Random streams through every fused-ingest codec path match the
    numpy oracle (interpret mode, one seed per format)."""
    import jax.numpy as jnp
    from fdreadoutlibs_jax.formats import daphne, protowib, wib2
    from fdreadoutlibs_jax.ops import TPGConfig, Algorithm
    from fdreadoutlibs_jax.ops.chanstate import init_chanstate, seed_chanstate
    from fdreadoutlibs_jax.ops.hits import sort_hits
    from fdreadoutlibs_jax.ops.ingest import (process_packed_daphne,
                                              process_packed_frames,
                                              process_packed_protowib,
                                              process_packed_wib2,
                                              host_words)
    from fdreadoutlibs_jax.ops.pallas_tpg import (decode_pallas_hits,
                                                  pack_state)
    from fdreadoutlibs_jax.ops.reference import process_window_reference
    rng = np.random.default_rng(31)
    cfg = TPGConfig(algorithm=Algorithm.ABS_RS, threshold=300)

    def oracle(stream, cfg, C):
        st = seed_chanstate(init_chanstate(C), stream[0],
                            cfg.rs_memory_factor_x10)
        hits, _ = process_window_reference(stream.astype(np.int32), st, cfg)
        return sort_hits(hits), st

    # --- wibeth: 1 link x 2 frames (T=128, 64 ch)
    adcs = (820 + rng.normal(0, 12, (2, 64, 64))).astype(np.uint16)
    adcs[0, 10:19, 9] += 900
    frames = np.zeros((2, wibeth.FRAME_SIZE), np.uint8)
    wibeth.set_adcs(frames, adcs)
    words = host_words(frames).reshape(1, 128, 28)
    stream = adcs.reshape(128, 64)
    ref, st = oracle(stream, cfg, 64)
    out = process_packed_frames(jnp.asarray(words), pack_state(st, 64), cfg,
                                64, tc=64, k_slots=8, unroll=1,
                                interpret=True)
    hits, _ = decode_pallas_hits(out[0], out[1], 64)
    np.testing.assert_array_equal(hits, ref)

    # --- wib2: 64 single-tick frames of 256 ch
    adcs = (820 + rng.normal(0, 12, (64, 256))).astype(np.uint16)
    adcs[20:28, 100] += 900
    frames = wib2.empty_frames(64)
    wib2.set_adcs(frames, adcs)
    words = np.ascontiguousarray(wib2.adc_region_u32(frames)) \
        .reshape(1, 64, wib2.ADC_WORDS)
    ref, st = oracle(adcs, cfg, 256)
    out = process_packed_wib2(jnp.asarray(words), pack_state(st, 256), cfg,
                              256, tc=64, k_slots=8, unroll=1,
                              interpret=True)
    hits, _ = decode_pallas_hits(out[0], out[1], 256)
    np.testing.assert_array_equal(hits, ref)

    # --- daphne stream: 2 frames x 64 ticks x 4 ch
    adcs = (820 + rng.normal(0, 12, (2, 64, 4))).astype(np.uint16)
    adcs[1, 5:13, 2] += 900
    frames = daphne.stream_empty_frames(2)
    daphne.stream_set_adcs(frames, adcs)
    words = daphne.stream_frames_bytes_to_u32(frames) \
        .reshape(1, 2, daphne.STREAM_ADC_WORDS)
    stream = adcs.reshape(128, 4)
    ref, st = oracle(stream, cfg, 4)
    out = process_packed_daphne(jnp.asarray(words), pack_state(st, 4), cfg,
                                4, tc=64, k_slots=8, unroll=1,
                                interpret=True)
    hits, _ = decode_pallas_hits(out[0], out[1], 4)
    np.testing.assert_array_equal(hits, ref)

    # --- protowib: 64 frames, dual-plane FIR
    fir = TPGConfig(algorithm=Algorithm.FIR, threshold=5)
    adcs = (900 + rng.normal(0, 10, (64, 256))).astype(np.uint16)
    adcs[30:38, int(protowib.COLLECTION_INDEX_TO_CHAN[3])] += 600
    frames = np.zeros((64, protowib.FRAME_SIZE), np.uint8)
    protowib.set_adcs(frames, adcs)
    words = jnp.asarray(protowib.frames_bytes_to_u32(frames))
    coll = adcs[:, protowib.COLLECTION_INDEX_TO_CHAN].astype(np.int32)
    ref, st_c = oracle(coll, fir, 96)
    _, st_i = oracle(adcs[:, protowib.INDUCTION_INDEX_TO_CHAN]
                     .astype(np.int32), fir, 160)
    (cs, cn, _), _ = process_packed_protowib(
        words, pack_state(st_c, 96), pack_state(st_i, 160), fir, fir,
        tc=64, k_slots=8, unroll=1, interpret=True)
    hits, _ = decode_pallas_hits(cs, cn, 96)
    np.testing.assert_array_equal(hits, ref)


def test_bench_ingest_encoding_roundtrip():
    """bench.py's ingest-inclusive mode encodes the ADC stream into WIBEth
    byte words link-major; the fused ingest must yield hits identical to
    the direct packed-ADC path (pins the bench's to_words layout)."""
    import jax.numpy as jnp
    from fdreadoutlibs_jax.formats import wibeth
    from fdreadoutlibs_jax.ops import TPGConfig
    from fdreadoutlibs_jax.ops.chanstate import init_chanstate, seed_chanstate
    from fdreadoutlibs_jax.ops.ingest import process_packed_frames
    from fdreadoutlibs_jax.ops.pallas_tpg import (
        decode_pallas_hits, pack_adcs, pack_state, process_window_pallas)

    C, T = 128, 256
    L, n_frames = C // 64, T // 64
    cfg = TPGConfig.from_raw("AbsRS", threshold=150)
    rng = np.random.default_rng(0)
    adcs = (900 + rng.normal(0, 30, size=(T, C))).astype(np.int32)
    adcs[40:48, 17] += 2000
    adcs[100:120, 70] += 1500
    frames = wibeth.empty_frames(L * n_frames)
    a = adcs.reshape(n_frames, 64, L, 64).transpose(2, 0, 1, 3)
    wibeth.set_adcs(frames,
                    a.reshape(L * n_frames, 64, 64).astype(np.uint16))
    words = wibeth.frames_bytes_to_u32(frames).reshape(L, T, 28)

    st = seed_chanstate(init_chanstate(C), adcs[0], cfg.rs_memory_factor_x10)
    s0 = pack_state(st, C)
    slots1, ncl1, _ = process_window_pallas(
        jnp.asarray(pack_adcs(adcs)), s0, cfg, tc=128, k_slots=2,
        interpret=True)
    h1, _ = decode_pallas_hits(slots1, ncl1, C)
    slots2, ncl2, _ = process_packed_frames(
        jnp.asarray(words), s0, cfg, C, tc=128, k_slots=2, unroll=1,
        interpret=True)
    h2, _ = decode_pallas_hits(slots2, ncl2, C)
    assert len(h1) > 10
    np.testing.assert_array_equal(h1, h2)


class TestTime2Feed:
    def test_relayout_native_numpy_and_semantics(self, monkeypatch):
        """native.relayout_time2 (C++ and numpy fallback) agree and match
        the canonical pack_adcs_time2 of the unpacked stream."""
        from fdreadoutlibs_jax import native
        from fdreadoutlibs_jax.ops.pallas_tpg import pack_adcs_time2
        for L, N, seed in [(2, 2, 5), (3, 3, 6)]:
            frames, adcs = make_frames(L, N, seed=seed)
            words = host_words(frames.reshape(-1, wibeth.FRAME_SIZE)) \
                .reshape(L, N * 64, 28)
            got = native.relayout_time2(words)
            assert got.dtype == np.int32
            ref = pack_adcs_time2(link_major_stream(adcs))
            np.testing.assert_array_equal(got, np.asarray(ref))
            with monkeypatch.context() as m:
                m.setattr(native, "load", lambda: None)
                np.testing.assert_array_equal(
                    native.relayout_time2(words), got)

    def test_unpadded_feed_matches_padded(self):
        """pad8=False ships only ceil(C/128) rows; process_time2_feed
        pads on device — hits and carried state must be bit-exact vs the
        host-padded feed (the apa_readout time2 transfer cut)."""
        from fdreadoutlibs_jax import native
        from fdreadoutlibs_jax.ops.ingest import process_time2_feed
        from fdreadoutlibs_jax.ops.chanstate import (init_chanstate,
                                                     seed_chanstate)
        from fdreadoutlibs_jax.ops.pallas_tpg import pack_state
        L, N = 9, 2            # C=576: 5 data rows, padded S=8
        frames, adcs = make_frames(L, N, pulse=(4, 1, 12, 6, 2200))
        C = L * 64
        words = host_words(frames.reshape(-1, wibeth.FRAME_SIZE)) \
            .reshape(L, N * 64, 28)
        padded = native.relayout_time2(words)
        unpadded = native.relayout_time2(words, pad8=False)
        assert unpadded.shape[1] == -(-C // 128) < padded.shape[1]
        np.testing.assert_array_equal(padded[:, :unpadded.shape[1]],
                                      unpadded)
        assert not padded[:, unpadded.shape[1]:].any()
        outs = []
        for feed in (padded, unpadded):
            stack = pack_state(
                seed_chanstate(init_chanstate(C),
                               link_major_stream(adcs)[0], 8), C)
            slots, nclose, stack = process_time2_feed(
                feed, stack, TPGConfig(threshold=150), C, tc=64,
                k_slots=4, unroll=2, interpret=True)
            outs.append((np.asarray(slots), np.asarray(nclose),
                         np.asarray(stack)))
        for a, b in zip(outs[0], outs[1]):
            np.testing.assert_array_equal(a, b)

    def test_submit_time2_matches_submit_words(self):
        """The time-paired host feed is hit-for-hit and state-for-state
        identical to the plain packed-words path."""
        from fdreadoutlibs_jax import native
        L, N = 2, 2
        frames, adcs = make_frames(L, N, pulse=(1, 1, 10, 5, 2000))
        cfg = TPGConfig(threshold=150)
        words = host_words(frames.reshape(-1, wibeth.FRAME_SIZE)) \
            .reshape(L, N * 64, 28)

        outs = {}
        for mode in ("words", "time2"):
            ing = StreamingIngest(cfg, n_links=L, tc=64, k_slots=8,
                                  interpret=True)
            parts, dropped = [], 0
            for _ in range(2):
                out = ing.submit_words(words) if mode == "words" else \
                    ing.submit_time2(native.relayout_time2(words))
                if out:
                    parts.append(out[0])
                    dropped += out[1]
            out = ing.flush()
            parts.append(out[0])
            dropped += out[1]
            assert dropped == 0
            outs[mode] = (concat_hits(parts), np.asarray(ing.stack))
        np.testing.assert_array_equal(outs["words"][0], outs["time2"][0])
        np.testing.assert_array_equal(outs["words"][1], outs["time2"][1])

    def test_time2_mode_all_formats(self):
        """StreamingIngest(time2=True): submit() relayouts on the host
        (format-specific codec) and runs the time_packed kernel — hits
        identical to the plain packed-words path for every format."""
        from fdreadoutlibs_jax.formats import daphne, wib2
        rng = np.random.default_rng(21)
        cfg = TPGConfig(threshold=120)

        cases = {}
        # wibeth: 2 links x 2 frames
        frames_we, _ = make_frames(2, 2, seed=1, pulse=(1, 1, 10, 5, 900))
        cases["wibeth"] = (2, frames_we)
        # wib2: 2 links x 48 one-tick frames
        adcs = (800 + rng.normal(0, 20, size=(2, 48, 256))).astype(np.uint16)
        adcs[0, 20:28, 77] += 900
        fr = wib2.empty_frames(2 * 48).reshape(2, 48, wib2.FRAME_SIZE)
        for l in range(2):
            wib2.set_adcs(fr[l], adcs[l])
        cases["wib2"] = (2, fr)
        # daphne_stream: 3 links x 2 frames (64 ticks x 4 ch each)
        adcs = (800 + rng.normal(0, 20, size=(3, 2, 64, 4))).astype(np.uint16)
        adcs[1, 1, 5:13, 2] += 900
        fr = daphne.stream_empty_frames(3 * 2) \
            .reshape(3, 2, daphne.STREAM_FRAME_SIZE)
        for l in range(3):
            daphne.stream_set_adcs(fr[l], adcs[l])
        cases["daphne_stream"] = (3, fr)

        for fmt, (L, frames) in cases.items():
            outs = {}
            for t2 in (False, True):
                ing = StreamingIngest(cfg, n_links=L, tc=48 if fmt == "wib2"
                                      else 64, k_slots=8, interpret=True,
                                      format=fmt, time2=t2)
                parts = [out for out in
                         (ing.submit(frames), ing.submit(frames))
                         if out] + [ing.flush()]
                assert all(d == 0 for _, d in parts), fmt
                outs[t2] = (concat_hits([h for h, _ in parts]),
                            np.asarray(ing.stack))
            np.testing.assert_array_equal(outs[False][0], outs[True][0],
                                          err_msg=fmt)
            np.testing.assert_array_equal(outs[False][1], outs[True][1],
                                          err_msg=fmt)

    def test_relayout_time2_input_validation(self):
        from fdreadoutlibs_jax import native
        import pytest
        with pytest.raises(ValueError, match="even tick count"):
            native.relayout_time2(
                np.zeros((2, 3, 28), np.uint32))
        with pytest.raises(ValueError, match="expected"):
            native.relayout_time2(np.zeros((2, 4, 112), np.uint32))
        with pytest.raises(ValueError, match="multiple of 16"):
            native.relayout_time2(np.zeros((2, 4, 28), np.uint32),
                                  ch_per_link=60)
        with pytest.raises(ValueError, match="expected"):
            native.relayout_time2_daphne(np.zeros((2, 4, 28), np.uint32))

    def test_relayout_time2_generic_native_vs_numpy(self, monkeypatch):
        """C++ and numpy fallbacks agree for the wib2 (channel-major,
        cpl=256) and daphne (time-major frames) relayout variants."""
        from fdreadoutlibs_jax import native
        rng = np.random.default_rng(33)
        w2 = rng.integers(0, 2 ** 32, size=(2, 48, 112), dtype=np.uint32)
        dp = rng.integers(0, 2 ** 32, size=(3, 2, 112), dtype=np.uint32)
        got_w2 = native.relayout_time2(w2, ch_per_link=256)
        got_dp = native.relayout_time2_daphne(dp)
        assert got_w2.shape == (24, 8, 128)     # C=512 -> S=8
        assert got_dp.shape == (64, 8, 128)     # C=12 -> S=8
        with monkeypatch.context() as m:
            m.setattr(native, "load", lambda: None)
            np.testing.assert_array_equal(
                native.relayout_time2(w2, ch_per_link=256), got_w2)
            np.testing.assert_array_equal(
                native.relayout_time2_daphne(dp), got_dp)
