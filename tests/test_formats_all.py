"""Round-trip tests for WIB2 / ProtoWIB / DAPHNE / TDE / SSP formats,
porting the reference's adapter invariants (wib2_test_bench.cxx round trip,
DAPHNEStreamSuperChunkTypeAdapter_test.cxx size/timestamp tests)."""

import numpy as np
import pytest

from fdreadoutlibs_jax.formats import (adapters, daphne, protowib, ssp, tde,
                                       wib2)


class TestWIB2:
    def test_sizes(self):
        assert wib2.FRAME_SIZE == 472
        assert wib2.SUPERCHUNK_SIZE == 5664     # DUNEWIBSuperChunkTypeAdapter

    def test_adc_roundtrip_sequential(self):
        """wib2_test_bench.cxx Test 1/2: vals=i and vals=0x3a0+i."""
        for base in (0, 0x3A0):
            frames = wib2.empty_frames(1)
            vals = (base + np.arange(256)) % (1 << 14)
            wib2.set_adcs(frames, vals[None])
            np.testing.assert_array_equal(wib2.get_adcs(frames)[0], vals)

    def test_adc_roundtrip_random(self):
        rng = np.random.default_rng(0)
        frames = wib2.empty_frames(3)
        vals = rng.integers(0, 1 << 14, size=(3, 256), dtype=np.uint16)
        wib2.set_adcs(frames, vals)
        np.testing.assert_array_equal(wib2.get_adcs(frames), vals)

    def test_timestamp_roundtrip(self):
        frames = wib2.empty_frames(2)
        wib2.set_timestamp(frames, [0x123456789ABCDEF0, 5])
        np.testing.assert_array_equal(wib2.get_timestamp(frames),
                                      [0x123456789ABCDEF0, 5])

    def test_fake_timestamps_superchunk(self):
        sc = wib2.empty_superchunks(2)
        wib2.fake_timestamps(sc, 1000)
        frames = wib2.superchunk_frames(sc).reshape(-1, wib2.FRAME_SIZE)
        np.testing.assert_array_equal(
            wib2.get_timestamp(frames),
            1000 + 32 * np.arange(24, dtype=np.uint64))

    def test_header_fields(self):
        frames = wib2.empty_frames(1)
        wib2.set_header_field(frames, "crate", 3)
        wib2.set_header_field(frames, "slot", 2)
        wib2.set_header_field(frames, "link", 5)
        assert wib2.get_header_field(frames, "crate")[0] == 3
        assert wib2.get_header_field(frames, "slot")[0] == 2
        assert wib2.get_header_field(frames, "link")[0] == 5

    def test_device_unpack(self):
        import jax.numpy as jnp
        rng = np.random.default_rng(1)
        frames = wib2.empty_frames(2)
        vals = rng.integers(0, 1 << 14, size=(2, 256), dtype=np.uint16)
        wib2.set_adcs(frames, vals)
        out = np.asarray(wib2.unpack_frames_jnp(
            jnp.asarray(wib2.adc_region_u32(frames))))
        np.testing.assert_array_equal(out.astype(np.uint16), vals)


class TestProtoWIB:
    def test_sizes(self):
        assert protowib.FRAME_SIZE == 464
        assert protowib.SUPERCHUNK_SIZE == 5568

    def test_adc_roundtrip(self):
        rng = np.random.default_rng(2)
        frames = protowib.empty_frames(3)
        vals = rng.integers(0, 1 << 12, size=(3, 256), dtype=np.uint16)
        protowib.set_adcs(frames, vals)
        np.testing.assert_array_equal(protowib.get_adcs(frames), vals)

    def test_collection_induction_partition(self):
        """96 collection + 160 induction channels partition all 256."""
        coll = set(protowib.COLLECTION_INDEX_TO_CHAN.tolist())
        ind = set(protowib.INDUCTION_INDEX_TO_CHAN.tolist())
        assert len(coll) == 96 and len(ind) == 160
        assert coll | ind == set(range(256))
        assert not (coll & ind)

    def test_register_order_view(self):
        frames = protowib.empty_frames(1)
        vals = np.arange(256, dtype=np.uint16)
        protowib.set_adcs(frames, vals[None])
        coll, ind = protowib.to_register_order(protowib.get_adcs(frames))
        np.testing.assert_array_equal(coll[0],
                                      protowib.COLLECTION_INDEX_TO_CHAN)
        np.testing.assert_array_equal(ind[0],
                                      protowib.INDUCTION_INDEX_TO_CHAN)

    def test_wib_errors(self):
        sc = protowib.empty_superchunks(1)
        protowib.fake_frame_errors(sc, 0xBEEF)
        frames = protowib.superchunk_frames(sc).reshape(-1, 464)
        assert (protowib.get_wib_errors(frames) == 0xBEEF).all()

    def test_timestamp_63bit(self):
        frames = protowib.empty_frames(1)
        protowib.set_timestamp(frames, (1 << 63) - 12345)
        assert protowib.get_timestamp(frames)[0] == (1 << 63) - 12345

    def test_wibheader_byte_positions(self):
        """Pin the real fddetdataformats WIBHeader layout: ts[31:0] in
        word 2, ts[47:32] in word 3 low half, ts[62:48] in wib_counter_1
        (word 3 bits [30:16]) gated on z (bit 31)."""
        ts = 0x5A3C_1122_3344_5566
        frames = protowib.empty_frames(1)
        protowib.set_timestamp(frames, ts)
        w = frames.view("<u4")[0]
        assert w[2] == 0x33445566
        assert w[3] & 0xFFFF == 0x1122
        assert (w[3] >> 16) & 0x7FFF == 0x5A3C
        assert w[3] >> 31 == 0                       # z untouched (0)
        # hand-built byte pattern decodes to the documented value
        raw = protowib.empty_frames(1)
        raw.view("<u4")[0, 2] = 0xDEADBEEF
        raw.view("<u4")[0, 3] = (0x7001 << 16) | 0xCAFE
        assert protowib.get_timestamp(raw)[0] == \
            (0x7001 << 48) | (0xCAFE << 32) | 0xDEADBEEF

    def test_wibheader_z_bit_gates_counter(self):
        """z=1: wib_counter_1 is an independent counter — get returns a
        48-bit ts and set must preserve the counter field."""
        frames = protowib.empty_frames(1)
        w = frames.view("<u4")
        w[0, 3] = np.uint32(0x80000000 | (0x1234 << 16))   # z=1, counter
        protowib.set_timestamp(frames, (0x7FFF << 48) | (0xAB << 32) | 7)
        assert w[0, 3] >> 31 == 1
        assert (w[0, 3] >> 16) & 0x7FFF == 0x1234          # preserved
        assert protowib.get_timestamp(frames)[0] == (0xAB << 32) | 7

    def test_geo_fields(self):
        frames = protowib.empty_frames(2)
        protowib.set_geo(frames, crate=21, slot=5, fiber=3)
        g = protowib.get_geo(frames)
        assert (g["crate"] == 21).all() and (g["slot"] == 5).all() \
            and (g["fiber"] == 3).all()


class TestDAPHNE:
    def test_sizes(self):
        assert daphne.FRAME_SIZE == 1816
        assert daphne.SUPERCHUNK_SIZE == 21792   # DAPHNESuperChunkTypeAdapter
        assert daphne.STREAM_FRAME_SIZE == 472
        assert daphne.STREAM_SUPERCHUNK_SIZE == 5664

    def test_waveform_roundtrip(self):
        rng = np.random.default_rng(3)
        frames = daphne.empty_frames(2)
        wf = rng.integers(0, 1 << 14, size=(2, 1024), dtype=np.uint16)
        daphne.set_waveform(frames, wf)
        np.testing.assert_array_equal(daphne.get_waveform(frames), wf)

    def test_stream_adc_roundtrip(self):
        rng = np.random.default_rng(4)
        frames = daphne.stream_empty_frames(2)
        adcs = rng.integers(0, 1 << 14, size=(2, 64, 4), dtype=np.uint16)
        daphne.stream_set_adcs(frames, adcs)
        np.testing.assert_array_equal(daphne.stream_get_adcs(frames), adcs)

    def test_fake_timestamps(self):
        """DAPHNEStreamSuperChunkTypeAdapter_test.cxx:31-53 equivalent."""
        sc = daphne.empty_superchunks(1, stream=True)
        daphne.fake_timestamps(sc, 1000, offset=64, stream=True)
        frames = daphne.superchunk_frames(sc, stream=True)[0]
        ts = daphne.stream_get_timestamp(frames)
        np.testing.assert_array_equal(ts, 1000 + 64 * np.arange(12))
        assert daphne.get_first_timestamp(sc, stream=True)[0] == 1000

    def test_fake_timestamps_advance_across_superchunks(self):
        """Multi-chunk batches get globally monotonic timestamps (the
        wib2/protowib batch semantics), not a per-chunk restart."""
        sc = daphne.empty_superchunks(3, stream=True)
        daphne.fake_timestamps(sc, 1000, offset=64, stream=True)
        firsts = daphne.get_first_timestamp(sc, stream=True)
        np.testing.assert_array_equal(firsts, 1000 + 12 * 64 * np.arange(3))


class TestTDE:
    def test_channel_and_timestamp(self):
        frames = tde.empty_frames(3)
        tde.set_channel(frames, [5, 63, 0])
        tde.set_timestamp(frames, [100, 100, 50])
        np.testing.assert_array_equal(tde.get_channel(frames), [5, 63, 0])
        order = tde.sort_key(frames)
        np.testing.assert_array_equal(order, [2, 0, 1])  # (ts, channel)

    def test_adc_samples(self):
        frames = tde.empty_frames(1)
        tde.set_adc_sample(frames, 1234, 7)
        assert tde.get_adc_samples(frames)[0, 7] == 1234
        assert tde.get_adc_samples(frames)[0, 6] == 0

    def test_expected_tick_difference(self):
        assert tde.EXPECTED_TICK_DIFFERENCE == \
            tde.TICKS_BETWEEN_ADC_SAMPLES * tde.TOT_ADC16_SAMPLES


class TestSSP:
    def test_frame_size_matches_aligned_cpp_struct(self):
        """sizeof(ssp::EventHeader) is 52 (4-byte C alignment pads the 50
        bytes of fields), so an SSPFrameTypeAdapter payload is 1064 bytes
        and the waveform starts at offset 52 — a packed 50-byte header
        would mis-frame every real DAQ payload."""
        assert ssp.HEADER_SIZE == 52
        assert ssp.FRAME_SIZE == 52 + 1012 == 1064
        frames = ssp.empty_frames(1)
        ssp.set_waveform(frames, np.arange(506, dtype=np.uint16))
        # the waveform region must not overlap the (padded) header
        assert (frames[0, :52] == 0).all()
        np.testing.assert_array_equal(ssp.get_waveform(frames)[0],
                                      np.arange(506))

    def test_timestamp_split_words(self):
        """hpp:36-57: ts split across 4 x 16-bit words."""
        frames = ssp.empty_frames(2)
        ssp.set_timestamp(frames, [0x0123456789ABCDEF, 7])
        h = ssp.headers(frames)
        np.testing.assert_array_equal(
            h["timestamp"][0], [0xCDEF, 0x89AB, 0x4567, 0x0123])
        np.testing.assert_array_equal(ssp.get_timestamp(frames),
                                      [0x0123456789ABCDEF, 7])


class TestAdapterRegistry:
    @pytest.mark.parametrize("name", list(adapters.ADAPTERS))
    def test_timestamp_roundtrip(self, name):
        ad = adapters.get_adapter(name)
        if name == "trigger_primitive":
            from fdreadoutlibs_jax.formats.trigprim import make_tps
            payload = make_tps(2)
        else:
            payload = ad.empty(2)
        ad.set_first_timestamp(payload, np.array([1234, 5678], dtype=np.uint64))
        np.testing.assert_array_equal(ad.get_first_timestamp(payload),
                                      [1234, 5678])

    def test_payload_sizes_match_reference(self):
        sizes = {n: a.fixed_payload_size for n, a in adapters.ADAPTERS.items()}
        assert sizes["wibeth"] == 7200
        assert sizes["wib2"] == 5664
        assert sizes["protowib"] == 5568
        assert sizes["daphne"] == 21792
        assert sizes["daphne_stream"] == 5664
