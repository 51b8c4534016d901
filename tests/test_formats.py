"""Frame-format round-trip tests.

Ports the reference's unpack-correctness oracles:
* WIBEthFrameExpansion_test.cxx — fill frame with ADC=channel-index, unpack,
  assert the register-order permutation {0..7,15,8..14};
* wibeth_test_bench.cxx / wib2_test_bench.cxx — set_adc/get_adc round trip.
"""

import numpy as np

from fdreadoutlibs_jax.formats import bitpack, wibeth


class TestBitpack:
    def test_roundtrip_random(self):
        rng = np.random.default_rng(0)
        adcs = rng.integers(0, 1 << 14, size=(5, 64), dtype=np.uint16)
        words = bitpack.pack_14bit(adcs)
        out = bitpack.unpack_14bit(words, 64)
        np.testing.assert_array_equal(out, adcs)

    def test_roundtrip_jnp_matches_numpy(self):
        import jax.numpy as jnp
        rng = np.random.default_rng(1)
        adcs = rng.integers(0, 1 << 14, size=(3, 64), dtype=np.uint16)
        words = bitpack.pack_14bit(adcs)
        out_np = bitpack.unpack_14bit(words, 64)
        out_jnp = np.asarray(bitpack.unpack_14bit_jnp(jnp.asarray(words), 64))
        np.testing.assert_array_equal(out_jnp.astype(np.uint16), out_np)

    def test_max_values(self):
        adcs = np.full((2, 64), (1 << 14) - 1, dtype=np.uint16)
        words = bitpack.pack_14bit(adcs)
        np.testing.assert_array_equal(bitpack.unpack_14bit(words, 64), adcs)


class TestWIBEthFrame:
    def test_frame_size(self):
        f = wibeth.empty_frames(1)
        assert f.nbytes == 7200  # DUNEWIBEthTypeAdapter.hpp:22

    def test_adc_roundtrip(self):
        rng = np.random.default_rng(2)
        frames = wibeth.empty_frames(2)
        adcs = rng.integers(0, 1 << 14, size=(2, 64, 64), dtype=np.uint16)
        wibeth.set_adcs(frames, adcs)
        np.testing.assert_array_equal(wibeth.get_adcs(frames), adcs)

    def test_adc_region_does_not_touch_header(self):
        frames = wibeth.empty_frames(1)
        wibeth.set_timestamp(frames, 0xDEADBEEF)
        wibeth.set_header_field(frames, "seq_id", 0x123)
        adcs = np.full((1, 64, 64), 0x3FFF, dtype=np.uint16)
        wibeth.set_adcs(frames, adcs)
        assert wibeth.get_timestamp(frames)[0] == 0xDEADBEEF
        assert wibeth.get_header_field(frames, "seq_id")[0] == 0x123

    def test_register_order_permutation(self):
        """Port of WIBEthFrameExpansion_test.cxx: ADC=channel-index fill."""
        frames = wibeth.empty_frames(1)
        adcs = np.broadcast_to(np.arange(64, dtype=np.uint16), (1, 64, 64)).copy()
        wibeth.set_adcs(frames, adcs)
        unpacked = wibeth.get_adcs(frames)
        reg_view = wibeth.to_register_order(unpacked)
        indices = np.array([0, 1, 2, 3, 4, 5, 6, 7, 15, 8, 9, 10, 11, 12, 13, 14])
        for j in range(64):
            expected = 16 * (j // 16) + indices[j % 16]
            assert (reg_view[0, :, j] == expected).all()

    def test_register_order_inverse(self):
        rng = np.random.default_rng(3)
        adcs = rng.integers(0, 1 << 14, size=(4, 64), dtype=np.uint16)
        back = wibeth.from_register_order(wibeth.to_register_order(adcs))
        np.testing.assert_array_equal(back, adcs)

    def test_header_bitfields(self):
        frames = wibeth.empty_frames(3)
        wibeth.fake_geoid(frames, crate_id=5, slot_id=3, stream_id=64)
        assert (wibeth.get_header_field(frames, "crate_id") == 5).all()
        assert (wibeth.get_header_field(frames, "slot_id") == 3).all()
        assert (wibeth.get_header_field(frames, "stream_id") == 64).all()
        # fields are independent
        wibeth.set_header_field(frames, "det_id", 10)
        assert (wibeth.get_header_field(frames, "crate_id") == 5).all()
        assert (wibeth.get_header_field(frames, "det_id") == 10).all()

    def test_fake_timestamps(self):
        frames = wibeth.empty_frames(4)
        wibeth.fake_timestamps(frames, 1000)
        np.testing.assert_array_equal(
            wibeth.get_timestamp(frames),
            1000 + 2048 * np.arange(4, dtype=np.uint64))

    def test_fake_seq_ids_wraparound(self):
        frames = wibeth.empty_frames(4)
        wibeth.fake_seq_ids(frames, 0xFFE)
        np.testing.assert_array_equal(
            wibeth.get_header_field(frames, "seq_id"), [0xFFE, 0xFFF, 0, 1])

    def test_fake_adc_pattern(self):
        frames = wibeth.empty_frames(1)
        wibeth.fake_adc_pattern(frames, channel=17)
        assert wibeth.get_adc(frames, 17, 0)[0] == 16383
        assert wibeth.get_adc(frames, 16, 0)[0] == 0

    def test_device_unpack_matches_host(self):
        import jax.numpy as jnp
        rng = np.random.default_rng(4)
        frames = wibeth.empty_frames(2)
        adcs = rng.integers(0, 1 << 14, size=(2, 64, 64), dtype=np.uint16)
        wibeth.set_adcs(frames, adcs)
        u32 = wibeth.frames_bytes_to_u32(frames)
        dev = np.asarray(wibeth.unpack_frames_jnp(jnp.asarray(u32)))
        np.testing.assert_array_equal(dev.astype(np.uint16), adcs)


def test_mxu_unpack_bit_exact():
    """Every alternative unpack lowering (classes, gather) is
    bit-exact vs the shift lowering and the numpy oracle over full-range
    random words, for the 14-bit and 12-bit field widths."""
    import jax.numpy as jnp
    from fdreadoutlibs_jax.formats.bitpack import (unpack_14bit,
                                                   unpack_14bit_jnp)
    rng = np.random.default_rng(0)
    for bits, W, C in ((14, 28, 64), (12, 24, 64), (14, 112, 256)):
        w = rng.integers(0, 1 << 32, size=(9, 5, W),
                         dtype=np.uint64).astype(np.uint32)
        ref = unpack_14bit(w, C, bits)
        for impl in ("classes", "gather"):
            got = np.asarray(unpack_14bit_jnp(jnp.asarray(w), C, bits,
                                              impl=impl))
            np.testing.assert_array_equal(got, ref,
                                          err_msg=f"{impl} {bits}b")
