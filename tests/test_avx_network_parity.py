"""Bit-level simulation of the reference's AVX2 unpack networks.

Rather than trusting the documented permutation, these tests re-implement
the actual instruction sequences — `unpack_one_register`
(wibeth/tpg/FrameExpand.hpp:84-186, operating on 32-bit words with
permutevar/sllv/srlv/and/or) and the ProtoWIB `expand_two_segments`
byte-shuffle network (wib/tpg/FrameExpand.hpp:151-235) — as numpy on the
same bytes, and assert our codecs + register-order views reproduce their
output exactly on random frames.
"""

import numpy as np

from fdreadoutlibs_jax.formats import protowib, wib2, wibeth


def simulate_unpack_one_register(words8: np.ndarray) -> np.ndarray:
    """The AVX2 14-bit unpack ladder on one 256-bit register.

    words8: (8,) uint32 — the register's eight 32-bit lanes.
    Returns (16,) uint16 — the unpacked lanes, reference register order.
    """
    w = words8.astype(np.uint64)

    def permute(v, idx):
        return v[np.array(idx)]

    # shuf1 = permutevar8x32(reg, {0,1,2,3,3,4,5,6})   (set_epi32 is MSB
    # first; setr order used here)
    shuf1 = permute(w, [0, 1, 2, 3, 3, 4, 5, 6])
    # high_half = sllv(shuf1, {2,6,10,14,0,4,8,12}) & 0x3fff0000
    count1 = np.array([2, 6, 10, 14, 0, 4, 8, 12], dtype=np.uint64)
    high_half = (shuf1 << count1) & np.uint64(0x3FFF0000)
    # shift2 = sllv(shuf1, {0,4,8,12,0,2,6,10})
    count2 = np.array([0, 4, 8, 12, 0, 2, 6, 10], dtype=np.uint64)
    shift2 = (shuf1 << count2) & np.uint64(0xFFFFFFFF)
    # shuf2 = permutevar8x32(reg, {0,0,1,2,2,3,4,5})
    shuf2 = permute(w, [0, 0, 1, 2, 2, 3, 4, 5])
    # shift3 = srlv(shuf2, {0,28,24,20,0,30,26,22})
    count3 = np.array([0, 28, 24, 20, 0, 30, 26, 22], dtype=np.uint64)
    shift3 = shuf2 >> count3
    low_half = (shift2 | shift3) & np.uint64(0x3FFF)
    both = low_half | high_half
    # zero word 4's low 16 bits (andnot with set_epi32(0,0,0,0xffff,0,0,0,0))
    both[4] &= np.uint64(0xFFFF0000)
    # 16th value: srli(reg,18), keep word 6, move to word 4
    shift4 = (w >> np.uint64(18)) & np.uint64(0x3FFF)
    both[4] |= shift4[6]
    # view as 16 uint16 lanes (little-endian)
    out = np.zeros(16, dtype=np.uint16)
    out[0::2] = (both & np.uint64(0xFFFF)).astype(np.uint16)
    out[1::2] = (both >> np.uint64(16)).astype(np.uint16)
    return out


def simulate_expand_two_segments(seg_bytes24: np.ndarray) -> np.ndarray:
    """The ProtoWIB 12-bit byte-shuffle network on two segments (24 bytes).

    Implements lane_shuffle + shuffle_epi8 masks + nibble blends
    (wib/tpg/FrameExpand.hpp:151-235).  Returns (16,) uint16.
    """
    raw = np.zeros(32, dtype=np.uint16)  # bytes of the 256-bit register
    raw[:24] = seg_bytes24
    # permutevar8x32(raw, setr{0,1,2,0,3,4,5,0}): move second 12-byte block
    # to the 128-bit lane boundary
    words = raw.reshape(8, 4)
    words = words[[0, 1, 2, 0, 3, 4, 5, 0]]
    b = words.reshape(32)
    lo_idx = [0, 2, 2, 4, 6, 8, 8, 10, 1, 3, 3, 5, 7, 9, 9, 11]
    hi_idx = [0, -1, 4, -1, 6, -1, 10, -1, 1, -1, 5, -1, 7, -1, 11, -1]
    # shuffle_epi8 operates per 128-bit lane: build both 16-byte lanes
    lo_b = np.zeros(32, dtype=np.uint16)
    hi_b = np.zeros(32, dtype=np.uint16)
    for lane in range(2):
        for j in range(16):
            li = lo_idx[j]
            lo_b[lane * 16 + j] = b[lane * 16 + li]
            hidx = hi_idx[j]
            hi_b[lane * 16 + j] = 0 if hidx < 0 else b[lane * 16 + hidx]
    # as 16-bit lanes
    lo16 = (lo_b[0::2] | (lo_b[1::2] << 8)).astype(np.uint32)
    hi16 = (hi_b[0::2] | (hi_b[1::2] << 8)).astype(np.uint32)
    lo_shift = lo16 >> 4
    hi_shift = (hi16 << 4) & 0xFFFF
    # blend 0xaa: odd 16-bit lanes take the shifted version
    lo_bl = lo16.copy()
    hi_bl = hi16.copy()
    lo_bl[1::2] = lo_shift[1::2]
    hi_bl[1::2] = hi_shift[1::2]
    final = (lo_bl & 0x0F0F) | (hi_bl & 0xF0F0)
    return final.astype(np.uint16)


class TestWIBEthNetwork:
    def test_matches_codec_on_random_frames(self):
        rng = np.random.default_rng(0)
        frames = wibeth.empty_frames(4)
        adcs = rng.integers(0, 1 << 14, size=(4, 64, 64), dtype=np.uint16)
        wibeth.set_adcs(frames, adcs)
        u32 = wibeth.adc_region_u32(frames)          # (4, 64, 28)
        reg_view = wibeth.to_register_order(adcs)    # our parity view
        for f in range(4):
            for t in range(0, 64, 7):                # sample time rows
                row = u32[f, t]
                # registers at bit offsets 0, 224, 448, 672 (FrameExpand
                # walks words 0 and 7, each with a +224-bit second half)
                for r, bit in enumerate([0, 224, 448, 672]):
                    start = bit // 32
                    words8 = np.zeros(8, dtype=np.uint32)
                    take = min(8, 28 - start)
                    words8[:take] = row[start:start + take]
                    got = simulate_unpack_one_register(words8)
                    expect = reg_view[f, t, 16 * r: 16 * r + 16]
                    np.testing.assert_array_equal(got, expect,
                                                  err_msg=f"f{f} t{t} r{r}")

    def test_wib2_same_network(self):
        """WIB2 uses the identical ladder on 7-word blocks."""
        rng = np.random.default_rng(1)
        frames = wib2.empty_frames(2)
        adcs = rng.integers(0, 1 << 14, size=(2, 256), dtype=np.uint16)
        wib2.set_adcs(frames, adcs)
        u32 = wib2.adc_region_u32(frames)            # (2, 112)
        for f in range(2):
            for sel in (0, 1):
                reg_view = wib2.to_register_order(adcs, sel)
                for blk in range(8):
                    start = 7 * (blk + sel * 8)
                    words8 = np.zeros(8, dtype=np.uint32)
                    take = min(8, 112 - start)
                    words8[:take] = u32[f, start:start + take]
                    got = simulate_unpack_one_register(words8)
                    np.testing.assert_array_equal(
                        got, reg_view[f, 16 * blk: 16 * blk + 16],
                        err_msg=f"f{f} sel{sel} blk{blk}")


class TestProtoWIBNetwork:
    def test_matches_codec_on_random_segments(self):
        rng = np.random.default_rng(2)
        frames = protowib.empty_frames(2)
        adcs = rng.integers(0, 1 << 12, size=(2, 256), dtype=np.uint16)
        protowib.set_adcs(frames, adcs)
        segs = protowib._segment_regions(frames)     # (2, 4, 8, 12)
        for f in range(2):
            for blk in range(4):
                for pair in range(4):                # 2 segments per expand
                    seg24 = segs[f, blk, 2 * pair: 2 * pair + 2] \
                        .reshape(24).astype(np.uint16)
                    got = simulate_expand_two_segments(seg24)
                    # output lanes: [s0a0c0-3, s0a1c0-3, s1a0c0-3, s1a1c0-3]
                    base = blk * 64 + 2 * pair * 8
                    expect = np.concatenate([
                        adcs[f, base + 0: base + 4],       # seg0 adc0
                        adcs[f, base + 4: base + 8],       # seg0 adc1
                        adcs[f, base + 8: base + 12],      # seg1 adc0
                        adcs[f, base + 12: base + 16],     # seg1 adc1
                    ])
                    np.testing.assert_array_equal(got, expect,
                                                  err_msg=f"f{f} b{blk} p{pair}")
