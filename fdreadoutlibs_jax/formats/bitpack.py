"""Bit-packing codecs for densely packed little-endian ADC words.

The WIB frame families pack N-bit ADCs back-to-back, little-endian, into
64-bit words: channel ``c`` occupies bits ``[N*c, N*(c+1))`` of the ADC
region.  The reference unpacks these with an AVX2 permute/shift/or ladder
(``unpack_one_register``, /root/reference/include/fdreadoutlibs/wibeth/tpg/
FrameExpand.hpp:84-186).  On the device we express the same transform as static
strided slices + shifts over 32-bit words — XLA vectorizes it with no
gathers, and every shift amount is a compile-time constant.

Two implementations are provided:

* numpy (host side, uses uint64 intermediates) — used by frame writers,
  emulators and tests;
* jnp (device side, uint32-only, static shifts) — used in the ingest path
  before the Pallas TPG kernel.

Both are bit-exact against each other (round-trip tested).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

__all__ = ["pack_14bit", "unpack_14bit", "unpack_14bit_jnp", "words_per_row"]


def words_per_row(n_channels: int, bits: int = 14, word_bits: int = 32) -> int:
    """Number of `word_bits` words holding `n_channels` packed ADCs."""
    total = n_channels * bits
    return -(-total // word_bits)


def unpack_14bit(words_u32: np.ndarray, n_channels: int, bits: int = 14) -> np.ndarray:
    """Unpack little-endian `bits`-bit ADCs from uint32 words (numpy).

    words_u32: (..., W) uint32 with W >= ceil(n_channels*bits/32).
    Returns (..., n_channels) uint16.
    """
    w = np.ascontiguousarray(words_u32).astype(np.uint64)
    # pad one zero word so the (w0 | w1<<32) pair never goes out of bounds
    pad = np.zeros(w.shape[:-1] + (1,), dtype=np.uint64)
    w = np.concatenate([w, pad], axis=-1)
    mask = np.uint64((1 << bits) - 1)
    out = np.empty(w.shape[:-1] + (n_channels,), dtype=np.uint16)
    for c in range(n_channels):
        bit = c * bits
        wi, sh = bit // 32, bit % 32
        pair = w[..., wi] | (w[..., wi + 1] << np.uint64(32))
        out[..., c] = ((pair >> np.uint64(sh)) & mask).astype(np.uint16)
    return out


def pack_14bit(adcs: np.ndarray, bits: int = 14, n_words: int | None = None) -> np.ndarray:
    """Pack (..., C) ADC values into little-endian uint32 words (numpy)."""
    adcs = np.asarray(adcs)
    C = adcs.shape[-1]
    W = n_words if n_words is not None else words_per_row(C, bits)
    vals = adcs.astype(np.uint64) & np.uint64((1 << bits) - 1)
    out = np.zeros(adcs.shape[:-1] + (W + 1,), dtype=np.uint64)
    for c in range(C):
        bit = c * bits
        wi, sh = bit // 32, bit % 32
        out[..., wi] |= (vals[..., c] << np.uint64(sh)) & np.uint64(0xFFFFFFFF)
        spill = vals[..., c] >> np.uint64(32 - sh) if sh else np.zeros_like(vals[..., c])
        if sh:
            out[..., wi + 1] |= spill
    return out[..., :W].astype(np.uint32)


def dump_registers(adcs, per_register: int = 16, fmt: str = "dec") -> str:
    """Debug printer for unpacked values in 16-lane register groups — the
    print256_as16 / print256_as16_dec equivalents (src/*/tpg/FrameExpand.cpp).
    """
    adcs = np.asarray(adcs).reshape(-1)
    lines = []
    for r in range(0, len(adcs), per_register):
        group = adcs[r:r + per_register]
        if fmt == "hex":
            body = " ".join(f"{int(v) & 0xFFFF:04x}" for v in group)
        else:
            body = " ".join(f"{int(v):6d}" for v in group)
        lines.append(f"reg {r // per_register:3d}: {body}")
    return "\n".join(lines)


def unpack_14bit_jnp(words_u32, n_channels: int, bits: int = 14,
                     dtype=jnp.int32, impl: str = "shifts"):
    """Unpack little-endian `bits`-bit ADCs from uint32 words (jnp, device).

    impl="shifts" (default): pure static shifts/ors — no gathers, no
    uint64 — XLA lowers it to plain vector ops, as ``n_channels``
    separate slice fusions stacked on the last axis.  "classes" and
    "gather" are alternative lowerings, bit-exact (tested).

    words_u32: (..., W) uint32.  Returns (..., n_channels) `dtype`.
    """
    if impl == "classes":
        # exploit the word-alignment period: lcm(bits, 32)/bits channels
        # (16 for 14-bit, 8 for 12-bit) span a whole number of words, so
        # channel c = g*per + r has the SAME word offset/shift for every
        # group g — "per" vectorized extracts over (..., G)-wide slices
        # replace n_channels scalar-indexed ones.  Bit-exact (tested).
        import math as _math
        per = _math.lcm(bits, 32) // bits
        wpg = bits * per // 32
        if n_channels % per:
            return unpack_14bit_jnp(words_u32, n_channels, bits, dtype,
                                    impl="shifts")
        G = n_channels // per
        w = words_u32.astype(jnp.uint32)
        wr = w[..., : G * wpg].reshape(*w.shape[:-1], G, wpg)
        mask = jnp.uint32((1 << bits) - 1)
        cols = []
        for r in range(per):
            bit = r * bits
            wi, sh = bit // 32, bit % 32
            lo = wr[..., wi] >> jnp.uint32(sh) if sh else wr[..., wi]
            if sh + bits > 32:
                hi = wr[..., wi + 1] << jnp.uint32(32 - sh)
                v = (lo | hi) & mask
            else:
                v = lo & mask
            cols.append(v)                                # (..., G)
        out = jnp.stack(cols, axis=-1)                    # (..., G, per)
        return out.reshape(*w.shape[:-1], n_channels).astype(dtype)
    if impl == "gather":
        # ONE minor-axis gather for the lo/hi u16 halves + one shift/or
        # pass (per-lane shift amounts) — trades the n_channels slice
        # fusions for two takes
        import numpy as _np
        w = words_u32.astype(jnp.uint32)
        halves = jnp.stack([w & jnp.uint32(0xFFFF),
                            w >> jnp.uint32(16)], axis=-1)
        H = halves.reshape(*w.shape[:-1], -1).astype(jnp.int32)
        c = _np.arange(n_channels)
        j = (c * bits) // 16
        r = (c * bits) % 16
        lo = jnp.take(H, jnp.asarray(j), axis=-1)
        hi = jnp.take(H, jnp.asarray(_np.minimum(j + 1, H.shape[-1] - 1)),
                      axis=-1)
        hi = hi * jnp.asarray((r + bits > 16).astype(_np.int32))
        rv = jnp.asarray(r, jnp.int32)
        v = ((lo >> rv) | (hi << (jnp.int32(16) - rv))) & ((1 << bits) - 1)
        return v.astype(dtype)
    w = words_u32.astype(jnp.uint32)
    mask = jnp.uint32((1 << bits) - 1)
    cols = []
    for c in range(n_channels):
        bit = c * bits
        wi, sh = bit // 32, bit % 32
        lo = w[..., wi] >> jnp.uint32(sh) if sh else w[..., wi]
        if sh + bits > 32:
            hi = w[..., wi + 1] << jnp.uint32(32 - sh)
            v = (lo | hi) & mask
        else:
            v = lo & mask
        cols.append(v)
    return jnp.stack(cols, axis=-1).astype(dtype)
