"""Exact emulation of the int16 fixed-point arithmetic the AVX2 kernels use.

The reference relies on quirky-but-load-bearing int16 semantics; we compute
in int32 and reproduce them bit-exactly (SURVEY.md §7 "hard parts" (a)):

* ``mulhrs`` — ``_mm256_mulhrs_epi16``: ((a*b) >> 14 + 1) >> 1, the rounding
  high-multiply behind the "divide by constant" trick
  (wibeth/tpg/UtilsAVX2.hpp:77-81: div(a, b) = mulhrs(a, 32768/b));
* ``mullo16`` — ``_mm256_mullo_epi16``: wrapping int16 product
  (RS kernels, ProcessAbsRSAVX2.hpp:137-144);
* ``adds16`` — ``_mm256_adds_epi16``: saturating add;
* ``wrap_i16`` / ``sat_i16`` — int16 wraparound / clamp.

All functions are numpy/jnp polymorphic: they only use ``+ - * >> & |`` and
``where``-free arithmetic, so they trace under jit and inside Pallas.
"""

from __future__ import annotations

INT16_MAX = 32767
INT16_MIN = -32768


def wrap_i16(x):
    """Reinterpret an int32 value as wrapped int16 (two's complement).

    (x << 16) >> 16 — two ops instead of add/mask/sub; left shift wraps
    mod 2^32 and the arithmetic right shift sign-extends the low 16 bits
    (property-tested over the full int32 domain vs the masked form).
    """
    if isinstance(x, int):
        return ((x + 32768) & 0xFFFF) - 32768
    return (x << 16) >> 16


def sat_i16(x):
    """Clamp to int16 range (saturating)."""
    return x.clip(INT16_MIN, INT16_MAX) if hasattr(x, "clip") else max(INT16_MIN, min(INT16_MAX, x))


def adds16(a, b):
    """_mm256_adds_epi16: saturating int16 add (int32 inputs in i16 range)."""
    return sat_i16(a + b)


def mullo16(a, b):
    """_mm256_mullo_epi16: wrapping low-half int16 product."""
    return wrap_i16(wrap_i16(a) * wrap_i16(b))


def mullo16_i16(a, b):
    """mullo16 for inputs ALREADY in int16 range (skips the input wraps).

    Every carried state value is stored wrapped, and pedestal-subtracted
    14-bit samples are in range by construction, so the hot kernels use
    this variant; semantics are identical where the precondition holds
    (property-tested against mullo16).
    """
    return wrap_i16(a * b)


def mulhrs16(a, b):
    """_mm256_mulhrs_epi16: round((a*b) / 2^15) computed as (((a*b)>>14)+1)>>1.

    Inputs int32 holding int16-range values; arithmetic shifts.
    Product fits int32 (|a|,|b| <= 2^15).
    """
    prod = wrap_i16(a) * wrap_i16(b)
    return wrap_i16(((prod >> 14) + 1) >> 1)


def mulhrs16_i16(a, b):
    """mulhrs16 for inputs already in int16 range."""
    return wrap_i16(((a * b >> 14) + 1) >> 1)


def rs_div10_unwrapped(sum32):
    """div16_const(wrap_i16(sum32), 10) with deferred wrapping — the RS
    update's whole tail in minimal depth.

    Exactness (property-tested against the composed form):
    * the adds/multiplies feeding ``sum32`` are int16 lane ops upstream
      (``_mm256_add_epi16``/``mullo``), so any int32 value congruent
      mod 2^16 gives the same wrap — callers may skip intermediate wraps;
    * ``((p >> 14) + 1) >> 1  ==  (p + 16384) >> 15`` for all int32 p
      (arithmetic shifts are floor division: write p = q*2^14 + r);
    * the mulhrs result for multiplier 3276 is in [-3276, 3276], so the
      final int16 wrap is a no-op and is dropped.
    """
    a = wrap_i16(sum32)
    return (a * 3276 + 16384) >> 15


def div16_const(a, b: int):
    """_mm256_div_epi16(a, b) = mulhrs(a, 32768/b) — approximate division.

    Matches UtilsAVX2.hpp:77-81 exactly, including its rounding behavior
    (e.g. div16_const(x, 10) uses multiplier 3276 = 32768//10).
    """
    return mulhrs16(a, 32768 // b)


def div16_const_i16(a, b: int):
    """div16_const for `a` already in int16 range."""
    return mulhrs16_i16(a, 32768 // b)


class I32Fx:
    """Fixed-point helper namespace: int32 arrays holding int16-range
    values with explicit wrap emulation."""

    dtype_name = "int32"

    @staticmethod
    def make(xp):
        class _F:
            dtype = xp.int32
            one = xp.int32(1)
            zero = xp.int32(0)
            cast_in = staticmethod(lambda x: x.astype(xp.int32))
            wrap = staticmethod(wrap_i16)
            mullo = staticmethod(mullo16_i16)
            div10 = staticmethod(lambda a: div16_const_i16(a, 10))
            rs_div10 = staticmethod(rs_div10_unwrapped)
            sub16 = staticmethod(lambda a, b: wrap_i16(a - b))

            @staticmethod
            def add_clamp(a, b, cap, floor=None):
                # floor=INT16_MIN reproduces _mm256_adds_epi16's negative
                # saturation (the production RS/FIR kernels); floor=None
                # is the top-only clamp of the naive oracle's int32
                # accumulate (ProcessNaive.hpp:96-99), enough when the
                # accumulated terms are provably non-negative
                s = xp.minimum(a + b, cap)
                return s if floor is None else xp.maximum(s, floor)
            widen = staticmethod(lambda x: x)
            clip = staticmethod(lambda x, lo, hi: xp.clip(x, lo, hi))
            minimum = staticmethod(xp.minimum)
        return _F
