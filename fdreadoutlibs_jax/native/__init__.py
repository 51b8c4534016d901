"""ctypes bindings for the native C++ runtime pieces.

The library is built on demand (``make -C fdreadoutlibs_jax/native``) or at
first import; absence of a toolchain degrades gracefully to the pure-Python
implementations (``available()`` reports which path is active).
"""

from __future__ import annotations

import ctypes

import subprocess
from pathlib import Path

import numpy as np

_DIR = Path(__file__).parent
_LIB_PATH = _DIR / "libfdreadout_native.so"
_lib = None
_tried = False


def _build() -> bool:
    try:
        subprocess.run(["make", "-C", str(_DIR)], check=True,
                       capture_output=True, timeout=120)
        return _LIB_PATH.exists()
    except Exception:
        return False


def load():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    stale = _LIB_PATH.exists() and any(
        src.stat().st_mtime > _LIB_PATH.stat().st_mtime
        for src in _DIR.glob("*.cpp"))
    if (not _LIB_PATH.exists() or stale) and not _build() \
            and not _LIB_PATH.exists():
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None
    # a stale prebuilt lib with no toolchain to rebuild keeps its older
    # entry points; wrappers for newer ones fall back to Python
    lib.has_time2 = hasattr(lib, "wibeth_relayout_time2")
    lib.has_time2_generic = hasattr(lib, "relayout_time2_chmajor")
    lib.has_mt = hasattr(lib, "relayout_time2_chmajor_mt")
    lib.has_protowib_time2 = hasattr(lib, "protowib_relayout_time2")
    # latency buffer
    lib.lb_create.restype = ctypes.c_void_p
    lib.lb_create.argtypes = [ctypes.c_uint64, ctypes.c_uint64]
    lib.lb_destroy.argtypes = [ctypes.c_void_p]
    lib.lb_insert.restype = ctypes.c_uint64
    lib.lb_insert.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                              ctypes.c_uint64]
    lib.lb_occupancy.restype = ctypes.c_uint64
    lib.lb_occupancy.argtypes = [ctypes.c_void_p]
    lib.lb_bounds.restype = ctypes.c_int
    lib.lb_bounds.argtypes = [ctypes.c_void_p,
                              ctypes.POINTER(ctypes.c_uint64),
                              ctypes.POINTER(ctypes.c_uint64)]
    lib.lb_count_window.restype = ctypes.c_uint64
    lib.lb_count_window.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                    ctypes.c_uint64]
    lib.lb_extract_window.restype = ctypes.c_uint64
    lib.lb_extract_window.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                      ctypes.c_uint64, ctypes.c_char_p,
                                      ctypes.c_uint64]
    lib.lb_extract_all.restype = ctypes.c_uint64
    lib.lb_extract_all.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_uint64]
    lib.lb_pop_until.restype = ctypes.c_uint64
    lib.lb_pop_until.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.lb_pop_n.restype = ctypes.c_uint64
    lib.lb_pop_n.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.lb_key_at.restype = ctypes.c_int
    lib.lb_key_at.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                              ctypes.POINTER(ctypes.c_uint64)]
    lib.lb_cleanup_max_ts_diff.restype = ctypes.c_uint64
    lib.lb_cleanup_max_ts_diff.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    # frame codec
    for name, argtypes in [
        ("wibeth_unpack", [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p]),
        ("wibeth_pack", [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p]),
        ("wibeth_timestamps", [ctypes.c_char_p, ctypes.c_uint64,
                               ctypes.c_char_p]),
        ("wibeth_fake_headers", [ctypes.c_char_p, ctypes.c_uint64,
                                 ctypes.c_uint64, ctypes.c_uint64,
                                 ctypes.c_uint64]),
        ("wibeth_relayout_time2", [ctypes.c_char_p, ctypes.c_uint64,
                                   ctypes.c_uint64, ctypes.c_uint64,
                                   ctypes.c_char_p]),
        ("relayout_time2_chmajor", [ctypes.c_char_p, ctypes.c_uint64,
                                    ctypes.c_uint64, ctypes.c_uint64,
                                    ctypes.c_uint64, ctypes.c_char_p]),
        ("daphne_relayout_time2", [ctypes.c_char_p, ctypes.c_uint64,
                                   ctypes.c_uint64, ctypes.c_uint64,
                                   ctypes.c_char_p]),
        ("relayout_time2_chmajor_mt", [ctypes.c_char_p, ctypes.c_uint64,
                                       ctypes.c_uint64, ctypes.c_uint64,
                                       ctypes.c_uint64, ctypes.c_char_p,
                                       ctypes.c_uint64]),
        ("protowib_relayout_time2", [ctypes.c_char_p, ctypes.c_uint64,
                                     ctypes.c_char_p, ctypes.c_uint64,
                                     ctypes.c_uint64, ctypes.c_char_p]),
    ]:
        if not hasattr(lib, name):
            continue             # stale prebuilt lib (see has_time2)
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = argtypes
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_char_p)


class NativeLatencyBuffer:
    """Native ordered buffer over fixed-size structured records; the key is
    the first 8 bytes (e.g. TP_DTYPE.time_start)."""

    def __init__(self, dtype: np.dtype, capacity: int = 0):
        lib = load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.dtype = np.dtype(dtype)
        assert self.dtype.itemsize >= 8
        self._h = lib.lb_create(self.dtype.itemsize, capacity)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.lb_destroy(self._h)
            self._h = None

    def insert(self, records: np.ndarray) -> int:
        records = np.ascontiguousarray(records, dtype=self.dtype)
        return int(self._lib.lb_insert(self._h, _ptr(records), len(records)))

    def occupancy(self) -> int:
        return int(self._lib.lb_occupancy(self._h))

    def bounds(self):
        lo, hi = ctypes.c_uint64(), ctypes.c_uint64()
        if not self._lib.lb_bounds(self._h, ctypes.byref(lo),
                                   ctypes.byref(hi)):
            return None
        return int(lo.value), int(hi.value)

    def oldest_ts(self):
        b = self.bounds()
        return None if b is None else b[0]

    def newest_ts(self):
        b = self.bounds()
        return None if b is None else b[1]

    def extract_window(self, start: int, end: int) -> np.ndarray:
        n = int(self._lib.lb_count_window(self._h, start, end))
        out = np.zeros(n, dtype=self.dtype)
        if n:
            got = int(self._lib.lb_extract_window(self._h, start, end,
                                                  _ptr(out), n))
            out = out[:got]
        return out

    def extract_all(self) -> np.ndarray:
        """Every record in key order (non-consuming).  NOT a window query:
        [start, end) cannot express 'include key UINT64_MAX', and a
        snapshot built on a window dropped top-bit-set timestamps
        (scripts/fuzz_tp_path.py)."""
        n = int(self._lib.lb_occupancy(self._h))
        out = np.zeros(n, dtype=self.dtype)
        if n:
            got = int(self._lib.lb_extract_all(self._h, _ptr(out), n))
            out = out[:got]
        return out

    def pop_until(self, ts: int) -> int:
        return int(self._lib.lb_pop_until(self._h, ts))

    def pop_n(self, n: int) -> int:
        """Drop the n oldest records (exact count, duplicate-key safe)."""
        return int(self._lib.lb_pop_n(self._h, n))

    def key_at(self, idx: int):
        """Key of the idx-th oldest record (None if out of range) — no
        record copies (the occupancy-trim path's cheap query)."""
        k = ctypes.c_uint64()
        if not self._lib.lb_key_at(self._h, idx, ctypes.byref(k)):
            return None
        return int(k.value)

    def cleanup_max_ts_diff(self, max_diff: int) -> int:
        return int(self._lib.lb_cleanup_max_ts_diff(self._h, max_diff))


def wibeth_unpack(frames: np.ndarray) -> np.ndarray:
    """Native WIBEth unpack: (n, 7200) uint8 -> (n*64, 64) uint16."""
    lib = load()
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    n = frames.shape[0]
    out = np.empty((n * 64, 64), dtype=np.uint16)
    lib.wibeth_unpack(_ptr(frames), n, _ptr(out))
    return out


def wibeth_pack(frames: np.ndarray, adcs: np.ndarray) -> None:
    lib = load()
    adcs = np.ascontiguousarray(adcs, dtype=np.uint16)
    lib.wibeth_pack(_ptr(frames), frames.shape[0], _ptr(adcs))


def wibeth_timestamps(frames: np.ndarray) -> np.ndarray:
    lib = load()
    n = frames.shape[0]
    out = np.empty(n, dtype=np.uint64)
    lib.wibeth_timestamps(_ptr(np.ascontiguousarray(frames)), n, _ptr(out))
    return out


def wibeth_fake_headers(frames: np.ndarray, first_ts: int, tick: int = 2048,
                        first_seq: int = 0) -> None:
    lib = load()
    lib.wibeth_fake_headers(_ptr(frames), frames.shape[0], first_ts, tick,
                            first_seq)


def unpack14_words(words: np.ndarray) -> np.ndarray:
    """Vectorized numpy 14-bit unpack of (..., 7) uint32 word groups ->
    (..., 16) uint16 ADCs (the lcm(14,32)=224-bit quartet layout of
    formats/bitpack.py; the numpy mirror of the C++ unpack16 ladder)."""
    w = np.asarray(words, dtype=np.uint32)
    out = np.empty(w.shape[:-1] + (16,), dtype=np.uint16)
    for r in range(16):
        bit = 14 * r
        j, sh = bit // 32, bit % 32
        v = w[..., j] >> np.uint32(sh)
        if sh + 14 > 32:
            v = v | (w[..., j + 1] << np.uint32(32 - sh))
        out[..., r] = v & np.uint32(0x3FFF)
    return out


def _aligned_empty(shape, dtype, align: int = 64) -> np.ndarray:
    """np.empty with a guaranteed 64-byte-aligned base: the native time2
    relayout uses non-temporal 64-byte stores (skipping the write-allocate
    read of the ~50 MB/window output) only when the destination is
    cacheline-aligned — numpy's default allocator does not guarantee it."""
    n = int(np.prod(shape))
    itemsize = np.dtype(dtype).itemsize
    buf = np.empty(n * itemsize + align, dtype=np.uint8)
    off = (-buf.ctypes.data) % align
    return buf[off:off + n * itemsize].view(dtype).reshape(shape)


class FeedBuffer:
    """Double-buffered, 64-byte-aligned reusable outputs for the relayout
    codecs' ``out=`` parameter.  Two buffers (not one) so the array handed
    to the previous submit/device_put is never overwritten while its
    device transfer may still be in flight; a shape change replaces the
    slot (bounded at two live buffers).  Streaming callers must reuse:
    a fresh ~50 MB output page-faults every line (~3x over steady state,
    BENCH_NOTES round-3 host codec)."""

    def __init__(self):
        self._bufs = [None, None]
        self._flip = 0

    def get(self, shape) -> np.ndarray:
        shape = tuple(shape)
        self._flip ^= 1
        buf = self._bufs[self._flip]
        if buf is None or buf.shape != shape:
            buf = _aligned_empty(shape, np.int32)
            self._bufs[self._flip] = buf
        return buf


def _check_out(out: np.ndarray, shape: tuple) -> np.ndarray:
    """Validate a caller-supplied reusable output buffer (the relayout
    codecs' per-call output is ~50 MB/APA-window: a fresh allocation
    page-faults every line, which measured ~3x over the steady-state
    codec cost — streaming callers should reuse, see StreamingIngest)."""
    if (not isinstance(out, np.ndarray) or out.dtype != np.int32
            or out.shape != shape or not out.flags.c_contiguous
            or not out.flags.writeable):
        raise ValueError(
            f"out must be a writable C-contiguous int32 array of shape "
            f"{shape}, got {getattr(out, 'dtype', None)} "
            f"{getattr(out, 'shape', None)}")
    return out


def _pad_sublanes8(C: int) -> int:
    rows = -(-C // 128)
    return -(-rows // 8) * 8                   # pad_sublanes(C, 8)


def time2_feed_shape(n_links: int, n_ticks: int,
                     ch_per_link: int = 64, pad8: bool = True) -> tuple:
    """Canonical relayout_time2 output shape for an (L, T, .) word block —
    the one place the (T//2, S, 128) convention lives; every bench/feed
    call site must use this instead of re-deriving the literals.

    pad8=False ships only ceil(C/128) rows — the kernel's 8-sublane pad
    moves to the device (process_time2_feed pads before the Pallas
    call), cutting host->device transfer ~17% at APA shapes (24 -> 20
    rows); bit-exact either way."""
    C = ch_per_link * n_links
    rows = _pad_sublanes8(C) if pad8 else -(-C // 128)
    return (n_ticks // 2, rows, 128)


def _pair_flat(adcs: np.ndarray, C: int, S: int) -> np.ndarray:
    """(T, C) int -> (T//2, S, 128) int32 time-paired canonical layout."""
    T = adcs.shape[0]
    flat = np.zeros((T, S * 128), dtype=np.int32)
    flat[:, :C] = adcs
    return (flat[0::2] | (flat[1::2] << 16)).reshape(T // 2, S, 128)


def relayout_time2(words: np.ndarray, ch_per_link: int = 64,
                   out: np.ndarray = None, nthreads: int = 1,
                   pad8: bool = True) -> np.ndarray:
    """Host-side 14-bit unpack + time-pairing: (L, T, nw) uint32 packed
    channel-major link rows (nw = ch_per_link*7/16: WIBEth 28, WIB2 112)
    -> (T//2, S, 128) int32 in the kernel's time_packed canonical layout
    (pack_adcs_time2: channel c = ch_per_link*link + ch at flat lane c,
    value adc(2t) | adc(2t+1) << 16).  The host pays the unpack; the
    kernel then reads half the ADC bytes.  Uses the native codec when
    available, numpy otherwise."""
    words = np.ascontiguousarray(words, dtype=np.uint32)
    if ch_per_link % 16:
        raise ValueError("ch_per_link must be a multiple of 16")
    nw = ch_per_link * 7 // 16
    L, T, W = words.shape
    if W != nw:
        raise ValueError(f"expected (L, T, {nw}) words for "
                         f"{ch_per_link} ch/link, got {words.shape}")
    if T % 2:
        raise ValueError("time2 relayout needs an even tick count")
    C = ch_per_link * L
    # pad8=False: ship exact rows, pad on device (time2_feed_shape doc)
    S = _pad_sublanes8(C) if pad8 else -(-C // 128)
    lib = load()
    if lib is not None and getattr(lib, "has_time2_generic", False):
        # 64-byte-aligned output enables the codec's non-temporal store
        # path (2.1x; BENCH_NOTES round-3 host codec); pass `out` to
        # amortize the ~50 MB allocation across a stream
        if out is None:
            out = _aligned_empty((T // 2, S, 128), np.int32)
        else:
            _check_out(out, (T // 2, S, 128))
        # nthreads > 1 fans 64-tick-aligned ranges over std::threads (an
        # APA's 8.75 GB/s raw rate needs ~2 cores at 6.3 GB/s/core)
        if nthreads > 1 and getattr(lib, "has_mt", False):
            lib.relayout_time2_chmajor_mt(_ptr(words), L, T, ch_per_link,
                                          S, _ptr(out), int(nthreads))
        else:
            lib.relayout_time2_chmajor(_ptr(words), L, T, ch_per_link, S,
                                       _ptr(out))
        return out
    adcs = unpack14_words(words.reshape(L, T, nw // 7, 7)) \
        .reshape(L, T, ch_per_link).transpose(1, 0, 2).reshape(T, C)
    res = _pair_flat(adcs, C, S)
    if out is not None:
        _check_out(out, res.shape)[...] = res
        return out
    return res


def relayout_time2_protowib(frames: np.ndarray, chan_list,
                            out: np.ndarray = None) -> np.ndarray:
    """ProtoWIB plane-subset variant of relayout_time2: (T, 464) uint8
    whole frames + an in-frame channel list (the plane's
    COLLECTION/INDUCTION_INDEX_TO_CHAN register order) -> (T//2, S, 128)
    int32 canonical time-paired feed with plane-LOCAL channel indices
    (matching process_packed_protowib's plane split).  The host pays the
    12-bit nibble decode; the device runs the plain time_packed FIR
    datapath."""
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    if frames.ndim != 2 or frames.shape[1] != 464:
        raise ValueError(f"expected (T, 464) ProtoWIB frames, "
                         f"got {frames.shape}")
    T = frames.shape[0]
    if T % 2:
        raise ValueError("time2 relayout needs an even tick count")
    chan = np.ascontiguousarray(chan_list, dtype=np.uint16)
    if chan.ndim != 1 or chan.size == 0 or int(chan.max()) > 255:
        raise ValueError("chan_list must be 1-D in-frame channels (0..255)")
    C = chan.size
    S = _pad_sublanes8(C)
    lib = load()
    if lib is not None and getattr(lib, "has_protowib_time2", False):
        if out is None:
            out = _aligned_empty((T // 2, S, 128), np.int32)
        else:
            _check_out(out, (T // 2, S, 128))
        lib.protowib_relayout_time2(_ptr(frames), T, _ptr(chan), C,
                                    S, _ptr(out))
        return out
    from ..formats import protowib as pw
    adcs = pw.get_adcs(frames)[:, chan].astype(np.int32)
    res = _pair_flat(adcs, C, S)
    if out is not None:
        _check_out(out, res.shape)[...] = res
        return out
    return res


def relayout_time2_daphne(words: np.ndarray,
                          out: np.ndarray = None) -> np.ndarray:
    """DAPHNE-stream variant of relayout_time2: (L, N, 112) uint32 frame
    rows (each frame = 64 ticks x 4 channels, TIME-major 14-bit values)
    -> (N*32, S, 128) int32 time-paired canonical layout, channel
    c = 4*link + ch."""
    words = np.ascontiguousarray(words, dtype=np.uint32)
    L, N, W = words.shape
    if W != 112:
        raise ValueError(f"expected (L, N, 112) DAPHNE stream words, "
                         f"got {words.shape}")
    C = 4 * L
    S = _pad_sublanes8(C)
    lib = load()
    if lib is not None and getattr(lib, "has_time2_generic", False):
        # aligned like the sibling codecs, so a future NT-store variant
        # of the daphne codec engages without caller changes
        if out is None:
            out = _aligned_empty((N * 32, S, 128), np.int32)
        else:
            _check_out(out, (N * 32, S, 128))
        lib.daphne_relayout_time2(_ptr(words), L, N, S, _ptr(out))
        return out
    adcs = unpack14_words(words.reshape(L, N, 16, 7)) \
        .reshape(L, N * 64, 4).transpose(1, 0, 2).reshape(N * 64, C)
    res = _pair_flat(adcs, C, S)
    if out is not None:
        _check_out(out, res.shape)[...] = res
        return out
    return res
