"""Device ingest: packed frame words -> unpack -> hit finding, one jit.

Streaming ships the *raw packed ADC region* to the device (1.75
bytes/sample for 14-bit WIBEth — the minimum host->device traffic;
SURVEY.md §7 hard part (d)) and runs the 14-bit unpack, the layout
reshape and the hit-finding kernel inside a single jitted call.  The host
never touches ADC values: its only per-batch work is a uint32 view of the
frame bytes.  The time2 feed is the alternative where the host unpacks
and pairs ticks (native.relayout_time2).

Each kernel entry point has a ``lax.scan`` twin for the CPU
(ops/backend.py): the same unpack feeds ops.scan.process_window_scan and
the dense hits are compacted into the same single-fetch hit array.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..formats import wibeth
from .config import TPGConfig
from .pallas_tpg import LANES, pad_sublanes, process_window_pallas


def host_words(frames: np.ndarray) -> np.ndarray:
    """(N, 7200) uint8 frames -> (N, 64, 28) uint32 ADC words (a view-level
    reshape; no decoding on host)."""
    return wibeth.frames_bytes_to_u32(frames)


@functools.partial(jax.jit, static_argnames=("cfg", "tc", "k_slots",
                                             "unroll", "n_channels",
                                             "interpret", "unpack_impl"))
def process_packed_frames(words, state_stack, cfg: TPGConfig,
                          n_channels: int, tc: int = 512, k_slots: int = 2,
                          unroll: int = 16, interpret: bool = False,
                          unpack_impl: str = "shifts"):
    """words: (L, T, 28) uint32 packed rows for L links of 64 channels.

    Returns (slots, nclose, new_state) like process_window_pallas, with
    channels stacked link-major on the lane axis (channel = link*64 + c).
    """
    L, T, _ = words.shape
    flat = words_to_adcs(words, unpack_impl)
    S = pad_sublanes(n_channels)
    packed = jnp.pad(
        flat, ((0, 0), (0, S * LANES - L * wibeth.N_CHANNELS)))
    packed = packed.reshape(T, S, LANES)
    return process_window_pallas(packed, state_stack, cfg, tc=tc,
                                 k_slots=k_slots, unroll=unroll,
                                 interpret=interpret)


@functools.partial(jax.jit, static_argnames=("cfg", "tc", "k_slots",
                                             "unroll", "n_channels",
                                             "interpret"))
def process_time2_feed(W2, state_stack, cfg: TPGConfig,
                       n_channels: int, tc: int = 512,
                       k_slots: int = 2, unroll: int = 16,
                       interpret: bool = False):
    """Time-paired host feed: the input is UNPACKED on the host into the
    kernel's time_packed layout — (T//2, S, 128) int32 holding
    adc(2t) | adc(2t+1) << 16 at flat lane c (native.relayout_time2) —
    so the kernel reads half the ADC bytes and splits each pair with two
    shifts.  The host pays the unpack (C++, reused output buffers).

    W2 may arrive UNPADDED on the row axis (ceil(C/128) rows,
    relayout_time2(pad8=False)): the container pad then happens here on
    device instead of shipping dead rows to the device.  Bit-exact either
    way (the host codec zero-fills the same rows).
    """
    S = pad_sublanes(n_channels)
    if W2.shape[1] < S:
        W2 = jnp.pad(W2, ((0, 0), (0, S - W2.shape[1]), (0, 0)))
    return process_window_pallas(W2, state_stack, cfg, tc=tc,
                                 k_slots=k_slots, unroll=unroll,
                                 interpret=interpret,
                                 time_packed=True)


@functools.partial(jax.jit, static_argnames=("cfg", "tc", "k_slots",
                                             "unroll", "n_channels",
                                             "interpret"))
def process_packed_wib2(words, state_stack, cfg: TPGConfig,
                        n_channels: int, tc: int = 512, k_slots: int = 4,
                        unroll: int = 16, interpret: bool = False):
    """WIB2 fused ingest: words (L, T, 112) uint32 packed rows (each WIB2
    frame is ONE tick of 256 channels); channel = link*256 + c."""
    from ..formats import wib2
    L, T, _ = words.shape
    adcs = wib2.unpack_frames_jnp(words)                 # (L, T, 256)
    flat = adcs.transpose(1, 0, 2).reshape(T, L * wib2.N_CHANNELS)
    S = pad_sublanes(n_channels)
    padded = jnp.zeros((T, S * LANES), jnp.int32)
    padded = padded.at[:, : L * wib2.N_CHANNELS].set(flat)
    packed = padded.reshape(T, S, LANES)
    return process_window_pallas(packed, state_stack, cfg, tc=tc,
                                 k_slots=k_slots, unroll=unroll,
                                 interpret=interpret)


@functools.partial(jax.jit, static_argnames=("cfg", "tc", "k_slots",
                                             "unroll", "n_channels",
                                             "interpret"))
def process_packed_daphne(words, state_stack, cfg: TPGConfig,
                          n_channels: int, tc: int = 512, k_slots: int = 4,
                          unroll: int = 16, interpret: bool = False):
    """DAPHNE-stream fused ingest: words (L, N, 112) uint32 packed rows —
    each stream frame is 64 ticks of 4 channels; channel = link*4 + c."""
    from ..formats import daphne
    L, N, _ = words.shape
    flat = daphne_words_to_adcs(words)
    T = flat.shape[0]
    S = pad_sublanes(n_channels)
    padded = jnp.zeros((T, S * LANES), jnp.int32)
    padded = padded.at[:, : L * daphne.STREAM_N_CHANNELS].set(flat)
    packed = padded.reshape(T, S, LANES)
    return process_window_pallas(packed, state_stack, cfg, tc=tc,
                                 k_slots=k_slots, unroll=unroll,
                                 interpret=interpret)


@functools.partial(jax.jit, static_argnames=("coll_cfg", "ind_cfg", "tc",
                                             "k_slots", "unroll",
                                             "interpret"))
def process_packed_protowib(words, coll_stack, ind_stack,
                            coll_cfg: TPGConfig, ind_cfg: TPGConfig,
                            tc: int = 12, k_slots: int = 4,
                            unroll: int = 1, interpret: bool = False):
    """ProtoWIB fused ingest: words (T, 116) uint32 whole frames (one tick
    of 256 channels each).  Runs the legacy dual-plane pipeline as two
    kernel calls over static channel subsets of one device batch — the
    device replacement for the reference's caller-thread collection + spin-waiting
    induction thread (WIBFrameProcessor.hpp:455-459; SURVEY.md §2.7).

    Returns ((slots, nclose, new_coll_stack), (slots, nclose, new_ind_stack))
    with plane-local channel indices (COLLECTION/INDUCTION_INDEX_TO_CHAN
    order, matching the plane-split host path).
    """
    from ..formats import protowib as pw
    T = words.shape[0]
    adcs = pw.unpack_frames_jnp(words)                 # (T, 256)

    def run(plane_idx, stack, cfg):
        C = len(plane_idx)
        x = adcs[:, np.asarray(plane_idx)]             # static gather
        S = pad_sublanes(C)
        padded = jnp.zeros((T, S * LANES), jnp.int32).at[:, :C].set(x)
        return process_window_pallas(padded.reshape(T, S, LANES), stack,
                                     cfg, tc=tc, k_slots=k_slots,
                                     unroll=unroll, interpret=interpret)

    return (run(pw.COLLECTION_INDEX_TO_CHAN, coll_stack, coll_cfg),
            run(pw.INDUCTION_INDEX_TO_CHAN, ind_stack, ind_cfg))


def _with_trailer(out, n, dropped):
    """(max_hits, 6) hit rows + counts -> ONE (max_hits + 1, 6) array with
    a trailer row [n_valid, dropped, 0...], so the host decode is a
    single device->host fetch instead of three."""
    trailer = jnp.zeros((1, 6), jnp.int32)
    trailer = trailer.at[0, 0].set(n.astype(jnp.int32))
    trailer = trailer.at[0, 1].set(dropped.astype(jnp.int32))
    return jnp.concatenate([out, trailer], axis=0)


@functools.partial(jax.jit, static_argnames=("n_channels", "max_hits"))
def compact_on_device(slots, nclose, tick_offset, n_channels: int,
                      max_hits: int):
    """Kernel K-slot outputs -> ONE (max_hits + 1, 6) int32 array: the
    compact hit rows in canonical (end_tick, channel) order plus the
    trailer row [n_valid, dropped] (_with_trailer)."""
    from .hits import compact_pallas_slots
    out, n, dropped = compact_pallas_slots(slots, nclose, n_channels,
                                           max_hits, tick_offset=tick_offset)
    return _with_trailer(out, n, dropped)


def words_to_adcs(words, unpack_impl: str = "shifts"):
    """(L, T, 28) uint32 packed WIBEth rows -> (T, L*64) int32 ADCs,
    channel = link*64 + c.  The PACKED words (1.75 B/sample) are
    transposed to time-major before unpacking, so the layout copy moves
    the small array and the unpack fuses with what follows."""
    L, T, _ = words.shape
    wt = jnp.swapaxes(words, 0, 1)                       # (T, L, 28)
    adcs = wibeth.unpack_frames_jnp(wt, impl=unpack_impl)  # (T, L, 64)
    return adcs.reshape(T, L * wibeth.N_CHANNELS)


def time2_to_adcs(W2, n_channels: int):
    """(T//2, S', 128) time-paired feed -> (T, n_channels) int32 ADCs
    (tick 2t in the low half of each word, 2t+1 in the high half)."""
    flat = W2.reshape(W2.shape[0], -1)[:, :n_channels]
    pairs = jnp.stack([(flat << 16) >> 16, flat >> 16], axis=1)
    return pairs.reshape(-1, n_channels)


def daphne_words_to_adcs(words):
    """(L, N, 112) uint32 DAPHNE-stream rows -> (N*64, L*4) int32 ADCs,
    channel = link*4 + c."""
    from ..formats import daphne
    L, N, _ = words.shape
    adcs = daphne.stream_unpack_frames_jnp(words)      # (L, N, 64, 4)
    T = N * daphne.STREAM_N_SAMPLES
    return adcs.reshape(L, T, daphne.STREAM_N_CHANNELS) \
        .transpose(1, 0, 2).reshape(T, L * daphne.STREAM_N_CHANNELS)


@functools.partial(jax.jit, static_argnames=("cfg", "max_hits"))
def scan_compact(adcs, state: dict, cfg: TPGConfig, max_hits: int):
    """The ``lax.scan`` twin of a kernel entry point + compact_on_device:
    (T, C) ADCs and a ChanState dict of (C,) device arrays ->
    ((max_hits + 1, 6) compact hits with trailer, new state)."""
    from .scan import compact_hits_device, process_window_scan
    closed, records, new_state = process_window_scan(adcs, state, cfg)
    out, n, dropped = compact_hits_device(closed, records, max_hits)
    return _with_trailer(out, n, dropped), new_state


def unpack_compact(packed: np.ndarray):
    """compact_on_device / scan_compact output -> (canonical hit array,
    dropped count); the one host-side fetch + decode."""
    from .hits import hits_from_compact
    packed = np.asarray(packed)
    n, dropped = int(packed[-1, 0]), int(packed[-1, 1])
    return hits_from_compact(packed[:-1], n), dropped


def collect_hits(slots, nclose, n_channels: int, max_hits: int | None = None,
                 tick_offset: int = 0, device: bool = True):
    """Kernel slot outputs -> (canonical hit array, dropped count).

    device=True (default) compacts on device and ships only the hit list
    to the host; device=False pulls the raw slot buffers and decodes with
    numpy (always lossless).  Identical results (tested).

    max_hits bounds the device-compact output (None -> max(2048, 2x the
    channel count): ~30x above physical APA TP rates per window); overflow
    beyond it is counted in the returned dropped count."""
    if max_hits is None:
        max_hits = max(2048, 2 * n_channels)
    if device:
        return unpack_compact(compact_on_device(slots, nclose, tick_offset,
                                                n_channels, max_hits))
    from .pallas_tpg import decode_pallas_hits
    return decode_pallas_hits(slots, nclose, n_channels,
                              tick_offset=tick_offset)


class StreamingIngest:
    """Double-buffered streaming driver: enqueue the next batch while the
    device processes the current one (jax dispatch is asynchronous, so the
    host-side framing of batch k+1 overlaps device compute of batch k).

    format="wibeth" (64 ch x 64 ticks per frame), "wib2" (256 ch x 1 tick
    per frame; feed superchunk frames flattened per link) or
    "daphne_stream" (4 ch x 64 ticks per frame).

    device_compact=True compacts the K-slot buffers into a
    (max_hits, 6) hit list ON DEVICE, shrinking device->host transfer
    from the full slot buffers to the hit list itself.

    time2=True: submit()/submit_words() relayout on the HOST into the
    time-paired feed (host_relayout_time2) and run the kernel's
    time_packed datapath.
    """

    def __init__(self, cfg: TPGConfig, n_links: int, tc: int | None = None,
                 k_slots: int = 4, unroll: int | None = None,
                 interpret: bool = False,
                 format: str = "wibeth", device_compact: bool = False,
                 max_hits: int = 1024, rs_memory_factor=None,
                 time2: bool = False):
        from ..formats import daphne, wib2
        self.cfg = cfg
        self.n_links = n_links
        self.format = format
        self._ticks_per_row = 1            # ticks per packed word row
        self.time2 = time2
        from .. import native
        self._t2_bufs = native.FeedBuffer()   # host relayout output reuse
        if format == "wibeth":
            self._ch_per_link = wibeth.N_CHANNELS
            self._fn = process_packed_frames
            self._unpack = wibeth.unpack_frames_jnp
        elif format == "wib2":
            self._ch_per_link = wib2.N_CHANNELS
            self._fn = process_packed_wib2
            self._unpack = wib2.unpack_frames_jnp
        elif format == "daphne_stream":
            self._ch_per_link = daphne.STREAM_N_CHANNELS
            self._fn = process_packed_daphne
            self._ticks_per_row = daphne.STREAM_N_SAMPLES
            # tick-major flat view so row 0 of the result is tick 0
            self._unpack = lambda w: daphne.stream_unpack_frames_jnp(w) \
                .reshape(w.shape[0], -1, daphne.STREAM_N_CHANNELS)
        else:
            raise ValueError(f"unknown format {format!r}")
        self.n_channels = n_links * self._ch_per_link
        # knob resolution: explicit args win; else a tuned-config file
        # (FDREADOUT_TUNED); else the shipped per-family values
        from ..utils.tuning import kernel_knobs
        knobs = kernel_knobs(cfg, self.n_channels)
        self.tc = tc if tc is not None else knobs["tc"]
        self.k_slots = k_slots
        self.unroll = unroll if unroll is not None else knobs["unroll"]
        self._block_sublanes = knobs["block_sublanes"]
        self.interpret = interpret
        self.device_compact = device_compact
        self.max_hits = max_hits
        # per-channel RS memory factors (threshold-on-collection mixes
        # memoryless collection channels with RS induction channels,
        # WIBEthFrameProcessor.cpp:441-450); scalar default = cfg value
        if rs_memory_factor is None:
            rs_memory_factor = cfg.rs_memory_factor_x10
        else:
            rs_memory_factor = np.asarray(rs_memory_factor)
            if rs_memory_factor.shape not in ((), (self.n_channels,)):
                raise ValueError(
                    f"rs_memory_factor must be scalar or "
                    f"({self.n_channels},), got {rs_memory_factor.shape}")
            cfg.check_memory_factors(np.atleast_1d(rs_memory_factor))
        self.rs_memory_factor = rs_memory_factor
        self.stack = None
        self._pending = None          # (slots, nclose, tick_offset) or
                                      # the compact array when compacting
        self.tick_offset = 0

    def _seed(self, first: np.ndarray) -> None:
        from .chanstate import init_chanstate, seed_chanstate
        from .pallas_tpg import pack_state
        state = seed_chanstate(init_chanstate(self.n_channels), first,
                               self.rs_memory_factor)
        self.stack = pack_state(state, self.n_channels,
                                block_sublanes=self._block_sublanes)

    def _launch(self, fn, feed, T: int, tc: int, unroll: int):
        out = self._collect() if self._pending is not None else None
        slots, nclose, self.stack = fn(
            jnp.asarray(feed), self.stack, self.cfg, self.n_channels,
            tc=tc, k_slots=self.k_slots, unroll=unroll,
            interpret=self.interpret)
        if self.device_compact:
            self._pending = compact_on_device(
                slots, nclose, self.tick_offset, self.n_channels,
                self.max_hits)
        else:
            self._pending = (slots, nclose, self.tick_offset)
        self.tick_offset += T
        return out

    def submit_words(self, words: np.ndarray):
        """words: (L, rows, W) uint32 packed rows (W=28 wibeth,
        112 wib2/daphne_stream)."""
        if self.time2:
            return self.submit_time2(self.host_relayout_time2(words))
        L, rows, _ = words.shape
        T = rows * self._ticks_per_row
        if self.stack is None:
            self._seed(np.asarray(self._unpack(
                jnp.asarray(words[:, :1])))[:, 0].reshape(-1))
        from .pallas_tpg import auto_tc
        tc = auto_tc(T, cap=self.tc)
        # interpret mode is a correctness path: unrolled interpret
        # compiles are slow on the CPU and measure nothing
        unroll = 1 if self.interpret or tc % self.unroll else self.unroll
        return self._launch(self._fn, words, T, tc, unroll)

    def host_relayout_time2(self, words: np.ndarray) -> np.ndarray:
        """Format-appropriate host relayout into the time2 feed:
        (L, rows, W) packed words (submit_words layout) -> (T//2, S, 128)
        int32 (native C++, numpy fallback), into reused double-buffered
        output pages (native.FeedBuffer)."""
        from .. import native

        if self.format == "daphne_stream":
            L, N, _ = words.shape
            shape = (N * 32, native._pad_sublanes8(4 * L), 128)
            return native.relayout_time2_daphne(
                words, out=self._t2_bufs.get(shape))
        L, T, _ = words.shape
        shape = native.time2_feed_shape(L, T,
                                        ch_per_link=self._ch_per_link)
        return native.relayout_time2(words, ch_per_link=self._ch_per_link,
                                     out=self._t2_bufs.get(shape))

    def submit_time2(self, W2: np.ndarray):
        """Time-paired host feed: W2 is (T//2, S, 128) int32 from
        host_relayout_time2 / native.relayout_time2 (any format: the feed
        itself is canonical channel order, only the host relayout is
        format-specific).  Pipelining/collection semantics match
        submit_words."""
        T = 2 * int(W2.shape[0])
        if self.stack is None:
            # seed from tick 0 = the low 16-bit halves of the first row
            self._seed((np.asarray(W2[0]).reshape(-1)[: self.n_channels]
                        & 0xFFFF).astype(np.int32))
        from .pallas_tpg import auto_tc
        tc = auto_tc(T, cap=self.tc)
        # the time_packed datapath consumes two ticks per row: tc and
        # unroll must be even.  auto_tc can return an odd divisor (e.g.
        # T = 64*509 frames with cap 512 -> tc=509); fall back to the
        # largest even divisor (T = 2*rows is always even).
        if tc % 2:
            tc = next((d for d in range(tc, 1, -1)
                       if T % d == 0 and d % 2 == 0), T)
        unroll = self.unroll if (not self.interpret
                                 and tc % self.unroll == 0
                                 and self.unroll % 2 == 0) else 2
        return self._launch(process_time2_feed, W2, T, tc, unroll)

    def submit(self, frames_links: np.ndarray):
        """frames_links: (L, N, frame_size) uint8.  Returns the decoded
        hits of the PREVIOUS batch (pipelined), or None on the first call."""
        from ..formats import daphne, wib2
        L, N, _ = frames_links.shape
        if self.format == "wibeth":
            T = N * wibeth.N_TIME_SAMPLES
            words = host_words(frames_links.reshape(-1, wibeth.FRAME_SIZE)) \
                .reshape(L, T, 28)
        elif self.format == "wib2":
            words = np.ascontiguousarray(wib2.adc_region_u32(
                frames_links.reshape(-1, wib2.FRAME_SIZE))) \
                .reshape(L, N, wib2.ADC_WORDS)
        else:
            words = daphne.stream_frames_bytes_to_u32(
                frames_links.reshape(-1, daphne.STREAM_FRAME_SIZE)) \
                .reshape(L, N, daphne.STREAM_ADC_WORDS)
        return self.submit_words(words)

    def _collect(self):
        if self.device_compact:
            packed, self._pending = self._pending, None
            return unpack_compact(packed)
        from .pallas_tpg import decode_pallas_hits
        slots, nclose, tick_offset = self._pending
        hits, dropped = decode_pallas_hits(slots, nclose, self.n_channels,
                                           tick_offset=tick_offset)
        self._pending = None
        return hits, dropped

    def flush(self):
        """Collect the final in-flight batch."""
        return self._collect() if self._pending is not None else None
