"""Pallas hit-finding kernel, compiled for the GPU through Triton.

The production analogue of process_window_avx2 / process_window_rs_avx2 /
process_window_standard_rs_avx2 (wibeth/tpg/Process*AVX2.hpp) and the
FIR+IQR kernels — one kernel, parameterized by :class:`TPGConfig`, whose
body calls the same :func:`ops.step.dispatch_tick` as the numpy oracle and
the ``lax.scan`` backend, so it is bit-exact by construction (and tested).

Design:

* Channels are independent recurrences; ticks within a channel are
  serial.  The grid runs over channel blocks only: program ``b`` owns the
  SUB*128 flat channels in rows b*SUB .. b*SUB+SUB-1 of the (T, S, 128)
  container and runs the WHOLE window's time loop itself.  State is
  loaded into registers once and stored once.  Nothing carries between
  programs, so blocks may run in parallel and in any order.
* The time loop has two levels: an outer loop over ``tc``-tick emission
  chunks and an inner loop over groups of ``unroll`` ticks.  The next
  group's ADC rows are loaded at the top of each iteration and ride the
  loop carry, so their memory latency overlaps the current group's
  dependency chain instead of adding to it.
* Hit emission replaces the reference's MAGIC-sentinel register dumps
  (ProcessAVX2.hpp:157-196) with **per-channel K-slot buffers**: when a
  channel's hit closes, its packed record goes into slot ``n_closed[c]``
  via K one-hot selects.  The selects do not feed the recurrent chain.
  Records pack into int32 words [charge<<16 | tover,
  peak_adc<<16 | peak_time, end_tick+1] (the peak word is dropped for
  FIR without peak tracking).  Each ``tc``-tick chunk drains into its own
  output block, so per-channel capacity is K hits per tc ticks (the
  reference shares one 100k buffer per 64-tick window,
  WIBEthFrameProcessor.cpp:78).  Closes beyond K in a chunk are dropped
  per channel and visible in the per-chunk close counts, which also feed
  the hot-channel monitoring the reference keeps in
  m_tp_channel_rate_map.

The body is integer arithmetic with no matrix product, so the route is
Triton (``backend="triton"``); tensor cores and TMA have nothing to do
here.  ``interpret=True`` runs the same kernel on the CPU for tests.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from .chanstate import FIELDS, NSTATE
from .config import Algorithm, TPGConfig
from .fixedpoint import I32Fx
from .step import dispatch_tick

LANES = 128
ROW_GRANULE = 8                            # container rows pad to this
N_FIR_TAPS = 8
KSTATE = NSTATE + 1 + N_FIR_TAPS           # + rs_memory_factor + FIR ring rows
_STATE_KEYS = FIELDS + ("rs_memory_factor",)
_FIR_ROW0 = NSTATE + 1                     # first FIR ring row in the stack

# state fields actually carried through the tick loop, per algorithm family
_LIVE_SIMPLE = ("pedestals", "accum", "prev_was_over", "hit_charge",
                "hit_tover", "hit_peak_adc", "hit_peak_time")
# RS derives prev_was_over from the carried rs value (step.py) — the flag
# register drops out of the loop entirely
_LIVE_RS = tuple(k for k in _LIVE_SIMPLE if k != "prev_was_over") + \
    ("rs", "pedestals_rs", "accum_rs", "rs_memory_factor")
_LIVE_FIR = _LIVE_SIMPLE + ("quantile25", "quantile75", "accum25", "accum75")


def record_words(cfg: TPGConfig) -> int:
    """int32 words per hit record: [charge<<16|tover, peak<<16|ptime,
    end_tick+1], with the peak word dropped for kernels that do not track
    peaks (reference-shaped FIR records)."""
    return 2 if (cfg.algorithm == Algorithm.FIR
                 and not cfg.track_peaks) else 3


def live_fields(cfg: TPGConfig):
    if cfg.algorithm == Algorithm.SIMPLE_THRESHOLD:
        return _LIVE_SIMPLE
    if cfg.algorithm == Algorithm.FIR:
        if not cfg.track_peaks:   # no peak registers (reference FIR shape)
            return tuple(k for k in _LIVE_FIR
                         if k not in ("hit_peak_adc", "hit_peak_time"))
        return _LIVE_FIR
    return _LIVE_RS


# ---- layout helpers ------------------------------------------------------------

def pad_sublanes(C: int) -> int:
    """Channel count -> padded row count of the (T, S, 128) container (a
    multiple of ROW_GRANULE, so every power-of-two channel block up to
    ROW_GRANULE rows tiles it)."""
    S = -(-C // LANES)
    return -(-S // ROW_GRANULE) * ROW_GRANULE


def pack_state(state: dict, n_channels: int,
               block_sublanes: int | None = None):
    """ChanState dict of (C,) arrays -> (NB, KSTATE, SUB, 128) int32 stack.
    SUB (``block_sublanes``, default ROW_GRANULE) is the kernel's channel
    block: SUB*128 channels per program; it must divide ROW_GRANULE."""
    S = pad_sublanes(n_channels)
    sub = block_sublanes or ROW_GRANULE
    if ROW_GRANULE % sub:
        raise ValueError(f"block_sublanes={sub} must divide {ROW_GRANULE}")
    nb = S // sub
    out = np.zeros((nb, KSTATE, sub, LANES), dtype=np.int32)

    def put(i, values):
        v = np.zeros(nb * sub * LANES, dtype=np.int32)
        v[:n_channels] = np.asarray(values).astype(np.int32)
        out[:, i] = v.reshape(nb, sub, LANES)

    for i, k in enumerate(_STATE_KEYS):
        put(i, state[k])
    fir = state.get("fir_prev")
    if fir is not None:
        for j in range(N_FIR_TAPS):
            put(_FIR_ROW0 + j, np.asarray(fir)[j])
    return jnp.asarray(out)


def unpack_state(stack, n_channels: int) -> dict:
    arr = np.asarray(stack).astype(np.int32)
    nb, _, sub, _ = arr.shape
    flat = arr.transpose(1, 0, 2, 3).reshape(KSTATE, nb * sub * LANES)
    st = {k: flat[i][:n_channels].copy() for i, k in enumerate(_STATE_KEYS)}
    st["fir_prev"] = flat[_FIR_ROW0:_FIR_ROW0 + N_FIR_TAPS][:, :n_channels] \
        .copy()
    return st


def auto_tc(T: int, cap: int = 512) -> int:
    """Largest divisor of T not exceeding the chunk cap."""
    for tc in range(min(T, cap), 0, -1):
        if T % tc == 0:
            return tc
    return T


def pack_adcs(adcs: np.ndarray) -> np.ndarray:
    """(T, C) -> (T, S, 128) int32 with zero-padding of the channel axis."""
    T, C = adcs.shape
    S = pad_sublanes(C)
    out = np.zeros((T, S, LANES), dtype=np.int32)
    out.reshape(T, S * LANES)[:, :C] = adcs
    return out


def pack_adcs_time2(adcs: np.ndarray) -> np.ndarray:
    """(T, C) -> (T//2, S, 128) int32 with two consecutive time samples per
    word (t0 | t1<<16) — half the ADC bytes into the kernel.

    Values must be < 32768 (true for all 14-bit streams); the kernel
    recovers t1 with an arithmetic >>16 and t0 with a sign-extending
    (<<16)>>16, so the samples round-trip exactly.
    """
    packed = pack_adcs(adcs)                        # (T, S, 128)
    return packed[0::2] | (packed[1::2] << 16)


def pack_time2_jnp(adcs):
    """Device variant: (T, S, 128) int32 -> (T//2, S, 128) time-paired."""
    return adcs[0::2] | (adcs[1::2] << 16)


# ---- the kernel ----------------------------------------------------------------

def _emit_records(rec: dict, closed, tick, cfg: TPGConfig, slot_words: list,
                  nclose, k_slots: int):
    """Pack a tick's hit record into record_words(cfg) int32 words and
    write it into slot ``n_closed[c]`` via K one-hot selects (module
    docstring).  ``slot_words`` is a flat list of k_slots * nw words,
    slot-major; mutated in place.  Returns the new nclose."""
    w0 = (rec["charge"] << 16) | rec["tover"]
    w2 = jnp.full(closed.shape, tick + 1, jnp.int32)
    if record_words(cfg) == 3:
        words = (w0, (rec["peak_adc"] << 16) | rec["peak_time"], w2)
    else:
        words = (w0, w2)
    nw = len(words)
    for k in range(k_slots):
        sel = closed & (nclose == k)
        for j, w in enumerate(words):
            slot_words[k * nw + j] = jnp.where(sel, w,
                                               slot_words[k * nw + j])
    return nclose + closed.astype(jnp.int32)


def _tpg_kernel(adc_ref, state_ref, state_out_ref, slots_ref, nclose_ref, *,
                cfg: TPGConfig, tc: int, n_chunks: int, k_slots: int,
                unroll: int, time2: bool):
    is_fir = cfg.algorithm == Algorithm.FIR
    keys = live_fields(cfg)
    fx = I32Fx.make(jnp)
    nw = record_words(cfg)
    rows_per_group = unroll // 2 if time2 else unroll
    groups_per_chunk = tc // unroll
    last_group = n_chunks * groups_per_chunk - 1

    def load_group(g):
        r0 = g * rows_per_group
        return tuple(adc_ref[r0 + j] for j in range(rows_per_group))

    def ticks_of(rows):
        if not time2:
            return rows
        ticks = []
        for w in rows:      # tick 2j in the low half, 2j+1 in the high half
            ticks += [(w << 16) >> 16, w >> 16]
        return ticks

    state0 = tuple(state_ref[0, _STATE_KEYS.index(k)] for k in keys)
    if is_fir:
        # FIR ring rows ride the carry as separate values: the per-tick
        # shift is then a trace-time tuple rotation (no moves)
        state0 += tuple(state_ref[0, _FIR_ROW0 + j]
                        for j in range(N_FIR_TAPS))
    nst = len(state0)
    zero = jnp.zeros(state0[0].shape, jnp.int32)

    def as_dict(vals):
        st = dict(zip(keys, vals[:len(keys)]))
        if is_fir:
            st["fir_prev"] = tuple(vals[len(keys):nst])
        if cfg.algorithm == Algorithm.SIMPLE_THRESHOLD:
            st["rs_memory_factor"] = None
        return st

    def as_tuple(st):
        vals = tuple(st[k] for k in keys)
        return vals + (tuple(st["fir_prev"]) if is_fir else ())

    def chunk_body(c, outer):
        def group_body(i, carry):
            st = as_dict(carry[:nst])
            rows = carry[nst:nst + rows_per_group]
            slot_words = list(carry[nst + rows_per_group:-1])
            nclose = carry[-1]
            g = c * groups_per_chunk + i
            # prefetch: the next group's rows load while this group's
            # ticks run (the last group re-reads itself harmlessly)
            nxt = load_group(jnp.minimum(g + 1, last_group))
            for u, s_raw in enumerate(ticks_of(rows)):
                st, closed, rec = dispatch_tick(st, s_raw, cfg, jnp, fx=fx)
                nclose = _emit_records(rec, closed, g * unroll + u, cfg,
                                       slot_words, nclose, k_slots)
            return as_tuple(st) + nxt + tuple(slot_words) + (nclose,)

        carry = jax.lax.fori_loop(
            0, groups_per_chunk, group_body,
            outer + (zero,) * (k_slots * nw) + (zero,))
        for k in range(k_slots):
            for j in range(nw):
                slots_ref[0, c, k, j] = carry[nst + rows_per_group
                                              + k * nw + j]
        nclose_ref[0, c] = carry[-1]
        return carry[:nst + rows_per_group]

    final = jax.lax.fori_loop(0, n_chunks, chunk_body,
                              state0 + load_group(0))
    for i, k in enumerate(_STATE_KEYS):
        state_out_ref[0, i] = final[keys.index(k)] if k in keys \
            else state_ref[0, i]
    for j in range(N_FIR_TAPS):
        state_out_ref[0, _FIR_ROW0 + j] = final[len(keys) + j] if is_fir \
            else state_ref[0, _FIR_ROW0 + j]


@functools.partial(jax.jit,
                   static_argnames=("cfg", "tc", "k_slots", "interpret",
                                    "unroll", "time_packed", "num_warps",
                                    "num_stages"))
def process_window_pallas(adcs, state_stack, cfg: TPGConfig, tc: int = 256,
                          k_slots: int = 4, interpret: bool = False,
                          unroll: int = 1, time_packed: bool = False,
                          num_warps: int | None = None,
                          num_stages: int | None = None):
    """Run the kernel over a (T, S, 128) int32 window.

    Args:
      adcs: (T, S, 128) int32, T divisible by tc — or, with
        time_packed=True, (T//2, S, 128) time-paired words from
        pack_adcs_time2/pack_time2_jnp (half the ADC bytes; requires even
        unroll, samples < 32768).
      state_stack: (NB, KSTATE, SUB, 128) int32 from pack_state; SUB
        selects the channel block (SUB*128 channels per program), a power
        of two, NB * SUB == S.
      tc: ticks per emission chunk.
      k_slots: per-channel hit capacity PER CHUNK (closes beyond this are
        dropped per channel within that chunk; whole-window capacity is
        k_slots * T/tc per channel — see the per-chunk counts output).
      interpret: run on the CPU through the Pallas interpreter (tests);
        never a default.
      num_warps, num_stages: Triton launch parameters; None takes the
        per-family values of utils.tuning.kernel_knobs.

    Returns (slots (NB, T/tc, K, nw, SUB, 128) int32,
    nclose (NB, T/tc, SUB, 128) int32, new_state).  nclose is the
    per-channel number of hits that closed in each chunk (may exceed
    k_slots, indicating drops).  The state stack is updated in place
    (aliased).
    """
    nb, kst, sub, lanes = state_stack.shape
    rows, S, _ = adcs.shape
    T = rows * 2 if time_packed else rows
    n_chunks = T // tc
    if not (T % tc == 0 and tc % unroll == 0 and kst == KSTATE
            and lanes == LANES and nb * sub == S and sub & (sub - 1) == 0):
        raise ValueError(
            f"bad kernel shapes: adcs {adcs.shape}, state "
            f"{state_stack.shape}, tc={tc}, unroll={unroll} (need T % tc "
            "== 0, tc % unroll == 0, NB*SUB == S, SUB a power of two)")
    if adcs.dtype != jnp.int32 or state_stack.dtype != jnp.int32:
        raise ValueError("adcs and state must be int32")
    if time_packed and unroll % 2:
        raise ValueError("time_packed needs an even unroll")
    if num_warps is None or num_stages is None:
        from ..utils.tuning import kernel_knobs
        knobs = kernel_knobs(cfg, S * LANES)
        num_warps = num_warps or knobs["num_warps"]
        num_stages = num_stages or knobs["num_stages"]

    nw = record_words(cfg)
    kernel = functools.partial(_tpg_kernel, cfg=cfg, tc=tc,
                               n_chunks=n_chunks, k_slots=k_slots,
                               unroll=unroll, time2=time_packed)
    state_out, slots, nclose = pl.pallas_call(
        kernel,
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=num_warps,
                                                 num_stages=num_stages),
        grid=(nb,),
        in_specs=[
            pl.BlockSpec((rows, sub, LANES), lambda b: (0, b, 0)),
            pl.BlockSpec((1, KSTATE, sub, LANES), lambda b: (b, 0, 0, 0)),
        ],
        out_specs=[
            pl.BlockSpec((1, KSTATE, sub, LANES), lambda b: (b, 0, 0, 0)),
            pl.BlockSpec((1, n_chunks, k_slots, nw, sub, LANES),
                         lambda b: (b, 0, 0, 0, 0, 0)),
            pl.BlockSpec((1, n_chunks, sub, LANES), lambda b: (b, 0, 0, 0)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((nb, KSTATE, sub, LANES), jnp.int32),
            jax.ShapeDtypeStruct((nb, n_chunks, k_slots, nw, sub, LANES),
                                 jnp.int32),
            jax.ShapeDtypeStruct((nb, n_chunks, sub, LANES), jnp.int32),
        ],
        input_output_aliases={1: 0},
        interpret=interpret,
        name="tpg_hit_finding",
    )(adcs, state_stack)
    return slots, nclose, state_out


def decode_pallas_hits(slots, nclose, n_channels: int, tick_offset: int = 0):
    """Decode per-chunk K-slot outputs into the canonical hit array (host).

    slots: (NB, NCH, K, nw, SUB, 128); nclose: (NB, NCH, SUB, 128) — the
    per-chunk layout of process_window_pallas.  Returns (hits, n_dropped)
    where n_dropped counts closes beyond the per-channel per-chunk slot
    capacity.
    """
    from .hits import HIT_DTYPE, sort_hits
    slots = np.asarray(slots)
    nclose = np.asarray(nclose)
    nb, nch, K, nw, sub, lanes = slots.shape
    C = nb * sub * lanes
    # chunk-major slot axis: (NCH*K, nw, C) — record words already carry
    # the absolute tick, so chunks just widen the slot dimension; nw=2 is
    # the no-peak FIR record layout [w0, end+1]
    flat = slots.transpose(1, 2, 3, 0, 4, 5).reshape(nch * K, nw, C)
    counts = nclose.transpose(1, 0, 2, 3).reshape(nch, C)
    flat = flat[:, :, :n_channels]
    counts = counts[:, :n_channels]
    k_idx, c_idx = np.nonzero(flat[:, -1] != 0)
    hits = np.zeros(len(k_idx), dtype=HIT_DTYPE)
    w0 = flat[k_idx, 0, c_idx]
    w2 = flat[k_idx, -1, c_idx]
    hits["channel"] = c_idx
    hits["end_tick"] = w2 - 1 + tick_offset
    hits["charge"] = w0 >> 16
    hits["tover"] = w0 & 0xFFFF
    if nw == 3:
        w1 = flat[k_idx, 1, c_idx]
        hits["peak_adc"] = w1 >> 16
        hits["peak_time"] = w1 & 0xFFFF
    n_dropped = int(np.maximum(counts - K, 0).sum())
    return sort_hits(hits), n_dropped
