#!/usr/bin/env python
"""Per-frontend RTF arms on the GPU.

bench.py quantifies the WIBEth algorithm families; this script gives
every OTHER frontend with a device datapath its own real-time factor at a
production aggregation, so the claim
"the rebuild covers the reference's frontends" is a measured statement
per frontend, not an extrapolation from the flagship:

* ``wib2``      — 10 links x 256 ch (one APA), the processor's device
  ingest (`ops/ingest.process_packed_wib2`: packed 112-word rows,
  on-device 14-bit unpack -> FIR, peaks derived at assembly).  Tick =
  32 clocks @ 62.5 MHz.  Reference budget: 6.144 us/superchunk across
  2x128-ch tasks (src/wib2/WIB2FrameProcessor.cpp:224-225).
* ``protowib``  — 10 links dual-plane FIR (collection 960 ch + induction
  1600 ch) through the time2 host-feed device path
  (`stream/protowib.py:_run_pallas_time2`; the host 12-bit codec is
  measured separately — scripts/bench_host_codec.py).  Tick = 25 clocks
  @ 50 MHz.  Reference budget: 6 us/superchunk
  (src/wib/WIBFrameProcessor.hpp:516-518).
* ``daphne_stream`` — 10 links x 4 ch streaming PDS, device ingest
  (`process_packed_daphne`), SimpleThreshold.  ONE CLOCK PER SAMPLE
  (62.5 MHz/channel — 32x the TPC per-channel rate); the reference has
  no PDS TPG at all, so any RTF here is a superset capability.  The
  kernel's serial time recurrence bounds per-tick wall, so RTF ~ 16 ns /
  per-tick-wall regardless of channel count.
* ``tde``       — 40 links x 64 ch vertical-drift TDE (one CRP face
  slice), plain resident-window kernel (the TDE host decode is a uint16
  view + transpose, not a codec).  Samples are 32 clocks apart
  (src/tde/TDEFrameProcessor.cpp:34-77).

Method: identical to bench.py — each arm jits a lax.scan over N windows
of its device computation with carried state, timed around
block_until_ready (median of trials).  Inputs are device-resident packed
words
(wib2/daphne: the REAL packed wire words, so the on-device unpack is
inside the timed region).

Run:  python scripts/bench_frontends.py [--arms wib2,protowib,...]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import bench  # noqa: E402  (repo-root bench.py: timing helpers)

TICK_HZ = {
    "wib2": 62.5e6 / 32,
    "protowib": 50e6 / 25,
    "daphne_stream": 62.5e6,
    "tde": 62.5e6 / 32,
}


def _noise_pulses(T, C, seed, sigma=30, base=900, n_sig=None, amp_lo=300,
                  amp_hi=3000):
    rng = np.random.default_rng(seed)
    adcs = (base + rng.normal(0, sigma, size=(T, C))).astype(np.int32)
    for _ in range(n_sig if n_sig is not None else max(20, C // 16)):
        c, t0 = rng.integers(0, C), rng.integers(0, T - 16)
        adcs[t0:t0 + 8, c] += rng.integers(amp_lo, amp_hi)
    return adcs


def _measure(step, state0, n_windows, span_s, trials, sanity):
    """Compile, sanity-check the hit path, time; -> (rtf, trials)."""
    import jax
    multi = bench.scan_windows(step, n_windows)
    _, counts = jax.block_until_ready(multi(state0))
    n_hits = int(np.asarray(counts).sum())
    assert n_hits >= sanity, f"hit path produced only {n_hits} hits"
    dt, per_call = bench.time_per_window(multi, state0, n_windows, trials)
    return span_s / dt, sorted(span_s / s for s in per_call)


def arm_wib2(T, n_windows, trials, links=10):
    import jax.numpy as jnp
    from fdreadoutlibs_jax.formats import wib2
    from fdreadoutlibs_jax.formats.bitpack import pack_14bit
    from fdreadoutlibs_jax.ops import TPGConfig
    from fdreadoutlibs_jax.ops.chanstate import init_chanstate, \
        seed_chanstate
    from fdreadoutlibs_jax.ops.ingest import (process_packed_wib2,
                                              process_time2_feed)
    from fdreadoutlibs_jax.ops.pallas_tpg import pack_state
    from fdreadoutlibs_jax.utils.tuning import kernel_knobs

    C = links * wib2.N_CHANNELS
    cfg = TPGConfig.from_raw("FIR", threshold=5, track_peaks=False)
    adcs = _noise_pulses(T, C, seed=11)
    # the real wire words, per link: (L, T, 112) packed 14-bit rows
    words = np.stack([
        pack_14bit(adcs[:, l * 256:(l + 1) * 256].astype(np.uint16),
                   wib2.ADC_BITS, n_words=wib2.ADC_WORDS)
        for l in range(links)])
    knobs = kernel_knobs(cfg, C)
    stack = pack_state(
        seed_chanstate(init_chanstate(C), adcs[0], cfg.rs_memory_factor_x10),
        C, block_sublanes=knobs["block_sublanes"])
    tc = knobs["tc"] if T % knobs["tc"] == 0 else 256
    u = knobs["unroll"] if tc % knobs["unroll"] == 0 else 1
    w = jnp.asarray(words)

    def step_packed(s):
        return process_packed_wib2(w, s, cfg, C, tc=tc,
                                   k_slots=knobs["k_slots"], unroll=u)

    # production path (stream/wib2.py tpg_time2_feed): the HOST unpacks
    # + time-pairs (native.relayout_time2 is generic over ch_per_link —
    # WIB2 nw=112), the device runs the plain time_packed datapath.
    # Host codec cost is quantified separately (host_codecs in bench.py).
    from fdreadoutlibs_jax import native
    feed = jnp.asarray(native.relayout_time2(words, ch_per_link=256))
    u2 = u if u % 2 == 0 else 2
    tc2 = tc if tc % 2 == 0 else 256

    def step_time2(s):
        return process_time2_feed(feed, s, cfg, C, tc=tc2,
                                  k_slots=knobs["k_slots"], unroll=u2)

    span = T / TICK_HZ["wib2"]
    rtf, per = _measure(step_time2, stack, n_windows, span, trials,
                        sanity=3)
    rtf_f, per_f = _measure(step_packed, stack, n_windows, span, trials,
                            sanity=3)
    return {"rtf": round(rtf, 2), "trials": [round(v, 2) for v in per],
            "channels": C, "links": links, "algorithm": "FIR",
            "ingest": "time2 host feed (codec in host_codecs)",
            "rtf_packed": round(rtf_f, 2),
            "trials_packed": [round(v, 2) for v in per_f],
            "tick_hz": TICK_HZ["wib2"]}


def arm_protowib(T, n_windows, trials, links=10):
    import jax.numpy as jnp
    from fdreadoutlibs_jax.formats import protowib as pw
    from fdreadoutlibs_jax.ops import TPGConfig
    from fdreadoutlibs_jax.ops.chanstate import init_chanstate, \
        seed_chanstate
    from fdreadoutlibs_jax.ops.ingest import process_time2_feed
    from fdreadoutlibs_jax.ops.pallas_tpg import (pack_adcs, pack_state,
                                                  pack_time2_jnp)
    from fdreadoutlibs_jax.utils.tuning import kernel_knobs

    cfg = TPGConfig.from_raw("FIR", threshold=5, track_peaks=False)
    planes = {}
    for name, per_link in (("coll", pw.N_COLLECTION),
                           ("ind", pw.N_INDUCTION)):
        C = links * per_link
        adcs = _noise_pulses(T, C, seed=13 if name == "coll" else 17)
        knobs = kernel_knobs(cfg, C)
        stack = pack_state(
            seed_chanstate(init_chanstate(C), adcs[0],
                           cfg.rs_memory_factor_x10),
            C, block_sublanes=knobs["block_sublanes"])
        feed = pack_time2_jnp(jnp.asarray(pack_adcs(adcs)))
        tc = knobs["tc"] if T % knobs["tc"] == 0 else 256
        u = knobs["unroll"] if tc % knobs["unroll"] == 0 else 2
        u = u if u % 2 == 0 else 2
        planes[name] = (C, stack, feed, tc, u, knobs["k_slots"])

    def step(stacks):
        import jax.numpy as jnp
        sc, si = stacks
        outs = []
        for (C, _s0, feed, tc, u, ks), s in (
                (planes["coll"], sc), (planes["ind"], si)):
            slots, nclose, s = process_time2_feed(
                feed, s, cfg, C, tc=tc, k_slots=ks, unroll=u)
            outs.append((nclose, s))
        return None, jnp.sum(outs[0][0]) + jnp.sum(outs[1][0]), \
            (outs[0][1], outs[1][1])

    state0 = (planes["coll"][1], planes["ind"][1])  # packed stacks
    span = T / TICK_HZ["protowib"]
    rtf, per = _measure(step, state0, n_windows, span, trials, sanity=3)
    return {"rtf": round(rtf, 2), "trials": [round(v, 2) for v in per],
            "channels": links * 256, "links": links,
            "algorithm": "FIR dual-plane",
            "ingest": "time2 host feed (codec in host_codecs)",
            "tick_hz": TICK_HZ["protowib"]}


def arm_daphne_stream(T, n_windows, trials, links=10):
    import jax.numpy as jnp
    from fdreadoutlibs_jax.formats import daphne
    from fdreadoutlibs_jax.formats.bitpack import pack_14bit
    from fdreadoutlibs_jax.ops import TPGConfig
    from fdreadoutlibs_jax.ops.chanstate import init_chanstate, \
        seed_chanstate
    from fdreadoutlibs_jax.ops.ingest import process_packed_daphne
    from fdreadoutlibs_jax.ops.pallas_tpg import pack_state
    from fdreadoutlibs_jax.utils.tuning import kernel_knobs

    C = links * daphne.STREAM_N_CHANNELS
    N = T // daphne.STREAM_N_SAMPLES
    cfg = TPGConfig.from_raw("SimpleThreshold", threshold=50)
    adcs = _noise_pulses(T, C, seed=19, sigma=8, base=8000, n_sig=60,
                         amp_lo=100, amp_hi=1500)
    # real stream wire words: each frame = 64 ticks of 4 channels
    per_frame = adcs.reshape(N, daphne.STREAM_N_SAMPLES, links,
                             daphne.STREAM_N_CHANNELS).transpose(2, 0, 1, 3)
    flat = per_frame.reshape(links, N, daphne.STREAM_N_SAMPLES *
                             daphne.STREAM_N_CHANNELS).astype(np.uint16)
    words = pack_14bit(flat, daphne.ADC_BITS,
                       n_words=daphne.STREAM_ADC_WORDS)
    knobs = kernel_knobs(cfg, C)
    stack = pack_state(
        seed_chanstate(init_chanstate(C), adcs[0], cfg.rs_memory_factor_x10),
        C, block_sublanes=knobs["block_sublanes"])
    tc = knobs["tc"] if T % knobs["tc"] == 0 else 256
    u = knobs["unroll"] if tc % knobs["unroll"] == 0 else 1
    w = jnp.asarray(words)

    def step(s):
        return process_packed_daphne(w, s, cfg, C, tc=tc, k_slots=knobs["k_slots"],
                                     unroll=u)

    span = T / TICK_HZ["daphne_stream"]
    rtf, per = _measure(step, stack, n_windows, span, trials, sanity=3)
    per_tick_ns = (span / rtf) / T * 1e9
    return {"rtf": round(rtf, 3), "trials": [round(v, 3) for v in per],
            "channels": C, "links": links, "algorithm": "SimpleThreshold",
            "ingest": "on-device 14-bit unpack",
            "tick_hz": TICK_HZ["daphne_stream"],
            "per_tick_wall_ns": round(per_tick_ns, 1),
            "note": "62.5 MHz/channel stream; serial recurrence bounds "
                    "per-tick wall, so chips_per_stream = 1/rtf at any "
                    "channel count"}


def arm_tde(T, n_windows, trials, links=40):
    import jax.numpy as jnp
    from fdreadoutlibs_jax.formats import tde
    from fdreadoutlibs_jax.ops import TPGConfig
    from fdreadoutlibs_jax.ops.chanstate import init_chanstate, \
        seed_chanstate
    from fdreadoutlibs_jax.ops.pallas_tpg import (pack_adcs, pack_state,
                                                  process_window_pallas)
    from fdreadoutlibs_jax.utils.tuning import kernel_knobs

    C = links * tde.N_CHANNELS_PER_LINK
    cfg = TPGConfig.from_raw("SimpleThreshold", threshold=500)
    adcs = _noise_pulses(T, C, seed=23, amp_lo=600, amp_hi=3000)
    knobs = kernel_knobs(cfg, C)
    stack = pack_state(
        seed_chanstate(init_chanstate(C), adcs[0], cfg.rs_memory_factor_x10),
        C, block_sublanes=knobs["block_sublanes"])
    packed = jnp.asarray(pack_adcs(adcs))
    tc = knobs["tc"] if T % knobs["tc"] == 0 else 256
    u = knobs["unroll"] if tc % knobs["unroll"] == 0 else 1

    def step(s):
        return process_window_pallas(packed, s, cfg, tc=tc, k_slots=knobs["k_slots"],
                                     unroll=u)

    span = T / TICK_HZ["tde"]
    rtf, per = _measure(step, stack, n_windows, span, trials, sanity=3)
    return {"rtf": round(rtf, 2), "trials": [round(v, 2) for v in per],
            "channels": C, "links": links, "algorithm": "SimpleThreshold",
            "ingest": "resident windows (TDE host decode is a uint16 "
                      "view+transpose, not a codec)",
            "tick_hz": TICK_HZ["tde"]}


ARMS = {"wib2": arm_wib2, "protowib": arm_protowib,
        "daphne_stream": arm_daphne_stream, "tde": arm_tde}


def run_all(arms=None, T=8192, n_windows=16, trials=3):
    return {name: ARMS[name](T, n_windows, trials)
            for name in (arms or list(ARMS))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arms", default=",".join(ARMS))
    ap.add_argument("--windows", type=int, default=16)
    ap.add_argument("--ticks", type=int, default=8192)
    ap.add_argument("--trials", type=int, default=3)
    args = ap.parse_args(argv)
    from fdreadoutlibs_jax.utils.runtime import enable_compile_cache
    device = bench.device_info()
    enable_compile_cache()
    res = run_all(args.arms.split(","), args.ticks, args.windows,
                  args.trials)
    print(json.dumps({"metric": "frontend_rtf", "device": device,
                      "frontends": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
