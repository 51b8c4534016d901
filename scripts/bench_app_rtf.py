#!/usr/bin/env python
"""Whole-application sustained RTF on the GPU.

Drives ``APAReadoutApp`` end-to-end — packed WIBEth bytes -> batched
sequence/timestamp preprocess -> zero-copy raw retention -> host time2
codec -> device hit finding -> one compact-hit fetch -> batched whole-APA
TP assembly -> TP latency buffer -> TPSet windowing + cleanup — at the
production configuration, and records the sustained data-time / wall-time
ratio plus per-stage accounting.  ``device_compute_ms`` separately times
the app's exact per-batch device computation (process_time2_feed +
compact_on_device at the app's shapes, state chained) on device-resident
feeds, so the host stages and the host->device copy can be read against
it.

Reference chain being matched: the full processor+handler deployment unit,
src/wibeth/WIBEthFrameProcessor.cpp:411-572 feeding
src/TPCTPRequestHandler.cpp:100-193 (the reference's unit of deployment is
this assembled chain, not any one kernel).

Run:  python scripts/bench_app_rtf.py [--frames 128 --timed 12]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from fdreadoutlibs_jax.formats import wibeth  # noqa: E402

TS0 = 0x1000000
SPAN_S_PER_FRAME = wibeth.N_TIME_SAMPLES * 32 / 62.5e6


def generate_batches(L: int, N: int, B: int, signal_rate_per_frame: float,
                     seed: int = 0):
    """B distinct (L, N, 7200) uint8 WIBEth batches with continuous
    timestamps and sequence ids (the emulated 40-link source).  Generated
    UP FRONT so source emulation never pollutes the timed loop — and never
    mutated afterwards, which the zero-copy retention contract requires."""
    rng = np.random.default_rng(seed)
    ts = TS0
    batches = []
    for b in range(B):
        frames = np.zeros((L, N, wibeth.FRAME_SIZE), dtype=np.uint8)
        adcs = (900 + rng.normal(0, 30, size=(L, N, 64, 64))) \
            .astype(np.uint16)
        n_sig = int(rng.poisson(signal_rate_per_frame * N * L * 64))
        for _ in range(n_sig):
            link, c = rng.integers(0, L), rng.integers(0, 64)
            f, t = rng.integers(0, N), rng.integers(0, 50)
            adcs[link, f, t:t + 8, c] += np.uint16(rng.integers(300, 3000))
        for link in range(L):
            wibeth.set_adcs(frames[link], adcs[link])
            wibeth.fake_timestamps(frames[link], ts)
            wibeth.fake_seq_ids(frames[link], b * N)
            wibeth.fake_geoid(frames[link], 1, link // 8, link % 8)
        batches.append(frames)
        ts += N * wibeth.EXPECTED_TICK_DIFFERENCE
    return batches


def _build_app(L: int, N: int, pipelined: bool, algorithm: str,
               threshold: int, codec_threads: int):
    from fdreadoutlibs_jax.apps.apa_readout import APAReadoutApp
    return APAReadoutApp(
        n_links=L, algorithm=algorithm, threshold=threshold,
        threshold_on_collection=True, time2_feed=True,
        codec_threads=codec_threads, batched_assembly=True,
        raw_capacity_frames=max(4096, 4 * N), raw_retention="zerocopy",
        pipelined=pipelined, backend="pallas")


def _stage_p50s(rows):
    keys = [k for k in rows[0] if k != "total_ms"]
    return {k: round(float(np.percentile([r[k] for r in rows], 50)), 3)
            for k in keys}


def run_mode(batches, L: int, N: int, warm: int, timed: int,
             pipelined: bool, algorithm: str, threshold: int,
             codec_threads: int) -> dict:
    """One timed pass over the pregenerated stream; returns the sustained
    RTF and per-stage p50s, plus proof that TPSets flowed during the
    timed region (not just during warmup)."""
    app = _build_app(L, N, pipelined, algorithm, threshold, codec_threads)
    for fb in batches[:warm]:
        app.process_batch(fb)
    app.batch_timings.clear()
    tpsets0 = app.handler.metrics.count("num_tpsets_sent")
    drained = 0

    t0 = time.perf_counter()
    for fb in batches[warm:warm + timed]:
        app.process_batch(fb)
        # the downstream trigger consumer: draining the TPSet queue is part
        # of a sustained deployment (an undrained queue eventually refuses
        # sends and the handler stops doing windowing work)
        drained += len(app.tpset_q.drain())
    app.flush()
    wall = time.perf_counter() - t0

    drained += len(app.tpset_q.drain())
    info = app.get_info()
    data_seconds = timed * N * SPAN_S_PER_FRAME
    rows = list(app.batch_timings)
    out = {
        "rtf": round(data_seconds / wall, 3),
        "wall_s": round(wall, 3),
        "data_s": round(data_seconds, 4),
        "stages_ms_p50": _stage_p50s(rows),
        "tpsets_sent_timed": app.handler.metrics.count("num_tpsets_sent")
        - tpsets0,
        "tpsets_drained": drained,
        "total_tps_sent": info["total_tps_sent"],
        "total_hits": info["total_hits"],
        "ts_errors": info["ts_errors"],
        "raw_frames_buffered": info["raw_buffered"],
    }
    # proof the data-request path is live on the SAME run: serve a raw
    # fragment for a recent window on link 0 and round-trip its binary
    # daqdataformats form
    last_ts = TS0 + (warm + timed) * N * wibeth.EXPECTED_TICK_DIFFERENCE
    start = last_ts - 64 * wibeth.EXPECTED_TICK_DIFFERENCE
    frag = app.readout[0].request_fragment(
        start, last_ts, run_number=app.run_number, trigger_number=1,
        source_id=0)
    from fdreadoutlibs_jax.formats.fragment import Fragment
    blob = frag.to_bytes()
    rt = Fragment.from_bytes(blob)
    assert rt.header.window_begin == frag.header.window_begin
    out["fragment_payloads"] = len(frag)
    out["fragment_bytes"] = len(blob)
    return out


def measure_device_compute(L: int, N: int, algorithm: str, threshold: int,
                           trials: int = 3) -> float:
    """Time the app's EXACT per-batch device computation (the
    process_time2_feed + compact_on_device pair _device_submit builds,
    same shapes/knobs/state-chaining) with device-resident feeds: n
    batches chained in one jit, host clock around block_until_ready.
    Returns the median milliseconds of device time per batch."""
    import jax
    import jax.numpy as jnp
    from fdreadoutlibs_jax.formats import wibeth
    from fdreadoutlibs_jax.ops import TPGConfig
    from fdreadoutlibs_jax.ops.chanstate import init_chanstate, \
        seed_chanstate
    from fdreadoutlibs_jax.ops.ingest import (compact_on_device,
                                              process_time2_feed)
    from fdreadoutlibs_jax.ops.pallas_tpg import (auto_tc, pack_adcs,
                                                  pack_state,
                                                  pack_time2_jnp)
    from fdreadoutlibs_jax.utils.tuning import kernel_knobs

    T, C = N * wibeth.N_TIME_SAMPLES, L * wibeth.N_CHANNELS
    cfg = TPGConfig.from_raw(algorithm, threshold=threshold)
    rng = np.random.default_rng(3)
    adcs = (900 + rng.normal(0, 30, size=(T, C))).astype(np.int32)
    for _ in range(100):
        c, t0 = rng.integers(0, C), rng.integers(0, T - 16)
        adcs[t0:t0 + 8, c] += rng.integers(300, 3000)
    rmf = np.where(np.arange(C) % 8 < 3, 0, cfg.rs_memory_factor_x10)
    knobs = kernel_knobs(cfg, C)
    stack = pack_state(seed_chanstate(init_chanstate(C), adcs[0], rmf), C,
                       block_sublanes=knobs["block_sublanes"])
    # two distinct resident feeds, alternated like a double-buffered DMA.
    # Sliced to the UNPADDED ceil(C/128) rows the app actually ships
    # (relayout_time2 pad8=False): process_time2_feed's on-device zero-pad
    # is part of the app's per-batch device computation and must be timed
    rows = -(-C // 128)
    feeds = [pack_time2_jnp(jnp.asarray(pack_adcs(adcs)))[:, :rows],
             pack_time2_jnp(jnp.asarray(pack_adcs(np.roll(adcs, T // 2,
                                                          axis=0))))[:, :rows]]
    tc = auto_tc(T, cap=knobs["tc"])
    # the app's exact unroll resolution (_device_submit)
    u = knobs["unroll"] if tc % knobs["unroll"] == 0 else \
        (8 if tc % 8 == 0 else 1)
    u = u if u % 2 == 0 else 2          # two ticks per time2 word
    max_hits = max(2048, 2 * C)

    feeds_arr = jnp.stack(feeds)                     # (2, T//2, S, 128)

    def body(stack, i):
        feed = jax.lax.dynamic_index_in_dim(feeds_arr, i, keepdims=False)
        slots, nclose, stack = process_time2_feed(
            feed, stack, cfg, C, tc=tc, k_slots=4, unroll=u)  # k=4: the app's
        # capacity-driven default (APAReadoutApp.k_slots), not the
        # kernel-bench knob — the projection must model the app
        return stack, compact_on_device(slots, nclose, 0, C, max_hits)

    n = 8

    @jax.jit
    def multi(stack):
        return jax.lax.scan(body, stack, jnp.arange(n) % 2)

    jax.block_until_ready(multi(stack))              # compile
    per_batch = []
    for _ in range(trials):
        t0 = time.perf_counter()
        jax.block_until_ready(multi(stack))
        per_batch.append((time.perf_counter() - t0) / n)
    return float(np.median(per_batch)) * 1e3


def run_bench(links: int = 40, frames: int = 128, warm: int = 3,
              timed: int = 12, algorithm: str = "AbsRS",
              threshold: int = 150, signal_rate: float = 0.0025,
              codec_threads: int = 1) -> dict:
    """The whole bench as a callable (bench.py embeds it as the
    ``app_rtf`` object); main() is the CLI shell around this."""
    L, N = links, frames
    B = warm + timed
    t_gen = time.perf_counter()
    batches = generate_batches(L, N, B, signal_rate)
    gen_s = time.perf_counter() - t_gen

    span_ms = N * SPAN_S_PER_FRAME * 1e3
    common = dict(L=L, N=N, warm=warm, timed=timed,
                  algorithm=algorithm, threshold=threshold,
                  codec_threads=codec_threads)
    unpiped = run_mode(batches, pipelined=False, **common)
    piped = run_mode(batches, pipelined=True, **common)

    # exact per-batch device traffic: time2 feed up + compact hits down
    from fdreadoutlibs_jax import native
    C = L * 64
    T_ticks = N * wibeth.N_TIME_SAMPLES
    # pad8=False: the app ships only the ceil(C/128) data rows since the
    # unpadded-feed change (apa_readout pad-on-device) — count the bytes
    # that actually cross the link, not the 8-sublane kernel pad
    feed_mb = int(np.prod(native.time2_feed_shape(
        L, T_ticks, pad8=False))) * 4 / 1e6
    hits_mb = (max(2048, 2 * C) + 1) * 6 * 4 / 1e6
    transfer_mb = feed_mb + hits_mb

    dev_ms = measure_device_compute(L, N, algorithm, threshold)

    return {
        "metric": "app_rtf",
        "config": {"links": L, "frames_per_batch": N,
                   "batches_timed": timed,
                   "algorithm": algorithm,
                   "threshold_on_collection": True,
                   "feed": "time2", "retention": "zerocopy",
                   "assembly": "batched", "source_pregen_s": round(gen_s, 1)},
        "batch_span_ms": round(span_ms, 3),
        "rtf_pipelined": piped["rtf"],
        "rtf_unpipelined": unpiped["rtf"],
        "device_transfer_mb_per_batch": round(transfer_mb, 2),
        "device_compute_ms": round(dev_ms, 4),
        "pipelined": piped,
        "unpipelined": unpiped,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--links", type=int, default=40)
    ap.add_argument("--frames", type=int, default=128,
                    help="frames per batch per link (batch span = "
                         "frames * 32.768 us)")
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--timed", type=int, default=12)
    ap.add_argument("--algorithm", default="AbsRS")
    ap.add_argument("--threshold", type=int, default=150)
    ap.add_argument("--signal-rate", type=float, default=0.0025,
                    help="signals per channel per frame")
    ap.add_argument("--codec-threads", type=int, default=1,
                    help="host feed codec std::thread fan-out")
    args = ap.parse_args(argv)
    import bench
    from fdreadoutlibs_jax.utils.runtime import enable_compile_cache
    device = bench.device_info()
    enable_compile_cache()
    out = run_bench(args.links, args.frames, args.warm, args.timed,
                    args.algorithm, args.threshold, args.signal_rate,
                    args.codec_threads)
    out["device"] = device
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
