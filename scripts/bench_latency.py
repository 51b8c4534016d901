#!/usr/bin/env python
"""End-to-end TP-emission latency: data-arrival -> TP-available.

The reference's defining real-time constraint is a latency budget, not a
throughput number: 6 us per superchunk in the spin-wait handshake
(/root/reference/include/fdreadoutlibs/wib/WIBFrameProcessor.hpp:516-518)
and a `tpset_min_latency_ticks` windowing margin that bounds how stale a
TP may be before the cutoff tardy-drops it
(/root/reference/src/TPCTPRequestHandler.cpp:131-133).  This rebuild
trades per-superchunk latency for batched throughput; this harness
quantifies that trade so the margin can be SPECIFIED instead of guessed:

  latency(oldest sample in a batch) = batch_span + processing
  processing = preprocess + retention + host codec + (H2D + kernel + D2H)
               + TP assembly + handler insert/window

Each APAReadoutApp batch records its stage breakdown (app.batch_timings);
this harness drives the production app config over the ingest arms at one
or more batch sizes on the GPU and reports p50/p95/max and the implied
minimum safe `tpset_min_latency_ticks` (2x margin on p95).  The device
stage ends in one blocking fetch (compact_on_device packs its outputs
into a single array), so each batch's timing includes its device work.

Usage:
  python scripts/bench_latency.py [--arms time2,packed]
      [--links 40] [--frames 8,32] [--batches 20]
Output: one JSON document (device and card included).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import zlib

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ARM_KWARGS = {
    "packed": {},
    "time2": {"time2_feed": True},
}


def gen_batch(rng, L, N, batch_idx, ts, signal_rate=0.02):
    """One realistic APA batch: emulated noise + Poisson signal pulses
    (the apa_readout demo generator, kept outside the timed region)."""
    from fdreadoutlibs_jax.formats import wibeth
    frames = np.zeros((L, N, wibeth.FRAME_SIZE), dtype=np.uint8)
    adcs = (900 + rng.normal(0, 30, size=(L, N, 64, 64))).astype(np.uint16)
    for _ in range(rng.poisson(signal_rate * L * 64)):
        l, c = rng.integers(0, L), rng.integers(0, 64)
        f, t = rng.integers(0, N), rng.integers(0, 50)
        adcs[l, f, t:t + 8, c] += np.uint16(rng.integers(300, 3000))
    for l in range(L):
        wibeth.set_adcs(frames[l], adcs[l])
        wibeth.fake_timestamps(frames[l], ts)
        wibeth.fake_seq_ids(frames[l], batch_idx * N)
        wibeth.fake_geoid(frames[l], 1, l // 8, l % 8)
    return frames


def run_arm(arm, links, frames_n, batches, warmup, algorithm, threshold,
            threshold_on_collection, codec_threads, signal_rate,
            backend="pallas", pipelined=False):
    from fdreadoutlibs_jax.apps.apa_readout import APAReadoutApp
    from fdreadoutlibs_jax.formats import wibeth
    app = APAReadoutApp(
        n_links=links, algorithm=algorithm, threshold=threshold,
        threshold_on_collection=threshold_on_collection,
        codec_threads=codec_threads, backend=backend, pipelined=pipelined,
        raw_capacity_frames=max(4096, 4 * frames_n),
        **ARM_KWARGS[arm])
    # crc32, not hash(): str hash is salted per interpreter (PEP 456),
    # which would time different data every run.
    rng = np.random.default_rng(zlib.crc32(arm.encode()) % 2 ** 31)
    ts = 0x1000000
    for b in range(warmup + batches):
        frames = gen_batch(rng, links, frames_n, b, ts, signal_rate)
        if b == warmup:
            # pipelined: one warmup batch is still in flight; its timing
            # row lands after this clear (one stale sample, negligible
            # at the 20-batch default)
            app.batch_timings.clear()
        app.process_batch(frames)
        ts += frames_n * wibeth.EXPECTED_TICK_DIFFERENCE
    app.flush()
    info = app.latency_info(frames_per_batch=frames_n)
    if pipelined:
        info["pipelined"] = True
    info["total_hits"] = app.get_info()["total_hits"]
    return info


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arms", default="time2,packed")
    ap.add_argument("--links", type=int, default=40)
    ap.add_argument("--frames", default="8,32",
                    help="frames per batch (comma list); span = N x 32.768 us")
    ap.add_argument("--batches", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--algorithm", default="AbsRS")
    ap.add_argument("--threshold", type=int, default=120)
    ap.add_argument("--no-threshold-on-collection", action="store_true")
    ap.add_argument("--codec-threads", type=int, default=2)
    ap.add_argument("--signal-rate", type=float, default=0.02)
    ap.add_argument("--backend", default="pallas",
                    help="pallas (the GPU kernel) | scan (XLA lax.scan)")
    ap.add_argument("--pipelined", action="store_true",
                    help="measure the depth-2 pipelined app: quantifies "
                         "the ~one-batch-period latency the mode trades "
                         "for throughput")
    args = ap.parse_args(argv)

    import bench as bench_mod
    from fdreadoutlibs_jax.utils.runtime import enable_compile_cache
    out = {"device": bench_mod.device_info(), "links": args.links,
           "algorithm": args.algorithm,
           "threshold_on_collection": not args.no_threshold_on_collection,
           "arms": {}}
    enable_compile_cache()
    for arm in args.arms.split(","):
        arm = arm.strip()
        out["arms"][arm] = {}
        for frames_n in (int(f) for f in args.frames.split(",")):
            res = run_arm(arm, args.links, frames_n, args.batches,
                          args.warmup, args.algorithm, args.threshold,
                          not args.no_threshold_on_collection,
                          args.codec_threads, args.signal_rate,
                          backend=args.backend, pipelined=args.pipelined)
            out["arms"][arm][f"N{frames_n}"] = res
            print(f"# {arm} N={frames_n}: proc p50 "
                  f"{res['proc_ms_p50']} ms, p95 latency "
                  f"{res['latency_ms_p95']} ms -> min_latency_ticks "
                  f"{res['min_latency_ticks']}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
