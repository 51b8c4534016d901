#!/usr/bin/env python
"""Host relayout codec benchmark (pure CPU — no accelerator needed).

Measures the native feed codecs at steady state (reused aligned output
buffers — a fresh ~50 MB output page-faults every line, ~3x over steady
state; BENCH_NOTES round-3 host codec) and reports ms/window + GB/s of
packed input per configuration.  The numbers to compare against:

* an APA's raw WIBEth rate is 8.75 GB/s of packed 14-bit input;
* recorded on the round-3 box (one shared core, AVX-512): time2
  6.3 GB/s/core, words14 5.1 GB/s/core — the shared host core drifts
  ~2x between sessions, so re-measure rather than trust absolutes.

Usage:
  python scripts/bench_host_codec.py                 # defaults: APA shape
  python scripts/bench_host_codec.py --links 40 --ticks 8192 --seconds 3
  python scripts/bench_host_codec.py --threads 1 2 4 # mt scaling sweep
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def bench_one(fn, seconds):
    fn()                                   # warm (page-fault the buffers)
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < seconds:
        fn()
        n += 1
    return (time.perf_counter() - t0) / n


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--links", type=int, default=40)
    ap.add_argument("--ticks", type=int, default=8192)
    ap.add_argument("--seconds", type=float, default=3.0,
                    help="measurement time per codec per thread count")
    ap.add_argument("--threads", type=int, nargs="+", default=[1],
                    help="thread counts to sweep (needs >1 host cores to "
                         "show scaling)")
    ap.add_argument("--numpy", action="store_true",
                    help="also time the numpy fallback (slow)")
    args = ap.parse_args()

    from fdreadoutlibs_jax import native
    if native.load() is None:
        print(json.dumps({"error": "native library unavailable"}))
        return 1

    L, T = args.links, args.ticks
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2 ** 32, size=(L, T, 28), dtype=np.uint32)
    gb_in = words.nbytes / 1e9

    # steady-state reusable outputs (the production calling convention)
    buf_t2 = native.FeedBuffer()
    buf_w14 = native.FeedBuffer()

    results = {"links": L, "ticks": T, "input_GB": round(gb_in, 3),
               "apa_rate_GBps": 8.75, "codecs": {}}
    for nt in args.threads:
        dt = bench_one(lambda: native.relayout_time2(
            words, out=buf_t2.get(native.time2_feed_shape(L, T)),
            nthreads=nt), args.seconds)
        results["codecs"][f"time2_t{nt}"] = {
            "ms_per_window": round(dt * 1e3, 2),
            "GBps_input": round(gb_in / dt, 2)}
        dt = bench_one(lambda: native.relayout_words14(
            words, out=buf_w14.get(native.words14_feed_shape(L, T)),
            nthreads=nt), args.seconds)
        results["codecs"][f"words14_t{nt}"] = {
            "ms_per_window": round(dt * 1e3, 2),
            "GBps_input": round(gb_in / dt, 2)}

    if args.numpy:
        orig = native.load
        native.load = lambda: None
        try:
            dt = bench_one(lambda: native.relayout_time2(words),
                           max(args.seconds, 5.0))
            results["codecs"]["time2_numpy"] = {
                "ms_per_window": round(dt * 1e3, 2),
                "GBps_input": round(gb_in / dt, 2)}
        finally:
            native.load = orig

    # cross-check: every benchmarked configuration (both codecs, every
    # thread count) must produce identical bytes
    ref_t2 = native.relayout_time2(words)
    ref_w14 = native.relayout_words14(words)
    for nt in args.threads:
        assert np.array_equal(ref_t2,
                              native.relayout_time2(words, nthreads=nt))
        assert np.array_equal(ref_w14,
                              native.relayout_words14(words, nthreads=nt))
    results["parity"] = "ok"
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
