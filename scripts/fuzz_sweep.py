#!/usr/bin/env python
"""Extended randomized-config semantic fuzz sweep (standalone).

The in-suite fuzz (tests/test_fuzz_semantics.py) pins 10 seeds so CI
stays fast; this script sweeps an arbitrary seed range for long
background validation runs.  Each case draws the config space the same
way (algorithm, thresholds, accumulator limit, scale factor, mixed
per-channel memory factors, peak tracking, uneven batch splits) and
asserts the XLA-scan backend matches the numpy oracle bit-exactly —
hits AND carried state.  Every --pallas-every'th case also runs the
Pallas backend in interpret mode (slow; keep sparse).

Usage:  python scripts/fuzz_sweep.py --n 200 [--start 20000]
Output: one JSON line per failure (none expected) + a summary line.
Exit 1 on any mismatch; the failing seed reproduces via the same case
generator in tests/test_fuzz_semantics.py.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100)
    ap.add_argument("--start", type=int, default=20_000,
                    help="first seed (the test suite owns 101..1010)")
    ap.add_argument("--pallas-every", type=int, default=25,
                    help="run the Pallas interpret backend on every k-th "
                         "case (0 = never)")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")

    from fdreadoutlibs_jax.ops.chanstate import init_chanstate, seed_chanstate
    from fdreadoutlibs_jax.ops.hits import concat_hits, decode_dense
    from fdreadoutlibs_jax.ops.reference import run_reference
    from fdreadoutlibs_jax.ops.scan import process_window_scan, state_to_jnp
    from test_fuzz_semantics import C, _case

    t0 = time.time()
    failures = 0
    pallas_runs = 0
    for i in range(args.n):
        if i and i % 20 == 0:
            # every case traces fresh shapes (random batch splits); the
            # accumulated XLA-CPU executables killed a 400-case run with
            # LLVM "Cannot allocate memory" — drop the caches periodically
            jax.clear_caches()
        seed = args.start + i
        cfg, rmf, adcs, bounds = _case(seed)
        try:
            h_ref, st_ref = run_reference(adcs, cfg, rs_memory_factor=rmf)
            state = state_to_jnp(seed_chanstate(init_chanstate(C), adcs[0],
                                                rmf))
            parts = []
            for a, b in zip(bounds[:-1], bounds[1:]):
                closed, records, state = process_window_scan(
                    adcs[a:b], state, cfg)
                parts.append(decode_dense(closed, records, tick_offset=a))
            np.testing.assert_array_equal(concat_hits(parts), h_ref)
            for k, v in st_ref.items():
                if k in ("fir_prev", "fir_phase"):
                    continue
                np.testing.assert_array_equal(np.asarray(state[k]), v,
                                              err_msg=k)
            if args.pallas_every and i % args.pallas_every == 0:
                from test_tpg_pallas import run_pallas
                h_p, _, d = run_pallas(adcs, cfg, rs_memory_factor=rmf,
                                       tc=32, k_slots=8)
                assert d == 0
                np.testing.assert_array_equal(h_p, h_ref)
                pallas_runs += 1
        except Exception as e:  # noqa: BLE001 — report and continue
            failures += 1
            print(json.dumps({"seed": seed, "alg": str(cfg.algorithm),
                              "error": str(e)[:400]}), flush=True)
    print(json.dumps({"swept": args.n, "start": args.start,
                      "failures": failures, "pallas_cases": pallas_runs,
                      "seconds": round(time.time() - t0, 1)}))
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
