#!/usr/bin/env python
"""Plot trigger-primitive text output (equivalent of the reference's
scripts/plot_trigprim_output_data.py): scatter of channel vs time_start,
color = adc_integral.

Usage: python scripts/plot_trigprim_output_data.py TPS.txt [-o out.png]
(the TPS.txt format is what `fdreadoutlibs_jax.cli tpg-emulator
--save-trigprim` writes).
"""

import argparse
import csv
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("file")
    ap.add_argument("-o", "--output", default="trigprim_output.png")
    args = ap.parse_args(argv)

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib not available", file=sys.stderr)
        return 1

    chans, times, sums = [], [], []
    with open(args.file) as f:
        for row in csv.DictReader(f):
            chans.append(int(row["channel"]))
            times.append(int(row["time_start"]))
            sums.append(int(row["adc_integral"]))
    if not times:
        print("no TPs in file", file=sys.stderr)
        return 1
    t0 = min(times)
    rel = [(t - t0) for t in times]

    fig, ax = plt.subplots(figsize=(10, 6))
    sc = ax.scatter(rel, chans, c=sums, s=12, cmap="viridis")
    ax.set_xlabel(f"time_start - {t0} [ticks]")
    ax.set_ylabel("offline channel")
    ax.set_title(f"{len(times)} trigger primitives")
    fig.colorbar(sc, label="adc_integral")
    fig.tight_layout()
    fig.savefig(args.output, dpi=120)
    print(f"plot -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
