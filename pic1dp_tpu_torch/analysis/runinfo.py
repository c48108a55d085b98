"""Batch run analysis & comparison CLI.

A copy of pic1dp_tpu/analysis/runinfo.py over the port's OutputData;
tests/test_torch_analysis.py pins its output to the original's.

Python-3 re-design of reference tools/runinfo.py: per run it reports the
time-integrated field energy, the deviation from the first ("reference") run,
the fitted growth rate (gamma = energy-fit / 2, reference :116) over `-gr`
bounds, and the saturation peak over `-sr` bounds; `-g` adds group statistics
(mean/std over groups of runs, reference :137-230) and `-wg` exports them.

Usage:
    python -m pic1dp_tpu_torch.analysis.runinfo [-gr T1 T2] [-sr T1 T2]
        [-g N1 N2 ...] [-wg out.dat] [-gref GAMMA] path [path ...]
"""

from __future__ import annotations

import argparse

import numpy as np

from pic1dp_tpu_torch.analysis.output_data import OutputData


def intfdt(t: np.ndarray, f: np.ndarray) -> float:
    """Trapezoidal integral of f over t (reference tools/runinfo.py:30-37)."""
    return float(np.trapezoid(f, t) if hasattr(np, "trapezoid")
                 else np.trapz(f, t))


def _printvalref(desc: str, value: float, ref: float) -> None:
    if ref != 0.0:
        print(f"{desc} {value:.6e}  (ref {ref:.6e}, rel diff "
              f"{(value - ref) / ref * 100.0:+.3f}%)")
    else:
        print(f"{desc} {value:.6e}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Get various information from run(s)")
    ap.add_argument("-g", metavar="<# of runs in group>", nargs="+", type=int,
                    help="get information from a group of runs")
    ap.add_argument("-wg", metavar="<data file>", type=str,
                    help="write group results to a data file")
    ap.add_argument("-gr", metavar=("<lower bound>", "<upper bound>"),
                    nargs=2, type=float,
                    help="time boundaries for growth rate calculation")
    ap.add_argument("-gref", metavar="<reference growth rate>", nargs=1,
                    type=float, help="reference growth rate override")
    ap.add_argument("-sr", metavar=("<lower bound>", "<upper bound>"),
                    nargs=2, type=float,
                    help="time boundaries for saturation level calculation")
    ap.add_argument("datapaths", metavar="data path", nargs="*", type=str,
                    default=["./"], help="data path for each run")
    args = ap.parse_args(argv)

    groups = list(args.g) if args.g else None
    group_rows = []  # one row per completed group
    gamma_ref = intengdt_ref = peak_ref = None
    t_ref = eng_ref = None

    igroup, irun_group = 0, 0
    gammas, peaks, intengs = [], [], []

    for irun, path in enumerate(args.datapaths):
        tag = " (ref)" if irun == 0 else ""
        print(f"\nrun {irun}{tag}:  {path}")
        data = OutputData(path, verbose=True)
        scalar_t = data.get_scalar_t()
        t, eng = scalar_t[0], scalar_t[1]
        if irun == 0:
            t_ref, eng_ref = t, eng

        intengdt = intfdt(t, eng)
        if irun == 0:
            intengdt_ref = intengdt
        _printvalref("int energy dt =", intengdt, intengdt_ref)
        if len(t) == len(t_ref):
            diff = intfdt(t_ref, np.abs(eng - eng_ref))
            print(f"int |energy - energy_ref| dt = {diff:.6e} "
                  f"({diff / intengdt_ref * 100.0:.3f}% of ref integral)")

        gamma = peak = None
        if args.gr is not None:
            gamma = data.growthrate_energy_fit(*args.gr) / 2.0
            if irun == 0:
                gamma_ref = args.gref[0] if args.gref else gamma
            _printvalref("growth rate =", gamma, gamma_ref)
        if args.sr is not None:
            peak = data.findpeak_energy(*args.sr)
            if irun == 0:
                peak_ref = peak
            _printvalref("saturation level (energy) =", peak[1], peak_ref[1])
            _printvalref("saturation time =", peak[0], peak_ref[0])

        if groups:
            gammas.append(gamma)
            peaks.append(peak)
            intengs.append(intengdt)
            irun_group += 1
            if irun_group == groups[min(igroup, len(groups) - 1)]:
                row = {"group": igroup, "nruns": irun_group}
                print(f"\n== group {igroup} statistics over {irun_group} runs ==")
                row["intengdt_mean"] = float(np.mean(intengs))
                row["intengdt_std"] = float(np.std(intengs))
                print(f"int energy dt: mean {row['intengdt_mean']:.6e} "
                      f"std {row['intengdt_std']:.3e}")
                if args.gr is not None:
                    row["gamma_mean"] = float(np.mean(gammas))
                    row["gamma_std"] = float(np.std(gammas))
                    print(f"growth rate:   mean {row['gamma_mean']:.6e} "
                          f"std {row['gamma_std']:.3e}")
                if args.sr is not None:
                    lv = [p[1] for p in peaks]
                    tm = [p[0] for p in peaks]
                    row["sat_mean"] = float(np.mean(lv))
                    row["sat_std"] = float(np.std(lv))
                    row["sat_t_mean"] = float(np.mean(tm))
                    row["sat_t_std"] = float(np.std(tm))
                    print(f"saturation:    mean {row['sat_mean']:.6e} "
                          f"std {row['sat_std']:.3e}")
                    print(f"sat. time:     mean {row['sat_t_mean']:.6e} "
                          f"std {row['sat_t_std']:.3e}")
                group_rows.append(row)
                igroup += 1
                irun_group = 0
                gammas, peaks, intengs = [], [], []

    if args.wg and group_rows:
        keys = sorted({k for r in group_rows for k in r})
        with open(args.wg, "w") as fh:
            fh.write("# " + " ".join(keys) + "\n")
            for r in group_rows:
                fh.write(" ".join(str(r.get(k, "nan")) for k in keys) + "\n")
        print(f"\ngroup results written to {args.wg}")


if __name__ == "__main__":
    main()
