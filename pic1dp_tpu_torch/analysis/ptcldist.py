"""Dump a selected particle distribution to text files (optionally plot).

A copy of pic1dp_tpu/analysis/ptcldist.py over the port's OutputData;
tests/test_torch_analysis.py pins its files and output to the original's.
matplotlib is imported only for -vis, so -vis fails without it.

Python-3 re-design of reference tools/ptcldist.py: writes the chosen
(time index, species, distribution type) slice plus axis files so external
plotting tools can consume them; `-vis` shows a quick contour/line plot.

    python -m pic1dp_tpu_torch.analysis.ptcldist <datapath> [-xv 0|1] [-t IT]
        [-s IS] [-d 0|1|2] [-vis]

-xv 0 selects the (x, v) distribution, 1 the v-space distribution;
-d: 0 marker g, 1 total f, 2 perturbed delta f.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from pic1dp_tpu_torch.analysis.output_data import OutputData


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Dump a particle distribution to text files")
    ap.add_argument("data_path", metavar="data path", type=str)
    ap.add_argument("-xv", metavar="<coordinate type index>", type=int,
                    default=0, help="0: x-v plane; 1: v space")
    ap.add_argument("-t", metavar="<time index>", type=int, default=-1)
    ap.add_argument("-s", metavar="<species index>", type=int, default=0)
    ap.add_argument("-d", metavar="<distribution index>", type=int, default=2,
                    help="0 marker g, 1 total f, 2 perturbed delta f")
    ap.add_argument("-vis", action="store_true", help="show a quick plot")
    ap.add_argument("-o", "--outdir", metavar="<output directory>", type=str,
                    default=".", help="directory for the .dat files "
                    "(default: current directory, as the reference tool)")
    args = ap.parse_args(argv)

    data = OutputData(args.data_path, verbose=True)
    itime = args.t if args.t >= 0 else data.ntime + args.t

    def _out(name: str) -> str:
        return os.path.join(args.outdir, name)

    if args.xv == 0:
        dist = data.get_ptcldist_xv(itime, args.s, args.d)
        np.savetxt(_out("ptcldist_xv_x.dat"), data.x_pd)
        np.savetxt(_out("ptcldist_xv_v.dat"), data.v_pd)
        np.savetxt(_out("ptcldist_xv.dat"), dist)
        print("written: ptcldist_xv.dat, ptcldist_xv_x.dat, ptcldist_xv_v.dat")
    else:
        dist = data.get_ptcldist_v(itime, args.s, args.d)
        np.savetxt(_out("ptcldist_v_v.dat"), data.v_pd)
        np.savetxt(_out("ptcldist_v.dat"), dist)
        print("written: ptcldist_v.dat, ptcldist_v_v.dat")

    if args.vis:
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        if args.xv == 0:
            cs = ax.contourf(data.x_pd, data.v_pd, dist, 20)
            fig.colorbar(cs, ax=ax)
            ax.set_xlabel("x")
            ax.set_ylabel("v")
        else:
            ax.plot(data.v_pd, dist)
            ax.set_xlabel("v")
        ax.set_title(f"distribution {args.d}, species {args.s}, "
                     f"t = {data.get_scalar_t()[0, itime]:.3f}")
        plt.show()


if __name__ == "__main__":
    main()
