"""Interactive dispersion-relation viewer.

A copy of pic1dp_tpu/analysis/visual_dispersion.py over the port's
dispersion copy.  It needs matplotlib, imported when the viewer is built.

Python-3 re-design of reference tools/VisualDispersion.py: a two-panel
figure with omega(k) (Re on the left axis, Im = growth rate on a twin axis)
and the delta-f mode-structure contour for the currently selected k; click in
the omega(k) panel to re-solve at that k, radio buttons choose the species
whose structure is shown.

    python -m pic1dp_tpu_torch.analysis.visual_dispersion Z m T n v0 [...] -k K0 K1
"""

from __future__ import annotations

import argparse

import numpy as np


class VisualDispersion:
    def __init__(self, disp, k_values, omegas):
        import matplotlib.pyplot as plt
        from matplotlib.widgets import RadioButtons

        self.plt = plt
        self.disp = disp
        self.k_values = np.asarray(k_values, dtype=float)
        self.omegas = np.asarray(omegas, dtype=complex)
        self.ispecies: int | None = None

        self.fig, (self.ax_wk, self.ax_ms) = plt.subplots(
            1, 2, figsize=(12, 5))
        self.fig.subplots_adjust(left=0.2, wspace=0.35)
        self.ax_gamma = self.ax_wk.twinx()

        labels = ["all"] + [f"species {i}" for i in range(len(disp.species))]
        ax_rb = self.fig.add_axes([0.02, 0.4, 0.1, 0.2])
        self.rb = RadioButtons(ax_rb, labels)
        self.rb.on_clicked(self._on_species)
        self.fig.canvas.mpl_connect("button_press_event", self._on_click)
        self.update()

    def _on_species(self, label):
        self.ispecies = None if label == "all" else int(label.split()[-1])
        self.update()

    def _on_click(self, event):
        if event.inaxes in (self.ax_wk, self.ax_gamma) and event.xdata:
            self.disp.set_k(float(event.xdata))
            self.update()

    def update(self):
        ax, axg = self.ax_wk, self.ax_gamma
        ax.clear()
        axg.clear()
        ax.plot(self.k_values, self.omegas.real, "b-", label="Re $\\omega$")
        axg.plot(self.k_values, self.omegas.imag, "r--", label="$\\gamma$")
        ax.axvline(self.disp.k, color="k", lw=0.5)
        ax.set_xlabel("k")
        ax.set_ylabel("Re $\\omega$", color="b")
        axg.set_ylabel("$\\gamma$", color="r")
        ax.set_title("dispersion $\\omega(k)$ (click to choose k)")

        omega = self.disp.solve_omega()
        x, v, ms = self.disp.mode_structure(self.ispecies)
        self.ax_ms.clear()
        cs = self.ax_ms.contourf(x, v, ms, 24)
        self.ax_ms.set_xlabel("x")
        self.ax_ms.set_ylabel("v")
        self.ax_ms.set_title(
            f"$\\delta f$ structure, k = {self.disp.k:.4g}, "
            f"$\\omega$ = {omega:.4g}")
        self.fig.canvas.draw_idle()

    def show(self):
        self.plt.show()


def show_dispersion(disp, k_values, omegas):
    VisualDispersion(disp, k_values, omegas).show()


def main(argv=None) -> None:
    from pic1dp_tpu_torch.analysis.dispersion import Dispersion

    ap = argparse.ArgumentParser(description="Interactive dispersion viewer")
    ap.add_argument("params", nargs="+", type=float,
                    help="per species: charge Z, mass m, temperature T, "
                    "density n, flow v0")
    ap.add_argument("-k", nargs=2, type=float, default=[0.1, 1.0],
                    metavar=("<k start>", "<k stop>"))
    ap.add_argument("-sks", type=float, default=0.01, help="k scan step")
    args = ap.parse_args(argv)

    disp = Dispersion.from_params(args.params, args.k[0])
    ks = np.arange(args.k[0], args.k[1] + args.sks, args.sks)
    omegas = disp.scan_k(ks)
    disp.set_k(ks[len(ks) // 2])
    show_dispersion(disp, ks, omegas)


if __name__ == "__main__":
    main()
