"""Interactive visualization app for pic1dp output.

A copy of pic1dp_tpu/analysis/visual.py over the port's OutputData.  It
needs matplotlib, imported when the app is built.

Python-3 / modern-matplotlib re-design of reference tools/visual.py: a
multi-panel figure showing

  1. a chosen scalar vs time (energies),
  2. a chosen E-mode Re/Im vs time,
  3. the mode amplitude on a log scale over a drag-selected time window,
     with the fitted growth rate printed and the gamma-normalized mode
     overlaid (reference :309-341),
  4. E(x) and rho(x) at the selected time,
  5. the selected species' distribution f(x, v) contour,
  6. the v-space distribution f(v),

with radio choosers for scalar / mode / distribution type (g, f, delta f) /
species, click-to-set time in any time panel, click-drag to set the fit
window, and a play/pause animation button.

    python -m pic1dp_tpu_torch.analysis.visual <datapath>
"""

from __future__ import annotations

import argparse

import numpy as np

from pic1dp_tpu_torch.analysis.output_data import OutputData

_DIST_LABELS = ("marker g", "total f", "pertb $\\delta f$")


class VisualApp:
    def __init__(self, datapath: str):
        import matplotlib.pyplot as plt
        from matplotlib.widgets import Button, RadioButtons

        self.plt = plt
        self.data = OutputData(datapath, verbose=True)
        d = self.data
        self.scalar_t = d.get_scalar_t()
        self.mode_t = d.get_mode_t()
        self.itime = 0
        self.iscalar = 1          # field energy
        self.imode = 0
        self.idist = 2            # delta f
        self.ispecies = 0
        self.twindow = (float(self.scalar_t[0, 0]),
                        float(self.scalar_t[0, -1]))
        self._press_t = None
        self._playing = False

        self.fig = plt.figure(figsize=(15, 9))
        self.fig.canvas.manager.set_window_title("pic1dp_tpu_torch visual")
        grid = self.fig.add_gridspec(3, 3, left=0.18, hspace=0.45, wspace=0.3)
        self.ax_scalar = self.fig.add_subplot(grid[0, 0])
        self.ax_mode = self.fig.add_subplot(grid[0, 1])
        self.ax_modeamp = self.fig.add_subplot(grid[0, 2])
        self.ax_field = self.fig.add_subplot(grid[1, 0])
        self.ax_xv = self.fig.add_subplot(grid[1, 1:])
        self.ax_v = self.fig.add_subplot(grid[2, 1:])
        self.ax_info = self.fig.add_subplot(grid[2, 0])
        self.ax_info.axis("off")

        ns = d.nspecies
        scalar_labels = ["field energy"]
        for s in range(ns):
            scalar_labels += [f"s{s} marker", f"s{s} total", f"s{s} pertb"]
        if ns > 1:
            scalar_labels += ["sum marker", "sum total", "sum pertb"]
        self._scalar_rows = [1] + [2 + i for i in range(3 * ns)] + \
            ([2 + 3 * ns + i for i in range(3)] if ns > 1 else [])

        def radio(rect, labels, cb, active=0):
            ax = self.fig.add_axes(rect)
            rb = RadioButtons(ax, labels, active=active)
            rb.on_clicked(cb)
            return rb

        self.rb_scalar = radio([0.01, 0.72, 0.13, 0.2], scalar_labels,
                               self._on_scalar)
        self.rb_mode = radio([0.01, 0.55, 0.13, 0.12],
                             [f"mode {m}" for m in d.mode], self._on_mode)
        self.rb_dist = radio([0.01, 0.38, 0.13, 0.12], _DIST_LABELS,
                             self._on_dist, active=self.idist)
        self.rb_species = radio(
            [0.01, 0.2, 0.13, 0.12],
            [f"species {s}" for s in range(ns)] + (["all"] if ns > 1 else []),
            self._on_species)
        ax_play = self.fig.add_axes([0.01, 0.08, 0.13, 0.06])
        self.btn_play = Button(ax_play, "play / pause")
        self.btn_play.on_clicked(self._on_play)

        self.fig.canvas.mpl_connect("button_press_event", self._on_press)
        self.fig.canvas.mpl_connect("button_release_event", self._on_release)
        self.timer = self.fig.canvas.new_timer(interval=200)
        self.timer.add_callback(self._advance)

        self.update_all()

    # ---- widget callbacks ----

    def _on_scalar(self, label):
        self.iscalar = self._scalar_rows[
            [t.get_text() for t in self.rb_scalar.labels].index(label)]
        self.update_all()

    def _on_mode(self, label):
        self.imode = [t.get_text() for t in self.rb_mode.labels].index(label)
        self.update_all()

    def _on_dist(self, label):
        self.idist = _DIST_LABELS.index(label)
        self.update_all()

    def _on_species(self, label):
        labels = [t.get_text() for t in self.rb_species.labels]
        self.ispecies = labels.index(label)
        self.update_all()

    def _on_play(self, _event):
        self._playing = not self._playing
        (self.timer.start if self._playing else self.timer.stop)()

    def _advance(self):
        self.itime = (self.itime + 1) % self.data.ntime
        self.update_all()

    def _time_axes(self):
        return (self.ax_scalar, self.ax_mode, self.ax_modeamp)

    def _on_press(self, event):
        if event.inaxes in self._time_axes() and event.xdata is not None:
            self._press_t = float(event.xdata)

    def _on_release(self, event):
        if self._press_t is None or event.xdata is None \
                or event.inaxes not in self._time_axes():
            self._press_t = None
            return
        t0, t1 = self._press_t, float(event.xdata)
        self._press_t = None
        times = self.scalar_t[0]
        if abs(t1 - t0) < 1e-3 * (times[-1] - times[0] + 1e-300):
            self.itime = int(np.clip(np.searchsorted(times, t0),
                                     0, self.data.ntime - 1))
        else:
            self.twindow = (min(t0, t1), max(t0, t1))
        self.update_all()

    # ---- panels ----

    def update_all(self):
        d = self.data
        t = self.scalar_t[0]
        tc = t[self.itime]

        ax = self.ax_scalar
        ax.clear()
        ax.plot(t, self.scalar_t[self.iscalar])
        ax.axvline(tc, color="k", lw=0.5)
        ax.set_title("scalar vs t (click: set time)")
        ax.set_xlabel("t")

        ax = self.ax_mode
        ax.clear()
        nm = d.nmode
        ax.plot(t, self.mode_t[self.imode], label="Re")
        ax.plot(t, self.mode_t[nm + self.imode], label="Im")
        ax.axvline(tc, color="k", lw=0.5)
        ax.legend(fontsize=8)
        ax.set_title(f"E mode {d.mode[self.imode]} vs t")

        ax = self.ax_modeamp
        ax.clear()
        amp = np.hypot(self.mode_t[self.imode], self.mode_t[nm + self.imode])
        w0, w1 = self.twindow
        sel = (t >= w0) & (t <= w1) & (amp > 0)
        gamma = np.nan
        if np.count_nonzero(sel) >= 2:
            gamma = np.polyfit(t[sel], np.log(amp[sel]), 1)[0]
            norm = amp / np.exp(gamma * t)
            ax.semilogy(t, norm / np.max(norm[sel]), color="0.7",
                        label="$|E_k| e^{-\\gamma t}$ (norm.)")
        with np.errstate(divide="ignore"):
            ax.semilogy(t, amp, label="$|E_k|$")
        ax.axvspan(w0, w1, color="tab:orange", alpha=0.15)
        ax.axvline(tc, color="k", lw=0.5)
        ax.set_title(f"amplitude, $\\gamma$ = {gamma:.4g} (drag: fit window)")
        ax.legend(fontsize=8)

        ax = self.ax_field
        ax.clear()
        field = d.get_field_x(self.itime)
        ax.plot(d.x, field[0], label="E")
        ax.plot(d.x, field[1], label="$\\rho$")
        ax.legend(fontsize=8)
        ax.set_title(f"fields, t = {tc:.3f}")
        ax.set_xlabel("x")

        ax = self.ax_xv
        ax.clear()
        dist = d.get_ptcldist_xv(self.itime, self.ispecies, self.idist)
        cs = ax.contourf(d.x_pd, d.v_pd, dist, 24)
        ax.set_title(f"{_DIST_LABELS[self.idist]}(x, v)")
        ax.set_xlabel("x")
        ax.set_ylabel("v")

        ax = self.ax_v
        ax.clear()
        ax.plot(d.v_pd, d.get_ptcldist_v(self.itime, self.ispecies, self.idist))
        ax.set_title(f"{_DIST_LABELS[self.idist]}(v)")
        ax.set_xlabel("v")

        self.ax_info.clear()
        self.ax_info.axis("off")
        self.ax_info.text(
            0.0, 0.9,
            f"t = {tc:.3f}  (snapshot {self.itime + 1}/{d.ntime})\n"
            f"fit window: [{w0:.2f}, {w1:.2f}]\n"
            f"$\\gamma_{{|E_k|}}$ = {gamma:.5g}\n"
            f"nx = {d.nx}, modes = {list(d.mode)}\n"
            f"lx = {d.lx:.4f}, v_max = {d.v_max:.2f}",
            va="top", family="monospace", fontsize=9,
            transform=self.ax_info.transAxes)

        self.fig.canvas.draw_idle()

    def show(self):
        self.plt.show()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="pic1dp interactive visualization")
    ap.add_argument("data_path", metavar="data path", type=str, nargs="?",
                    default="./")
    args = ap.parse_args(argv)
    VisualApp(args.data_path).show()


if __name__ == "__main__":
    main()
