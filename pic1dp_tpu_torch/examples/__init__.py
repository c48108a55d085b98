"""The JAX package's four example scripts (examples/*.py), on the port.

Each script builds the Config of its original, runs pic1dp_tpu_torch's
Simulation on the device it is given (`--device`, default cuda), fits the
growth or damping rate from the snapshots as its original does, and checks
it against the port's copy of the dispersion relation with the original's
tolerance and exit code.  Each exposes `config`, `theory` and its fit, so
that a caller that runs the Simulation itself (chip_smoke.py) fits its
snapshots the same way.

    python -m pic1dp_tpu_torch.examples.landau_damping [--device cpu]
"""

from __future__ import annotations

import argparse

import torch


def parser(description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    return ap


def device_of(args) -> torch.device:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"device {args.device!r} requested but torch sees no CUDA "
                         "device; pass --device cpu to run on the CPU")
    return device


def run_dtype(device: torch.device | str) -> str:
    """float64 on the CPU, float32 on an accelerator, as the originals pick
    by the JAX platform."""
    return "float64" if torch.device(device).type == "cpu" else "float32"


def simulate(cfg, device) -> list[dict]:
    """Simulation.run of cfg on device, no output file; the snapshots."""
    from pic1dp_tpu_torch.core.simulation import Simulation

    snaps: list[dict] = []
    Simulation(cfg, device=device).run(snapshot_callback=snaps.append)
    return snaps
