"""Command-line simulation driver (port of pic1dp_tpu/run.py).

A run is a preset name or a JSON config (Config.to_json / from_json) plus
overrides, on an explicit device:

    python -m pic1dp_tpu_torch.run                           # default bump-on-tail
    python -m pic1dp_tpu_torch.run -s time_max=100 -o run1   # overrides, output dir
    python -m pic1dp_tpu_torch.run -s bf16_weights=True      # p and w1 stored as bf16
    python -m pic1dp_tpu_torch.run -p landau --device cpu    # preset, on the CPU
    python -m pic1dp_tpu_torch.run --write-config cfg.json   # dump config and exit
    python -m pic1dp_tpu_torch.run --checkpoint-interval 50  # checkpoint.npz every 50
    python -m pic1dp_tpu_torch.run --resume run1/checkpoint.npz -s time_max=200
    python -m pic1dp_tpu_torch.run -s shape=1                # the EXPLICIT grid path
    python -m pic1dp_tpu_torch.run -s "rng={'backend': 'multirand'}" --emulate-ranks 4

A schedule of particle optimization (merge/remove/split) is part of the
config: write one with --write-config, fill in `optimization`, run it with
-c.  Of the JAX package's command line, --phase-table, --profile, --mesh and
--distributed are not ported.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import sys

from pic1dp_tpu_torch import config as config_mod

_PRESETS = {
    "bump_on_tail": config_mod.bump_on_tail_default,
    "landau": config_mod.landau_damping,
    "two_stream": config_mod.two_stream,
}


def _apply_overrides(cfg, overrides: list[str]):
    fields = {f.name for f in dataclasses.fields(cfg)}
    kv = {}
    for item in overrides:
        key, _, raw = item.partition("=")
        if key not in fields:
            raise SystemExit(f"unknown config field {key!r}; valid: "
                             f"{', '.join(sorted(fields))}")
        try:
            kv[key] = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            kv[key] = raw  # plain string (e.g. equilibrium name)
    return config_mod.Config.from_dict({**cfg.to_dict(), **kv})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run a pic1dp_tpu_torch simulation")
    ap.add_argument("-p", "--preset", choices=sorted(_PRESETS),
                    default="bump_on_tail")
    ap.add_argument("-c", "--config", metavar="<json file>",
                    help="load full config from JSON (overrides preset)")
    ap.add_argument("-s", "--set", metavar="field=value", action="append",
                    default=[], help="override a config field")
    ap.add_argument("-o", "--out", metavar="<dir>", default=".",
                    help="output directory for pic1dp.out (default .)")
    ap.add_argument("--no-output", action="store_true",
                    help="run without writing the science-data stream")
    ap.add_argument("--write-config", metavar="<json file>",
                    help="write the resolved config and exit")
    ap.add_argument("--checkpoint-interval", type=float, default=None,
                    metavar="<sim time>",
                    help="write a checkpoint every so much simulation time")
    ap.add_argument("--resume", metavar="<checkpoint.npz>",
                    help="resume from a checkpoint written by a previous run "
                    "(of this package or of pic1dp_tpu)")
    ap.add_argument("--emulate-ranks", type=int, default=1, metavar="<npe>",
                    help="with -s rng=\"{'backend': 'multirand'}\": load "
                    "markers in the draw order of an npe-rank reference run")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)

    if args.config:
        with open(args.config) as fh:
            cfg = config_mod.Config.from_json(fh.read())
    else:
        cfg = _PRESETS[args.preset]()
    if args.set:
        cfg = _apply_overrides(cfg, args.set)
    cfg = cfg.validate()

    if args.write_config:
        with open(args.write_config, "w") as fh:
            fh.write(cfg.to_json())
        print(f"config written to {args.write_config}")
        return 0

    import torch

    from pic1dp_tpu_torch.core.simulation import Simulation

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"device {args.device!r} requested but torch sees no "
                         "CUDA device; pass --device cpu to run on the CPU")
    sim = Simulation(cfg, out_path=None if args.no_output else args.out,
                     checkpoint_interval=args.checkpoint_interval,
                     checkpoint_path=None if args.no_output else args.out,
                     emulate_ranks=args.emulate_ranks, device=device)
    if args.resume:
        sim.restore_checkpoint(args.resume)
    sim.run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
