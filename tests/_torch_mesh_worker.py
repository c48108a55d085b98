"""One rank of the gloo CPU job of tests/test_torch_parallel.py.

Usage: python tests/_torch_mesh_worker.py <rank> <world> <workdir>

Reads <workdir>/configs.json (the port's Configs by case) and
<workdir>/states.npz (the JAX-loaded states, `<case>.<field>`), runs
pic1dp_tpu_torch's ShardedStepper and Simulation on a mesh of <world> gloo
processes, and writes from rank 0 <workdir>/results.npz (global arrays:
each rank's part all-gathered) and from every rank <workdir>/rank<r>.json.
"""

import json
import os
import sys

# launched by script path, so sys.path[0] is tests/: add the repo root
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

torch.set_num_threads(1)

from pic1dp_tpu_torch import Simulation  # noqa: E402
from pic1dp_tpu_torch.config import Config  # noqa: E402
from pic1dp_tpu_torch.core.state import FIELDS, SimState  # noqa: E402
from pic1dp_tpu_torch.parallel import launch  # noqa: E402
from pic1dp_tpu_torch.parallel import mesh as pmesh  # noqa: E402

STEPS = 3
MERGE_THRESHOLD = 0.3


def gather(state: SimState, mesh) -> dict:
    """The global state's fields from every rank's part: the particle
    arrays all-gathered along the particle axis, the fields as they are."""
    specs, out = pmesh.state_specs(), {}
    for f in FIELDS:
        t = getattr(state, f)
        if specs[f]:
            parts = [torch.empty_like(t) for _ in range(mesh.size)]
            dist.all_gather(parts, t.contiguous(), group=mesh.group)
            t = torch.cat(parts, dim=1)
        out[f] = t
    return out


def main() -> None:
    rank, world, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    launch.initialize(f"file://{os.path.join(workdir, 'rendezvous')}", world, rank, "cpu")
    mesh = launch.global_mesh("cpu")
    assert (mesh.rank, mesh.size) == (rank, world)
    with open(os.path.join(workdir, "configs.json")) as fh:
        cfgs = {k: Config.from_json(v) for k, v in json.load(fh).items()}
    with np.load(os.path.join(workdir, "states.npz")) as npz:
        states = {case: SimState.from_numpy({f: npz[f"{case}.{f}"] for f in FIELDS}, "cpu")
                  for case in cfgs if f"{case}.x" in npz.files}
    out, info = {}, {"rank": rank}

    def keep(name, tree):
        for f, t in (tree.items() if isinstance(tree, dict) else tree._asdict().items()):
            out[f"{name}.{f}"] = t.detach().numpy().copy()

    def keep_state(name, state):
        keep(name, gather(state, mesh))

    # the stepper's entry points, each from the state the JAX package loaded
    cfg = cfgs["landau"]
    st = pmesh.ShardedStepper(cfg, mesh)
    s0 = st.initial_field(pmesh.shard_state(states["landau"], mesh))
    keep_state("initial", s0)
    keep("energies", st.energies(s0))
    keep("ptcldist", st.ptcldist(s0))
    keep("full_rho", {"rho": st.full_rho(s0)})
    pushed = st.push_pair(s0.clone())
    keep_state("push_pair", pushed)
    keep_state("collect", st.collect_and_solve(pushed))
    keep_state("merge", st.collect_and_solve(
        st.apply_optimizations(pushed, torch.Generator(), merge=MERGE_THRESHOLD)))
    s = s0.clone()
    for _ in range(STEPS):
        s = st.step(s)
    keep_state("steps", s)
    keep_state("multi_step", st.make_multi_step(STEPS)(s0.clone()))

    fullf = pmesh.ShardedStepper(cfgs["fullf"], mesh)
    keep("fullf_ptcldist", fullf.ptcldist(
        fullf.initial_field(pmesh.shard_state(states["fullf"], mesh))))

    # Simulation on the mesh: rank 0 alone writes pic1dp.out
    cfg = cfgs["simulation"]
    run_dir = os.path.join(workdir, "run")
    sim = Simulation(cfg, out_path=run_dir, checkpoint_path=run_dir, device="cpu", mesh=world)
    snaps = []
    sim.run(snapshot_callback=snaps.append)
    info["writer"] = sim.writer is not None
    info["snapshots"] = len(snaps)
    keep("sim_energy", {"field": torch.tensor([q["field_energy"] for q in snaps],
                                              dtype=torch.float64)})
    if rank == 0:   # the same run without a mesh, in a process like the ranks'
        Simulation(cfg, out_path=os.path.join(workdir, "single"), device="cpu").run()

    # a per-process checkpoint half way, resumed by a new Simulation on the
    # same mesh, ends where the uninterrupted run ends, bit for bit
    ck_cfg = cfgs["checkpoint"]
    ck_dir = os.path.join(workdir, "ck")
    os.makedirs(ck_dir, exist_ok=True)
    first = Simulation(ck_cfg, device="cpu", mesh=world, checkpoint_path=ck_dir)
    first.load()
    for _ in range(4):
        first.step_once()
    info["checkpoint"] = first.save_checkpoint()
    for _ in range(4):
        first.step_once()
    resumed = Simulation(ck_cfg, device="cpu", mesh=world)
    resumed.restore_checkpoint(os.path.join(ck_dir, "checkpoint.npz"))
    for _ in range(4):
        resumed.step_once()
    info["resume_bitwise"] = all(
        torch.equal(getattr(first.state, f), getattr(resumed.state, f)) for f in FIELDS)
    info["resume_itime"] = [first.itime, resumed.itime]

    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as fh:
        json.dump(info, fh)
    if rank == 0:
        np.savez(os.path.join(workdir, "results.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
