"""Does a CPU run of the port repeat bit for bit inside a process that has
run the JAX package's mesh, as tier-1's pytest workers have?

Usage: python tests/_torch_repeat_probe.py [repeats]   (default 50)

Sets the process up as tests/conftest.py and tests/_torch_port.py do (JAX on
8 virtual CPU devices with x64, 2 torch threads), then `repeats` times: the
JAX part of tests/test_torch_parallel.py's job fixture (a ShardedStepper of
2 or 4 devices: initial field, ptcldist, 3 steps), then the port's
Simulation of that file's "simulation" config without a mesh; each
pic1dp.out is compared byte for byte with the same run made by a fresh
process at 1 torch thread.  Then the same run at 1, 2, 4 and 8 torch
threads, three times each.  Prints the count of runs that differ.
"""

import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

# the fresh process: the same config, from the same definition (imported,
# not run: this process runs no JAX)
SINGLE = """
import sys
sys.path[:0] = [sys.argv[2], sys.argv[2] + "/tests"]
import torch
import test_torch_parallel as tp
import pic1dp_tpu_torch.config as m
from pic1dp_tpu_torch import Simulation
torch.set_num_threads(1)
Simulation(tp._configs(m)["simulation"], out_path=sys.argv[1], device="cpu").run()
"""


def main() -> None:
    repeats = int(sys.argv[1]) if len(sys.argv) > 1 else 50
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import _torch_port  # noqa: F401  (2 torch threads, as the tests run)
    import torch
    import test_torch_parallel as tp

    import pic1dp_tpu.config as jcfg_mod
    import pic1dp_tpu_torch.config as tcfg_mod
    from pic1dp_tpu.core.loading import load_particles
    from pic1dp_tpu.parallel import mesh as jpmesh
    from pic1dp_tpu_torch import Simulation

    with tempfile.TemporaryDirectory() as work:
        subprocess.run([sys.executable, "-c", SINGLE, os.path.join(work, "fresh"), ROOT],
                       cwd=ROOT, check=True)
        with open(os.path.join(work, "fresh", "pic1dp.out"), "rb") as fh:
            fresh = fh.read()
        cfg = tp._configs(tcfg_mod)["simulation"]

        def differs(tag: str) -> bool:
            out = os.path.join(work, tag)
            Simulation(cfg, out_path=out, device="cpu").run()
            with open(os.path.join(out, "pic1dp.out"), "rb") as fh:
                return fh.read() != fresh

        jcfg = tp._configs(jcfg_mod)["landau"]
        bad = 0
        for i in range(repeats):
            world = (2, 4)[i % 2]
            mesh = jpmesh.make_mesh(world)
            st = jpmesh.ShardedStepper(jcfg, mesh)
            s0 = st.initial_field(jpmesh.shard_state(
                load_particles(jcfg, jax.random.PRNGKey(7)), mesh))
            jax.block_until_ready((st.ptcldist(s0), st.make_multi_step(3)(s0)))
            bad += differs(f"after_mesh_{i}")
        print(f"after a JAX mesh run, {torch.get_num_threads()} torch threads: {bad} of "
              f"{repeats} runs differ from the fresh process's pic1dp.out")
        bad = 0
        for rep in range(3):
            for nt in (1, 2, 4, 8):
                torch.set_num_threads(nt)
                bad += differs(f"threads_{nt}_{rep}")
        print(f"at 1, 2, 4 and 8 torch threads, 3 runs each: {bad} of 12 differ")


if __name__ == "__main__":
    main()
