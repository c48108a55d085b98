"""One process's part of a cell's run: set-up, the measured window of whole
runs through Simulation.run, the profiled run, and the check against the
plain reference.  The harness (benchmark/run.py) calls run_rank in its own
process for a one-process cell and in one process per card for a cell that
runs through the port's mesh path.

The window.  Every run is a new Simulation(cfg, out_path, device) of the
cell's configuration and traffic, handed the benchmark's initial markers
(SimState after Stepper.initial_field), stepping in CUDA-graph chunks
between snapshots and writing its own pic1dp.out.  Runs follow each other
until the first snapshot at or after the window's end, where the snapshot
callback ends the run.  All processes of a job end at the same snapshot: at
each snapshot they agree whether the window is over (one small all_reduce).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import os
import random
import resource
import sys
import time
import traceback
import weakref

import torch
import torch.distributed as dist

from benchmark import check, markers as markers_mod, reference, trace as trace_mod
from benchmark.outfile import OutFile

FORBIDDEN = ("jax", "jaxlib", "flax", "pic1dp_tpu")


class WindowClosed(Exception):
    """Raised by the snapshot callback at the first snapshot past the window."""


@dataclasses.dataclass
class Job:
    """What every process of a cell's run is told."""

    cell: str
    config: dict          # the configuration file
    traffic: dict         # the traffic file
    seed: int
    seconds: float
    traced: bool
    control: bool         # the program's own lower-precision path (bf16 weights)
    ranks: int
    device: str           # "cuda" or "cpu" (tests)
    t0_wall: float        # time.time() when the command started
    out_dir: str
    init_method: str | None = None


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the benchmark may not load."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def program_config(job: Job) -> dict:
    """The port's Config fields as this cell runs them."""
    prog = dict(job.config["program"])
    prog["output_interval"] = job.traffic["output_interval"]
    prog["verbosity"] = 0
    prog["nparticle_max"] = prog["nparticle_max"] * job.ranks
    if job.control:
        prog["bf16_weights"] = True
    return prog


def snapshots_per_run(prog: dict) -> int:
    return int(round(prog["time_max"] / prog["output_interval"])) + 1


def capture_plan(seed: int, run: int, nsnap: int) -> tuple[set, list]:
    """(snapshots to capture, pairs to check) of run `run`: in the first run
    its first interval (from the benchmark's markers) and its last, in every
    other one interval drawn from the seed."""
    if run == 0:
        return {1, nsnap - 2, nsnap - 1}, [(0, 1), (nsnap - 2, nsnap - 1)]
    j = random.Random(seed * 7_919 + run).randrange(0, nsnap - 1)
    return {j, j + 1} - {0}, [(j, j + 1)]


def _reducers(ranks: int):
    def reduce(*tensors):
        if ranks == 1:
            return tensors
        buf = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(buf)
        return tuple(part.view(t.shape) for part, t in
                     zip(buf.split([t.numel() for t in tensors]), tensors))

    def reduce_max(t):
        if ranks > 1:
            t = t.clone()
            dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return t

    return reduce, reduce_max


class _Peak:
    """The program's peak of device memory in the window, without the
    check's captures: the allocator's peak less the bytes the captures hold,
    read before each capture and at the window's end, the peak reset after
    each capture (between two readings the captures' bytes do not change)."""

    def __init__(self, device, cuda: bool):
        self.device, self.cuda, self.held, self.value = device, cuda, 0, 0

    def read(self) -> None:
        if self.cuda:
            self.value = max(self.value,
                             torch.cuda.max_memory_allocated(self.device) - self.held)

    def hold(self, tensors) -> None:
        self.held += sum(t.numel() * t.element_size() for t in tensors)
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)


class _Callback:
    """The snapshot callback of one run: the host clock of each snapshot,
    the captures the check needs, and the end of the window."""

    def __init__(self, sim, t_start, capture_at, stop, peak, span):
        self.sim, self.t_last, self.capture_at, self.stop = sim, t_start, capture_at, stop
        self.peak, self.span = peak, span
        self.intervals, self.captured, self.count = [], {}, 0

    def __call__(self, snap) -> None:
        with self.span("bench.callback"):
            t = time.perf_counter()
            self.intervals.append(t - self.t_last)
            self.t_last = t
            j = self.count
            self.count += 1
            if j in self.capture_at:
                st = self.sim.state
                self.peak.read()
                self.captured[j] = (st.x.clone(), st.v.clone(), st.w.clone())
                self.peak.hold(self.captured[j])
            if self.stop(t):
                raise WindowClosed


def _no_span(name: str):
    return contextlib.nullcontext()


def _span_method(obj, attr: str, name: str) -> None:
    """Wrap obj.attr in a record_function span, on this instance only.  The
    wrapper holds obj weakly: a strong reference would make a cycle, and a
    run's objects (its CUDA graphs among them) would then wait for the
    cyclic collector, which may destroy them while a later run captures a
    graph, and a graph destroyed during a capture invalidates the capture."""
    fn = getattr(type(obj), attr)
    ref = weakref.ref(obj)

    def call(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(ref(), *args, **kwargs)

    setattr(obj, attr, call)


def run_rank(job: Job, rank: int) -> dict:
    """This process's run of the cell: the numbers the harness reduces."""
    from pic1dp_tpu_torch.config import Config
    from pic1dp_tpu_torch.core.simulation import Simulation
    from pic1dp_tpu_torch.core.state import SimState

    cuda = job.device == "cuda"
    # the benchmark's spans, only where the profiler reads them
    span = torch.profiler.record_function if job.traced else _no_span
    if job.ranks > 1:
        if cuda:
            torch.cuda.set_device(rank)
        dist.init_process_group("nccl" if cuda else "gloo", init_method=job.init_method,
                                world_size=job.ranks, rank=rank)
    device = torch.device("cuda", rank) if cuda else torch.device("cpu")
    prog = program_config(job)
    cfg = Config.from_dict(prog)
    dtype = getattr(torch, cfg.dtype)
    physics = reference.module(job.config["reference"]).Physics(prog, device)
    n_block = job.config["program"]["nparticle_max"]
    mk = markers_mod.make(physics, dtype, n_block, prog["nparticle_max"], job.seed, rank,
                          device)
    p_state = mk.p.to(getattr(torch, cfg.p_dtype))
    reduce, reduce_max = _reducers(job.ranks)
    mesh = job.ranks if job.traffic.get("mesh", False) else None
    zeros_x = torch.zeros(cfg.nx, dtype=dtype, device=device)
    zeros_m = torch.zeros(cfg.nmode, dtype=dtype, device=device)

    def new_run(run_cfg, out_path):
        sim = Simulation(run_cfg, out_path=out_path, device=device, mesh=mesh)
        state = SimState(x=mk.x.clone(), v=mk.v.clone(), p=p_state.clone(), w=mk.w.clone(),
                         live=mk.live, rho=zeros_x.clone(), electric=zeros_x.clone(),
                         mode_re=zeros_m.clone(), mode_im=zeros_m.clone())
        sim.state = sim.stepper.initial_field(state)
        if job.traced:
            _span_method(sim, "output_snapshot", "bench.output_snapshot")
            _span_method(sim.stepper, "multi_step", "bench.multi_step")
        return sim

    def sync():
        if cuda:
            torch.cuda.synchronize(device)
        if job.ranks > 1:
            dist.barrier()

    # warm-up: a short run of the same shapes (kernel libraries, the eager
    # first chunk, a graph of the cell's chunk length, the snapshots' kernels)
    warm = Config.from_dict(dict(prog, time_max=3 * prog["output_interval"]))
    sim = new_run(warm, os.path.join(job.out_dir, f"warm{rank}"))
    sim.run()
    del sim
    gc.collect()
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    peak = _Peak(device, cuda)

    nsnap = snapshots_per_run(prog)
    profiled_run = 1 if job.traced else None
    t_w0 = time.perf_counter()
    setup_s = time.time() - job.t0_wall
    deadline = t_w0 + job.seconds
    flag = torch.zeros(1, dtype=torch.float64, device=device)

    def window_over(run_index):
        def stop(t):
            over = t >= deadline and (profiled_run is None or run_index > profiled_run)
            if job.ranks > 1:
                flag.fill_(1.0 if over else 0.0)
                dist.all_reduce(flag, op=dist.ReduceOp.MAX)
                over = bool(flag.item() > 0)
            return over
        return stop

    runs, steps, intervals, output_s, output_calls, failed = [], 0, [], 0.0, 0, 0
    run_walls, run_cpu = [], []
    host0 = host_counters(job.out_dir)
    # every run writes the one pic1dp.out of the process; once a run has
    # ended, the records the check needs are read and the file is removed,
    # so that its pages are dropped before they are written back to disk
    out_path = os.path.join(job.out_dir, "out")
    out_file = os.path.join(out_path, "pic1dp.out")
    prof = None
    t_end = t_w0
    i = 0
    while True:
        if i == profiled_run:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        capture_at, pairs = capture_plan(job.seed, i, nsnap)
        t_start = time.perf_counter()
        cpu_start = os.times()
        closed = run_failed = False
        with span("bench.run"):
            with span("bench.run_start"):
                sim = new_run(cfg, out_path)
            cb = _Callback(sim, t_start, capture_at, window_over(i), peak, span)
            try:
                sim.run(snapshot_callback=cb)
            except WindowClosed:
                closed = True
                if sim.writer is not None:
                    sim.writer.close()
            except Exception:
                # a run that fails counts as failed and ends the window; on a
                # mesh the other ranks would wait in a collective, so the
                # process ends and the harness stops them
                traceback.print_exc()
                if job.ranks > 1:
                    raise
                failed += 1
                closed = run_failed = True
        if i == profiled_run:
            prof.__exit__(None, None, None)
            traced_steps, traced_snaps = sim.itime, cb.count
        else:
            # the profiler slows the host's side of its run
            output_s += sim.timers.seconds("output")
            output_calls += cb.count
        steps += sim.itime
        intervals += cb.intervals
        t_end = cb.t_last
        run_walls.append(t_end - t_start)
        cpu_end = os.times()
        run_cpu.append(cpu_end.user + cpu_end.system - cpu_start.user - cpu_start.system)
        run_pairs = [(a, b) for a, b in pairs if b < cb.count]
        out = None
        if rank == 0 and os.path.exists(out_file):
            if not run_failed:
                out = check.harvest(OutFile(out_file), cb.count, run_pairs, first=i == 0)
            os.remove(out_file)
        runs.append(check.RunOutput(out=out, snapshots=cb.count, complete=not closed,
                                    captured=cb.captured, pairs=run_pairs))
        del sim, cb
        i += 1
        if closed:
            break
    window_s = t_end - t_w0
    sync()
    peak.read()
    host = {k: v - host0.get(k, 0) for k, v in host_counters(job.out_dir).items()
            if isinstance(v, (int, float))}
    host["out_fs"] = host_counters(job.out_dir)["out_fs"]
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    summary = None
    if prof is not None:
        path = os.path.join(job.out_dir, f"trace{rank}.json")
        prof.export_chrome_trace(path)
        del prof
        summary = trace_mod.load(path)
        os.remove(path)

    numbers = check.check_runs(physics, mk, runs, prog["output_interval"], prog["dt"], rank,
                               reduce, reduce_max) if failed == 0 else \
        dict.fromkeys(check.NUMBERS, math.inf)
    if job.ranks > 1:
        dist.barrier()
        dist.destroy_process_group()
    result = {
        "rank": rank, "setup_s": setup_s, "window_s": window_s, "steps": steps,
        "runs": len(runs), "run_walls": run_walls, "run_cpu": run_cpu, "host": host,
        "failed": failed, "intervals": intervals, "output_s": output_s,
        "output_calls": output_calls, "memory_peak_bytes": int(peak.value),
        "markers": prog["nparticle_max"] * len(prog["species"]),
        "numbers": numbers, "forbidden": forbidden_modules(),
        "device_kind": torch.cuda.get_device_name(device) if cuda else "cpu",
    }
    if summary is not None:
        result["trace"] = {"steps": traced_steps, "snapshots": traced_snaps,
                           **trace_to_json(summary)}
    return result


def host_counters(path: str) -> dict:
    """The host's counters of this process, read around the window: CPU
    seconds, context switches, collections of the oldest generation, bytes
    it sent to the storage layer and bytes whose writing a removal
    cancelled (/proc/self/io), and the file system that holds `path`."""
    usage = resource.getrusage(resource.RUSAGE_SELF)
    out = {"cpu_s": usage.ru_utime + usage.ru_stime, "ctx_invol": usage.ru_nivcsw,
           "ctx_vol": usage.ru_nvcsw, "gc_full": gc.get_stats()[2]["collections"]}
    try:
        with open("/proc/self/io") as fh:
            io = dict(line.split(": ") for line in fh.read().splitlines())
        out["write_bytes"] = int(io["write_bytes"])
        out["cancelled_write_bytes"] = int(io["cancelled_write_bytes"])
    except (OSError, KeyError, ValueError):
        pass
    out["out_fs"] = _fs_type(path)
    return out


def _fs_type(path: str) -> str:
    best, kind = "", "unknown"
    try:
        with open("/proc/self/mountinfo") as fh:
            for line in fh:
                left, _, right = line.partition(" - ")
                mount = left.split()[4]
                if os.path.abspath(path).startswith(mount) and len(mount) > len(best):
                    best, kind = mount, right.split()[0]
    except (OSError, IndexError):
        pass
    return kind


def trace_to_json(s: trace_mod.TraceSummary) -> dict:
    names = sorted({op.name for op in s.ops})
    index = {n: k for k, n in enumerate(names)}
    return {"window_s": s.window_s, "busy_s": s.busy_s, "idle_by_span": s.idle_by_span,
            "names": names,
            "ops": [[index[op.name], op.cat, op.start, op.dur] for op in s.ops]}


def trace_from_json(d: dict) -> trace_mod.TraceSummary:
    ops = [trace_mod.DeviceOp(d["names"][k], cat, start, dur) for k, cat, start, dur in d["ops"]]
    return trace_mod.TraceSummary(window_s=d["window_s"], busy_s=d["busy_s"], ops=ops,
                                  idle_by_span=d["idle_by_span"])
