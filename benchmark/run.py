"""Run one cell of BENCHMARK.json once, or check the file.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>
    python -m benchmark.run --check
    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace 0 --control

The last line of standard output is one JSON object: `correct`, `attempted`
(runs started in the window), `failed` (runs that raised), `metrics` (the
cell's end-to-end metrics, or with --trace 1 its per-layer metrics),
`device`, with --trace 1 `breakdown`, and last `compared`: each number the
check compared, with its limit.  The same numbers are the last lines of
standard error.  No result is printed, and the exit code is not 0, when the
cell needs more cards than there are, when a process of the run fails, or
when JAX or the JAX package was loaded.

--control runs the program's own lower-precision path (bfloat16 marker
weights) in the timed program's place: its `correct` has to come out false.

A cell whose traffic goes through the mesh path runs one process a card,
started here (`--rank`, `--job` are theirs); rank 0 holds pic1dp.out.
"""

from __future__ import annotations

import time

T0_WALL = time.time()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import socket  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

from benchmark import spec  # noqa: E402
from benchmark.yardstick import PEAKS, percentile  # noqa: E402


# the ranks of a mesh cell are stopped past this: a run's first call in a
# checkout, which builds the kernels, has 1200 s
RANKS_SECONDS = 1150

# the program's kernel libraries that a run loads (its build cache,
# pic1dp_tpu_torch/_build, lies inside the checkout)
KERNEL_LIBRARIES = ["substep_kernels", "hist_kernels"]


@dataclasses.dataclass
class Reading:
    """What the metric readers read: the program's configuration as run and
    every process's result (rank 0 first) with its reduced trace."""

    prog: dict
    results: list
    traces: list | None

    @property
    def local_markers(self) -> int:
        """The markers one card holds."""
        return self.results[0]["markers"] // len(self.results)


def make_job(bench: dict, cell_name: str, seed: int, seconds: float, traced: bool,
             control: bool, device: str, out_dir: str, config: dict | None = None):
    from benchmark.session import Job

    wl = spec.workload(bench, cell_name)
    traffic = spec.traffic(wl["traffic"])
    if not traffic.get("mesh", False) and wl["chips"] != 1:
        raise ValueError(f"{cell_name}: a cell on {wl['chips']} cards needs mesh traffic")
    return Job(cell=cell_name, config=config or spec.config(bench, wl["config"]),
               traffic=traffic, seed=seed, seconds=seconds, traced=traced, control=control,
               ranks=wl["chips"], device=device, t0_wall=T0_WALL, out_dir=out_dir)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(job) -> list[dict]:
    """Every process's result, rank 0 first: in this process for one rank,
    else one process a card, each waited for."""
    from benchmark.session import run_rank

    if job.ranks == 1:
        return [run_rank(job, 0)]
    job.init_method = f"tcp://localhost:{_free_port()}"
    path = os.path.join(job.out_dir, "job.json")
    with open(path, "w") as fh:
        json.dump(dataclasses.asdict(job), fh)
    procs = [subprocess.Popen([sys.executable, "-m", "benchmark.run", "--rank", str(r),
                               "--job", path], cwd=spec.ROOT, stdout=sys.stderr)
             for r in range(job.ranks)]
    deadline = time.monotonic() + RANKS_SECONDS
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                print(f"the ranks ran past {RANKS_SECONDS} s; stopped", file=sys.stderr)
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        raise RuntimeError(f"rank exit codes {codes}")
    results = []
    for r in range(job.ranks):
        with open(os.path.join(job.out_dir, f"rank{r}.json")) as fh:
            results.append(json.load(fh))
    return results


def result_line(bench: dict, job, results: list[dict], limits: dict | None = None) -> dict:
    """The cell's result from every process's, its numbers judged by
    `limits` (by default its cell file's)."""
    from benchmark import check
    from benchmark.session import program_config, trace_from_json

    traced = job.traced
    traces = [trace_from_json(r["trace"]) for r in results] if traced else None
    reading = Reading(prog=program_config(job), results=results, traces=traces)
    metrics = {}
    for m in spec.cell_metrics(bench, job.cell, traced):
        value = spec.metric_reader(m["name"])(reading)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limits = limits or spec.cell(job.cell)["limits"]
    numbers = results[0]["numbers"]
    failed = sum(r["failed"] for r in results)
    ok, rows = check.judge(numbers, limits)
    device = {"platform": "gpu" if job.device == "cuda" else job.device,
              "kind": results[0]["device_kind"], "count": job.ranks,
              "memory_peak_bytes": max(r["memory_peak_bytes"] for r in results)}
    line = {"correct": bool(ok and failed == 0), "attempted": results[0]["runs"],
            "failed": failed, "metrics": metrics, "device": device}
    if traced:
        device["busy_s"] = sum(t.busy_s for t in traces) / len(traces)
        device["window_s"] = sum(t.window_s for t in traces) / len(traces)
        line["breakdown"] = {"device_ops": traces[0].device_ops(),
                             "idle_gaps": traces[0].idle_gaps()}
    line["compared"] = {name: [number, limit] for name, number, limit in rows}
    return line


def load_kernels() -> tuple[float, list[str]]:
    """Build (on a checkout's first run) and load the program's kernel
    libraries, before the ranks start: (seconds, the libraries built)."""
    from pic1dp_tpu_torch.utils import nvcc

    t0 = time.perf_counter()
    libs = nvcc.load_all(KERNEL_LIBRARIES)
    return time.perf_counter() - t0, [n for n, lib in zip(KERNEL_LIBRARIES, libs)
                                      if lib.build_seconds > 0]


def _card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        out = f"nvidia-smi: {exc}"
    return out.replace("\n", " | ")


def _run_child(rank: int, job_path: str) -> int:
    from benchmark.session import Job, run_rank

    with open(job_path) as fh:
        job = Job(**json.load(fh))
    try:
        result = run_rank(job, rank)
    except BaseException:
        # end at once: NCCL's teardown after a failed collective can wait
        # for many minutes, and the harness stops the other ranks
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    path = os.path.join(job.out_dir, f"rank{rank}.json")
    with open(path + ".tmp", "w") as fh:
        json.dump(result, fh)
    os.replace(path + ".tmp", path)
    return 0


def _check_file() -> int:
    raw = spec.BENCHMARK_JSON.read_bytes()
    problems = spec.problems(json.loads(raw), len(raw))
    for p in problems:
        print(p, file=sys.stderr)
    print(json.dumps({"ok": not problems, "problems": len(problems)}))
    return 1 if problems else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--check", action="store_true", help="check BENCHMARK.json and exit")
    ap.add_argument("--control", action="store_true",
                    help="run the program's bfloat16-weight path in its place")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--job", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.check:
        return _check_file()
    if args.rank is not None:
        return _run_child(args.rank, args.job)
    if not args.workload:
        ap.error("--workload is required")
    bench = spec.load()
    wl = spec.workload(bench, args.workload)
    seconds = bench["run_seconds"] if args.seconds is None else args.seconds

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # set-up's share that compiles: recorded on its own line; setup_s holds it
    kernels_s, built = load_kernels()
    out_dir = tempfile.mkdtemp(prefix="pic1dp-bench-")
    try:
        job = make_job(bench, args.workload, args.seed, seconds, bool(args.trace),
                       args.control, "cuda", out_dir)
        results = run_ranks(job)
        line = result_line(bench, job, results)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    from benchmark.session import forbidden_modules

    found = sorted(set(sum((r["forbidden"] for r in results), [])) | set(forbidden_modules()))
    if found:
        print(f"modules the benchmark may not load were loaded: {found}", file=sys.stderr)
        return 3
    print(f"card: {_card_line()}; peaks: {json.dumps(PEAKS)}", file=sys.stderr)
    print(f"kernel libraries: {kernels_s:.3f} s of setup_s, built by nvcc: "
          f"{', '.join(built) or 'none (cached)'}", file=sys.stderr)
    r0 = results[0]
    print(f"host in the window: run CPU s {[round(c, 4) for c in r0['run_cpu']]}; "
          f"{json.dumps(r0['host'])}", file=sys.stderr)
    q1, med, q3 = statistics.quantiles(r0["intervals"], n=4)
    print(f"runs {line['attempted']}, steps {r0['steps']}, window {r0['window_s']:.3f} s, "
          f"setup {r0['setup_s']:.3f} s; run walls {[round(w, 4) for w in r0['run_walls']]}; "
          f"intervals {len(r0['intervals'])}: quartiles {q1 * 1e3:.4f} {med * 1e3:.4f} "
          f"{q3 * 1e3:.4f} ms, 95th percentile "
          f"{percentile(r0['intervals'], 95.0) * 1e3:.4f} ms", file=sys.stderr)
    for name, (number, limit) in line["compared"].items():
        print(f"compared {name} {number!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
