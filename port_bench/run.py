"""Run one cell of the benchmark of ``mint_tpu_torch`` once.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: whether
the timed path's output was correct, the work attempted and failed, the
cell's end-to-end metrics (``--trace 0``) or its per-layer metrics
(``--trace 1``, with the traced window's busy and window seconds and a
breakdown), and the device.  The numbers compared with the reference are
the last lines of standard error and the last key of that object.

Exits non-zero, printing no result, without enough CUDA cards for the
cell, or if the JAX stack or the JAX package was loaded in this process.

A cell whose configuration is data-parallel over several cards runs one
process a card: this one is rank 0, which starts the others (the same
command, told their rank in the environment), joins them over NCCL and
alone prints the result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
CACHE = os.path.join(ROOT, ".port_bench_cache")
RANK_ENV, PORT_ENV = "PORT_BENCH_RANK", "PORT_BENCH_PORT"
RANK_TIMEOUT_S = 300


def _environment() -> None:
    """Kernel caches inside the checkout, at fixed paths, and no library
    that would load JAX on its own."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"
    for path in (ROOT, BENCH_DIR):
        if path not in sys.path:
            sys.path.insert(0, path)


class Context:
    """What a kind's ``run`` reads: the cell, its configuration, the run's
    arguments, the device and the kernel families."""

    def __init__(self, name, cell, config, seed, seconds, trace, device,
                 families, t_start, mesh=None, hooks=None):
        self.name, self.cell, self.config = name, cell, config
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.families, self.t_start = device, families, t_start
        self.mesh, self.hooks = mesh, hooks

    @staticmethod
    def log(msg: str) -> None:
        print(f"port_bench: {msg}", file=sys.stderr, flush=True)


def measure(name: str, seed: int, seconds: float, trace: bool, device,
            t_start: float, hooks=None, bench_dir: str = BENCH_DIR,
            mesh=None) -> dict:
    """Run cell `name` on `device` (this rank's of `mesh`) and return the
    kind's outcome, empty on ranks but 0; `hooks` (model, trainer,
    dataset), where a kind takes it, sees the program's objects before
    the first step."""
    from lib import registry

    cell = registry.cell(name, bench_dir)
    ctx = Context(name, cell, registry.config(cell["config"], bench_dir),
                  seed, seconds, trace, device,
                  registry.kernel_families(bench_dir), t_start, mesh, hooks)
    return registry.kind(cell["kind"], bench_dir).run(ctx)


def start_ranks(world: int, argv) -> list:
    """Ranks 1 to `world` - 1: this process's script again with `argv`,
    each told its rank and the port rank 0 serves, writing to this
    process's standard error."""
    import socket
    import subprocess

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    os.environ[PORT_ENV] = str(port)
    return [subprocess.Popen([sys.executable, os.path.abspath(sys.argv[0]),
                              *argv], cwd=os.getcwd(),
                             env={**os.environ, RANK_ENV: str(r)},
                             stdout=subprocess.DEVNULL)
            for r in range(1, world)]


def join(world: int, rank: int, device):
    """This rank's place in a data-parallel mesh of `world` ranks: NCCL
    between cards, gloo between CPU processes."""
    import datetime

    import torch.distributed as dist

    from mint_tpu_torch.parallel import mesh as mesh_lib

    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://127.0.0.1:{os.environ[PORT_ENV]}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    return mesh_lib.make_mesh(data=world, model=1, device=device)


def result(name: str, outcome: dict, trace: bool, device_info: dict,
           bench: dict, bench_dir: str = BENCH_DIR) -> dict:
    """The result line: the metrics the cell reports, by BENCHMARK.json."""
    from lib import registry

    metrics = {}
    if trace:
        tr = outcome["trace"]
        for mname, entry in registry.per_layer(bench, name).items():
            value = registry.metric(mname, bench_dir).read(tr)
            if value is not None:
                metrics[mname] = {"value": value, "unit": entry["unit"]}
        device_info = dict(device_info,
                           busy_s=outcome.get("busy_s", tr.busy_s()),
                           window_s=outcome.get("window_s", tr.window_s))
    else:
        for mname, entry in registry.end_to_end(bench, name).items():
            if mname in outcome["e2e"]:
                metrics[mname] = {"value": outcome["e2e"][mname],
                                  "unit": entry["unit"]}
    checks = {k: {"value": v, "limit": lim}
              for k, (v, lim) in outcome["checks"].items()}
    correct = (outcome["failed"] == 0 and outcome["attempted"] > 0
               and all(math.isfinite(v) and v <= lim
                       for v, lim in outcome["checks"].values()))
    line = {"correct": correct, "attempted": outcome["attempted"],
            "failed": outcome["failed"], "metrics": metrics,
            "device": device_info}
    if trace:
        line["breakdown"] = outcome["trace"].breakdown()
    line["checks"] = checks
    return line


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    _environment()
    args = parse(argv)

    import torch

    from lib import registry

    chips = registry.cell(args.workload)["chips"]
    rank = int(os.environ.get(RANK_ENV, "0"))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips:
        print(f"port_bench: {args.workload} needs {chips} CUDA card(s); "
              f"this machine has {cards}", file=sys.stderr)
        return 2
    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    torch.cuda.reset_peak_memory_stats(device)
    return run_cell(args, device, torch.cuda.get_device_name(device),
                    sys.argv[1:] if argv is None else argv)


def run_cell(args, device, kind: str, argv,
             bench_dir: str = BENCH_DIR) -> int:
    """The run once the cards are there: the other ranks started (the
    same command, `argv`), the cell measured on `device`, whose name is
    `kind`, and rank 0's result printed.  Every rank exits non-zero if
    it loaded a forbidden module; rank 0 then prints no result."""
    import torch

    from lib import common, registry

    cell = registry.cell(args.workload, bench_dir)
    world = registry.config(cell["config"], bench_dir).get(
        "data_parallel", 1)
    rank = int(os.environ.get(RANK_ENV, "0"))
    if world > 1:  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    ranks = start_ranks(world, argv) if world > 1 and rank == 0 else []
    try:
        mesh = join(world, rank, device) if world > 1 else None
        outcome = measure(args.workload, args.seed, args.seconds,
                          bool(args.trace), device, T_START,
                          bench_dir=bench_dir, mesh=mesh)
        if mesh is not None:
            from mint_tpu_torch.parallel import mesh as mesh_lib

            mesh_lib.leave()
        for p in ranks:
            p.wait(timeout=RANK_TIMEOUT_S)
    finally:
        for p in ranks:
            if p.poll() is None:
                p.kill()
                p.wait()
    loaded = common.forbidden_modules()
    if loaded:
        print(f"port_bench: rank {rank} loaded {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    if rank != 0:
        return 0
    failed = [i + 1 for i, p in enumerate(ranks) if p.returncode != 0]
    if failed:
        print(f"port_bench: rank(s) {failed} failed", file=sys.stderr)
        return 4
    info = {"platform": "gpu", "kind": kind, "count": cell["chips"],
            "memory_peak_bytes": int(outcome["memory_peak_bytes"])}
    line = result(args.workload, outcome, bool(args.trace), info,
                  registry.benchmark(os.path.dirname(bench_dir)), bench_dir)
    for k, c in line["checks"].items():
        print(f"port_bench check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
