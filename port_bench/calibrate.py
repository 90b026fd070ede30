"""Readings that the limits of a cell's correctness check are set from.

    python3 port_bench/calibrate.py --workload <cell> --seeds <n> [<n> ...]

For each seed, in one process: the program's readings at the cell's own
size and load, and those of the control (the reference computed in the
precision below the configuration's) and of the kind's planted faults,
each against the float32 reference.  One JSON line a seed on standard
output.  A data-parallel cell runs a process a card, as ``run.py`` does.
The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import run


def main(argv=None) -> int:
    run._environment()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)

    import torch

    from lib import registry

    cell = registry.cell(args.workload)
    config = registry.config(cell["config"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < \
            cell["chips"]:
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    world = config.get("data_parallel", 1)
    rank = int(os.environ.get(run.RANK_ENV, "0"))
    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    ranks = run.start_ranks(world, sys.argv[1:] if argv is None else argv) \
        if world > 1 and rank == 0 else []
    kind = registry.kind(cell["kind"])
    try:
        mesh = run.join(world, rank, device) if world > 1 else None
        for seed in args.seeds:
            t0 = time.perf_counter()
            ctx = run.Context(args.workload, cell, config, seed, 0.0, False,
                              device, registry.kernel_families(), t0, mesh)
            out = kind.calibrate(ctx)
            if rank == 0:
                out.update(seed=seed, seconds=time.perf_counter() - t0,
                           workload=args.workload)
                print(json.dumps(out), flush=True)
        if mesh is not None:
            from mint_tpu_torch.parallel import mesh as mesh_lib

            mesh_lib.leave()
        for p in ranks:
            p.wait(timeout=run.RANK_TIMEOUT_S)
    finally:
        for p in ranks:
            if p.poll() is None:
                p.kill()
                p.wait()
    return max([0] + [p.returncode for p in ranks])


if __name__ == "__main__":
    sys.exit(main())
