"""Readings that the limits of ``correct`` are set from, for one cell,
over many seeds in one process:

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 ... \\
        [--control-seeds 1 2 3] [--first N]

For each seed it serves every item of the mix once through the program
(a stream: every frame of every session) and prints the
check's numbers against the reference (``program``: the lower readings).
For each control seed it puts the reference in the program's place with
float32 matmuls in TF32, the nearest precision below the configurations'
float32, and prints its numbers against the float32 reference
(``control``: the upper readings). One JSON line a reading, on stdout.
``--first N`` compares only the first ``N`` calls of the pass (a stream of
16-scan sessions: ``--first 16`` is its first session): a reading over
fewer outputs is never above the reading over all of them, so it can
stand as an upper reading where the control is slow.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(workload, seeds, control_seeds, device="cuda", root=None,
             first=None):
    """Yields one dict a reading: side, seed, numbers, seconds."""
    import torch

    from benchmark import check
    from benchmark.harness import reference_outputs
    from benchmark.manifest import Manifest

    man = Manifest(root)
    cell = man.cell(workload)
    conf = man.config(cell["config"])
    mix = man.mix(cell["traffic"])
    kind = man.entry(conf["entry"])
    gen = man.generator(mix)
    entry = kind(conf, mix, device)
    for side, seed_list in (("program", seeds), ("control", control_seeds)):
        for seed in seed_list:
            t0 = time.perf_counter()
            items = gen.make(mix, seed)
            calls = []                  # one pass over the mix
            for key, item in entry.schedule(items):
                if calls and key == calls[0][0]:
                    break
                calls.append((key, item))
            calls = calls[:first]
            keys = [k for k, _ in calls]
            if side == "program":
                outs = {k: entry.call(k, item, None) for k, item in calls}
            else:
                outs = reference_outputs(kind, conf, mix, items, keys,
                                         device, tf32=True)
            refs = reference_outputs(kind, conf, mix, items, keys, device,
                                     tf32=False)
            rows = [check.compare(outs[k], refs[k]) for k in keys]
            yield dict(side=side, seed=seed, outputs=len(rows),
                       numbers=check.worst(rows),
                       seconds=time.perf_counter() - t0)
            del outs, refs
            gc.collect()
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--first", type=int, default=None)
    args = p.parse_args(argv)
    if _ROOT not in sys.path:
        sys.path.insert(0, _ROOT)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    for r in readings(args.workload, args.seeds, args.control_seeds,
                      first=args.first):
        print(json.dumps(dict(r, workload=args.workload,
                              kind=torch.cuda.get_device_name())),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
