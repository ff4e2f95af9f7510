"""One run of one cell: set-up, the measured window, the traced stretch,
the check against the reference, and the result line.

The window serves the mix's items in turn, closed loop, one caller, for
``seconds``: every call completed in it counts, and a rate is taken over
all of them and all of its time. Nothing is built or compiled inside it:
set-up has built the kernel library, made the inputs, and served every
item of the mix once (a stream: the first frames of every session).

Over the window the collector is off, with set-up's objects frozen out of
its reach, and only a sample of the outputs is kept for the check: the
first output of every item of the mix, and each later one with a chance
of ``KEEP_SHARE`` drawn from the seed.

A traced run (``trace``) passes ``timings`` to every call (the program's
``StageClock``), wraps the calls into each layer in harness spans, and
profiles ``PROFILED_CALLS`` whole calls that start once ``PROFILE_AT`` of
the window has passed. Stage means are over the unprofiled calls, which
the profiler does not slow.
"""

from __future__ import annotations

import contextlib
import gc
import sys
import time

from . import check, trace
from .manifest import Manifest

PROFILE_AT = 0.4
PROFILED_CALLS = 4
KEEP_SHARE = 0.25
FORBIDDEN = ("jax", "jaxlib", "flax", "icpflow_tpu")


def log(msg: str):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``icpflow_tpu_torch`` is not ``icpflow_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def _window(entry, items, seconds, traced, device, keep_rng):
    """The measured loop. Returns the window's record and the kept calls'
    (key, output)."""
    import torch
    sched = entry.schedule(items)
    seen = set()
    units = 0
    lat, outs, stages, host = [], [], [], []
    prof, profiled, done = None, 0, not traced
    t_start = time.perf_counter()
    while True:
        now = time.perf_counter() - t_start
        if done and now >= seconds:
            break
        active = prof is not None and not done
        if traced and not done and prof is None and now >= PROFILE_AT * seconds:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.device(device).type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            active = True
        key, item = next(sched)
        timings = {} if traced else None
        span = (torch.profiler.record_function("bench.call") if active
                else contextlib.nullcontext())
        t0 = time.perf_counter()
        with span:
            out = entry.call(key, item, timings)
        t1 = time.perf_counter()
        lat.append((t1 - t0) * 1e3)
        units += entry.units(key, item)
        if key not in seen or keep_rng.random() < KEEP_SHARE:
            seen.add(key)
            outs.append((key, out))
        if active:
            profiled += 1
            if profiled == PROFILED_CALLS:
                prof.stop()
                done = True
        elif traced:
            stages.append(timings)
            host.append((t1 - t0) * 1e3)
    window_s = time.perf_counter() - t_start
    profile = None
    if prof is not None:
        cuda = torch.autograd.DeviceType.CUDA
        profile = trace.summarize(prof.profiler.kineto_results.events(), cuda)
    return dict(window_s=window_s, calls=len(lat), units=units,
                latency_ms=lat, stages=stages, host_ms=host,
                profile=profile), outs


def run_cell(workload: str, seed: int, seconds: float, trace_on: bool,
             device: str = "cuda", root=None, started_at=None) -> dict:
    """Runs ``workload`` once. Returns the result line (the check's numbers
    under its last key, ``"check"``) and the window's record.
    ``started_at`` is the ``time.time()`` at which set-up began (the
    process's start)."""
    import numpy as np
    import torch
    t_setup = started_at if started_at is not None else time.time()
    man = Manifest(root)
    cell = man.cell(workload)
    conf = man.config(cell["config"])
    mix = man.mix(cell["traffic"])
    limits = man.limits(workload)
    items = man.generator(mix).make(mix, seed)
    kind = man.entry(conf["entry"])
    entry = kind(conf, mix, device)
    is_cuda = torch.device(device).type == "cuda"
    if is_cuda:
        torch.cuda.reset_peak_memory_stats()
    entry.warm(items)
    if is_cuda:
        torch.cuda.synchronize()
    setup_s = time.time() - t_setup
    log(f"{workload} seed {seed}: set-up {setup_s:.3f} s")

    keep_rng = np.random.default_rng([int(seed) % (1 << 64), 1])
    spans = entry.spans() if trace_on else contextlib.nullcontext()
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        with spans:
            record, outs = _window(entry, items, seconds, trace_on, device,
                                   keep_rng)
    finally:
        gc.enable()
        gc.unfreeze()
    record.update(entry=conf["entry"], unit=kind.unit, root=kind.root,
                  setup_s=setup_s)
    log(f"window {record['window_s']:.3f} s, {record['calls']} calls")
    peak = torch.cuda.max_memory_allocated() if is_cuda else 0

    metrics = {}
    for m in man.metrics(workload, trace_on):
        value = man.reader(m["name"], trace_on)(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the program's state goes before the reference runs
    del entry
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    refs = reference_outputs(kind, conf, mix, items, [k for k, _ in outs],
                             device, tf32=False)
    rows = [check.compare(o, refs[k]) for k, o in outs]
    numbers, failed = check.judge(rows, limits)
    log(f"reference {time.perf_counter() - t_ref:.3f} s over "
        f"{len(outs)} outputs")
    correct = bool(rows) and failed == 0

    dev = {"platform": "gpu" if is_cuda else "cpu",
           "kind": torch.cuda.get_device_name() if is_cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    line = {"correct": correct, "attempted": record["calls"],
            "failed": failed, "metrics": metrics, "device": dev}
    prof = record["profile"]
    if trace_on and prof:
        dev["busy_s"] = prof["busy_s"]
        dev["window_s"] = prof["window_s"]
        line["breakdown"] = {"device_ops": prof["device_ops"],
                             "idle_gaps": prof["idle_gaps"]}
    line["check"] = {k: {"value": numbers[k], "limit": v}
                     for k, v in limits.items()}
    return dict(line=line, record=record)


def reference_outputs(kind, conf, mix, items, keys, device,
                      tf32: bool) -> dict:
    """The reference's outputs for ``keys`` through the counterpart of the
    entry ``kind`` (``Manifest.entry``), in float32 or, for the control,
    with float32 matmuls in TF32."""
    from .reference.engine import Reference, use_tf32
    ref = Reference(conf["pipeline"], device)
    use_tf32(tf32)
    try:
        return kind.reference(ref, mix, items, keys)
    finally:
        use_tf32(False)
