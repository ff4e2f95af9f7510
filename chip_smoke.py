"""Smoke run of the PyTorch port (``icpflow_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, any failure ends with a non-zero exit:

1. environment: torch / CUDA / nvcc versions and the card's name and power
   limit; a GPU is required;
2. build: compile the NN kernel library from ``icpflow_tpu_torch/csrc``;
3. kernel vs plain: all four kernel instantiations against the plain
   PyTorch version at the main path's shapes and at edge cases, with both
   timed by CUDA events;
4. main path: ``run_frame_pair`` at the bench configuration on the
   synthetic held-out scene (seed 7, gaps 1 and 4, ~74k points per frame),
   twice per pair; the flow is checked against the GT flow and against the
   JAX package's numbers on the same input (``JAX_REFERENCE``, computed on
   the CPU by ``tests/torch_smoke_reference.py``), and the kernel launch counts show
   the path went through the kernel.

The last lines are the card (nvidia-smi), the kernel table as JSON, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import io
import json
import subprocess
import sys
import time

import numpy as np

# bench.py make_cfg(): the configuration the JAX package is benchmarked at
BENCH_OVERRIDES = dict(
    max_points_scene=131072, max_points=4096, num_clusters=200,
    min_cluster_size=20, nn_tile=256, hist_grid_xy=128, icp_max_iters=100,
    epsilon=0.6, eps_scale_per_m=0.012, eps_max=0.8,
    cluster_dedup_voxel=0.15, cluster_rep_cap=32768, hist_grid_xy_small=64,
    hdbscan_knn_recall=0.95, hdbscan_fetch_f16=True)
SEED = 7
NUM_FRAMES = 5
GAPS = (1, 4)

# The JAX package on the same inputs (XLA:CPU, jax 0.9.0), from
# `python3 tests/torch_smoke_reference.py`; 74,202 / 74,593 src points, 0 overflow.
JAX_REFERENCE = {
    1: dict(epe3d=0.0004226506862323731, epe3d_dynamic=0.004312640987336636,
            matched=8),
    4: dict(epe3d=0.0002953319053631276, epe3d_dynamic=0.002881204942241311,
            matched=8),
}
# documented knife-edge band of the accuracy guardrails: sub-mm NN
# differences (here: the elementwise form at dst >= 2048 on the card vs the
# expanded form everywhere on XLA:CPU) flip borderline ICP basins
EPE_BAND = 0.005
MATCHED_BAND = 1

# kernel name -> (expanded form, points output, the TPU kernel it replaces,
# main-path shape (B, N, M) where the path runs it)
KERNELS = {
    "nn_expanded_points": (True, True,
                           "icpflow_tpu/ops/pallas/nn_kernel.py:217",
                           (256, 512, 512)),      # ICP, small bucket
    "nn_elementwise_points": (False, True,
                              "icpflow_tpu/ops/pallas/nn_kernel.py:217",
                              (32, 1024, 4096)),  # ICP, large bucket
    "nn_expanded_index": (True, False,
                          "icpflow_tpu/ops/pallas/nn_kernel.py:56",
                          (2048, 512, 512)),      # scoring, small bucket
    "nn_elementwise_index": (False, False,
                             "icpflow_tpu/ops/pallas/nn_kernel.py:90",
                             (256, 1024, 4096)),  # scoring, large bucket
}
SOURCE = "icpflow_tpu_torch/csrc/nn_kernel.cu"


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def bench_config():
    from icpflow_tpu_torch import DEMO
    return DEMO.replace(**BENCH_OVERRIDES)


def scene_pairs(cfg, seed=SEED, gaps=GAPS):
    """(gap, point_src, point_dst, gt_flow, dynamic, translation_frame) of
    the held-out synthetic scene (numpy, made from ``seed``)."""
    from icpflow_tpu_torch.data.synthetic import ego_aligned_pair, make_sample
    buf = io.BytesIO()
    make_sample(buf, num_frames=NUM_FRAMES, seed=seed)
    buf.seek(0)
    sample = dict(np.load(buf))
    out = []
    for j in gaps:
        src, dst, gt, dyn = ego_aligned_pair(sample, j)
        out.append((j, src, dst, gt, dyn, cfg.translation_frame(j)))
    return out


def pair_metrics(flow, gt, dyn, pairs):
    err = np.linalg.norm(flow - gt, axis=-1)
    return dict(epe3d=float(err.mean()),
                epe3d_dynamic=float(err[dyn].mean()) if dyn.any() else 0.0,
                matched=int(len(pairs)), n_dynamic=int(dyn.sum()))


# --------------------------------------------------------------------------
def phase_environment():
    import torch
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    from icpflow_tpu_torch.ops.cuda import nn_kernel
    nvcc = subprocess.run([nn_kernel.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} nvcc "
          f"{nvcc.stdout.strip().splitlines()[-1]} | gpus "
          f"{torch.cuda.device_count()} | {card}", flush=True)
    return card


def phase_build():
    from icpflow_tpu_torch.ops.cuda import nn_kernel
    path = nn_kernel.build(force=True)
    nn_kernel.load()
    print(f"[build] {path.name} from {SOURCE} in "
          f"{nn_kernel.build_seconds:.2f} s", flush=True)


def _inputs(b, n, m, seed, *, dup=False, empty_row=False):
    """Metre-scale clouds: dst a noisy copy of a box at ~20 m from the
    origin, src the same box under a small motion."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-2.0, 2.0, (b, max(n, m), 3)) + [18.0, -9.0, 0.5]
    dst = base[:, :m] + rng.normal(scale=0.01, size=(b, m, 3))
    src = base[:, :n] + [0.05, -0.03, 0.0] + rng.normal(
        scale=0.02, size=(b, n, 3))
    mask = rng.random((b, m)) < 0.9
    if dup:                       # exact duplicates: the lowest index wins
        dst[:, m // 2:] = dst[:, :m - m // 2]
        mask[:] = True
    if empty_row:
        mask[0] = False
    return src.astype(np.float32), dst.astype(np.float32), mask


def _time_ms(fn, iters=10):
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    z = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    z.record()
    torch.cuda.synchronize()
    return a.elapsed_time(z) / iters


def _compare(expanded, points, src, dst, mask):
    """Kernel vs plain on the card. Returns the max abs dist/point error."""
    import torch
    from icpflow_tpu_torch.ops import knn
    from icpflow_tpu_torch.ops.cuda import nn_kernel
    s, d, mk = (torch.as_tensor(a, device="cuda") for a in (src, dst, mask))
    ko, kd = nn_kernel.masked_nn_cuda(s, d, mk, expanded=expanded,
                                      points=points)
    po, pd = knn.masked_nn_plain(s, d, mk, expanded=expanded, points=points)
    torch.cuda.synchronize()
    # dist within 1e-5 m: kernel and plain run the same rounded fp32
    # sequence, so any difference is a fault, not noise (1e-5 m leaves
    # room only for the last bit of sqrt at ~100 m distances)
    err = float((kd - pd).abs().max()) if kd.numel() else 0.0
    check(err <= 1e-5, f"dist differs by {err:.3g} m")
    if points:
        perr = float((ko - po).abs().max()) if ko.numel() else 0.0
        check(perr <= 1e-5, f"points differ by {perr:.3g} m")
        err = max(err, perr)
    else:
        bad = (ko != po)
        if bool(bad.any()):
            # idx may differ only where the two candidates' d^2 differ by
            # less than 1e-6 d^2 (FMA-contraction noise between two
            # compilations of the same formula)
            gk = torch.gather(d, 1, ko.long()[..., None].expand(-1, -1, 3))
            gp = torch.gather(d, 1, po.long()[..., None].expand(-1, -1, 3))
            d2k = ((gk.double() - s.double()) ** 2).sum(-1)
            d2p = ((gp.double() - s.double()) ** 2).sum(-1)
            gap = (d2k - d2p).abs()[bad]
            check(bool((gap <= 1e-6 * d2p[bad].clamp(min=1e-30)).all()),
                  f"{int(bad.sum())} idx differ beyond FMA noise")
    return err, (s, d, mk)


def phase_kernels():
    from icpflow_tpu_torch.ops import knn
    from icpflow_tpu_torch.ops.cuda import nn_kernel
    rows = {}
    edge = [  # (b, n, m, kwargs): edge cases
        (3, 200, 300, dict(empty_row=True)),   # a row with no valid dst
        (2, 257, 512, dict(dup=True)),         # duplicates
        (2, 129, 1500, {}),                    # M not a multiple of the chunk
        (4, 1, 777, {}),                       # N = 1
    ]
    for k, (name, (expanded, points, _, shape)) in enumerate(KERNELS.items()):
        worst = 0.0
        for b, n, m, kw in edge:
            src, dst, mask = _inputs(b, n, m, 100 + k, **kw)
            err, (s, d, mk) = _compare(expanded, points, src, dst, mask)
            worst = max(worst, err)
            if kw.get("empty_row"):
                o, dist = nn_kernel.masked_nn_cuda(s, d, mk, expanded=expanded,
                                                   points=points)
                check(bool((dist[0] == 1e15).all()), "empty row dist")
                check(bool((o[0] == 0).all()), "empty row idx / points")
        src, dst, mask = _inputs(*shape, 200 + k)
        err, (s, d, mk) = _compare(expanded, points, src, dst, mask)
        worst = max(worst, err)
        ms = _time_ms(lambda: nn_kernel.masked_nn_cuda(
            s, d, mk, expanded=expanded, points=points))
        plain_ms = _time_ms(lambda: knn.masked_nn_plain(
            s, d, mk, expanded=expanded, points=points), iters=3)
        rows[name] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms)
        print(f"[kernel] {name} B,N,M={shape}: max_abs_err {worst:.3g} "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms", flush=True)
    return rows


def phase_main_path(card):
    import torch
    from icpflow_tpu_torch import SceneFlowEngine, run_frame_pair
    from icpflow_tpu_torch.ops import knn
    from icpflow_tpu_torch.ops.cuda import nn_kernel
    cfg = bench_config()
    engine = SceneFlowEngine(cfg, device="cuda")
    pairs = scene_pairs(cfg)
    nn_kernel.launches = 0
    nn_kernel.variant_launches.clear()
    knn.plain_calls = 0
    results = []
    for gap, src, dst, gt, dyn, tf in pairs:
        outs, times = [], []
        for _ in range(2):
            timings = {}
            a = torch.cuda.Event(enable_timing=True)
            z = torch.cuda.Event(enable_timing=True)
            a.record()
            out = run_frame_pair(engine, src, dst, translation_frame=tf,
                                 timings=timings)
            z.record()
            torch.cuda.synchronize()
            timings["total"] = a.elapsed_time(z)
            outs.append(out)
            times.append(timings)
        results.append((gap, src, dst, gt, dyn, outs, times))
    launches = nn_kernel.launches
    per_kernel = dict(nn_kernel.variant_launches)
    plain = knn.plain_calls
    check(launches > 0, "the main path launched no NN kernel")
    check(plain == 0, f"the main path called the plain NN {plain} times")

    for gap, src, dst, gt, dyn, outs, times in results:
        out = outs[1]
        check(out.flow.shape == src.shape, f"flow shape {out.flow.shape}")
        check(bool(np.isfinite(out.flow).all()), "non-finite flow")
        m = pair_metrics(out.flow, gt, dyn, out.pairs)
        same = all(np.array_equal(a, b) for a, b in
                   zip(outs[0][:5], outs[1][:5]))
        w = times[1]
        print(f"[main] gap {gap}: src {len(src)} dst {len(dst)} pts | EPE3D "
              f"{m['epe3d']:.5f} dyn {m['epe3d_dynamic']:.5f} over "
              f"{m['n_dynamic']} | matched {m['matched']} overflow "
              f"{out.overflow} | runs identical {same} | warm ms: cluster "
              f"{w['cluster']:.1f} track {w['track']:.1f} flow "
              f"{w['flow']:.1f} total {w['total']:.1f} (cold total "
              f"{times[0]['total']:.1f}) | {card}", flush=True)
        ref = JAX_REFERENCE[gap]
        for key in ("epe3d", "epe3d_dynamic"):
            check(abs(m[key] - ref[key]) <= EPE_BAND,
                  f"gap {gap} {key} {m[key]:.5f} vs JAX {ref[key]:.5f}")
        check(abs(m["matched"] - ref["matched"]) <= MATCHED_BAND,
              f"gap {gap} matched {m['matched']} vs JAX {ref['matched']}")
    print(f"[main] NN kernel launches {launches} {per_kernel}, plain NN "
          f"calls {plain}", flush=True)
    return per_kernel


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    t0 = time.time()
    card = phase_environment()
    phase_build()
    rows = phase_kernels()
    per_kernel = phase_main_path(card)
    for name in KERNELS:
        check(per_kernel.get(name, 0) > 0,
              f"kernel {name} was not launched by the main path")
    table = [dict(name=name, route="cuda", source=SOURCE, replaces=rep,
                  launches=per_kernel.get(name, 0), **rows[name])
             for name, (_, _, rep, _) in KERNELS.items()]
    print(f"[done] {time.time() - t0:.1f} s", flush=True)
    print(card)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
