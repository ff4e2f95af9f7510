"""Smoke run of the PyTorch port (``icpflow_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, any failure ends with a non-zero exit:

1. environment: torch / CUDA / nvcc versions and the card's name and power
   limit; a GPU is required;
2. build: compile the NN kernel library from ``icpflow_tpu_torch/csrc``;
3. kernel vs plain: all six kernel instantiations against the plain
   PyTorch version at the main paths' shapes (the stream's exact odometry
   sweep included) and at edge cases (an empty row, duplicates, ragged M,
   N = 1, an equidistant tie), with both timed by CUDA events;
4. frame-pair path: ``run_frame_pair`` at the bench configuration on the
   synthetic held-out scene (seed 7, gaps 1 and 4, ~74k points per frame),
   twice per pair; the flow is checked against the GT flow and against the
   JAX package's numbers on the same input (``JAX_REFERENCE``, computed on
   the CPU by ``tests/torch_smoke_reference.py``);
5. stream path: ``StreamingEngine`` (ego odometry, CZM ground, joint
   clustering, matching, flow) over the scene's five ~92k-point
   sensor-frame scans at the same configuration, once under
   ``ICPFLOW_NN_VARIANT=vpu2`` (the sentinel kernels) and once under the
   default policy, after a two-frame warm-up; each frame is checked
   against the GT pose and flow and against ``JAX_STREAM_REFERENCE``.

Each path runs with the kernel launch counts set to 0 just before it and
read just after; they show it went through the kernels and never through
the plain NN version. The last lines are the card (nvidia-smi), the kernel
table as JSON, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import io
import json
import os
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
# The JAX package's StreamingEngine on the same five scans (XLA:CPU, jax
# 0.9.0; `python3 tests/torch_smoke_reference.py --stream`), per frame: EPE3D
# and dynamic EPE against the GT flow to the previous frame, matched pairs,
# and the estimated pose's top 3x4 rows. Run at ego_map_capacity 65536 and
# ego_src_capacity 4096 (map filled to 11,994 / 25,492 / 35,191 / 44,632 /
# 51,816 points, source 3,283-3,643 points: nothing truncated, so the
# padded capacity does not change the result).
JAX_STREAM_REFERENCE = {
    1: dict(epe3d=0.013951686210930347,
            epe3d_dynamic=0.1459459662437439, matched=10,
            pose=[[1.0000001192092896, -6.250304068089463e-06,
                   3.2627264090479e-07, 1.1003608703613281],
                  [6.2743852140556555e-06, 1.0000001192092896,
                   2.9425666525639826e-06, 0.09985669702291489],
                  [-3.2483305290043063e-07, -2.9436171189445304e-06,
                   1.000000238418579, 0.0013318900018930435]]),
    2: dict(epe3d=0.011594541370868683,
            epe3d_dynamic=0.11839686334133148, matched=10,
            pose=[[1.0, 9.21687842492247e-06,
                   -1.8576744196252548e-06, 2.200517177581787],
                  [-9.215525096806232e-06, 1.0,
                   1.0052757716039196e-05, 0.2005940079689026],
                  [1.8576121192381834e-06, -1.0052560355688911e-05,
                   1.0, 0.0020303227938711643]]),
    3: dict(epe3d=0.010762483812868595,
            epe3d_dynamic=0.1090300902724266, matched=11,
            pose=[[1.0000001192092896, -8.043035450100433e-06,
                   -7.880803423176985e-07, 3.3009252548217773],
                  [8.095012162812054e-06, 1.0,
                   1.3404881428868975e-05, 0.3005104064941406],
                  [7.881286592237302e-07, -1.3405154277279507e-05,
                   1.0000001192092896, 0.0017898082733154297]]),
    4: dict(epe3d=0.01044867467135191,
            epe3d_dynamic=0.10541573166847229, matched=11,
            pose=[[1.0, -1.8995189748238772e-05,
                   -1.957845370270661e-07, 4.400069236755371],
                  [1.8972081306856126e-05, 1.0,
                   1.9051205526920967e-05, 0.3999721109867096],
                  [1.9467093181901873e-07, -1.9051311028306372e-05,
                   1.0, 0.002566578099504113]]),
}
# documented knife-edge band of the accuracy guardrails: sub-mm NN
# differences (here: the elementwise or sentinel form on the card vs the
# expanded form everywhere on XLA:CPU) flip borderline ICP basins
EPE_BAND = 0.005
MATCHED_BAND = 1
POSE_BAND_M = 0.01
POSE_BAND_DEG = 0.1

_TPU = "icpflow_tpu/ops/pallas/nn_kernel.py:"
# kernel name -> (form, points output, the TPU kernel it replaces, shapes
# (B, N, M) where the main paths run it; the first is the JSON row's)
KERNELS = {
    "nn_expanded_points": ("expanded", True, _TPU + "217",
                           [(256, 512, 512)]),       # ICP, small bucket
    "nn_elementwise_points": ("elementwise", True, _TPU + "217",
                              [(32, 1024, 4096)]),   # ICP, large bucket
    "nn_expanded_index": ("expanded", False, _TPU + "56",
                          [(2048, 512, 512)]),       # scoring, small bucket
    "nn_elementwise_index": ("elementwise", False, _TPU + "90",
                             [(256, 1024, 4096),     # scoring, large bucket
                              (1, 16384, 262144)]),  # odometry, exact
    "nn_sentinel_points": ("sentinel", True, _TPU + "175",
                           [(32, 1024, 4096), (256, 512, 512)]),   # vpu2 ICP
    "nn_sentinel_index": ("sentinel", False, _TPU + "125",
                          [(256, 1024, 4096), (2048, 512, 512)]),  # vpu2
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


def stream_frames(seed=SEED):
    """(scans, ego_gt, gt_flow, dynamic) of the held-out synthetic scene
    as a sensor stream: the ``NUM_FRAMES`` (n_k, 3) sensor-frame scans of
    ``make_sample``, their GT world poses (``ego_motion_gt``), and for each
    frame k >= 1 the GT flow of its points back to frame k-1 in world
    coordinates (the instance motions of ``bbox_tsfm``; zero for static
    points) with the mover mask. Entry 0 of the last two is None."""
    from icpflow_tpu_torch.data.synthetic import make_sample
    buf = io.BytesIO()
    make_sample(buf, num_frames=NUM_FRAMES, seed=seed)
    buf.seek(0)
    sample = dict(np.load(buf))
    raw = sample["raw_points"]
    ti = sample["time_indice"]
    inst = sample["inst_labels"]
    ego = sample["ego_motion_gt"].astype(np.float64)
    tsfm = sample["bbox_tsfm"].astype(np.float64)
    scans, gts, dyns = [], [None], [None]
    for k in range(NUM_FRAMES):
        sel = ti == k
        scans.append(raw[sel].astype(np.float32))
        if k == 0:
            continue
        world = raw[sel] @ ego[k, :3, :3].T + ego[k, :3, 3]
        gt = np.zeros_like(world)
        lab = inst[sel]
        for i in np.unique(lab[lab > 0]):
            m = lab == i
            M = np.linalg.inv(tsfm[int(i), k - 1]) @ tsfm[int(i), k]
            gt[m] = world[m] @ M[:3, :3].T + M[:3, 3] - world[m]
        gts.append(gt.astype(np.float32))
        dyns.append(sample["sd_labels"][sel] > 0)
    return scans, sample["ego_motion_gt"], gts, dyns


def pose_error(pose, ref):
    """(translation error m, rotation error deg) of two (4,4) poses."""
    pose = np.asarray(pose, np.float64)
    ref = np.asarray(ref, np.float64)
    r = pose[:3, :3].T @ ref[:3, :3]
    skew = np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])
    ang = np.degrees(np.arctan2(np.linalg.norm(skew) / 2,
                                (np.trace(r) - 1) / 2))
    return float(np.linalg.norm(pose[:3, 3] - ref[:3, 3])), float(ang)


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
    driver = subprocess.run(
        ["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.split()[0]
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} nvcc "
          f"{nvcc.stdout.strip().splitlines()[-1]} driver {driver} | gpus "
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


def _tie_inputs(seed):
    """Row 0, src 0 at the origin with exactly two nearest dst, at distance
    1 and j = 2 and j = 9; every other dst lies 5-15 m away. The index
    output takes j = 2 in every form; the points output dst[2], except the
    sentinel form's, which takes dst[9] (lower j mod 8)."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-1.0, 1.0, (2, 40, 3))
    src[0, 0] = 0.0
    dst = rng.uniform(5.0, 15.0, (2, 300, 3)) * rng.choice([-1.0, 1.0],
                                                         (2, 300, 3))
    dst[0, 2] = (1.0, 0.0, 0.0)
    dst[0, 9] = (0.0, 1.0, 0.0)
    return (src.astype(np.float32), dst.astype(np.float32),
            np.ones((2, 300), bool))


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


def _explain(form, points, arrays, card, outs):
    """Why a kernel and its plain version disagree: the worst rows against
    a float64 reference on the host, and both sides run again on fresh
    card copies of the same inputs. Printed to stderr before the failure."""
    import torch
    from icpflow_tpu_torch.ops import knn
    from icpflow_tpu_torch.ops.cuda import nn_kernel
    src, dst, mask = arrays
    (ko, kd), (po, pd) = outs
    gap = (kd - pd).abs().cpu().numpy()
    lines = [f"[mismatch] {nn_kernel.kernel_name(form, points)} "
             f"B,N,M={src.shape[0]},{src.shape[1]},{dst.shape[1]}: "
             f"{int((gap > 1e-5).sum())} dist entries differ, rows "
             f"{sorted(set(np.nonzero(gap > 1e-5)[0].tolist()))[:8]}; card "
             "inputs equal the host's: " + str(all(
                 np.array_equal(t.cpu().numpy(), a)
                 for t, a in zip(card, arrays)))]
    for flat in [f for f in np.argsort(gap, axis=None)[::-1][:4]
                 if gap.flat[f] > 1e-5]:
        b, i = np.unravel_index(flat, gap.shape)
        d64 = np.linalg.norm(dst[b].astype(np.float64) - src[b, i], axis=-1)
        ok = mask[b] if form != "sentinel" else np.ones_like(mask[b])
        j = int(np.flatnonzero(ok)[d64[ok].argmin()]) if ok.any() else -1
        lines.append(f"  row {b} src {i}: kernel {float(kd[b, i])!r} "
                     f"{ko[b, i].tolist()} plain {float(pd[b, i])!r} "
                     f"{po[b, i].tolist()} | float64 nearest valid j {j} "
                     f"at {float(d64[j]) if j >= 0 else None!r}")
    torch.cuda.synchronize()
    fresh = [torch.as_tensor(a, device="cuda") for a in arrays]
    for tag, tensors in (("same tensors", card), ("fresh copies", fresh)):
        ko2, kd2 = nn_kernel.masked_nn_cuda(*tensors, form=form,
                                            points=points)
        po2, pd2 = knn.masked_nn_plain(*tensors, form=form, points=points)
        torch.cuda.synchronize()
        lines.append(
            f"  again on {tag}: kernel == first kernel "
            f"{bool(torch.equal(kd2, kd) and torch.equal(ko2, ko))}, plain "
            f"== first plain {bool(torch.equal(pd2, pd) and torch.equal(po2, po))}"
            f", kernel == plain {bool(torch.equal(kd2, pd2))}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,"
         "ecc.errors.corrected.volatile.total,"
         "ecc.errors.uncorrected.volatile.total", "--format=csv,noheader"],
        capture_output=True, text=True)
    lines.append(f"  card: sm clock, temperature, ECC corrected / uncorrected "
                 f"errors: {smi.stdout.strip()}")
    print("\n".join(lines), file=sys.stderr, flush=True)


def _compare(form, points, src, dst, mask):
    """Kernel vs plain on the card. Returns the max abs dist/point error,
    the kernel's and the plain version's outputs, and the card tensors."""
    import torch
    from icpflow_tpu_torch.ops import knn
    from icpflow_tpu_torch.ops.cuda import nn_kernel
    s, d, mk = (torch.as_tensor(a, device="cuda") for a in (src, dst, mask))
    ko, kd = nn_kernel.masked_nn_cuda(s, d, mk, form=form, points=points)
    po, pd = knn.masked_nn_plain(s, d, mk, form=form, points=points)
    torch.cuda.synchronize()
    what = (f"{nn_kernel.kernel_name(form, points)} "
            f"B,N,M={src.shape[0]},{src.shape[1]},{dst.shape[1]}")

    def agree(cond, msg):
        if not cond:
            try:        # the report must not replace the failure below
                _explain(form, points, (src, dst, mask), (s, d, mk),
                         ((ko, kd), (po, pd)))
            except Exception as e:
                print(f"[mismatch] report failed: {e!r}", file=sys.stderr)
        check(cond, f"{what}: {msg}")

    # dist within 1e-5 m: kernel and plain run the same rounded fp32
    # sequence, so any difference is a fault, not noise (1e-5 m leaves
    # room only for the last bit of sqrt at ~100 m distances)
    err = float((kd - pd).abs().max()) if kd.numel() else 0.0
    agree(err <= 1e-5, f"dist differs by {err:.3g} m")
    if points:
        perr = float((ko - po).abs().max()) if ko.numel() else 0.0
        agree(perr <= (0.0 if form == "sentinel" else 1e-5),
              f"points differ by {perr:.3g} m")
        err = max(err, perr)
    elif form == "sentinel":
        agree(bool((ko == po).all()), f"{int((ko != po).sum())} idx differ")
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
            agree(bool((gap <= 1e-6 * d2p[bad].clamp(min=1e-30)).all()),
                  f"{int(bad.sum())} idx differ beyond FMA noise")
    return err, (ko, kd), (po, pd), (s, d, mk)


def _check_edges(name, form, points, k):
    """Edge cases of one instantiation; returns the worst error."""
    edge = [  # (b, n, m, kwargs)
        (3, 200, 300, dict(empty_row=True)),   # a row with no valid dst
        (2, 257, 512, dict(dup=True)),         # duplicates
        (2, 129, 1500, {}),                    # M not a multiple of the chunk
        (4, 1, 777, {}),                       # N = 1
    ]
    worst = 0.0
    for b, n, m, kw in edge:
        src, dst, mask = _inputs(b, n, m, 100 + k, **kw)
        err, (ko, kd), (po, pd), _ = _compare(form, points, src, dst, mask)
        worst = max(worst, err)
        if not kw.get("empty_row"):
            continue
        if form == "sentinel":   # the sentinel stays a candidate
            check(bool((kd[0] == pd[0]).all()) and float(kd[0].min()) > 1.7e6,
                  f"{name}: empty row dist {float(kd[0].min())}")
            check(bool((ko[0] == (1e6 if points else 0)).all()),
                  f"{name}: empty row idx / points")
        else:
            check(bool((kd[0] == 1e15).all()), f"{name}: empty row dist")
            check(bool((ko[0] == 0).all()), f"{name}: empty row idx / points")
    src, dst, mask = _tie_inputs(300 + k)
    err, (ko, kd), _, _ = _compare(form, points, src, dst, mask)
    worst = max(worst, err)
    check(float(kd[0, 0]) == 1.0, f"{name}: tie dist {float(kd[0, 0])}")
    if points:
        j = 9 if form == "sentinel" else 2
        check(np.array_equal(ko[0, 0].cpu().numpy(), dst[0, j]),
              f"{name}: tie took {ko[0, 0].tolist()}, not dst[{j}]")
    else:
        check(int(ko[0, 0]) == 2, f"{name}: tie took j={int(ko[0, 0])}")
    return worst


def phase_kernels():
    from icpflow_tpu_torch.ops import knn
    from icpflow_tpu_torch.ops.cuda import nn_kernel
    rows = {}
    for k, (name, (form, points, _, shapes)) in enumerate(KERNELS.items()):
        worst = _check_edges(name, form, points, k)
        times = []
        for shape in shapes:
            src, dst, mask = _inputs(*shape, 200 + k)
            err, _, _, (s, d, mk) = _compare(form, points, src, dst, mask)
            worst = max(worst, err)
            ms = _time_ms(lambda: nn_kernel.masked_nn_cuda(
                s, d, mk, form=form, points=points))
            plain_ms = _time_ms(lambda: knn.masked_nn_plain(
                s, d, mk, form=form, points=points), iters=3)
            times.append(dict(shape=list(shape), ms=ms, plain_ms=plain_ms))
            print(f"[kernel] {name} B,N,M={shape}: kernel {ms:.4f} ms plain "
                  f"{plain_ms:.4f} ms", flush=True)
        rows[name] = dict(max_abs_err=worst, ms=times[0]["ms"],
                          plain_ms=times[0]["plain_ms"],
                          shape=times[0]["shape"], times=times)
        print(f"[kernel] {name}: max_abs_err {worst:.3g} over the shapes, "
              "the edge cases and the tie", flush=True)
    return rows


def _reset_counts():
    from icpflow_tpu_torch.ops import knn
    from icpflow_tpu_torch.ops.cuda import nn_kernel
    nn_kernel.launches = 0
    nn_kernel.variant_launches.clear()
    knn.plain_calls = 0


def _read_counts():
    from icpflow_tpu_torch.ops import knn
    from icpflow_tpu_torch.ops.cuda import nn_kernel
    return (nn_kernel.launches, dict(nn_kernel.variant_launches),
            knn.plain_calls)


def phase_main_path(card):
    import torch
    from icpflow_tpu_torch import SceneFlowEngine, run_frame_pair
    cfg = bench_config()
    engine = SceneFlowEngine(cfg, device="cuda")
    pairs = scene_pairs(cfg)
    _reset_counts()
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
    launches, per_kernel, plain = _read_counts()
    check(launches > 0, "the frame-pair path launched no NN kernel")
    check(plain == 0, f"the frame-pair path called the plain NN {plain} times")

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


def _run_stream(cfg, scans):
    """One StreamingEngine over the scans on the card. Returns the outputs
    and, per frame, the stage milliseconds (CUDA events) and the total."""
    import torch
    from icpflow_tpu_torch import StreamingEngine
    eng = StreamingEngine(cfg, estimate_ego=True, device="cuda")
    outs, times = [], []
    for scan in scans:
        timings = {}
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        outs.append(eng.process(scan, timings=timings))
        z.record()
        torch.cuda.synchronize()
        timings["total"] = a.elapsed_time(z)
        times.append(timings)
    return outs, times


def phase_stream(card):
    """The stream path under vpu2 and under the default policy."""
    cfg = bench_config()
    scans, ego_gt, gts, dyns = stream_frames()
    _run_stream(cfg, scans[:2])          # warm-up: solver handles, caches
    counts = {}
    for variant in ("vpu2", "auto"):
        old = os.environ.get("ICPFLOW_NN_VARIANT")
        os.environ["ICPFLOW_NN_VARIANT"] = variant
        try:
            _reset_counts()
            outs, times = _run_stream(cfg, scans)
            launches, per_kernel, plain = _read_counts()
        finally:
            if old is None:
                os.environ.pop("ICPFLOW_NN_VARIANT", None)
            else:
                os.environ["ICPFLOW_NN_VARIANT"] = old
        counts[variant] = per_kernel
        check(outs[0] is None, "the first frame returned a result")
        for k in range(1, len(scans)):
            out, w = outs[k], times[k]
            check(out.flow.shape == scans[k].shape,
                  f"flow shape {out.flow.shape}")
            check(bool(np.isfinite(out.flow).all()), "non-finite flow")
            m = pair_metrics(out.flow, gts[k], dyns[k], out.pairs)
            gt_t, gt_r = pose_error(out.pose, ego_gt[k])
            ref = JAX_STREAM_REFERENCE[k]
            ref_pose = np.eye(4)
            ref_pose[:3] = ref["pose"]
            d_t, d_r = pose_error(out.pose, ref_pose)
            print(f"[stream {variant}] frame {k}: {len(scans[k])} pts | "
                  f"pose err vs GT {gt_t:.4f} m {gt_r:.4f} deg, vs JAX "
                  f"{d_t:.5f} m {d_r:.5f} deg | EPE3D {m['epe3d']:.5f} dyn "
                  f"{m['epe3d_dynamic']:.5f} over {m['n_dynamic']} | matched "
                  f"{m['matched']} | warm ms: ego {w['ego']:.1f} ground "
                  f"{w['ground']:.1f} cluster {w['cluster']:.1f} track "
                  f"{w['track']:.1f} flow {w['flow']:.1f} total "
                  f"{w['total']:.1f} | {card}", flush=True)
            check(d_t <= POSE_BAND_M and d_r <= POSE_BAND_DEG,
                  f"{variant} frame {k} pose {d_t:.4f} m {d_r:.4f} deg "
                  "from JAX")
            for key in ("epe3d", "epe3d_dynamic"):
                check(abs(m[key] - ref[key]) <= EPE_BAND,
                      f"{variant} frame {k} {key} {m[key]:.5f} vs JAX "
                      f"{ref[key]:.5f}")
            check(abs(m["matched"] - ref["matched"]) <= MATCHED_BAND,
                  f"{variant} frame {k} matched {m['matched']} vs JAX "
                  f"{ref['matched']}")
        check(launches > 0 and plain == 0,
              f"{variant} stream: {launches} launches, {plain} plain NN calls")
        check(per_kernel.get("nn_elementwise_index", 0) > 0,
              f"{variant} stream: the odometry's exact NN ran no kernel")
        print(f"[stream {variant}] NN kernel launches {launches} "
              f"{per_kernel}, plain NN calls {plain}", flush=True)
    for name in ("nn_sentinel_index", "nn_sentinel_points"):
        check(counts["vpu2"].get(name, 0) > 0,
              f"the vpu2 stream did not launch {name}")
        check(counts["auto"].get(name, 0) == 0,
              f"the default stream launched {name}")
    return counts["vpu2"]


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
    stream_kernel = phase_stream(card)
    table = []
    for name, (form, _, rep, _) in KERNELS.items():
        # launches: the frame-pair path's count; the sentinel kernels run
        # only on the vpu2 stream, whose count they carry
        path = stream_kernel if form == "sentinel" else per_kernel
        check(path.get(name, 0) > 0,
              f"kernel {name} was not launched by its main path")
        table.append(dict(name=name, route="cuda", source=SOURCE,
                          replaces=rep, launches=path[name], **rows[name]))
    print(f"[done] {time.time() - t0:.1f} s", flush=True)
    print(card)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
