"""Smoke run of the PyTorch port (``icpflow_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, any failure ends with a non-zero exit:

1. environment: torch / CUDA / nvcc versions and the card's name and power
   limit; a GPU is required;
2. build: compile the kernel library from ``icpflow_tpu_torch/csrc`` (the
   NN sweep, Kabsch's solve and DBSCAN's neighbour sweep);
3. kernel vs plain: all six kernel instantiations against the plain
   PyTorch version at the main paths' shapes (the stream's exact odometry
   sweep included) and, 20 times over, at edge cases (an empty row,
   duplicates, ragged M, N = 1, an equidistant tie; prefix masks of 0, 1,
   chunk - 1, chunk, chunk + 1 and all dst, a hole of more than two chunks,
   duplicates across a slice boundary, src masks with an all-invalid block,
   one valid point, a prefix and nothing valid; for the merge of a split
   sweep: ties between ranks under each tie rule, a row whose valid dst lie
   in one rank's chunks, M = S chunks and a point, negative expanded-form
   d2), one pass and clusters of 2, 4 and 8 blocks (either output; the
   index output of the elementwise and sentinel forms also over 2, 3 and 5
   dst slices merged by atomicMin) against the wrapper's own choice, bit
   for bit. The nominal index rows are timed at every cluster size.
   Kernel, plain version and the library call (``torch.cdist`` + ``min``,
   timed only) by CUDA events, beside the bound on the valid pairs;
3b. Kabsch: the ``kabsch_solve`` kernel against the plain solve
   (``geometry._kabsch_solve_plain``) bit for bit, R and t: every kind of
   ``kabsch_cases`` alone at B = 1, the kinds mixed at every B of
   ``KABSCH_SIZES`` (1 to 4096), and 100,000 random covariances; no host
   sync in a whole ``geometry.kabsch`` call. After the stream path, the
   kernel, the card's solve (the kernel and the einsums) and the plain
   solve are timed at the batch sizes the pair and stream paths launched
   most (eager; device: replayed from a CUDA graph, and for the plain
   solve, which synchronizes and cannot be captured, the sum of its device
   kernels under ``torch.profiler``), beside the empty kernel;
3c. DBSCAN: the ``dbscan_candidates`` kernel against the plain sweep
   (``cluster._candidates_plain``), counts and edges, every row, 0
   differing values: on the clouds that the benchmark's four cells cluster
   (its generator and entries, one seed each; every ``dbscan`` call of a
   pair, of three stream scans, of a multigap sample), each cell's first
   cloud also under the fixed radius and as ``dbscan_dedup``'s weighted
   representatives under both radii, and on ``dbscan_edge_cases``; the
   dense cloud's labels on the card equal the CPU's; each cell's calls
   launched the kernel once a ``dbscan`` call and the plain sweep never.
   The kernel's device time (``torch.profiler``), the wrapper's (eager and
   replayed from a CUDA graph) and the plain sweep's at each cell's shape,
   beside the bound;
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
   In phases 4 and 5 every traced call holds ``launches.kabsch_solve`` to its
   ``icpflow.kabsch`` spans plus its ICP trips replayed from CUDA graphs
   (a replay's Kabsch has no span).

5b. ICP graphs: a cold stream of 100 frame pairs, each a dense-mix scene
   of its own (``benchmark/traffic``), through ``run_frame_pair`` from an
   empty graph cache, each pair with its ICP trips replayed from CUDA
   graphs and eagerly (the outputs bit for bit equal): the hit share as
   the stream goes on, the mean pair time of either, the cache's bytes; at
   the three most frequent graph keys a replay against the eager trip from
   the same state, bit for bit, and capture, replay and eager trip
   milliseconds; a traced pair seen before replays every trip and
   captures none. In a tree without the graphs (a parent checkout) the
   eager stream alone, timed.

6. offline path: the port's CLI (``icpflow_tpu_torch.cli.run``: npz
   decode, ``DatasetPCA`` with CZM ground removal, GT or estimated ego
   poses and joint clustering in the 262144-slot bucket, gaps 1-4 through
   the matcher, flow on the raw points, the metric sweep) on the scene
   written as a PCAccumulation-format sample, at the bench configuration
   with the held-out protocol's crop, for seeds 7 and 8: with GT poses,
   with ``--if_kiss_icp`` (a fresh root, so no pose cache is read) and,
   seed 7, with GT poses under ``ICPFLOW_NN_VARIANT=vpu2``. Meters, poses,
   non-ground points per frame and labelled clusters per pair are checked
   against ``JAX_OFFLINE_REFERENCE``; stage milliseconds by CUDA events;

7. hdbscan path (``use_hdbscan=True``, the bench configuration): the
   native library present; the exact kNN mutual-reachability graph over
   the gap-1 pair's voxel representatives against a float64 brute force
   (2,048 random rows, within the fp32 rounding of the expanded-form d2)
   and against the same function on the CPU (indices equal, distances
   within 1e-6 m), and the ``knn_graph`` kernel against the plain block
   loop on the card, bit for bit; the hdbscan cell's four joint clouds
   (~224k rows each, the full graph): the kernel against the plain loop
   bit for bit, one call's launches, the kernel's device time beside its
   bound and the plain loop's, and the first pair of the cell's mix through
   ``run_frame_pair`` (the full path, one ``knn_graph`` launch and no plain
   graph); the host copy of the graph timed as hdbscan makes it and as one
   ``.cpu()`` a tensor; the frame pairs of gaps 1 and 4 through
   ``run_frame_pair``, twice each (the dedup path, the occupied voxels
   equal to JAX's, no overflow, NN kernels and no plain NN call, one
   ``knn_graph`` launch a pair and no plain graph),
   gap 1's joint labels against ``hdbscan`` over the same joint cloud on
   the CPU (equal on 99% of the points at least); gap 1 on the voxel-hash
   graph;
   ``cli.run --if_hdbscan`` over seed 7 with GT poses; a scene past the
   representative bucket taking the full graph, counted. Checked against
   ``JAX_HDBSCAN_REFERENCE`` (EPE within 0.005 m, matched pairs and
   clusters within 1); hdbscan's stage milliseconds and the graph's bound
   printed;

8. launch table: the launches per kernel and (B, N, M) are those phases 4
   to 7 and 9 counted (phase 7: the hdbscan frame pairs, whose 200 clusters
   give the matcher other batch sizes; phase 9: rank 0 of the sharded
   run). The paths then run once more with
   every NN launch's
   inputs kept (the same launches, or the run fails), and each is launched
   again alone: valid pairs, kernel milliseconds and bound per kernel and
   (N, M), a pair and a stream frame, ranked by the time lost against the
   bound, with how each was launched (dst slices, split) and how many came
   with a src mask: every index launch must; the largest launch of each is
   held against the plain version, src mask included, and timed like the
   shapes of phase 3; the sweeps that a cluster can split are timed at
   every cluster size, and an empty kernel (``launch_floor``) the same two
   ways.

Each path runs with the trace's ledger of kernel calls cleared just before
it and read just after; it shows it went through the kernels and never through
the plain NN version nor the plain Kabsch solve (phases 4-7), and its
counts are the launches the kernel table reports. The last lines are the card (nvidia-smi), the kernel
table as JSON, and ``{"ok": true, "device": {...}}``.

9. sharded path: the collectives on CUDA tensors (two ranks; each op the
   sharded step and the CLI issue, against its known result); ``cli.run
   --dp 2 --cp 2`` (four ranks started by the call: on one card they share
   it over gloo, on four they take NCCL) over seed 7's offline sample,
   written twice, with GT poses:
   every meter within 1e-4 m of the unsharded run and within the band of
   ``JAX_SHARDED_REFERENCE``, clusters and overflow as JAX's, the NN
   launches of every rank handed back (none plain); ``--dp 4`` (a pair a
   rank: every rank launches); ``run_scaling`` at the widths the cards
   allow. The launch table (phase 8) replays rank 0's launches of the
   (2, 2) run too. ``--sharded`` alone runs on four cards as well.

10. the bench: ``icpflow_tpu_torch.bench.main()`` on the card, whole (the
    headline pair, the held-out protocol of seeds 7, 8 and 9, stage times,
    the NN kernel against its bound, hist and ICP, hdbscan, the
    estimated-ego protocol); its one JSON line is printed on a line of its
    own and must carry every field of ``bench.py``'s line (four renamed),
    skip nothing but the demo fixture, hold every held-out and
    estimated-ego record within EPE_BAND of ``JAX_HELDOUT_REFERENCE``
    (seed 9's worst gap printed), make no plain NN call, and give
    ``kernel_plain_max_err`` 0 and ``0 < nn_util_vs_bound <= 1.05``.

``python3 chip_smoke.py --offline``, ``--hdbscan``, ``--sharded``,
``--bench``, ``--icp-graph``, ``--dbscan`` and ``--kabsch`` run only the
offline, the hdbscan or the sharded path, the bench, the ICP graph phase,
the DBSCAN phase or the Kabsch check (timed at B = 1 and 64) after the
build, and print no result line.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

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
# The JAX package's CLI (``run`` of ``icpflow_tpu/cli.py``) on the same samples
# (XLA:CPU, jax 0.9.0; `python3 tests/torch_smoke_reference.py --offline`;
# seed 7 had 10,611 / 22,749 / 31,065 / 39,159 / 45,036 map points and
# 2,479-2,837 source points, seed 8 10,592-44,925 and 2,431-2,811), per seed
# and ego source ("gt": GT poses, "kiss": ``--if_kiss_icp``): the EPE3D
# meters of ``offline_meter_names()``, the non-ground points of each frame,
# the labelled clusters of each frame pair and, for "kiss", the estimated
# poses' top 3x4 rows. The "kiss" runs were made at ego_map_capacity 65536
# and ego_src_capacity 4096; the script prints the fill counts that show
# nothing was truncated, so the padded capacity does not change the result.
JAX_OFFLINE_REFERENCE = {7: {'gt': {'meters': {'overall_0': 0.0003354838991072029,
                       'dynamic_0': 0.003749481402337551,
                       'static_0': 0.0,
                       'overall_1': 0.0003254579787608236,
                       'dynamic_1': 0.003747359151020646,
                       'static_1': 0.0,
                       'overall_2': 0.00028625759296119213,
                       'dynamic_2': 0.0032036106567829847,
                       'static_2': 0.0,
                       'overall_3': 0.0002889338356908411,
                       'dynamic_3': 0.0031932673882693052,
                       'static_3': 0.0,
                       'overall_4': 0.0004410862165968865,
                       'dynamic_4': 0.0048364694230258465,
                       'static_4': 0.0,
                       'overall_5': 0.0003354838991072029},
            'points': [90203, 90482, 90754, 90890, 90992],
            'nonground': [63868, 64053, 64216, 64311, 64364],
            'clusters': [8, 8, 8, 9]},
     'kiss': {'meters': {'overall_0': 0.0019105359679087996,
                         'dynamic_0': 0.003874522401019931,
                         'static_0': 0.001717540668323636,
                         'overall_1': 0.0014545960584655404,
                         'dynamic_1': 0.0037483188789337873,
                         'static_1': 0.001236439449712634,
                         'overall_2': 0.0016715271631255746,
                         'dynamic_2': 0.003456113627180457,
                         'static_2': 0.001496419426985085,
                         'overall_3': 0.0019306938629597425,
                         'dynamic_3': 0.0032094528432935476,
                         'static_3': 0.0018034783424809575,
                         'overall_4': 0.002582591027021408,
                         'dynamic_4': 0.00506241712719202,
                         'static_4': 0.00233373511582613,
                         'overall_5': 0.0019105359679087996},
              'points': [90203, 90482, 90754, 90890, 90992],
              'nonground': [63868, 64053, 64216, 64311, 64364],
              'clusters': [8, 8, 8, 9],
              'poses': [[[1.0, 0.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0],
                         [0.0, 0.0, 1.0, 0.0]],
                        [[1.0000001192092896, -4.6122611820464954e-05,
                          -5.002430043532513e-06, 1.1006019115447998],
                         [4.614404679159634e-05, 1.0, 4.90063575853128e-05,
                          0.10036304593086243],
                         [5.002072612114716e-06, -4.900856947642751e-05,
                          1.0000001192092896, 0.0011008920846506953]],
                        [[1.0, -3.259550067014061e-05, -1.4016021850693505e-05,
                          2.200529098510742],
                         [3.259338700445369e-05, 1.0, 3.221430961275473e-05,
                          0.2009759098291397],
                         [1.4015539818501566e-05, -3.221514998585917e-05, 1.0,
                          0.001745547167956829]],
                        [[1.0, -5.18773595103994e-05, 2.2750537027604878e-05,
                          3.3011531829833984],
                         [5.187454371480271e-05, 1.0, 7.478041516151279e-05,
                          0.30100560188293457],
                         [-2.2755053578293882e-05, -7.478063344024122e-05,
                          1.0000001192092896, 0.0015333890914916992]],
                        [[0.9999998807907104, -6.485219637397677e-05,
                          -2.447984843456652e-05, 4.399832248687744],
                         [6.484984623966739e-05, 1.0, 6.535615830216557e-05,
                          0.4006277620792389],
                         [2.4473883968312293e-05, -6.53546885587275e-05,
                          0.9999998807907104, 0.0024150600656867027]]]}},
 8: {'gt': {'meters': {'overall_0': 0.0003769993199966848,
                       'dynamic_0': 0.0042066993191838264,
                       'static_0': 0.0,
                       'overall_1': 0.0004070152062922716,
                       'dynamic_1': 0.004684451036155224,
                       'static_1': 0.0,
                       'overall_2': 0.0003511591348797083,
                       'dynamic_2': 0.003934173379093409,
                       'static_2': 0.0,
                       'overall_3': 0.0004978921497240663,
                       'dynamic_3': 0.005494029726833105,
                       'static_3': 0.0,
                       'overall_4': 0.000252176629146561,
                       'dynamic_4': 0.0027502626180648804,
                       'static_4': 0.0,
                       'overall_5': 0.0003769993199966848},
            'points': [90172, 90484, 90750, 90884, 91033],
            'nonground': [63732, 63888, 64061, 64142, 64224],
            'clusters': [8, 8, 8, 9]},
     'kiss': {'meters': {'overall_0': 0.0023020668886601925,
                         'dynamic_0': 0.0040373955853283405,
                         'static_0': 0.002131239278241992,
                         'overall_1': 0.0019644731655716896,
                         'dynamic_1': 0.004623973276466131,
                         'static_1': 0.0017114111687988043,
                         'overall_2': 0.002155255526304245,
                         'dynamic_2': 0.00408421503379941,
                         'static_2': 0.0019662047270685434,
                         'overall_3': 0.002626044675707817,
                         'dynamic_3': 0.004744128789752722,
                         'static_3': 0.0024149660021066666,
                         'overall_4': 0.002460752846673131,
                         'dynamic_4': 0.002741411328315735,
                         'static_4': 0.0024324210826307535,
                         'overall_5': 0.0023020668886601925},
              'points': [90172, 90484, 90750, 90884, 91033],
              'nonground': [63732, 63888, 64061, 64142, 64224],
              'clusters': [8, 8, 8, 9],
              'poses': [[[1.0, 0.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0],
                         [0.0, 0.0, 1.0, 0.0]],
                        [[1.0, -6.117862358223647e-05, 1.9054106132898596e-06,
                          1.1005207300186157],
                         [6.116464646765962e-05, 1.0000001192092896,
                          -1.844921030169644e-06, 0.10068173706531525],
                         [-1.9024171251658117e-06, 1.8429634565109154e-06,
                          1.0000001192092896, 0.0009632353321649134]],
                        [[1.0000001192092896, -4.2606014176271856e-05,
                          1.5176775377767626e-05, 2.200467586517334],
                         [4.259893103153445e-05, 1.0, 1.1115261258964892e-05,
                          0.20029082894325256],
                         [-1.5177704881352838e-05, -1.111587516788859e-05,
                          1.0000001192092896, 0.0016143831890076399]],
                        [[1.0000001192092896, -6.156192830530927e-05,
                          2.5198418370564468e-05, 3.3009531497955322],
                         [6.156126619316638e-05, 1.0, 1.1660989912343211e-05,
                          0.3007555603981018],
                         [-2.5198538423865102e-05, -1.1660935342661105e-05,
                          1.0000001192092896, 0.0017042160034179688]],
                        [[1.0000001192092896, -4.141709359828383e-05,
                          -6.576185114681721e-06, 4.4009318351745605],
                         [4.138169970246963e-05, 1.0000001192092896,
                          -9.698197573015932e-06, 0.40000107884407043],
                         [6.5784452090156265e-06, 9.694539585325401e-06,
                          1.000000238418579, 0.0020787965040653944]]]}}}
# The JAX package with ``use_hdbscan=True`` at the bench configuration on
# the same inputs (XLA:CPU, jax 0.9.0; `python3 tests/torch_smoke_reference.py
# --hdbscan`): the frame pairs of gaps 1 and 4 (exact kNN graph over the
# voxel representatives; ``n_unique``: occupied 0.15 m voxels of the joint
# cloud, under the 32,768-slot bucket), gap 1 on the voxel-hash graph, and
# ``cli.run --if_hdbscan`` over seed 7 with GT poses. The cluster cap (200)
# binds: hdbscan splits the static scene into many small clusters.
JAX_HDBSCAN_REFERENCE = {1: {'epe3d': 0.0004226506862323731,
                             'epe3d_dynamic': 0.004312640987336636,
                             'matched': 200,
                             'clusters': 200,
                             'n_unique': 30842},
                         4: {'epe3d': 0.0002953319053631276,
                             'epe3d_dynamic': 0.002881204942241311,
                             'matched': 199,
                             'clusters': 200,
                             'n_unique': 30871},
                         'voxel_hash': {'epe3d': 0.0004226506862323731,
                                        'epe3d_dynamic': 0.004312640987336636,
                                        'matched': 165,
                                        'clusters': 166},
                         'offline': {'meters': {'overall_0': 0.0003354838991072029,
                                                'dynamic_0': 0.003749481402337551,
                                                'static_0': 0.0,
                                                'overall_1': 0.0003254579787608236,
                                                'dynamic_1': 0.003747359151020646,
                                                'static_1': 0.0,
                                                'overall_2': 0.00028625759296119213,
                                                'dynamic_2': 0.0032036106567829847,
                                                'static_2': 0.0,
                                                'overall_3': 0.0002889338356908411,
                                                'dynamic_3': 0.0031932673882693052,
                                                'static_3': 0.0,
                                                'overall_4': 0.0004410862165968865,
                                                'dynamic_4': 0.0048364694230258465,
                                                'static_4': 0.0,
                                                'overall_5': 0.0003354838991072029},
                                     'points': [90203, 90482, 90754, 90890, 90992],
                                     'nonground': [63868, 64053, 64216, 64311, 64364],
                                     'clusters': [200, 200, 200, 200]}}
# The JAX package's CLI with ``--dp 2 --cp 2`` on a virtual 4-device CPU
# mesh (XLA:CPU, jax 0.9.0; `python3 tests/torch_smoke_reference.py
# --sharded`, ``cli.run`` 150.0 s on the repository's 8-core CPU test host)
# over seed 7's sample with GT poses: the meters of ``offline_meter_names()``
# (equal to the unsharded run's in ``JAX_OFFLINE_REFERENCE`` to the last
# bit: no slice of a pair overflowed), the labelled clusters and the
# overflow of each frame pair.
JAX_SHARDED_REFERENCE = {'meters': {'overall_0': 0.0003354838991072029,
            'dynamic_0': 0.003749481402337551,
            'static_0': 0.0,
            'overall_1': 0.0003254579787608236,
            'dynamic_1': 0.003747359151020646,
            'static_1': 0.0,
            'overall_2': 0.00028625759296119213,
            'dynamic_2': 0.0032036106567829847,
            'static_2': 0.0,
            'overall_3': 0.0002889338356908411,
            'dynamic_3': 0.0031932673882693052,
            'static_3': 0.0,
            'overall_4': 0.0004410862165968865,
            'dynamic_4': 0.0048364694230258465,
            'static_4': 0.0,
            'overall_5': 0.0003354838991072029},
 'clusters': [8, 8, 8, 9],
 'overflow': [0, 0, 0, 0]}
# The JAX bench's held-out protocols (``heldout_eval`` of ``bench.py`` at
# ``make_cfg()``, XLA:CPU, jax 0.9.0; `python3 tests/torch_smoke_reference.py
# --heldout <7|8|9|ego>`, a scene a process: 99.6 / 96.5 / 290.7 /
# 141.2 s on the repository's 8-core CPU test host): (protocol, seed, gap)
# -> EPE3D and dynamic EPE, rounded to 5 decimals as ``heldout_eval`` rounds
# them. Seeds 7 and 8: the waymo-like 5-frame scene; seed 9: the
# nuScenes-like 11-frame cadence (speed 0.833333, gaps 1-10); the estimated
# ego protocol on seed 7 (``use_kiss_icp``; the odometry at the cut
# capacities of the stream reference, the map never full).
JAX_HELDOUT_REFERENCE = {
    ('waymo_like', 7, 1): dict(epe3d=0.00033, epe3d_dynamic=0.00375),
    ('waymo_like', 7, 2): dict(epe3d=0.00029, epe3d_dynamic=0.0032),
    ('waymo_like', 7, 3): dict(epe3d=0.00029, epe3d_dynamic=0.00319),
    ('waymo_like', 7, 4): dict(epe3d=0.00044, epe3d_dynamic=0.00484),
    ('waymo_like', 8, 1): dict(epe3d=0.00041, epe3d_dynamic=0.00468),
    ('waymo_like', 8, 2): dict(epe3d=0.00035, epe3d_dynamic=0.00393),
    ('waymo_like', 8, 3): dict(epe3d=0.0005, epe3d_dynamic=0.00549),
    ('waymo_like', 8, 4): dict(epe3d=0.00025, epe3d_dynamic=0.00275),
    ('nuscene_like', 9, 1): dict(epe3d=0.0003, epe3d_dynamic=0.00341),
    ('nuscene_like', 9, 2): dict(epe3d=0.0004, epe3d_dynamic=0.00454),
    ('nuscene_like', 9, 3): dict(epe3d=0.00059, epe3d_dynamic=0.00648),
    ('nuscene_like', 9, 4): dict(epe3d=0.00029, epe3d_dynamic=0.00322),
    ('nuscene_like', 9, 5): dict(epe3d=0.00047, epe3d_dynamic=0.0051),
    ('nuscene_like', 9, 6): dict(epe3d=0.00037, epe3d_dynamic=0.00408),
    ('nuscene_like', 9, 7): dict(epe3d=0.00072, epe3d_dynamic=0.0049),
    ('nuscene_like', 9, 8): dict(epe3d=0.00059, epe3d_dynamic=0.00405),
    ('nuscene_like', 9, 9): dict(epe3d=0.00074, epe3d_dynamic=0.00423),
    ('nuscene_like', 9, 10): dict(epe3d=0.0006, epe3d_dynamic=0.00346),
    ('waymo_like_ego_est', 7, 1): dict(epe3d=0.00145, epe3d_dynamic=0.00375),
    ('waymo_like_ego_est', 7, 2): dict(epe3d=0.00167, epe3d_dynamic=0.00346),
    ('waymo_like_ego_est', 7, 3): dict(epe3d=0.00193, epe3d_dynamic=0.00321),
    ('waymo_like_ego_est', 7, 4): dict(epe3d=0.00258, epe3d_dynamic=0.00506),
}
# documented knife-edge band of the accuracy guardrails: sub-mm NN
# differences (here: the elementwise or sentinel form on the card vs the
# expanded form everywhere on XLA:CPU) flip borderline ICP basins
EPE_BAND = 0.005
MATCHED_BAND = 1
POSE_BAND_M = 0.01
POSE_BAND_DEG = 0.1

# non-ground points of a frame and labelled clusters of a pair may differ
# from JAX's by this much: an ulp of atan2 or of a plane fit moves a point
# across a CZM sector or the ground threshold, and a cluster at the
# min_cluster_size edge appears or not
NONGROUND_BAND = 0.002          # share of the frame's points
CLUSTER_BAND = 2

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
EXACT_SHAPE = (1, 16384, 262144)     # the odometry's buffers


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def bench_config():
    """bench.py make_cfg(): the configuration the JAX package is benchmarked
    at, kept once in the port's bench."""
    from icpflow_tpu_torch.bench import make_cfg
    return make_cfg()


@functools.lru_cache(maxsize=2)
def _sample(seed):
    """The held-out synthetic scene of ``seed`` as a dict of numpy arrays."""
    from icpflow_tpu_torch.bench import scene_sample
    return scene_sample(NUM_FRAMES, seed)


def scene_pairs(cfg, seed=SEED, gaps=GAPS):
    """(gap, point_src, point_dst, gt_flow, dynamic, translation_frame) of
    the held-out synthetic scene (numpy, made from ``seed``)."""
    from icpflow_tpu_torch.data.synthetic import ego_aligned_pair
    sample = _sample(seed)
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
    sample = _sample(seed)
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


# bench.py heldout_eval(): the held-out protocol's crop and frame count
OFFLINE_FIELDS = dict(dataset="waymo", range_x=32.0, range_y=32.0,
                      range_z=-1.6, ground_slack=0.3, num_frames=NUM_FRAMES)
OFFLINE_SEEDS = (7, 8)
SHARDED_ARGV = ("--dp", "2", "--cp", "2")


def offline_config(kiss):
    """The bench configuration with the held-out protocol's fields."""
    return bench_config().replace(use_kiss_icp=kiss, **OFFLINE_FIELDS)


def offline_argv(root, kiss, device=None, extra=()):
    """The command line of one offline run over the samples in ``root``,
    ``extra`` appended."""
    argv = ["--dataset", "waymo", "--split", "test", "--root", root]
    if kiss:
        argv.append("--if_kiss_icp")
    if device is not None:
        argv += ["--device", device]
    return argv + list(extra)


def offline_meter_names():
    """The meters an offline run is held to: per gap, all points and per
    scene, over all, moving and static points."""
    return [f"{cat}_{k}" for k in range(NUM_FRAMES)
            for cat in ("overall", "dynamic", "static")] + [
                f"overall_{NUM_FRAMES}"]


def offline_counts(pairs):
    """(non-ground points of each frame, labelled clusters of each pair)
    from the (src, dst) label arrays ``DatasetPCA`` hands the matcher."""
    ground = -(10 ** 8)
    nonground = [int((pairs[0]["label_dst"] != ground).sum())] + [
        int((p["label_src"] != ground).sum()) for p in pairs]
    clusters = []
    for p in pairs:
        lab = np.concatenate([p["label_src"], p["label_dst"]])
        clusters.append(int(len(np.unique(lab[lab >= 0]))))
    return nonground, clusters


@contextlib.contextmanager
def capture_prepare(dataset_cls, kept):
    """Append every (data, pairs) that ``dataset_cls._prepare`` returns
    inside the block to ``kept``."""
    orig = dataset_cls._prepare

    def prepare(self, *args, **kw):
        out = orig(self, *args, **kw)
        kept.append(out)
        return out

    dataset_cls._prepare = prepare
    try:
        yield
    finally:
        dataset_cls._prepare = orig


def run_offline(cli, dataset_cls, cfg, seed, kiss, device=None, extra=(),
                timed=None, samples=1, **run_kw):
    """One offline run of ``cli`` (either package's) over the scene of
    ``seed``, written by ``make_sample`` into a fresh directory (as
    ``samples`` samples of the same content, whose meters are then those
    of one: the sums double with the counts). The
    working directory is that directory and the root is relative, so that
    neither the pose cache nor the resume state of another run is read, and
    no word of the path above it ("test", "val", "train") moves the cache.
    ``extra`` is appended to the command line and ``run_kw`` (``timings``,
    ``ranks``) passed to ``cli.run``, which ``timed`` times (by default
    the host clock; ``_timed``: CUDA events). Returns (meters, data, pairs,
    seconds of ``cli.run``, its printed lines)."""
    from icpflow_tpu_torch.data.synthetic import make_sample
    kept, out = [], io.StringIO()
    orig, cwd = cli.config_from_args, os.getcwd()
    with tempfile.TemporaryDirectory() as td:
        os.mkdir(os.path.join(td, "pca"))
        make_sample(os.path.join(td, "pca", f"scene{seed}.npz"),
                    num_frames=NUM_FRAMES, seed=seed)
        for i in range(1, samples):
            shutil.copy(os.path.join(td, "pca", f"scene{seed}.npz"),
                        os.path.join(td, "pca", f"scene{seed}_{i}.npz"))
        args = cli.build_parser().parse_args(
            offline_argv("pca", kiss, device, extra))
        cli.config_from_args = lambda a: cfg
        os.chdir(td)
        try:
            with capture_prepare(dataset_cls, kept), \
                    contextlib.redirect_stdout(out):
                meters, ms = (timed or _host_timed)(
                    lambda: cli.run(args, **run_kw))
        finally:
            os.chdir(cwd)
            cli.config_from_args = orig
    check(len(kept) == samples, f"offline run prepared {len(kept)} samples")
    return (meters, kept[0][0], kept[0][1], ms / 1e3,
            out.getvalue().splitlines())


def pose_error(pose, ref):
    """(translation error m, rotation error deg) of two (4,4) poses."""
    pose = np.asarray(pose, np.float64)
    ref = np.asarray(ref, np.float64)
    r = pose[:3, :3].T @ ref[:3, :3]
    skew = np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])
    ang = np.degrees(np.arctan2(np.linalg.norm(skew) / 2,
                                (np.trace(r) - 1) / 2))
    return float(np.linalg.norm(pose[:3, 3] - ref[:3, 3])), float(ang)


def hdbscan_config(exact=True):
    """The bench configuration with the hdbscan clusterer (the exact kNN
    graph over voxel representatives, or the voxel-hash graph)."""
    return bench_config().replace(use_hdbscan=True, hdbscan_exact=exact)


def pair_clusters(labels_src, labels_dst):
    """Labelled clusters of a frame pair's joint labels."""
    lab = np.concatenate([labels_src, labels_dst])
    return int(len(np.unique(lab[lab >= 0])))


def pair_metrics(flow, gt, dyn, pairs):
    err = np.linalg.norm(flow - gt, axis=-1)
    return dict(epe3d=float(err.mean()),
                epe3d_dynamic=float(err[dyn].mean()) if dyn.any() else 0.0,
                matched=int(len(pairs)), n_dynamic=int(dyn.sum()))


# --------------------------------------------------------------------------
def phase_environment():
    import torch
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    from icpflow_tpu_torch.ops.cuda import library
    nvcc = subprocess.run([library.find_nvcc(), "--version"],
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
    from icpflow_tpu_torch.ops.cuda import library
    path = library.build(force=True)
    library.load()
    print(f"[build] {path.name} from "
          f"{', '.join(p.name for p in library.sources())} in "
          f"{library.build_seconds:.2f} s", flush=True)
    # ptxas -v: registers and spills of every instantiation
    # masked_nn_kernel<form, points output, mode> (mode 0: one pass, 1: dst
    # split with an atomic merge, 2: dst split over a thread-block cluster)
    entries = re.findall(
        r"Compiling entry function '(\S+)' for 'sm_90a'.*?(\d+) bytes stack "
        r"frame, (\d+) bytes spill stores, (\d+) bytes spill loads.*?Used "
        r"(\d+) registers", library.build_log, flags=re.S)
    check(entries, "nvcc printed no ptxas -v lines")
    by_regs = {}
    for sym, stack, st, ld, regs in entries:
        t = re.search(r"masked_nn_kernelILi(\d)ELb([01])ELi(\d)E", sym)
        db = re.search(r"dbscan_candidatesILb([01])ELb([01])E", sym)
        kg = re.search(r"knn_graph_kernelILi(\d+)E", sym)
        other = re.search(r"nn_finish_kernel|empty_kernel|kabsch_solve",
                          sym)
        check(t or db or kg or other,
              f"ptxas -v names an unknown kernel {sym}")
        tag = ("<{},{},{}>".format(*t.groups()) if t else
               "dbscan_candidates<{},{}>".format(*db.groups()) if db else
               "knn_graph_kernel<{}>".format(*kg.groups()) if kg else
               other.group(0))
        check(int(st) == 0 and int(ld) == 0, f"{tag} spills registers")
        by_regs.setdefault((int(regs), int(stack), int(st), int(ld)),
                           []).append(tag)
    for (regs, stack, st, ld), tags in sorted(by_regs.items()):
        print(f"[build] ptxas: {regs} registers, stack {stack} B, spill "
              f"stores {st} B, loads {ld} B: {' '.join(tags)}", flush=True)


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


def _host_timed(fn):
    """(fn(), its milliseconds by the host clock)."""
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def _timed(fn):
    """(fn(), its milliseconds by CUDA events around it)."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    z = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    z.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(z)


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


def _device_ms(fn, iters=10):
    """Milliseconds of device time a call of ``fn``: ``iters`` calls captured
    into one CUDA graph and replayed, so that no host work (the wrapper's
    checks and allocations, the launch itself) sits between the kernels."""
    import torch
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):      # warm up off the default stream
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    z = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    z.record()
    torch.cuda.synchronize()
    return a.elapsed_time(z) / iters


def _valid_pairs(form, src, mask, src_mask=None):
    """(src, dst) pairs a sweep over these inputs needs
    (``knn.valid_pairs``, summed over the batch rows). One device read."""
    from icpflow_tpu_torch.ops import knn
    return float(knn.valid_pairs(form, src, mask, src_mask).sum())


def _bound(form, points, src, mask, src_mask=None):
    """(valid pairs, bound ms, what bounds it) of one launch: the larger of
    its FP32 operations on the valid pairs at the card's peak FP32 rate and
    its bytes at the card's memory rate."""
    from icpflow_tpu_torch.ops.cuda import nn_kernel
    pairs = _valid_pairs(form, src, mask, src_mask)
    ops = nn_kernel.bound_ms(pairs, form, points)
    io = nn_kernel.io_ms(src.shape[0], src.shape[1], mask.shape[1], points,
                         src_mask is not None)
    return pairs, max(ops, io), "operations" if ops >= io else "bytes"


def _library_nn(form, src, dst, mask, budget=1 << 30):
    """The same function by PyTorch's library calls: ``torch.cdist``,
    invalid columns filled with a large value (the sentinel forms move the
    invalid dst instead), ``min`` over dst; in chunks over src that keep
    the distance matrix under ``budget`` elements (4 GB). Only timed here
    as a yardstick; the port never calls it."""
    import torch
    b, n, _ = src.shape
    m = dst.shape[1]
    if form == "sentinel":
        dst = torch.where(mask[:, :, None], dst, torch.full_like(dst, 1e6))
    step = max(1, budget // (b * m))
    out = []
    for i0 in range(0, n, step):
        d = torch.cdist(src[:, i0:i0 + step], dst)
        if form != "sentinel":
            d.masked_fill_(~mask[:, None, :], 1e15)
        out.append(d.min(dim=2))
    return out


def _time_case(name, form, points, s, d, mk, fill, src_mask=None):
    """Kernel, plain and library milliseconds of one input beside its
    bound; prints the ``[kernel]`` line and returns the JSON entry. ``ms``
    is a call of the wrapper in a loop of eager calls (its scratch fill and
    finish pass included; a launch under ~0.05 ms reads the wrapper's host
    time instead), ``device_ms`` the same calls replayed from a CUDA graph."""
    from icpflow_tpu_torch.ops import knn
    from icpflow_tpu_torch.ops.cuda import nn_kernel
    kw = {} if src_mask is None else dict(src_mask=src_mask)

    def kernel():
        return nn_kernel.masked_nn_cuda(s, d, mk, form=form, points=points,
                                        **kw)

    ms = _time_ms(kernel)
    device_ms = _device_ms(kernel)
    plain_ms = _time_ms(lambda: knn.masked_nn_plain(
        s, d, mk, form=form, points=points, **kw), iters=3)
    library_ms = _time_ms(lambda: _library_nn(form, s, d, mk), iters=3)
    pairs, bound, by = _bound(form, points, s, mk, src_mask)
    shape = [s.shape[0], s.shape[1], d.shape[1]]
    entry = dict(shape=shape, fill=fill, valid_pairs=pairs, ms=ms,
                 device_ms=device_ms, plain_ms=plain_ms, bound_ms=bound,
                 bound_by=by, share_of_bound=bound / ms,
                 share_of_bound_device=bound / device_ms,
                 library_ms=library_ms)
    print(f"[kernel] {name} B,N,M={tuple(shape)} {fill}: kernel {ms:.4f} ms "
          f"(device {device_ms:.4f}) plain {plain_ms:.4f} ms library "
          f"{library_ms:.4f} ms | valid pairs {pairs:.4g} of "
          f"{shape[0] * shape[1] * shape[2]:.4g} bound {bound:.4f} ms ({by}) "
          f"share {bound / ms:.3f} (device {bound / device_ms:.3f})",
          flush=True)
    return entry


def _plan_tag(slices, split):
    """A launch's (dst slices, split) in a few letters."""
    return f"S={slices}" + (" atomic" if split == "atomic" else "")


def _time_slices(name, form, points, s, d, mk, fill, src_mask=None):
    """One input of a sweep that a cluster can split, at every cluster
    size: eager and graph-replayed milliseconds beside the bound, the least
    of two rounds taken in turns (1, 2, 4, 8, 8, 4, 2, 1). Prints a
    ``[kernel]`` line a size, marks the size ``launch_plan`` chooses,
    returns the rows."""
    from icpflow_tpu_torch.ops.cuda import nn_kernel
    shape = (s.shape[0], s.shape[1], d.shape[1])
    chosen = nn_kernel.launch_plan(*shape, form, points,
                                   nn_kernel._sm_count(s.device))
    _, bound, _ = _bound(form, points, s, mk, src_mask)
    sizes = list(nn_kernel.CLUSTER_SIZES)
    best = {}
    for slices in sizes + sizes[::-1]:
        def kernel():
            return nn_kernel.masked_nn_cuda(
                s, d, mk, form=form, points=points, src_mask=src_mask,
                slices=slices, split="cluster")
        ms, dev = _time_ms(kernel, iters=50), _device_ms(kernel, iters=50)
        old = best.get(slices, (ms, dev))
        best[slices] = (min(ms, old[0]), min(dev, old[1]))
    rows = []
    for slices in sizes:
        ms, dev = best[slices]
        rows.append(dict(slices=slices, chosen=slices == chosen, ms=ms,
                         device_ms=dev, share_of_bound_device=bound / dev))
        print(f"[kernel] {name} B,N,M={shape} {fill} S={slices}"
              f"{' (chosen)' if slices == chosen else ''}: kernel {ms:.4f} ms "
              f"(device {dev:.4f}) | bound {bound:.4f} ms share "
              f"{bound / ms:.3f} (device {bound / dev:.3f})", flush=True)
    return rows


def _launch_floor():
    """An empty kernel launched the two ways the sweeps are timed: what any
    launch costs, to read the rows of tiny inputs against."""
    from icpflow_tpu_torch.ops.cuda import library
    ms = _time_ms(library.launch_floor, iters=200)
    dev = _device_ms(library.launch_floor, iters=200)
    print(f"[kernel] launch_floor (an empty kernel, one thread): kernel "
          f"{ms:.4f} ms (device {dev:.4f})", flush=True)


def _explain(form, points, arrays, card, outs, src_mask=None, plan=None):
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
             f"B,N,M={src.shape[0]},{src.shape[1]},{dst.shape[1]} launched as "
             f"{plan or 'the wrapper chooses'}, src_mask "
             f"{src_mask is not None}: "
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
        ko2, kd2 = nn_kernel.masked_nn_cuda(
            *tensors, form=form, points=points, src_mask=src_mask,
            **(plan or {}))
        po2, pd2 = knn.masked_nn_plain(*tensors, form=form, points=points,
                                       src_mask=src_mask)
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


def _compare(form, points, src, dst, mask, src_mask=None, plan=None):
    """Kernel vs plain on the card. Returns the max abs dist/point error,
    the kernel's and the plain version's outputs, and the card tensors.
    ``src_mask`` (numpy or None) goes to both; ``plan`` (slices, split)
    overrides how the wrapper would launch."""
    import torch
    from icpflow_tpu_torch.ops import knn
    from icpflow_tpu_torch.ops.cuda import nn_kernel
    s, d, mk = (torch.as_tensor(a, device="cuda") for a in (src, dst, mask))
    sm = None if src_mask is None else torch.as_tensor(src_mask, device="cuda")
    ko, kd = nn_kernel.masked_nn_cuda(s, d, mk, form=form, points=points,
                                      src_mask=sm, **(plan or {}))
    po, pd = knn.masked_nn_plain(s, d, mk, form=form, points=points,
                                 src_mask=sm)
    torch.cuda.synchronize()
    what = (f"{nn_kernel.kernel_name(form, points)} "
            f"B,N,M={src.shape[0]},{src.shape[1]},{dst.shape[1]} launched as "
            f"{plan or 'the wrapper chooses'}"
            f"{'' if sm is None else ' with src_mask'}")

    def agree(cond, msg):
        if not cond:
            try:        # the report must not replace the failure below
                _explain(form, points, (src, dst, mask), (s, d, mk),
                         ((ko, kd), (po, pd)), sm, plan)
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


def _plans(form, points):
    """Launches to hold against each other: {} is the wrapper's own choice.
    Either output of any form splits dst over a cluster of 2, 4 or 8
    blocks; the index output of the elementwise and sentinel forms also
    over any number of blocks by an atomic merge."""
    from icpflow_tpu_torch.ops.cuda.nn_kernel import CLUSTER_SIZES
    plans = [{}] + [dict(slices=size, split="cluster")
                    for size in CLUSTER_SIZES]
    if not points and form != "expanded":
        plans += [dict(slices=count, split="atomic") for count in (2, 3, 5)]
    return plans


def _compare_slices(name, form, points, what, src, dst, mask, sm=None):
    """One input under every launch of ``_plans``: each against the plain
    version and, bit for bit, against the wrapper's own choice. Returns the
    worst error and the kernel's outputs (out, dist)."""
    import torch
    worst, first = 0.0, None
    for plan in _plans(form, points):
        err, out, _, _ = _compare(form, points, src, dst, mask, sm, plan)
        worst = max(worst, err)
        if first is None:
            first = out
        check(torch.equal(out[0], first[0]) and torch.equal(out[1], first[1]),
              f"{name}: {what}: launched as {plan} and by the wrapper's own "
              "choice give different bits")
    return worst, first


def _check_fills(name, form, points, k):
    """Padding, slices and src masks: every slice count against the plain
    version and, bit for bit, against the wrapper's own choice. Returns the
    worst error."""
    import torch
    from icpflow_tpu_torch.ops.cuda.nn_kernel import CHUNK
    rng = np.random.default_rng(500 + k)
    cases = []                       # (what, src, dst, mask, src_mask)
    # N = 300 is no multiple of a block's 128 points; M = 2500 is 5 chunks,
    # the last ragged, so 2 slices hold 3 and 2 of them, 3 hold 2, 2 and 1
    src, dst, _ = _inputs(2, 300, 2500, 500 + k)
    for count in (0, 1, CHUNK - 1, CHUNK, CHUNK + 1, 2500):
        cases.append((f"prefix of {count} dst", src, dst,
                      np.tile(np.arange(2500) < count, (2, 1)),
                      None))
    src, dst, mask = _inputs(2, 300, 5000, 510 + k)
    mask[:, 700:700 + 2 * CHUNK + 400] = False
    cases.append(("a hole of more than two chunks", src, dst, mask, None))
    src, dst, mask = _inputs(2, 300, 3 * CHUNK, 520 + k)
    dst[:, CHUNK:2 * CHUNK] = dst[:, :CHUNK]     # chunk 1 repeats chunk 0:
    mask[:] = True                               # other slice, lower j wins
    cases.append(("duplicates across a slice boundary", src, dst, mask, None))
    src, dst, mask = _inputs(2, 1300, 2500, 530 + k)
    some = rng.random((2, 1300)) < 0.7
    some[:, 128:256] = False                     # an all-invalid block
    some[:, 256:384] = False
    some[:, 300] = True                          # a block with one valid point
    cases.append(("src_mask with holes", src, dst, mask, some))
    cases.append(("src_mask prefix", src, dst, mask,
                  np.tile(np.arange(1300) < 77, (2, 1))))
    cases.append(("src_mask all False", src, dst, mask,
                  np.zeros((2, 1300), bool)))
    # one row against a long, mostly empty buffer: the wrapper's own choice
    # splits dst here, as for the odometry
    src, dst, _ = _inputs(1, 300, 9000, 540 + k)
    cases.append(("prefixes of a long dst", src, dst,
                  np.arange(9000)[None] < 2900, np.arange(300)[None] < 211))
    worst = 0.0
    for what, src, dst, mask, sm in cases:
        err, (ko, kd) = _compare_slices(name, form, points, what, src, dst,
                                        mask, sm)
        worst = max(worst, err)
        if sm is not None:           # masked-out src: idx 0 / zeros, 1e15
            out = torch.as_tensor(~sm, device="cuda")
            check(bool((kd[out] == 1e15).all()) and bool((ko[out] == 0).all()),
                  f"{name}: {what}: masked-out src rows")
        if what.startswith("duplicates") and not points:
            check(bool(((ko < CHUNK) | (ko >= 2 * CHUNK)).all()),
                  f"{name}: {what}: a higher duplicate won")
    return worst


TIES = ((2, 257, 513), (5, 261, 517))    # equidistant dst of src 0 and src 1
ONE_RANK = (256, 512)                    # row 1: the only valid dst


def _merge_inputs(m, seed):
    """Three rows against ``m`` dst slots, for the merge of a split sweep.
    Row 0, all dst valid: src 0 at the origin with three nearest dst at
    distance 1, j = 2, 257 and 513 (j mod 8 = 2, 1, 1), and src 1 at
    (50, 0, 0) with three at j = 5, 261 and 517 (j mod 8 = 5 each); every
    other dst lies 5-15 m from the origin. A cluster's chunks are at most 256
    points and an atomic split's 512, so each trio lies in chunks 0, 1 and 2
    or in chunks 0, 0 and 1: other ranks, whatever the split. Row 1: only
    dst 256-511 are valid (one chunk of either split). Row 2: no valid
    dst."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-1.0, 1.0, (3, 40, 3))
    src[0, 0] = 0.0
    src[0, 1] = (50.0, 0.0, 0.0)
    dst = rng.uniform(5.0, 15.0, (3, m, 3)) * rng.choice([-1.0, 1.0],
                                                       (3, m, 3))
    for i, trio in enumerate(TIES):
        dst[0, trio] = src[0, i] + np.eye(3)
    mask = np.ones((3, m), bool)
    mask[1] = (np.arange(m) >= ONE_RANK[0]) & (np.arange(m) < ONE_RANK[1])
    mask[2] = False
    return src.astype(np.float32), dst.astype(np.float32), mask


def _negative_d2_inputs(seed):
    """Src points ~360 m from the origin, each with two near-copies in dst
    (1e-4 m away, at j and j + one chunk): the expanded form's d2 to them is
    rounding noise of either sign around 1e-8. Returns the inputs and the
    number of src points whose least expanded-form d2 is negative, counted
    with the kernel's sequence of fp32 operations in numpy."""
    from icpflow_tpu_torch.ops.cuda.nn_kernel import CHUNK
    rng = np.random.default_rng(seed)
    n, m = 200, 3 * CHUNK + 1
    src = (rng.uniform(-2.0, 2.0, (2, n, 3))
           + [300.0, -200.0, 10.0]).astype(np.float32)
    dst = (rng.uniform(-2.0, 2.0, (2, m, 3))
           + [300.0, -200.0, 40.0]).astype(np.float32)
    for off in (0, CHUNK):
        dst[:, off:off + n] = src + rng.normal(
            scale=1e-4, size=src.shape).astype(np.float32)
    x = [src[:, :, None, k] for k in range(3)]
    y = [dst[:, None, :, k] for k in range(3)]
    dot = lambda a, c: (a[0] * c[0] + a[1] * c[1]) + a[2] * c[2]  # noqa: E731
    d2 = (dot(x, x) - np.float32(2.0) * dot(x, y)) + dot(y, y)
    assert d2.dtype == np.float32
    return (src, dst, np.ones((2, m), bool)), int((d2.min(axis=2) < 0).sum())


def _check_merge(name, form, points, k):
    """The merge of a split sweep: ties between ranks under each tie rule,
    a row whose valid dst lie in one rank's chunks, a row with none, M = one
    point more than S chunks, a dst of one chunk (a cluster cuts it into S
    parts), N = 1 and negative d2, at every slice count, with and without a
    src mask, against the plain version and, bit for bit, against the
    wrapper's own choice. Returns the worst error."""
    import torch
    from icpflow_tpu_torch.ops.cuda.nn_kernel import CHUNK
    worst = 0.0

    def sweep_all(what, src, dst, mask, sm=None):
        nonlocal worst
        err, out = _compare_slices(name, form, points, what, src, dst, mask,
                                   sm)
        worst = max(worst, err)
        return out

    carry = form == "sentinel" and points        # the (j mod 8) tie rule
    for m in (CHUNK + 8, 2 * CHUNK + 1, 4 * CHUNK + 1, 8 * CHUNK + 1):
        src, dst, mask = _merge_inputs(m, 700 + k)
        keep = np.random.default_rng(710 + k).random(src.shape[:2]) < 0.5
        keep[:, :2] = True                       # the tie rows stay wanted
        for sm in (None, keep):
            what = f"merge at M={m}{'' if sm is None else ' with src_mask'}"
            ko, kd = sweep_all(what, src, dst, mask, sm)
            for i, trio in enumerate(TIES):
                # the lowest index, or the lowest (j mod 8, j div 8)
                j = min(trio, key=lambda t: (t % 8, t // 8)) if carry \
                    else min(trio)
                check(float(kd[0, i]) == 1.0,
                      f"{name}: {what}: tie dist {float(kd[0, i])}")
                took = ko[0, i].cpu().numpy()
                check(np.array_equal(took, dst[0, j]) if points
                      else int(took) == j,
                      f"{name}: {what}: tie {trio} took {took.tolist()}, not "
                      f"j={j}")
            rows = slice(None) if sm is None else torch.as_tensor(
                sm[1], device="cuda")
            lo, hi = ONE_RANK                    # row 1: one of its valid dst
            if points:
                valid = torch.as_tensor(dst[1, lo:hi], device="cuda")
                hit = (ko[1][rows][:, None, :] == valid[None]).all(-1).any(-1)
            else:
                hit = (ko[1][rows] >= lo) & (ko[1][rows] < hi)
            check(bool(hit.all()),
                  f"{name}: {what}: a row left its one valid chunk")
            rows = slice(None) if sm is None else torch.as_tensor(
                sm[2], device="cuda")
            kd2, ko2 = kd[2][rows], ko[2][rows]
            if form == "sentinel":               # row 2: nothing valid
                check(float(kd2.min()) > 1.7e6 and bool(
                    (ko2 == (1e6 if points else 0)).all()),
                    f"{name}: {what}: empty row")
            else:
                check(bool((kd2 == 1e15).all()) and bool((ko2 == 0).all()),
                      f"{name}: {what}: empty row")
    src, dst, mask = _inputs(4, 1, 8 * CHUNK + 1, 720 + k)
    sweep_all("N = 1 against 8 chunks and a point", src, dst, mask)
    # a dst of one chunk, which a cluster cuts into S parts: the j = 2 / j = 9
    # tie (its winner is checked with the edge cases) and a 512-point bucket
    sweep_all("the tie in a dst of 300", *_tie_inputs(740 + k))
    sweep_all("a dst of one chunk", *_inputs(4, 300, CHUNK, 750 + k))
    (src, dst, mask), negative = _negative_d2_inputs(730 + k)
    check(negative > 0, "the negative-d2 case holds no negative d2")
    _, kd = sweep_all("negative expanded-form d2", src, dst, mask)
    if form == "expanded":                       # sqrt(max(d2, 0))
        check(int((kd == 0).sum()) >= negative,
              f"{name}: negative d2: {int((kd == 0).sum())} zero distances "
              f"for {negative} negative minima")
    return worst


EDGE_REPEATS = 20      # a fault that shows once in thousands of checks


def phase_kernels():
    import torch
    rows = {}
    for k, (name, (form, points, _, shapes)) in enumerate(KERNELS.items()):
        worst = 0.0
        for rep in range(EDGE_REPEATS):
            worst = max(worst, _check_edges(name, form, points, k + 1000 * rep),
                        _check_fills(name, form, points, k + 1000 * rep),
                        _check_merge(name, form, points, k + 1000 * rep))
        times = []
        for shape in shapes:
            src, dst, mask = _inputs(*shape, 200 + k)
            err, _, _, (s, d, mk) = _compare(form, points, src, dst, mask)
            worst = max(worst, err)
            times.append(_time_case(name, form, points, s, d, mk,
                                    "random 0.9 mask"))
            if not points and shape != EXACT_SHAPE:
                times[-1]["by_slices"] = _time_slices(
                    name, form, points, s, d, mk, "random 0.9 mask")
            if shape == EXACT_SHAPE:     # every slot of both buffers valid
                full = torch.ones_like(mk)
                times.append(_time_case(
                    name, form, points, s, d, full, "all valid",
                    torch.ones(s.shape[:2], dtype=torch.bool, device="cuda")))
        rows[name] = dict(max_abs_err=worst, times=times)
        print(f"[kernel] {name}: max_abs_err {worst:.3g} over the shapes, "
              f"the edge cases and the tie, each {EDGE_REPEATS} times",
              flush=True)
    return rows


# ------------------------------------------------------------------ Kabsch
KABSCH_KINDS = ("normal", "fractional", "identity", "exact", "far", "empty",
                "below_one", "one_point", "two_points", "coincident",
                "collinear", "coplanar", "reflected", "huge", "tiny", "nan",
                "inf")
KABSCH_POINTS = 64
KABSCH_SIZES = (1, 2, 3, 7, 8, 14, 31, 56, 127, 128, 129, 300, 1000, 2048,
                4095, 4096)
KABSCH_RANDOM_ROWS = 100_000


def _rotation(rng, scale=None):
    """A random rotation; one within about ``scale`` radians of the
    identity where ``scale`` is given."""
    q = (rng.normal(size=4) if scale is None else
         np.concatenate([[1.0], rng.normal(scale=scale / 2, size=3)]))
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


def kabsch_cases(b, seed, first=0):
    """Correspondences for ``geometry.kabsch``: src, dst (b, 64, 3) and
    weights (b, 64), float32. Row r is of kind
    ``KABSCH_KINDS[(first + r) % len(KABSCH_KINDS)]``: a rigid motion with
    noise, fractional weights, the identity, an exact motion, an ICP-like
    small motion 20 m out, and the degenerate and non-finite inputs (no
    weight, a total below one point, one or two points, coincident,
    collinear, coplanar and mirrored clouds, coordinates near 1e18 and
    1e-18, a NaN in src, an inf in dst)."""
    rng = np.random.default_rng(seed)
    n = KABSCH_POINTS
    src = np.zeros((b, n, 3))
    dst = np.zeros((b, n, 3))
    w = np.zeros((b, n))
    for r in range(b):
        kind = KABSCH_KINDS[(first + r) % len(KABSCH_KINDS)]
        x = rng.normal(size=(n, 3)) * rng.uniform(0.2, 3.0, 3)
        rot, tr = _rotation(rng), rng.uniform(-2.0, 2.0, 3)
        wr = (rng.random(n) < 0.8).astype(np.float64)
        noise = 0.01
        if kind == "fractional":
            wr = rng.random(n)
        elif kind == "identity":
            rot, tr, noise = np.eye(3), np.zeros(3), 0.0
        elif kind == "exact":
            noise = 0.0
        elif kind == "far":
            x = x + [18.0, -9.0, 0.5]
            rot, tr = _rotation(rng, 0.02), rng.normal(scale=0.05, size=3)
        elif kind == "empty":
            wr[:] = 0.0
        elif kind == "below_one":
            wr[:] = 0.5 / n
        elif kind == "one_point":
            wr[:] = 0.0
            wr[0] = 1.0
        elif kind == "two_points":
            wr[:] = 0.0
            wr[:2] = 1.0
        elif kind == "coincident":
            x[:] = x[0]
            noise = 0.0
        elif kind == "collinear":
            x = x[0] + rng.normal(size=(n, 1)) * rng.normal(size=3)
            noise = 0.0
        elif kind == "coplanar":
            x[:, 2] = 0.0
            x = x @ _rotation(rng).T
            noise = 0.0
        elif kind == "huge":
            x = x * 1e18
            tr = tr * 1e18
        elif kind == "tiny":
            x = x * 1e-18
            tr, noise = tr * 1e-18, 0.0
        y = x @ rot.T + tr + rng.normal(scale=noise, size=(n, 3))
        if kind == "reflected":
            y = x * [1.0, 1.0, -1.0] + tr
        elif kind == "nan":
            x[3, 1] = np.nan
        elif kind == "inf":
            y[5, 0] = np.inf
        src[r], dst[r], w[r] = x, y, wr
    with np.errstate(over="ignore"):
        return (src.astype(np.float32), dst.astype(np.float32),
                w.astype(np.float32))


def kabsch_random_moments(rows, seed):
    """Random inputs of the solve itself: H (rows,3,3) of entries spread
    over 12 decades, a twentieth of the rows structured (zero, diagonal
    with tied entries, rank one, a NaN or an inf), the weight total (a
    tenth exactly 0 or 1) and the centroids, float32."""
    rng = np.random.default_rng(seed)
    H = rng.normal(size=(rows, 3, 3)) * 10.0 ** rng.uniform(
        -3, 3, (rows, 1, 1)) * 10.0 ** rng.uniform(-3, 3, (rows, 3, 3))
    k = rows // 100
    H[:k] = 0.0
    d = rng.normal(size=(k, 1))
    H[k:2 * k] = np.eye(3) * np.concatenate([d, d, rng.normal(size=(k, 1))],
                                             1)[:, None, :]
    H[2 * k:3 * k] = (rng.normal(size=(k, 3, 1))
                      * rng.normal(size=(k, 1, 3)))
    H[3 * k:4 * k, 1, 2] = np.nan
    H[4 * k:5 * k, 0, 0] = np.inf
    total = rng.uniform(0.0, 3.0, rows)
    total[5 * k:10 * k] = rng.choice([0.0, 1.0], 5 * k)
    mu_s = rng.normal(scale=10.0, size=(rows, 3))
    mu_d = rng.normal(scale=10.0, size=(rows, 3))
    perm = rng.permutation(rows)
    return (H[perm].astype(np.float32), total[perm].astype(np.float32),
            mu_s[perm].astype(np.float32), mu_d[perm].astype(np.float32))


def _kabsch_moments(src, dst, w):
    import torch
    from icpflow_tpu_torch.ops import geometry
    dev = torch.device("cuda")
    return geometry._kabsch_moments(torch.as_tensor(src, device=dev),
                                    torch.as_tensor(dst, device=dev),
                                    torch.as_tensor(w, device=dev))


def _kabsch_compare(tag, H, total, mu_s, mu_d):
    """The card's solve (the kernel and the two einsums) against the plain
    solve on the same card tensors: 0 differing bits in R and t, or a
    report and a failure."""
    import torch
    from icpflow_tpu_torch.ops import geometry
    Rk, tk = geometry._kabsch_solve_cuda(H, total, mu_s, mu_d)
    Rp, tp = geometry._kabsch_solve_plain(H, total, mu_s, mu_d)
    torch.cuda.synchronize()
    b = H.shape[0]
    bad = ((Rk.view(torch.int32) != Rp.view(torch.int32)).reshape(b, -1)
           .any(1) | (tk.view(torch.int32) != tp.view(torch.int32)).any(1))
    rows = torch.nonzero(bad)[:, 0].tolist()
    if rows:
        for r in rows[:5]:
            print(f"[kabsch mismatch] {tag} row {r}: H {H[r].tolist()} total "
                  f"{float(total[r])}\n  kernel R {Rk[r].tolist()} t "
                  f"{tk[r].tolist()}\n  plain  R {Rp[r].tolist()} t "
                  f"{tp[r].tolist()}", file=sys.stderr, flush=True)
    check(not rows, f"[kabsch] {tag}: {len(rows)} of {b} rows differ from "
          "the plain solve")
    return b


def _kabsch_no_sync():
    """A whole ``geometry.kabsch`` call on the card makes no host sync."""
    import torch
    from icpflow_tpu_torch.ops import geometry
    src, dst, w = (torch.as_tensor(a, device="cuda")
                   for a in kabsch_cases(56, 5))
    geometry.kabsch(src, dst, w)
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        geometry.kabsch(src, dst, w)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()


def phase_kabsch():
    """Phase 3b: ``kabsch_solve`` against the plain solve, bit for bit."""
    import torch
    from icpflow_tpu_torch import trace
    t0 = time.perf_counter()
    _reset_counts()
    rows = calls = 0
    for k, kind in enumerate(KABSCH_KINDS):
        rows += _kabsch_compare(f"{kind} B=1", *_kabsch_moments(
            *kabsch_cases(1, 100 + k, first=k)))
        calls += 1
    for b in KABSCH_SIZES:
        rows += _kabsch_compare(f"mixed B={b}", *_kabsch_moments(
            *kabsch_cases(b, b)))
        calls += 1
    dev = torch.device("cuda")
    rows += _kabsch_compare("random", *(
        torch.as_tensor(a, device=dev)
        for a in kabsch_random_moments(KABSCH_RANDOM_ROWS, 11)))
    calls += 1
    counts = trace.launch_counts("kabsch_solve")
    check(counts == {"kabsch_solve": calls, "kabsch_solve_plain": calls},
          f"[kabsch] {dict(counts)} for {calls} calls")
    _kabsch_no_sync()
    print(f"[kabsch] kernel == plain bit for bit, R and t: {rows} rows in "
          f"{calls} calls ({len(KABSCH_KINDS)} kinds alone, B = "
          f"{KABSCH_SIZES[0]}..{KABSCH_SIZES[-1]} mixed, "
          f"{KABSCH_RANDOM_ROWS} random); no host sync in a kabsch call; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


@contextlib.contextmanager
def _kabsch_batches(sizes):
    """Counts the batch size of every Kabsch kernel launch into ``sizes``."""
    from icpflow_tpu_torch.ops.cuda import kabsch
    launch = kabsch.kabsch_solve_cuda

    def counted(H, *args):
        sizes[H.shape[0]] += 1
        return launch(H, *args)

    kabsch.kabsch_solve_cuda = counted
    try:
        yield sizes
    finally:
        kabsch.kabsch_solve_cuda = launch


def _profiled_device_ms(fn, iters=5, name=None):
    """(device ms a call, device kernels a call) of ``fn`` under
    ``torch.profiler``: the sum of its device activities' durations (of
    those whose name holds ``name``, where it is given)."""
    import torch
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    ns, kernels = 0, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda and not e.is_user_annotation() and (
                name is None or name in e.name()):
            ns += e.duration_ns()
            kernels += not e.name().startswith(("Memcpy", "Memset"))
    return ns * 1e-6 / iters, kernels / iters


def phase_kabsch_times(card, sizes):
    """The kernel, the card's solve (the kernel and the two einsums) and
    the plain solve at batch sizes ``sizes`` (the main paths' most
    frequent), and the whole ``geometry.kabsch`` call."""
    import torch
    from icpflow_tpu_torch.ops import geometry
    from icpflow_tpu_torch.ops.cuda import kabsch, library
    floor = _time_ms(library.launch_floor, iters=200)
    floor_dev = _device_ms(library.launch_floor, iters=200)
    for b in sizes:
        src, dst, w = (torch.as_tensor(a, device="cuda")
                       for a in kabsch_cases(b, 7 + b))
        args = geometry._kabsch_moments(src, dst, w)
        kernel = functools.partial(kabsch.kabsch_solve_cuda, *args[:2])
        solve = functools.partial(geometry._kabsch_solve_cuda, *args)
        plain = functools.partial(geometry._kabsch_solve_plain, *args)
        k_ms = _time_ms(kernel, iters=200)
        k_dev = _device_ms(kernel, iters=50)
        s_ms = _time_ms(solve, iters=200)
        s_dev = _device_ms(solve, iters=50)
        s_prof, s_kernels = _profiled_device_ms(solve)
        p_ms = _time_ms(plain, iters=20)
        p_prof, p_kernels = _profiled_device_ms(plain)
        whole = _time_ms(lambda: geometry.kabsch(src, dst, w), iters=100)
        print(f"[kabsch times] B={b}: kernel {k_ms:.4f} ms (device "
              f"{k_dev:.4f}) | card solve {s_ms:.4f} ms (device {s_dev:.4f}, "
              f"profiled {s_prof:.4f}, {s_kernels:.0f} kernels) | plain "
              f"solve {p_ms:.3f} ms (profiled device {p_prof:.3f}, "
              f"{p_kernels:.0f} kernels) | launch floor {floor:.4f} (device "
              f"{floor_dev:.4f}) | whole kabsch call {whole:.4f} ms | {card}",
              flush=True)


# ------------------------------------------------------------------ DBSCAN
# the benchmark's cells whose clouds the sweep is held to, each at one seed
DBSCAN_CELLS = (("av2_pairs.dense", 3100000101),
                ("av2_pairs.sparse", 3200000101),
                ("av2_stream.sessions16", 3300000101),
                ("nuscenes_cli.multigap", 3190000101))
DBSCAN_STREAM_SCANS = 3       # scans of the stream's first session
DBSCAN_DEDUP_VOXEL = 0.15     # dbscan_dedup's voxel, the weighted variants


def dbscan_edge_cases():
    """(tag, xyz (n, 3) float32, valid (n,) bool, mult (n,) int64 or None,
    ``dbscan`` keywords) at the edges of the sweep: nothing valid (nv = 0),
    everything valid (nv = n), n below 2 * cell_cap (rcap = n), runs
    longer than rcap (tt > rcap: scale != 1), every point in one cell,
    neighbours at the radius; fixed and adaptive radius, unweighted and
    weighted."""
    rng = np.random.default_rng(2201)

    def blob(n, scale):
        return (rng.normal(scale=scale, size=(n, 3))
                + [3.0, -2.0, 0.5]).astype(np.float32)

    fixed = dict(eps=0.25, min_points=10, num_clusters=16, cell_cap=64,
                 max_iters=100)
    adaptive = dict(fixed, eps=0.2, eps_scale_per_m=0.05, eps_max=0.5)
    small = dict(fixed, cell_cap=4)
    x = blob(4096, 0.3)
    v = rng.random(4096) < 0.95
    mult = rng.integers(1, 6, 4096)
    one = rng.uniform(10.03, 10.22, (512, 3)).astype(np.float32)
    # 24 points at about eps around each of 400 centres 2 m apart: d_sq
    # lies within a few ulps of eps^2, so any other rounding flips hits
    centres = np.stack(np.meshgrid(np.arange(20.0), np.arange(20.0),
                                   [0.5]), -1).reshape(-1, 3) * 2.0 + 40.0
    u = rng.normal(size=(400, 24, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    ring = np.concatenate([centres[:, None], centres[:, None] + 0.25 * u],
                          1).reshape(-1, 3).astype(np.float32)
    return [
        ("nv = 0", blob(300, 0.5), np.zeros(300, bool), None, fixed),
        ("nv = n", blob(2048, 0.4), np.ones(2048, bool), None, fixed),
        ("nv = n adaptive", blob(2048, 0.4), np.ones(2048, bool), None,
         adaptive),
        ("rcap = n = 100", blob(100, 0.2), rng.random(100) < 0.9, None,
         fixed),
        ("tt > rcap", x, v, None, small),
        ("tt > rcap weighted", x, v, mult, small),
        ("tt > rcap adaptive weighted", x, v, mult, dict(adaptive,
                                                          cell_cap=4)),
        ("one cell", one, np.ones(512, bool), None, fixed),
        ("one cell weighted", one, np.ones(512, bool), mult[:512], fixed),
        ("on the radius", ring, np.ones(len(ring), bool), None, fixed),
    ]


@contextlib.contextmanager
def _captured(module, name, keep):
    """``module.name`` wrapped so that each call's positional arguments and
    keywords go into ``keep``, tensors cloned."""
    import torch
    fn = getattr(module, name)

    def wrapped(*args, **kw):
        keep.append((tuple(a.clone() if isinstance(a, torch.Tensor) else a
                           for a in args), dict(kw)))
        return fn(*args, **kw)

    setattr(module, name, wrapped)
    try:
        yield keep
    finally:
        setattr(module, name, fn)


def _sweeps(call):
    """The arguments of every ``cluster._candidates`` call that ``call()``
    makes."""
    from icpflow_tpu_torch.ops import cluster
    keep = []
    with _captured(cluster, "_candidates", keep):
        call()
    return [args for args, _ in keep]


def _dbscan_compare(tag, args):
    """The kernel against ``_candidates_plain`` on the same card tensors:
    counts and edges, every row of n, 0 differing values, or a report and
    a failure. Returns the values compared."""
    import torch
    from icpflow_tpu_torch.ops import cluster
    from icpflow_tpu_torch.ops.cuda import dbscan as cuda_dbscan
    xyz_s, eps_s, ids_s, mult_s, span, nv, n, rcap, eps, per_m = args
    ck, ek = cuda_dbscan.dbscan_candidates_cuda(
        xyz_s, eps_s, ids_s, mult_s, span, nv, rcap, eps, per_m > 0.0)
    cp, ep = cluster._candidates_plain(*args)
    torch.cuda.synchronize()
    check(ck.shape == cp.shape and ek.shape == ep.shape,
          f"[dbscan] {tag}: shapes {tuple(ck.shape)} {tuple(ek.shape)} vs "
          f"{tuple(cp.shape)} {tuple(ep.shape)}")
    diff = int((ck != cp).sum()) + int((ek != ep).sum())
    if diff:
        rows = torch.nonzero((ck != cp) | (ek != ep).any(1))[:, 0].tolist()
        for r in rows[:5]:
            print(f"[dbscan mismatch] {tag} row {r} (nv {nv}, rcap {rcap}): "
                  f"count kernel {int(ck[r])} plain {int(cp[r])}\n  edges "
                  f"kernel {ek[r].tolist()}\n  edges plain  {ep[r].tolist()}",
                  file=sys.stderr, flush=True)
    check(diff == 0, f"[dbscan] {tag}: {diff} of {ck.numel() + ek.numel()} "
          "values differ from the plain sweep")
    return ck.numel() + ek.numel()


def _dbscan_work(args):
    """(candidate tests, runs with tt > rcap) of one sweep: the sum over
    rows below nv and their 9 runs of min(tt, rcap) clipped at nv."""
    import torch
    from icpflow_tpu_torch.ops import cluster
    xyz_s, eps_s, ids_s, mult_s, span, nv, n, rcap, *_ = args
    deltas = torch.stack([(dx * span[1] + dy) * span[2] - 1
                          for dx, dy in cluster._NBR9])
    lo = ids_s[:nv, None] + deltas[None, :]
    st = torch.searchsorted(ids_s, lo)
    tt = torch.searchsorted(ids_s, lo + 3) - st
    stop = torch.clamp(st + torch.clamp(tt, max=rcap), max=nv)
    return (int(torch.clamp(stop - st, min=0).sum()),
            int((tt > rcap).sum()))


def _dbscan_times(tag, args, card):
    """The kernel (its own device time under ``torch.profiler``; the
    wrapper, its packing copy and the kernel, eager and replayed from a
    CUDA graph) beside the plain sweep on the card (eager; the sum of its
    device kernels) and the kernel's bound: the larger of its compulsory
    bytes at the card's HBM rate and its candidate tests at the card's
    FP32 lane rate (9 lane-operations a test: 3 subtractions, 3 products,
    2 sums, the compare; the adaptive radius 2 more, its min and square),
    the rates the NN kernel's bound takes."""
    from icpflow_tpu_torch.ops import cluster
    from icpflow_tpu_torch.ops.cuda import nn_kernel
    xyz_s, eps_s, ids_s, mult_s, span, nv, n, rcap, eps, per_m = args
    sweep = functools.partial(cluster._candidates, *args)
    plain = functools.partial(cluster._candidates_plain, *args)
    s_ms = _time_ms(sweep, iters=50)
    s_dev = _device_ms(sweep, iters=20)
    k_prof, _ = _profiled_device_ms(sweep, iters=10,
                                    name="dbscan_candidates")
    p_ms = _time_ms(plain, iters=3)
    p_prof, p_kernels = _profiled_device_ms(plain, iters=2)
    tests, over = _dbscan_work(args)
    nbytes = n * (16 + 8) + n * 80 + (0 if mult_s is None else n * 8)
    ops = tests * (11 if per_m > 0.0 else 9)
    bound = 1e3 * max(nbytes / nn_kernel.HBM_BYTES_PER_S,
                      ops / nn_kernel.FP32_LANE_OPS_PER_S)
    print(f"[dbscan times] {tag}: n {n} nv {nv} rcap {rcap} | kernel "
          f"{k_prof:.4f} ms (device, profiled) | wrapper {s_ms:.4f} ms "
          f"(device {s_dev:.4f}) | plain sweep {p_ms:.3f} ms (profiled device "
          f"{p_prof:.3f}, {p_kernels:.0f} kernels) | bound {bound:.4f} ms "
          f"({nbytes / 1e6:.1f} MB, {ops / 1e6:.1f} M lane-ops) | {tests} "
          f"candidate tests "
          f"({tests / max(nv, 1):.1f} a row), {over} runs with tt > rcap | "
          f"{card}", flush=True)


def _dbscan_traced(args, kw):
    """(path, rounds, host syncs) of one traced ``dbscan`` call on the card;
    its ``dbscan_rounds`` counter equals ``info["rounds"]``."""
    import torch
    from icpflow_tpu_torch import trace
    from icpflow_tpu_torch.ops import cluster
    trace.clear()
    info = {}
    with trace.StageClock({}, torch.device("cuda"), "dbscan"):
        cluster.dbscan(*args, info=info, **kw)
    (rec,) = trace.calls()
    trace.clear()
    check(rec.counters["dbscan_rounds"] == info["rounds"],
          f"[dbscan] dbscan_rounds {rec.counters['dbscan_rounds']} != "
          f"info rounds {info['rounds']}")
    return info["path"], info["rounds"], rec.counters.get("host_syncs", 0)


def _dbscan_cell(workload, seed):
    """The cell's program (the benchmark's entry, on the card) over its
    first items until it has clustered: the arguments of every ``dbscan``
    call it made and the ledger's DBSCAN calls meanwhile."""
    from benchmark.manifest import Manifest
    from icpflow_tpu_torch import trace
    from icpflow_tpu_torch.ops import cluster
    man = Manifest()
    cell = man.cell(workload)
    conf = man.config(cell["config"])
    mix = man.mix(cell["traffic"])
    items = man.generator(mix).make(mix, seed)
    entry = man.entry(conf["entry"])(conf, mix, "cuda")
    calls = []
    trace.clear_launches()
    with _captured(cluster, "dbscan", calls):
        if conf["entry"] == "stream":
            for k, scan in enumerate(items[0][:DBSCAN_STREAM_SCANS]):
                entry.call((0, k), scan, None)
        else:
            entry.call(0, items[0], None)
    return calls, trace.launch_counts("dbscan_candidates")


def _dbscan_variants(args, kw):
    """The sweeps of one captured ``dbscan`` input under the program's
    keywords, the fixed radius, and as ``dbscan_dedup``'s weighted
    representatives under both radii: (tag, sweep arguments)."""
    from icpflow_tpu_torch.ops import cluster
    xyz, valid = args[:2]
    fixed = dict(kw, eps_scale_per_m=0.0)
    out = []
    for tag, k in (("", kw), (" fixed", fixed)):
        for a in _sweeps(lambda: cluster.dbscan(*args, **k)):
            out.append((tag, a))
        voxel = min(DBSCAN_DEDUP_VOXEL, 0.5 * k.get("eps", 0.25))
        for a in _sweeps(lambda: cluster.dbscan_dedup(
                xyz, valid, dedup_voxel=voxel, rep_cap=xyz.shape[0], **k)):
            out.append((tag + " dedup", a))
    return out


def phase_dbscan(card):
    """Phase 3c: ``dbscan_candidates`` against the plain sweep, every value
    of every row: on the clouds the benchmark's four cells cluster (the
    program's own calls, and each cell's first cloud again under the fixed
    radius and as dedup representatives, weighted), and on the edge
    cases; the labels of ``dbscan`` on the card equal the CPU's on the
    dense cloud; each cell's calls launched the kernel once a ``dbscan``
    call and never the plain sweep; the kernel timed at each cell's
    shape."""
    import torch
    from icpflow_tpu_torch.ops import cluster
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    values = sweeps = 0
    dense = None
    for workload, seed in DBSCAN_CELLS:
        calls, launches = _dbscan_cell(workload, seed)
        check(calls and launches == {"dbscan_candidates": len(calls)},
              f"[dbscan] {workload}: {dict(launches)} for {len(calls)} "
              "dbscan calls")
        tag = f"{workload} seed {seed}"
        for i, (args, kw) in enumerate(calls):
            cases = (_dbscan_variants(args, kw) if i == 0 else
                     [("", a) for a in _sweeps(
                         lambda: cluster.dbscan(*args, **kw))])
            for var, a in cases:
                values += _dbscan_compare(f"{tag} call {i}{var}", a)
                sweeps += 1
            if i == 0:
                _dbscan_times(tag, cases[0][1], card)
        traced = [_dbscan_traced(a, k) for a, k in calls]
        print(f"[dbscan] {tag}: {len(calls)} dbscan calls, "
              f"{dict(launches)} launches, no plain sweep; n "
              f"{calls[0][0][0].shape[0]}, nv "
              f"{[int(a[1].sum()) for a, _ in calls]}; traced again: path, "
              f"dbscan_rounds, host syncs {traced}", flush=True)
        if dense is None:
            dense = calls[0]
    for tag, xyz, valid, mult, kw in dbscan_edge_cases():
        args = (torch.as_tensor(xyz, device=dev),
                torch.as_tensor(valid, device=dev),
                None if mult is None else torch.as_tensor(mult, device=dev))
        for a in _sweeps(lambda: cluster.dbscan(*args, **kw)):
            values += _dbscan_compare(f"edge {tag}", a)
            sweeps += 1
    args, kw = dense
    info_k, info_c = {}, {}
    card_lab = cluster.dbscan(*args, info=info_k, **kw).cpu()
    cpu_lab = cluster.dbscan(*(a.cpu() for a in args), info=info_c, **kw)
    check(torch.equal(card_lab, cpu_lab),
          f"[dbscan] {DBSCAN_CELLS[0][0]}: the card's labels differ from the "
          f"CPU's on {int((card_lab != cpu_lab).sum())} points")
    print(f"[dbscan] kernel == plain sweep: {values} values of {sweeps} "
          f"sweeps equal ({len(DBSCAN_CELLS)} cells, fixed, adaptive, "
          f"weighted, {len(dbscan_edge_cases())} edge cases); dense labels "
          f"card == CPU ({int(card_lab.max()) + 1} clusters, path "
          f"{info_k['path']} {info_k['rounds']} rounds, CPU {info_c['path']} "
          f"{info_c['rounds']}); {time.perf_counter() - t0:.1f} s",
          flush=True)


def _reset_counts():
    from icpflow_tpu_torch import trace
    trace.clear_launches()


def _check_kabsch_counts(tag):
    """Since ``_reset_counts``: Kabsch ran the kernel, never the plain
    solve."""
    from icpflow_tpu_torch import trace
    counts = trace.launch_counts("kabsch_solve")
    launches, plain = counts["kabsch_solve"], counts["kabsch_solve_plain"]
    check(launches > 0 and plain == 0, f"{tag}: {launches} Kabsch kernel "
          f"launches, {plain} plain Kabsch calls")
    print(f"[kabsch] {tag}: kernel launches {launches}, plain calls {plain}",
          flush=True)


def _check_kabsch_trace(tag):
    """Over the traced calls since ``trace.clear()``: every Kabsch launch
    is an ``icpflow.kabsch`` span or an ICP trip replayed from a CUDA graph
    (whose Kabsch has no span): ``launches.kabsch_solve`` == spans +
    replays."""
    from icpflow_tpu_torch import trace
    calls = trace.calls()
    check(calls, f"{tag}: no traced call")
    spans = replays = launches = 0
    for rec in calls:
        st = rec.spans.get("icpflow.kabsch")
        spans += st.count if st else 0
        replays += rec.counters.get("icp_graph_replays", 0)
        launches += rec.counters.get("launches.kabsch_solve", 0)
    check(launches == spans + replays and replays > 0,
          f"{tag}: launches.kabsch_solve {launches} != icpflow.kabsch spans "
          f"{spans} + replayed trips {replays}")
    print(f"[kabsch] {tag}: launches.kabsch_solve {launches} == icpflow.kabsch "
          f"spans {spans} + replayed trips {replays} over {len(calls)} "
          "traced calls", flush=True)


def _read_counts():
    """Since ``_reset_counts``: (NN kernel launches, by kernel, by (kernel,
    B, N, M), plain NN calls)."""
    from icpflow_tpu_torch import trace
    return (trace.launch_total("nn_"), dict(trace.launch_counts("nn_")),
            {(k, *shape): n for (k, shape), n in
             trace.launch_shapes("nn_").items()},
            trace.launch_total("masked_nn_plain"))


def phase_main_path(card):
    import torch
    from icpflow_tpu_torch import SceneFlowEngine, run_frame_pair, trace
    cfg = bench_config()
    engine = SceneFlowEngine(cfg)          # the default device: the card
    check(engine.device.type == "cuda", f"engine on {engine.device}")
    pairs = scene_pairs(cfg)
    _reset_counts()
    trace.clear()
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
    launches, per_kernel, per_shape, plain = _read_counts()
    check(launches > 0, "the frame-pair path launched no NN kernel")
    check(plain == 0, f"the frame-pair path called the plain NN {plain} times")
    _check_kabsch_counts("frame pairs")
    _check_kabsch_trace("frame pairs")

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
    # every pair ran twice: the counts are those of 2 * len(pairs) pairs
    return per_kernel, (per_shape, 2 * len(pairs))


def _run_stream(cfg, scans):
    """One StreamingEngine over the scans on the card. Returns the outputs
    and, per frame, the stage milliseconds (CUDA events) and the total."""
    import torch
    from icpflow_tpu_torch import StreamingEngine
    eng = StreamingEngine(cfg, estimate_ego=True)     # default: the card
    check(eng.device.type == "cuda" and eng.odo.device.type == "cuda",
          f"stream engine on {eng.device}")
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


@contextlib.contextmanager
def _nn_variant(variant):
    """ICPFLOW_NN_VARIANT set to ``variant`` inside the block."""
    old = os.environ.get("ICPFLOW_NN_VARIANT")
    os.environ["ICPFLOW_NN_VARIANT"] = variant
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("ICPFLOW_NN_VARIANT", None)
        else:
            os.environ["ICPFLOW_NN_VARIANT"] = old


def phase_stream(card):
    """The stream path under vpu2 and under the default policy."""
    from icpflow_tpu_torch import trace
    cfg = bench_config()
    scans, ego_gt, gts, dyns = stream_frames()
    _run_stream(cfg, scans[:2])          # warm-up: solver handles, caches
    counts, shapes = {}, {}
    for variant in ("vpu2", "auto"):
        with _nn_variant(variant):
            _reset_counts()
            trace.clear()
            outs, times = _run_stream(cfg, scans)
            launches, per_kernel, per_shape, plain = _read_counts()
        counts[variant] = per_kernel
        shapes[variant] = (per_shape, len(scans) - 1)
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
        _check_kabsch_counts(f"{variant} stream")
        _check_kabsch_trace(f"{variant} stream")
        check(per_kernel.get("nn_elementwise_index", 0) > 0,
              f"{variant} stream: the odometry's exact NN ran no kernel")
        print(f"[stream {variant}] NN kernel launches {launches} "
              f"{per_kernel}, plain NN calls {plain}", flush=True)
    for name in ("nn_sentinel_index", "nn_sentinel_points"):
        check(counts["vpu2"].get(name, 0) > 0,
              f"the vpu2 stream did not launch {name}")
        check(counts["auto"].get(name, 0) == 0,
              f"the default stream launched {name}")
    return counts["vpu2"], shapes


ICP_COLD_PAIRS = 100        # distinct frame pairs of the cold stream
ICP_COLD_SEED = 3120000000  # their seeds: ICP_COLD_SEED + i
ICP_TIMED_KEYS = 3          # the most frequent graph keys, timed alone


def _dense_mix():
    """(the benchmark's scene generator, its dense mix, the av2_pairs
    configuration), read from ``benchmark/`` by path."""
    import importlib.util
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "benchmark")
    spec = importlib.util.spec_from_file_location(
        "smoke_scenes", os.path.join(root, "traffic", "scenes.py"))
    scenes = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(scenes)
    with open(os.path.join(root, "traffic", "dense.json")) as f:
        mix = json.load(f)
    with open(os.path.join(root, "configs", "av2_pairs.json")) as f:
        conf = json.load(f)
    return scenes, mix, conf


def _cold_pair(scenes, mix, seed):
    """One frame pair of the dense mix in a scene of its own: the layout
    and the noise both drawn from ``seed``."""
    one = dict(mix, scenes=1, extra=dict(mix["extra"], layout_seed=seed))
    (pair,) = scenes.make(one, seed)
    return pair


def _same_outputs(a, b):
    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(a, b))


def phase_icp_graph(card, pairs=ICP_COLD_PAIRS):
    """Phase 5b: ICP's trips replayed from CUDA graphs. A cold stream of
    ``pairs`` frame pairs, each a dense-mix scene of its own, through
    ``run_frame_pair`` from an empty graph cache, each pair once with its
    trips replayed and once eagerly (alternating which goes first): the
    outputs bit-equal, the hit share as the stream goes on, the mean pair
    time of either; at the most frequent keys, a replay against the eager
    trip from the same state (bit for bit), and capture, replay and eager
    trip milliseconds; the cache's bytes; a traced pair's counts. On a
    tree without the graphs (a parent checkout), the eager stream alone."""
    import torch
    from icpflow_tpu_torch import (SceneFlowEngine, config_from_dict,
                                   run_frame_pair, trace)
    from icpflow_tpu_torch.ops import icp
    graphs = hasattr(icp, "graph_cache")
    eager_trips = icp.eager_trips if graphs else contextlib.nullcontext
    scenes, mix, conf = _dense_mix()
    cfg = config_from_dict(conf["pipeline"])
    tf = cfg.translation_frame(int(mix["gap"]))
    engine = SceneFlowEngine(cfg)
    check(engine.device.type == "cuda", f"engine on {engine.device}")

    def run(pair):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_frame_pair(engine, pair[0], pair[1], translation_frame=tf)
        return out, (time.perf_counter() - t0) * 1e3

    warm = _cold_pair(scenes, mix, ICP_COLD_SEED - 1)
    run(warm)
    with eager_trips():
        run(warm)
    if not graphs:
        t0 = time.perf_counter()
        eager = []
        for i in range(pairs):
            eager.append(run(_cold_pair(scenes, mix, ICP_COLD_SEED + i))[1])
        print(f"[icp_graph cold] no graphs in this tree: {pairs} pairs, "
              f"mean pair {np.mean(eager):.2f} ms (median "
              f"{np.median(eager):.2f}), {time.perf_counter() - t0:.1f} s "
              f"| {card}", flush=True)
        return
    icp.clear_graphs()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reserved0 = torch.cuda.memory_reserved()
    capture, replay = icp._capture, icp._replay
    captured, replayed, seen = [0], [0], collections.Counter()
    capture_ms, last = [], {}

    def counted_capture(*args):
        t0 = time.perf_counter()
        g = capture(*args)
        capture_ms.append((time.perf_counter() - t0) * 1e3)
        captured[0] += 1
        return g

    def counted_replay(work, phase, thres, coarse_thr, patience, stall_rel,
                       tile):
        key = icp.graph_key(work, phase, thres, coarse_thr, patience,
                            stall_rel)
        seen[key] += 1
        last[key] = (work, phase, coarse_thr if phase == icp.COARSE
                     else thres, patience, stall_rel, tile)
        replayed[0] += 1
        return replay(work, phase, thres, coarse_thr, patience, stall_rel,
                      tile)

    icp._capture, icp._replay = counted_capture, counted_replay
    t_all = time.perf_counter()
    rows, graph_ms, eager_ms = [], [], []
    try:
        for i in range(pairs):
            pair = _cold_pair(scenes, mix, ICP_COLD_SEED + i)
            c0, r0 = captured[0], replayed[0]
            if i % 2:
                out_g, ms_g = run(pair)
            with eager_trips():
                out_e, ms_e = run(pair)
            if not i % 2:
                out_g, ms_g = run(pair)
            check(_same_outputs(out_g, out_e),
                  f"cold pair {i}: replayed and eager trips differ")
            graph_ms.append(ms_g)
            eager_ms.append(ms_e)
            rows.append((captured[0] - c0, replayed[0] - r0))
    finally:
        icp._capture, icp._replay = capture, replay
    torch.cuda.synchronize()
    caps = np.cumsum([c for c, _ in rows])
    reps = np.cumsum([r for _, r in rows])
    curve = " ".join(f"{n}: {1 - caps[n - 1] / reps[n - 1]:.3f}"
                     for n in sorted({1, 2, 5, 10, 25, 50, 75, 100, pairs})
                     if n <= pairs)
    windows = " ".join(
        f"{a + 1}-{b}: {1 - sum(c for c, _ in rows[a:b]) / max(1, sum(r for _, r in rows[a:b])):.3f}"
        for a, b in ((0, 10), (10, 25), (25, 50), (50, 100)) if b <= pairs)
    print(f"[icp_graph cold] {pairs} distinct pairs (seeds {ICP_COLD_SEED}"
          f"+i, each its own layout): outputs bit-equal replayed vs eager | "
          f"captures {caps[-1]}, replays {reps[-1]}, trips a pair "
          f"{reps[-1] / pairs:.1f} | cumulative hit share after n pairs: "
          f"{curve} | by window: {windows} | {card}", flush=True)
    print(f"[icp_graph cold] mean pair ms: replayed {np.mean(graph_ms):.2f} "
          f"(median {np.median(graph_ms):.2f}), eager {np.mean(eager_ms):.2f}"
          f" (median {np.median(eager_ms):.2f}); pairs 51+: replayed "
          f"{np.mean(graph_ms[50:] or graph_ms):.2f}, eager "
          f"{np.mean(eager_ms[50:] or eager_ms):.2f}; capture ms mean "
          f"{np.mean(capture_ms):.2f} max {np.max(capture_ms):.2f} over "
          f"{len(capture_ms)}; {time.perf_counter() - t_all:.1f} s | {card}",
          flush=True)
    works = {id(w): w for w in icp.graph_cache().values()}
    print(f"[icp_graph cache] {len(icp.graph_cache())} entries (bound "
          f"{icp.GRAPH_CACHE}), {len(works)} working sets, "
          f"{icp.graph_cache_bytes()} B of working sets, largest "
          f"{max(w.nbytes() for w in works.values())} B; reserved "
          f"{(torch.cuda.memory_reserved() - reserved0) / 2**20:.1f} MiB more "
          f"than before the stream; peak allocated over the stream "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB", flush=True)

    # the most frequent keys: a replay against the eager trip from the same
    # state, bit for bit; then capture, replay and eager trip times
    for key, n in seen.most_common(ICP_TIMED_KEYS):
        work, phase, thr, patience, stall_rel, tile = last[key]
        g = icp._graphs.get(key)
        check(g is not None, f"key {key[:5]} left the cache")
        start = {a: getattr(work, a).clone() for a in icp.STATE}

        def restore():
            for a, v in start.items():
                getattr(work, a).copy_(v)
        icp._trip(work, phase, thr, patience, stall_rel, tile)
        eager = {a: getattr(work, a).clone() for a in icp.STATE}
        restore()
        g.graph.replay()
        torch.cuda.synchronize()
        for a in icp.STATE:
            check(torch.equal(getattr(work, a), eager[a]),
                  f"key {key[:5]}: replay and eager trip differ in {a}")

        def timed(fn, iters):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                restore()
                fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / iters

        rest = timed(lambda: None, 50)
        rep = timed(g.graph.replay, 50) - rest
        eag = timed(lambda: icp._trip(work, phase, thr, patience, stall_rel,
                                      tile), 50) - rest
        cap = timed(lambda: icp._capture(work, phase, thr, patience,
                                         stall_rel, tile), 5) - rest
        restore()
        print(f"[icp_graph key] (B, N, M) = {key[:3]} {key[4]} {key[5]}: "
              f"{n} replays in the stream | replay == eager trip bit for "
              f"bit | capture {cap:.3f} ms, replay {rep:.3f} ms, eager trip "
              f"{eag:.3f} ms (host clock to a synchronize, each) | {card}",
              flush=True)

    # a traced pair seen before: every trip a replay, no capture
    trace.clear()
    pair = _cold_pair(scenes, mix, ICP_COLD_SEED)
    run_frame_pair(engine, pair[0], pair[1], translation_frame=tf,
                   timings={})
    (rec,) = trace.calls()
    c = rec.counters
    check(c.get("icp_graph_captures", 0) == 0
          and c.get("icp_graph_replays", 0) == c["icp_iters"] > 0,
          f"traced pair seen before: captures "
          f"{c.get('icp_graph_captures', 0)}, replays "
          f"{c.get('icp_graph_replays', 0)}, trips {c['icp_iters']}")
    _check_kabsch_trace("icp_graph pair")
    trace.clear()


def _check_offline(tag, ref, meters, data, pairs, cluster_band=CLUSTER_BAND):
    """One offline run against the JAX package's: meters within EPE_BAND,
    estimated poses within the pose bands, the counts of non-ground points
    and labelled clusters printed beside JAX's and within their bands."""
    worst = max(abs(meters[k] - ref["meters"][k])
                for k in offline_meter_names())
    nonground, clusters = offline_counts(pairs)
    points = [int((data["time_indice"] == j).sum())
              for j in range(NUM_FRAMES)]
    line = (f"[offline {tag}] overall_0 {meters['overall_0']:.5f} dynamic_0 "
            f"{meters['dynamic_0']:.5f} static_0 {meters['static_0']:.5f} "
            f"overall_{NUM_FRAMES} {meters[f'overall_{NUM_FRAMES}']:.5f} | "
            f"worst meter vs JAX {worst:.5f} m | non-ground per frame "
            f"{nonground} (JAX {ref['nonground']}) of {points} | clusters "
            f"per pair {clusters} (JAX {ref['clusters']})")
    if "poses" in ref:
        errs = []
        for pose, rows in zip(data["ego_poses"], ref["poses"]):
            ref_pose = np.eye(4)
            ref_pose[:3] = rows
            errs.append(pose_error(pose, ref_pose))
        gt = [pose_error(p, g) for p, g in zip(data["ego_poses"],
                                               data["ego_motion_gt"])]
        line += (f" | poses vs JAX {max(e[0] for e in errs):.5f} m "
                 f"{max(e[1] for e in errs):.5f} deg, vs GT "
                 f"{max(e[0] for e in gt):.4f} m {max(e[1] for e in gt):.4f} "
                 "deg")
    print(line, flush=True)
    for k in offline_meter_names():
        check(np.isfinite(meters[k]) and abs(meters[k] - ref["meters"][k])
              <= EPE_BAND, f"offline {tag}: meter {k} {meters[k]:.5f} vs JAX "
              f"{ref['meters'][k]:.5f}")
    check(points == ref["points"], f"offline {tag}: {points} points a frame, "
          f"JAX had {ref['points']}")
    for j, (a, b) in enumerate(zip(nonground, ref["nonground"])):
        check(abs(a - b) <= NONGROUND_BAND * points[j],
              f"offline {tag}: frame {j} has {a} non-ground points, JAX {b}")
    for j, (a, b) in enumerate(zip(clusters, ref["clusters"]), 1):
        check(abs(a - b) <= cluster_band,
              f"offline {tag}: pair {j} has {a} clusters, JAX {b}")
    if "poses" in ref:
        check(max(e[0] for e in errs) <= POSE_BAND_M
              and max(e[1] for e in errs) <= POSE_BAND_DEG,
              f"offline {tag}: poses {errs} from JAX")


def phase_offline(card):
    """The port's CLI over one PCAccumulation-format sample a run, on the
    default device. Returns the launches per kernel of seed 7's runs (GT
    poses, ``--if_kiss_icp``, GT poses under vpu2) and the launches by
    shape of the first, for the launch table."""
    from icpflow_tpu_torch import cli
    from icpflow_tpu_torch.data import native_loader
    from icpflow_tpu_torch.data.pca import DatasetPCA
    check(cli.build_parser().get_default("device") == "cuda",
          "the CLI does not default to the card")
    print(f"[offline] npz decoder: {native_loader.decoder()}", flush=True)
    runs = [(seed, kiss, "auto") for seed in OFFLINE_SEEDS
            for kiss in (False, True)] + [(SEED, False, "vpu2")]
    counts, shapes = {}, None
    for seed, kiss, variant in runs:
        ego = "kiss" if kiss else "gt"
        tag = f"seed {seed} {ego}" + ("" if variant == "auto" else " vpu2")
        timings = []
        with _nn_variant(variant):
            _reset_counts()
            meters, data, pairs, seconds, lines = run_offline(
                cli, DatasetPCA, offline_config(kiss), seed, kiss,
                timings=timings)
            launches, per_kernel, per_shape, plain = _read_counts()
        check(len([ln for ln in lines if " EPE3D: " in ln])
              == 6 * (NUM_FRAMES + 1), f"offline {tag}: the report is short")
        check(not [ln for ln in lines if "WARNING" in ln],
              f"offline {tag}: pairs overflowed their buckets")
        _check_offline(tag, JAX_OFFLINE_REFERENCE[seed][ego], meters, data,
                       pairs)
        t = timings[0]
        print(f"[offline {tag}] cli.run {seconds:.2f} s | ms: load "
              f"{t['load']:.1f} ground {t['ground']:.1f} ego {t['ego']:.1f} "
              f"cluster {t['cluster']:.1f} | pairs (pad / track / flow): "
              + ", ".join(f"{p['pad']:.1f} / {p['track']:.1f} / "
                          f"{p['flow']:.1f}" for p in t["pairs"])
              + f" | {card}", flush=True)
        check(launches > 0 and plain == 0,
              f"offline {tag}: {launches} launches, {plain} plain NN calls")
        _check_kabsch_counts(f"offline {tag}")
        by_shape = ", ".join(f"{k[0]} {k[1]}x{k[2]}x{k[3]}: {c}"
                             for k, c in sorted(per_shape.items()))
        print(f"[launches offline {tag}] NN kernel launches {launches} "
              f"{per_kernel}, plain NN calls {plain} | {by_shape}",
              flush=True)
        if kiss:
            check(per_shape.get(("nn_elementwise_index",) + EXACT_SHAPE, 0)
                  > 0, f"offline {tag}: the odometry's exact NN ran no kernel")
        if seed == SEED:
            counts[ego if variant == "auto" else variant] = per_kernel
            if shapes is None:
                shapes = (per_shape, 1)
    for name in ("nn_sentinel_index", "nn_sentinel_points"):
        check(counts["vpu2"].get(name, 0) > 0,
              f"the vpu2 offline run did not launch {name}")
        check(counts["gt"].get(name, 0) == 0,
              f"the default offline run launched {name}")
    return counts, shapes


HDBSCAN_SUBSET = 2048       # src rows held against a float64 brute force
HDBSCAN_CPU_REPS = 8192     # representatives held against the CPU version
# the fp32 expanded-form d2 of (p, q) is within 16 u (|p|^2 + |q|^2) of the
# true d2 (u = 2^-24; ~15 roundings of terms no larger than that sum):
# ~1e-3 m^2 at 30 m from the origin, where a neighbour's d2 is 0.02-0.09
D2_ROUNDING = 16 * 2.0 ** -24


# lane-operations a (point, candidate) pair of hdbscan's graph needs: nine
# for d2 (three multiplies and two adds for p.q, one multiply by -2, two
# adds of the norms and the exclusion select; the voxel-hash graph's direct
# form: three subtracts, three multiplies, two adds and a square root) and
# one compare of the top-k merge against the running k-th
GRAPH_OPS_PER_PAIR = 10


def _graph_bound(pairs, nbytes):
    """(bound ms, what bounds it) of hdbscan's graph: the larger of its
    lane-operations at the card's peak FP32 rate (no FMA) and its bytes,
    inputs read once and outputs written once, at the memory rate."""
    from icpflow_tpu_torch.ops.cuda import nn_kernel
    ops = pairs * GRAPH_OPS_PER_PAIR / nn_kernel.FP32_LANE_OPS_PER_S * 1e3
    io = nbytes / nn_kernel.HBM_BYTES_PER_S * 1e3
    return max(ops, io), "operations" if ops >= io else "bytes"


def _joint_cloud(engine, src, dst):
    """The padded joint cloud that ``cluster_joint`` clusters: dst, then
    src, each padded to its bucket as ``run_frame_pair`` pads it. Returns
    (points, valid, dst's bucket)."""
    import torch
    (pd, vd), (ps, vs) = engine.pad_cloud(dst), engine.pad_cloud(src)
    return (torch.as_tensor(np.concatenate([pd, ps]), device=engine.device),
            torch.as_tensor(np.concatenate([vd, vs]), device=engine.device),
            len(pd))


def _graph_vs_float64(xyz, valid, mult, k, core, edge_dst, rows):
    """The weighted exact graph of ``rows`` against a float64 brute force
    on the host. Each row's tolerance is twice the fp32 rounding of its
    expanded-form d2, ``e = 2 * D2_ROUNDING * (|p|^2 + max |q|^2)`` over its
    k + 1 nearest: the squared core distance must lie within e of the
    float64 one, and an edge may differ from the float64 k nearest only
    where its float64 d2 lies within e of the k-th. Returns (worst core
    error m, worst core error / tolerance in d2, rows whose edge set
    differs, rows whose difference is not such a near-tie, largest e)."""
    vidx = np.flatnonzero(valid)
    q = xyz[vidx].astype(np.float64)
    qsq = (q * q).sum(1)
    worst = worst_share = e_max = 0.0
    differ = bad = 0
    for r0 in range(0, len(rows), 256):
        r = rows[r0:r0 + 256]
        p = xyz[r].astype(np.float64)
        d2 = ((p[:, None, :] - q[None]) ** 2).sum(-1)
        d2[np.arange(len(r)), np.searchsorted(vidx, r)] = np.inf    # self
        o = np.argsort(d2, axis=1, kind="stable")[:, :k + 1]
        od2 = np.take_along_axis(d2, o, axis=1)
        e = 2 * D2_ROUNDING * ((p * p).sum(1) + qsq[o].max(1))
        e_max = max(e_max, float(e.max()))
        cum = (mult[r] - 1)[:, None] + np.cumsum(mult[vidx[o[:, :k]]], 1)
        first = np.argmax(cum >= k, axis=1)
        want = np.sqrt(od2[np.arange(len(r)), first])
        want = np.where(mult[r] - 1 >= k, 0.0, want)
        got = core[r].astype(np.float64)
        worst = max(worst, float(np.abs(got - want).max()))
        worst_share = max(worst_share,
                          float((np.abs(got ** 2 - want ** 2) / e).max()))
        for i, row in enumerate(r):
            have = set(edge_dst[row].tolist())
            ref = set(vidx[o[i, :k]].tolist())
            if have == ref:
                continue
            differ += 1
            gap = [abs(d2[i, np.searchsorted(vidx, j)] - od2[i, k - 1])
                   for j in have ^ ref]
            bad += max(gap) > e[i]
    return worst, worst_share, differ, bad, e_max


def _check_graph(engine, pair):
    """(b): the exact kNN graph over the gap-1 pair's representatives on
    the card, against a float64 brute force on a random subset of its src
    rows and against the same function on the CPU (the first
    ``HDBSCAN_CPU_REPS`` representatives); its time by CUDA events. Then
    the host copy that ``hdbscan`` makes of the graph and the other arrays
    its host stages read (``hdbscan._fetch``: pinned copies and one
    synchronize) against one ``.cpu()`` a tensor, host work included."""
    import torch
    from icpflow_tpu_torch.ops import cluster, hdbscan
    cfg = engine.cfg
    gap, src, dst = pair[:3]
    pts, valid, _ = _joint_cloud(engine, src, dst)
    rx, rv, rm, point_rep, n_unique = cluster.voxel_dedup_compact(
        pts, valid, voxel=cfg.hdbscan_dedup_voxel, cap=cfg.hdbscan_rep_cap)
    k = min(cfg.min_cluster_size, 30)
    info = {}

    def graph():
        return cluster.exact_knn_mutual_reachability(rx, rv, rm, k=k,
                                                     info=info)

    core, ed, ew = graph()
    ms = _time_ms(graph, iters=3)
    xyz_h, valid_h, mult_h = (t.cpu().numpy() for t in (rx, rv, rm))
    rows = np.sort(np.random.default_rng(SEED).choice(
        np.flatnonzero(valid_h), HDBSCAN_SUBSET, replace=False))
    worst, share, differ, bad, e_max = _graph_vs_float64(
        xyz_h, valid_h, mult_h, k, core.cpu().numpy(), ed.cpu().numpy(),
        rows)
    sub = [t[:HDBSCAN_CPU_REPS] for t in (rx, rv, rm)]
    card = cluster.exact_knn_mutual_reachability(*sub, k=k)
    host = cluster.exact_knn_mutual_reachability(*[t.cpu() for t in sub],
                                                 k=k)
    cpu_err = max(float((a.cpu() - b).abs().max())
                  for a, b in ((card[0], host[0]), (card[2], host[2])))
    cpu_idx = int((card[1].cpu() != host[1]).sum())
    valid_pairs = float(n_unique) * (n_unique - 1)
    n = rx.shape[0]       # xyz, valid, mult in; core, edge_dst, edge_w out
    bound, by = _graph_bound(valid_pairs, n * (12 + 1 + 8 + 4 + 8 * k))
    print(f"[hdbscan graph] gap {gap}: {n_unique} representatives of "
          f"{int(valid.sum())} points, k {k} | {ms:.2f} ms ({info['blocks']} "
          f"blocks of the plain loop; {info['tie_rows']} of "
          f"{info['rows']} rows tie at the k-th / (k+1)-th d2) | "
          f"{_graph_equal(rx, rv, k)[0]} | {valid_pairs:.4g} "
          f"valid pairs, bound {bound:.4f} ms ({by}), share "
          f"{bound / ms:.4f} | vs float64 on {len(rows)} rows: core max err "
          f"{worst:.3g} m ({share:.3f} of the fp32 rounding bound, at most "
          f"{e_max:.3g} m^2), {differ} edge sets differ ({bad} beyond a "
          f"near-tie within that bound) | vs the CPU on {HDBSCAN_CPU_REPS} "
          f"representatives: max err {cpu_err:.3g} m, {cpu_idx} indices "
          "differ", flush=True)
    check(share <= 1.0, f"hdbscan graph: core {worst:.3g} m from float64, "
          f"{share:.3f} of the fp32 rounding bound")
    check(bad == 0, f"hdbscan graph: {bad} edge sets differ from float64 "
          "beyond a near-tie")
    # the same rounded fp32 operations on both: indices equal, distances
    # within a few ulps (6e-8 m measured)
    check(cpu_err <= 1e-6 and cpu_idx == 0,
          f"hdbscan graph: the card and the CPU differ ({cpu_err:.3g} m, "
          f"{cpu_idx} indices)")

    arrays = hdbscan.compress_edges(ed, ew) + (
        rm.to(torch.int32), point_rep.to(torch.int32), rv, valid)
    mb = sum(t.numel() * t.element_size() for t in arrays) / 1e6
    fetch = _time_ms(lambda: hdbscan._fetch(*arrays), iters=20)
    each = _time_ms(lambda: [t.cpu().numpy() for t in arrays], iters=20)
    same = all(np.array_equal(a, t.cpu().numpy()) for a, t in
               zip(hdbscan._fetch(*arrays), arrays))
    print(f"[hdbscan fetch] gap {gap}: {mb:.3f} MB in {len(arrays)} arrays "
          f"| pinned copies and one synchronize (_fetch) {fetch:.3f} ms, one "
          f".cpu() a tensor {each:.3f} ms | equal {same}", flush=True)
    check(same, "hdbscan fetch: _fetch differs from .cpu()")


# the hdbscan cell, whose four joint clouds take the full graph, at a seed
HDBSCAN_CELL = ("av2_pairs_hdbscan.dense", 3124000101)


def _graph_equal(xyz, valid, k):
    """The kernel (``cluster._knn_graph`` on the card) against the plain
    block loop on the card, every bit of every value and index and the tie
    count; fails the run where they differ. Returns (the line's words, the
    plain loop's stats, its host ms)."""
    import torch
    from icpflow_tpu_torch.ops import cluster
    _, q, qsq = cluster.graph_points(xyz, valid)
    got_s, want_s = dict(blocks=0, tie_rows=0), dict(blocks=0, tie_rows=0)
    vals, cols = cluster._knn_graph(q, qsq, k, cluster._GRAPH_BLOCK, got_s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w_vals, w_cols = cluster._knn_graph_plain(q, qsq, k, cluster._GRAPH_BLOCK,
                                              want_s)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    bad_v = int((vals.view(torch.int32) != w_vals.view(torch.int32)).sum())
    bad_c = int((cols != w_cols).sum())
    check(bad_v == 0 and bad_c == 0
          and got_s["tie_rows"] == want_s["tie_rows"],
          f"knn_graph: {bad_v} values and {bad_c} indices differ from the "
          f"plain loop, tie rows {got_s['tie_rows']} vs "
          f"{want_s['tie_rows']}")
    return (f"kernel == plain loop on the card: {vals.numel()} values and "
            f"indices equal, tie rows {got_s['tie_rows']} both", want_s,
            plain_ms)


def _check_full_graph(card):
    """The hdbscan cell's full exact graph on the card: each of the four
    joint clouds of its mix (``HDBSCAN_CELL``, padded as ``run_frame_pair``
    pads them; every one past the representative bucket): the kernel
    against the plain block loop, bit for bit; one call's launches; the
    kernel's device time by ``torch.profiler`` beside the graph's bound
    (``benchmark/layers/hdbscan_bound.py``), the whole call's and the
    plain loop's. Then the mix's first pair through ``run_frame_pair`` on
    the cell's configuration, the ledger cleared just before: the full
    path, one ``knn_graph`` launch, no plain graph."""
    import torch
    from benchmark.layers import hdbscan_bound
    from benchmark.manifest import Manifest
    from icpflow_tpu_torch import (SceneFlowEngine, config_from_dict,
                                   run_frame_pair, trace)
    from icpflow_tpu_torch.ops import cluster
    from icpflow_tpu_torch.ops.cuda import knn_graph
    workload, seed = HDBSCAN_CELL
    man = Manifest()
    cell = man.cell(workload)
    conf = man.config(cell["config"])
    mix = man.mix(cell["traffic"])
    engine = SceneFlowEngine(config_from_dict(conf["pipeline"]))
    k = min(engine.cfg.min_cluster_size, 30)
    items = man.generator(mix).make(mix, seed)
    for i, (src, dst) in enumerate(items):
        pts, valid, _ = _joint_cloud(engine, src, dst)
        m = int(valid.sum())
        trace.clear_launches()
        info = {}
        call = functools.partial(cluster.exact_knn_mutual_reachability, pts,
                                 valid, k=k, info=info)
        call()
        launches = dict(trace.launch_shapes("knn_graph"))
        check(launches == {("knn_graph", (m, k)): 1} and info["blocks"] == 0,
              f"full graph scene {i}: launches {launches}, blocks "
              f"{info['blocks']}")
        trace.clear()
        with trace.StageClock({}, pts.device, "graph"):
            call()
        (rec,) = trace.calls()
        trace.clear()
        traced = {key: n for key, n in rec.counters.items()
                  if key.startswith("launches.knn_graph")}
        check(traced == {"launches.knn_graph": 1},
              f"full graph scene {i}: a traced call counted {traced}")
        same, plain_s, plain_ms = _graph_equal(pts, valid, k)
        _, q, qsq = cluster.graph_points(pts, valid)
        pts4 = torch.cat([q, qsq[:, None]], 1)
        kern, kernels = _profiled_device_ms(
            lambda: knn_graph.knn_graph_cuda(pts4, k), iters=5,
            name="knn_graph")
        whole = _time_ms(call, iters=5)
        bound = hdbscan_bound.bound_ms(m, k)
        print(f"[hdbscan full graph] {workload} seed {seed} scene {i}: {m} "
              f"rows, k {k} | kernel {kern:.3f} ms (device, profiled; "
              f"{kernels:.0f} kernels) | whole call {whole:.3f} ms (eager) "
              f"| bound {bound:.3f} ms (operations), share "
              f"{bound / kern:.4f}, at the kernel's 8 lane-ops a pair "
              f"{8 / hdbscan_bound.GRAPH_OPS_PER_PAIR * bound / kern:.4f} | "
              f"plain loop {plain_ms:.1f} ms "
              f"({plain_s['blocks']} blocks, {plain_s['tie_rows']} tie "
              f"rows) | {same} | launches a call {launches}, traced "
              f"{traced}, blocks {info['blocks']}, tie_rows "
              f"{info['tie_rows']} | {card}", flush=True)

    src, dst = items[0]
    trace.clear_launches()
    run_frame_pair(engine, src, dst,
                   translation_frame=engine.cfg.translation_frame(
                       int(mix["gap"])))
    path = engine.cluster_info["path"]
    shapes = dict(trace.launch_shapes("knn_graph"))
    check(path == "full" and list(shapes.values()) == [1]
          and next(iter(shapes))[0] == "knn_graph",
          f"{workload} pair: path {path}, graph launches {shapes}")
    print(f"[hdbscan full graph] {workload} seed {seed} pair 0 through "
          f"run_frame_pair: path {path}, graph launches {shapes} | {card}",
          flush=True)


def _check_labels(engine, pair, out):
    """A frame pair's joint labels from the card (``run_frame_pair``)
    against ``hdbscan`` over the same joint cloud on the CPU: equal on at
    least 99% of the points. The two graphs agree on every index and within
    a few ulps in distance (``_check_graph``), the f16 fetch absorbs most
    of that, and a near-tie in the spanning tree may still move a few
    fringe points."""
    from icpflow_tpu_torch.ops import hdbscan
    gap, src, dst = pair[:3]
    pts, valid, nd = _joint_cloud(engine, src, dst)
    host, ms = _host_timed(lambda: hdbscan.hdbscan(pts.cpu(), valid.cpu(),
                                                   engine.cfg))
    want = np.concatenate([host[:len(dst)], host[nd:nd + len(src)]])
    got = np.concatenate([out.labels_dst, out.labels_src])
    share = float((got == want).mean())
    clusters = pair_clusters(out.labels_src, out.labels_dst)
    print(f"[hdbscan labels] gap {gap}: the card's joint labels equal the "
          f"CPU's on {share:.6f} of {len(got)} points "
          f"({int((got != want).sum())} differ) | clusters card {clusters} "
          f"CPU {int(want.max()) + 1} | CPU hdbscan {ms:.0f} ms", flush=True)
    check(share >= 0.99, f"hdbscan gap {gap}: the card's labels equal the "
          f"CPU's on {share:.4f} of the points")


def _check_hdbscan_pair(tag, out, gt, dyn, ref):
    """One hdbscan frame pair against GT and the JAX package's numbers."""
    check(out.flow.shape == gt.shape and bool(np.isfinite(out.flow).all()),
          f"hdbscan {tag}: flow shape {out.flow.shape} or non-finite")
    m = pair_metrics(out.flow, gt, dyn, out.pairs)
    clusters = pair_clusters(out.labels_src, out.labels_dst)
    for key in ("epe3d", "epe3d_dynamic"):
        check(abs(m[key] - ref[key]) <= EPE_BAND,
              f"hdbscan {tag} {key} {m[key]:.5f} vs JAX {ref[key]:.5f}")
    check(abs(m["matched"] - ref["matched"]) <= MATCHED_BAND,
          f"hdbscan {tag} matched {m['matched']} vs JAX {ref['matched']}")
    check(abs(clusters - ref["clusters"]) <= 1,
          f"hdbscan {tag} clusters {clusters} vs JAX {ref['clusters']}")
    return m, clusters


def _stage_ms(info):
    return " ".join(f"{k} {v:.1f}" for k, v in info["ms"].items())


def phase_hdbscan(card):
    """``use_hdbscan=True`` on the card: (a) the native library, (b) the
    exact graph (the representatives', then the hdbscan cell's full
    graphs), (c) the frame pairs through ``run_frame_pair``, twice
    each, (d) gap 1 on the voxel-hash graph, (e) ``cli.run --if_hdbscan``
    over seed 7 with GT poses, (f) a scene past the representative bucket.
    Returns the launches per kernel of (c) and, for the launch table, its
    launches by shape."""
    import torch
    from icpflow_tpu_torch import SceneFlowEngine, cli, run_frame_pair, trace
    from icpflow_tpu_torch.ops.hdbscan_tree import get_lib
    from icpflow_tpu_torch.data.pca import DatasetPCA
    from icpflow_tpu_torch.ops import hdbscan
    ref = JAX_HDBSCAN_REFERENCE
    lib = get_lib()
    check(lib is not None,
          "hdbscan: the tree library (csrc/hdbscan_tree.cc) could not be "
          "built (no silent DBSCAN fallback here)")
    engine = SceneFlowEngine(hdbscan_config())
    pairs = scene_pairs(engine.cfg)
    _check_graph(engine, pairs[0])
    _check_full_graph(card)

    overflows = hdbscan.DEDUP_OVERFLOWS
    _reset_counts()
    runs = []
    for gap, src, dst, gt, dyn, tf in pairs:
        for _ in range(2):
            timings = {}
            out, timings["total"] = _timed(lambda: run_frame_pair(
                engine, src, dst, translation_frame=tf, timings=timings))
            runs.append((gap, out, dict(engine.cluster_info), timings))
    launches, per_kernel, per_shape, plain = _read_counts()
    check(launches > 0 and plain == 0, f"hdbscan pairs: {launches} NN "
          f"launches, {plain} plain NN calls")
    _check_kabsch_counts("hdbscan pairs")
    # one exact graph a pair (the representatives'), the kernel's
    graph_shapes = dict(trace.launch_shapes("knn_graph"))
    graph_counts = dict(trace.launch_counts("knn_graph"))
    check(graph_counts == {"knn_graph": len(runs)},
          f"hdbscan pairs: graph launches {graph_counts} over {len(runs)} "
          "pairs")
    check(hdbscan.DEDUP_OVERFLOWS == overflows,
          "hdbscan pairs overflowed the representative bucket")
    for gap, src, dst, gt, dyn, tf in pairs:
        (_, first, _, cold), (_, out, info, w) = [r for r in runs
                                                  if r[0] == gap]
        m, clusters = _check_hdbscan_pair(f"gap {gap}", out, gt, dyn,
                                          ref[gap])
        same = all(np.array_equal(a, b) for a, b in zip(first[:5], out[:5]))
        print(f"[hdbscan] gap {gap}: path {info['path']} n_unique "
              f"{info['n_unique']} (JAX {ref[gap]['n_unique']}) | EPE3D "
              f"{m['epe3d']:.5f} (JAX {ref[gap]['epe3d']:.5f}) dyn "
              f"{m['epe3d_dynamic']:.5f} (JAX "
              f"{ref[gap]['epe3d_dynamic']:.5f}) | matched {m['matched']} "
              f"(JAX {ref[gap]['matched']}) clusters {clusters} (JAX "
              f"{ref[gap]['clusters']}) | runs identical {same} | hdbscan "
              f"ms: {_stage_ms(info)}, graph share of the pair "
              f"{info['ms']['graph'] / w['total']:.3f} | warm ms: cluster "
              f"{w['cluster']:.1f} "
              f"track {w['track']:.1f} flow {w['flow']:.1f} total "
              f"{w['total']:.1f} (cold total {cold['total']:.1f}) | {card}",
              flush=True)
        check(info["path"] == "dedup", f"hdbscan gap {gap}: path "
              f"{info['path']}")
        check(info["n_unique"] == ref[gap]["n_unique"],
              f"hdbscan gap {gap}: {info['n_unique']} voxels, JAX "
              f"{ref[gap]['n_unique']}")
    print(f"[hdbscan] NN kernel launches {launches} {per_kernel}, plain NN "
          f"calls {plain} | graph launches by (kernel, (m, k)) "
          f"{graph_shapes}", flush=True)
    _check_labels(engine, pairs[0], [r[1] for r in runs if r[0] == GAPS[0]][1])

    # (d) the voxel-hash graph
    gap, src, dst, gt, dyn, tf = pairs[0]
    vh = SceneFlowEngine(hdbscan_config(exact=False))
    for _ in range(2):
        timings = {}
        out = run_frame_pair(vh, src, dst, translation_frame=tf,
                             timings=timings)
    info = vh.cluster_info
    check(info["path"] == "voxel_hash", f"voxel-hash path {info['path']}")
    m, clusters = _check_hdbscan_pair("voxel_hash", out, gt, dyn,
                                      ref["voxel_hash"])
    r = ref["voxel_hash"]
    n = 2 * engine.cfg.max_points_scene
    vh_bound, vh_by = _graph_bound(info["graph"]["candidates"],
                                   n * (12 + 1 + 4 + 8 * 3 * 8))
    vh_ms = info["ms"]["graph"]
    print(f"[hdbscan voxel_hash] gap {gap}: EPE3D {m['epe3d']:.5f} (JAX "
          f"{r['epe3d']:.5f}) dyn {m['epe3d_dynamic']:.5f} (JAX "
          f"{r['epe3d_dynamic']:.5f}) | matched {m['matched']} (JAX "
          f"{r['matched']}) clusters {clusters} (JAX {r['clusters']}) | "
          f"hdbscan ms (warm): {_stage_ms(info)} | graph: "
          f"{info['graph']['candidates']:.4g} usable candidate pairs, bound "
          f"{vh_bound:.4f} ms ({vh_by}), share {vh_bound / vh_ms:.4f} | "
          f"cluster {timings['cluster']:.1f} of the pair's "
          f"{sum(timings.values()):.1f} ms | {card}", flush=True)

    # (e) the offline path
    timings = []
    overflows = hdbscan.DEDUP_OVERFLOWS
    _reset_counts()
    meters, data, pairs_off, seconds, lines = run_offline(
        cli, DatasetPCA, offline_config(False).replace(use_hdbscan=True),
        SEED, False, timings=timings)
    launches, _, _, plain = _read_counts()
    _check_kabsch_counts("offline hdbscan")
    check(len([ln for ln in lines if " EPE3D: " in ln])
          == 6 * (NUM_FRAMES + 1), "offline hdbscan: the report is short")
    _check_offline("seed 7 gt hdbscan", ref["offline"], meters, data,
                   pairs_off, cluster_band=1)
    t = timings[0]
    print(f"[offline seed 7 gt hdbscan] cli.run {seconds:.2f} s | ms: load "
          f"{t['load']:.1f} ground {t['ground']:.1f} ego {t['ego']:.1f} "
          f"cluster {t['cluster']:.1f} | dedup overflows "
          f"{hdbscan.DEDUP_OVERFLOWS - overflows} | NN kernel launches "
          f"{launches}, plain NN calls {plain} | {card}", flush=True)
    check(launches > 0 and plain == 0, f"offline hdbscan: {launches} "
          f"launches, {plain} plain NN calls")

    # (f) a scene with more occupied voxels than the bucket: the full graph
    rng = np.random.default_rng(SEED)
    pts = np.concatenate([rng.uniform(-6.0, 6.0, (3000, 3)),
                          rng.normal(scale=0.1, size=(600, 3))]).astype(
                              np.float32)
    cfg = hdbscan_config().replace(hdbscan_rep_cap=64)
    before, info = hdbscan.DEDUP_OVERFLOWS, {}
    lab = hdbscan.hdbscan(torch.as_tensor(pts, device=engine.device),
                          torch.ones(len(pts), dtype=torch.bool,
                                     device=engine.device), cfg, info=info)
    counted = hdbscan.DEDUP_OVERFLOWS - before
    host = hdbscan.hdbscan(torch.as_tensor(pts), torch.ones(len(pts),
                                                            dtype=torch.bool),
                           cfg)
    print(f"[hdbscan overflow] {len(pts)} points, {info['n_unique']} voxels "
          f"> bucket 64: path {info['path']}, overflows counted {counted}, "
          f"clusters {int(lab.max()) + 1}, labels equal to the CPU's "
          f"{bool(np.array_equal(lab, host))}", flush=True)
    check(info["path"] == "full" and counted == 1,
          f"hdbscan overflow: path {info['path']}, {counted} overflows")
    check(np.array_equal(lab, host), "hdbscan overflow: the card's labels "
          "differ from the CPU's")
    # every pair ran twice: the counts are those of 2 * len(pairs) pairs
    return per_kernel, (per_shape, 2 * len(pairs))


# the collectives the sharded step and the CLI issue, by op and dtype
COLLECTIVES = (("all_reduce_min", "float32"), ("all_reduce_min", "int64"),
               ("all_reduce_sum", "float32"), ("all_reduce_sum", "int64"),
               ("all_gather", "float32"), ("all_gather", "int64"),
               ("all_gather", "bool"), ("broadcast", "int64"),
               ("broadcast", "float32"), ("broadcast", "int32"),
               ("broadcast", "bool"))


def _probe_collectives():
    """Every rank of a world on the card(s): each of ``COLLECTIVES`` on
    CUDA tensors against its known result. Raises on the first that fails
    or differs; returns {"op dtype": True} on success."""
    import torch
    import torch.distributed as dist
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device())
    base = torch.arange(6, device=dev)
    out = {}
    for op, name in COLLECTIVES:
        dtype = getattr(torch, name)
        x = ((base + rank) % 2 if dtype == torch.bool else base + rank
             ).to(dtype)
        ranks = [((base + r) % 2 if dtype == torch.bool else base + r
                  ).to(dtype).cpu() for r in range(world)]
        if op == "all_gather":
            parts = [torch.empty_like(x) for _ in range(world)]
            dist.all_gather(parts, x)
            got, want = torch.cat(parts), torch.cat(ranks)
        elif op == "broadcast":
            got = x.clone()
            dist.broadcast(got, 0)
            want = ranks[0]
        else:
            got = x.clone()
            kind = op.split("_")[-1]
            dist.all_reduce(got, op=getattr(dist.ReduceOp, kind.upper()))
            stack = torch.stack(ranks)
            want = stack.amin(0) if kind == "min" else stack.sum(0)
        check(got.is_cuda and torch.equal(got.cpu(), want),
              f"gloo {op} on CUDA {name}: {got.tolist()} != {want.tolist()}")
        out[f"{op} {name}"] = True
    return out


def _rank_launches(ranks):
    """(launches of each rank, plain calls of each rank, launches summed
    over the ranks by kernel name) from ``cli.run(..., ranks=)``."""
    by_name = {}
    for r in ranks:
        for (name, *_), c in r["shape_launches"].items():
            by_name[name] = by_name.get(name, 0) + c
    return ([r["nn_launches"] for r in ranks],
            [r["plain_calls"] for r in ranks], by_name)


def phase_sharded(card):
    """The sharded path on the card: (b) the backend's collectives on CUDA
    tensors, (a) ``cli.run --dp 2 --cp 2`` over seed 7's sample with GT
    poses against the unsharded run and ``JAX_SHARDED_REFERENCE``, then
    ``--dp 4`` (every rank a pair), (c) ``run_scaling`` at the widths the
    cards allow. On one card the ranks share it over gloo; with a card a
    rank they take NCCL. Returns the launches by kernel a sample summed
    over the (2, 2) run's ranks and, for the launch table, rank 0's
    launches by shape."""
    import torch
    from icpflow_tpu_torch import cli
    from icpflow_tpu_torch.data.pca import DatasetPCA
    from icpflow_tpu_torch.parallel.mesh import local_world, pick_backend
    from icpflow_tpu_torch.parallel.scaling import run_scaling
    cards = torch.cuda.device_count()

    # (b) each collective on two ranks
    with local_world(2, "cuda", _probe_collectives) as backend:
        probed = _probe_collectives()
    check(backend == pick_backend("cuda", 2) == ("gloo" if cards < 2
                                                 else "nccl"),
          f"two ranks on {cards} cards took {backend}")
    print(f"[sharded {backend}] 2 ranks on {cards} card(s): {len(probed)} "
          f"of {len(COLLECTIVES)} collectives right on CUDA tensors "
          f"({', '.join(probed)}); no tensor is staged through the host by "
          "the port", flush=True)

    # (a) the sharded CLI against the unsharded one, both after phase 6
    cfg = offline_config(False)
    ref = JAX_SHARDED_REFERENCE
    # two samples of the scene: the second finds every rank warm
    single_t = []
    single, _, _, single_s, _ = run_offline(
        cli, DatasetPCA, cfg, SEED, False, timed=_timed, samples=2,
        timings=single_t)
    runs = {}
    for argv, samples in ((SHARDED_ARGV, 2), (("--dp", "4"), 1)):
        ranks, timings = [], []
        _reset_counts()
        runs[argv] = run_offline(cli, DatasetPCA, cfg, SEED, False,
                                 extra=argv, timed=_timed, samples=samples,
                                 ranks=ranks, timings=timings) + (ranks,
                                                                  timings)
    meters, data, pairs, seconds, lines, ranks, timings = runs[SHARDED_ARGV]
    mesh_line = ("sharded step over mesh dp=2 cp=2 backend="
                 + pick_backend("cuda", 4))
    check(mesh_line in lines, f"sharded: no '{mesh_line}' in {lines[:3]}")
    check(len([ln for ln in lines if " EPE3D: " in ln])
          == 6 * (NUM_FRAMES + 1), "sharded: the report is short")
    worst = max(abs(meters[k] - single[k]) for k in single)
    worst_jax = max(abs(meters[k] - ref["meters"][k])
                    for k in offline_meter_names())
    _, clusters = offline_counts(pairs)
    overflow = [int(m.group(1)) for m in
                (re.search(r"WARNING: (\d+) candidate", ln) for ln in lines)
                if m]
    launches, plain, by_name = _rank_launches(ranks)
    print(f"[sharded dp=2 cp=2] overall_0 {meters['overall_0']:.5f} dynamic_0 "
          f"{meters['dynamic_0']:.5f} | worst meter vs unsharded "
          f"{worst:.2e} m, vs JAX sharded {worst_jax:.5f} m | clusters per "
          f"pair {clusters} (JAX {ref['clusters']}) | overflow warnings "
          f"{overflow} (JAX {ref['overflow']}) | NN launches by rank over 2 "
          f"samples {launches} (sum {sum(launches)}), plain NN calls by rank "
          f"{plain} | {card}", flush=True)
    # the pairs' ms of each sample: the sharded step (rank 0's broadcast
    # and step) against the unsharded track + flow
    step = [t["sharded"]["broadcast"] + t["sharded"]["step"]
            for t in timings]
    pairs_ms = [sum(p["track"] + p["flow"] for p in t["pairs"])
                for t in single_t]
    print(f"[sharded time] two samples of seed 7, cli.run by CUDA events: "
          f"sharded dp=2 cp=2 {seconds:.2f} s (starting 3 rank processes "
          f"included), unsharded {single_s:.2f} s | the pairs of sample 1 "
          f"(cold ranks) / 2 (warm): sharded broadcast + step "
          f"{step[0]:.1f} / {step[1]:.1f} ms, unsharded track + flow "
          f"{pairs_ms[0]:.1f} / {pairs_ms[1]:.1f} ms | {card}", flush=True)
    for k in single:
        check(abs(meters[k] - single[k]) <= 1e-4, f"sharded: meter {k} "
              f"{meters[k]:.6f} vs unsharded {single[k]:.6f}")
    for k in offline_meter_names():
        check(abs(meters[k] - ref["meters"][k]) <= EPE_BAND, f"sharded: "
              f"meter {k} {meters[k]:.5f} vs JAX {ref['meters'][k]:.5f}")
    for j, (a, b) in enumerate(zip(clusters, ref["clusters"]), 1):
        check(abs(a - b) <= CLUSTER_BAND,
              f"sharded: pair {j} has {a} clusters, JAX {b}")
    check(overflow == [o for o in ref["overflow"] if o > 0],
          f"sharded: overflow {overflow}, JAX {ref['overflow']}")
    check(len(ranks) == 4 and sum(launches) > 0 and not any(plain),
          f"sharded: launches {launches}, plain NN calls {plain}")
    check(not any(r["tf32"] for r in ranks), "sharded: TF32 on in a rank")
    check(len(timings) == 2 and all(v % 2 == 0 for v in by_name.values()),
          f"sharded: {len(timings)} samples, launches {by_name}")
    # the valid pairs sit at the front of each pair frame, which is the cp
    # rank 0 slice; the cp rank 1 slices hold none at this sample
    check(launches[0] > 0 and launches[2] > 0,
          f"sharded: the cp rank 0 ranks launched {launches}")

    # --dp 4: one pair a rank, so every rank runs the matcher
    meters4, *_, ranks4, _ = runs[("--dp", "4")]
    launches4, plain4, _ = _rank_launches(ranks4)
    worst4 = max(abs(meters4[k] - single[k]) for k in single)
    print(f"[sharded dp=4] worst meter vs unsharded {worst4:.2e} m | NN "
          f"launches by rank {launches4}, plain NN calls by rank {plain4} | "
          f"cli.run {runs[('--dp', '4')][3]:.2f} s | {card}", flush=True)
    check(worst4 <= 1e-4, f"dp=4: meters {worst4:.3g} m from unsharded")
    check(all(n > 0 for n in launches4) and not any(plain4),
          f"dp=4: launches {launches4}, plain NN calls {plain4}")

    # (c) scaling: one rank a card, the widths the cards allow
    widths = [w for w in (1, 2, 4) if w <= cards]
    scaling = run_scaling([1, 2, 4])
    for r in scaling:
        print(f"[sharded scaling] {json.dumps(r)} | {card}", flush=True)
    check([r["dp"] for r in scaling] == widths
          and all(r["pairs_per_sec"] > 0 for r in scaling),
          f"scaling ran widths {[r['dp'] for r in scaling]} on {cards} cards")
    torch.cuda.synchronize()
    return ({k: v // 2 for k, v in by_name.items()},
            (ranks[0]["shape_launches"], 2))


def _record_launches(run):
    """Run ``run()`` with the inputs of every NN launch cloned on the card,
    ICP's trips eager (a replayed trip launches nothing from Python).
    Returns [(kernel name, src, dst, dst_mask, src_mask | None, (dst
    slices, split)), ...]."""
    from icpflow_tpu_torch.ops import icp
    from icpflow_tpu_torch.ops.cuda import nn_kernel
    rec = []

    def keep(name, src, dst, dst_mask, src_mask, plan):
        rec.append((name, src.clone(), dst.clone(), dst_mask.clone(),
                    None if src_mask is None else src_mask.clone(), plan))

    nn_kernel.on_launch = keep
    try:
        with icp.eager_trips():
            run()
    finally:
        nn_kernel.on_launch = None
    return rec


def _replay(label, unit, units, rec, counted, reps):
    """Launch every recorded input again, alone and timed by CUDA events,
    beside its valid pairs and its bound. Prints, per kernel and (N, M), the
    launches and milliseconds a ``unit`` (the record holds ``units`` of
    them) and returns those rows per kernel name, ranked by the time lost
    against the bound. The launches are not the record's: they are
    ``counted``, what the trace's ledger of kernel calls read after the path's
    own run, as ({(kernel, B, N, M): launches}, units of that run); the
    record must hold the same launches a unit, or the run fails. ``reps``
    keeps the largest launch of each (kernel, N, M) for the
    kernel-vs-plain-vs-library timing. Every index launch must have come
    with a src mask (every caller reads its distances under one)."""
    from icpflow_tpu_torch.ops.cuda import nn_kernel
    per_shape, counted_units = counted
    recorded = {}
    bare = set()
    for name, s, d, _, sm, _ in rec:
        key = (name, s.shape[0], s.shape[1], d.shape[1])
        recorded[key] = recorded.get(key, 0) + 1
        if sm is None and not KERNELS[name][1]:
            bare.add(key)
    check(not bare, f"{label}: index launches without a src mask: "
          f"{sorted(bare)[:6]}")
    differ = sorted(k for k in set(recorded) | set(per_shape)
                    if recorded.get(k, 0) * counted_units
                    != per_shape.get(k, 0) * units)
    check(not differ,
          f"{label}: the recording pass ({units} {unit}s) and the path's own "
          f"run ({counted_units}) launched differently at " + ", ".join(
              f"{k}: {recorded.get(k, 0)} vs {per_shape.get(k, 0)}"
              for k in differ[:6]))
    groups = {}
    for name, s, d, mk, sm, plan in rec:
        form, points = KERNELS[name][:2]
        kw = {} if sm is None else dict(src_mask=sm)
        ms = _time_ms(lambda: nn_kernel.masked_nn_cuda(
            s, d, mk, form=form, points=points, **kw), iters=3)
        pairs, bound, _ = _bound(form, points, s, mk, sm)
        b, n, m = s.shape[0], s.shape[1], d.shape[1]
        g = groups.setdefault((name, n, m), dict(
            n=n, m=m, b_min=b, b_max=b, launches=0, valid_pairs=0.0,
            swept_pairs=0.0, kernel_ms=0.0, bound_ms=0.0, shapes={},
            plans=[], src_masked=0))
        if _plan_tag(*plan) not in g["plans"]:
            g["plans"].append(_plan_tag(*plan))
        g["src_masked"] += sm is not None
        g["b_min"], g["b_max"] = min(g["b_min"], b), max(g["b_max"], b)
        g["valid_pairs"] += pairs
        g["swept_pairs"] += float(b) * n * m
        g["kernel_ms"] += ms
        g["bound_ms"] += bound
        if (name, n, m) not in reps or reps[name, n, m][0] <= b:
            reps[name, n, m] = (b, label, (s, d, mk, sm))
    out = {}
    ranked = sorted(groups.items(),
                    key=lambda kv: kv[1]["bound_ms"] - kv[1]["kernel_ms"])
    for rank, ((name, n, m), g) in enumerate(ranked, 1):
        for key in ("valid_pairs", "swept_pairs", "kernel_ms", "bound_ms"):
            g[key] /= units
        # [B, launches in the path's own run of ``counted_units`` units]
        g["shapes"] = sorted([k[1], c] for k, c in per_shape.items()
                             if (k[0], k[2], k[3]) == (name, n, m))
        g["launches"] = sum(c for _, c in g["shapes"]) / counted_units
        g["lost_ms"] = g["kernel_ms"] - g["bound_ms"]
        out.setdefault(name, []).append(g)
        g["src_masked"] /= units
        print(f"[launches {label}] {rank}. {name} N,M={n},{m} B "
              f"{g['b_min']}-{g['b_max']}: {g['launches']:.2f} launches a "
              f"{unit} ({g['src_masked']:.2f} with a src mask) as "
              f"{', '.join(sorted(g['plans']))} | valid pairs "
              f"{g['valid_pairs']:.4g} of {g['swept_pairs']:.4g} swept | kernel {g['kernel_ms']:.4f} ms "
              f"bound {g['bound_ms']:.4f} ms lost {g['lost_ms']:.4f} ms a "
              f"{unit}", flush=True)
    return out


def phase_launch_table(rows, counted):
    """Launches by shape on each path as its own run counted them
    (``counted``: label -> ({(kernel, B, N, M): launches}, units)), beside
    their fill and time from a pass of its own that no path's time includes:
    every launch's inputs are kept, then launched again alone for the
    kernel's time beside its bound. The largest launch of each (kernel, N,
    M) is then held against the plain version as the path launched it and
    timed against it and the library call. Adds ``paths`` and the main-path
    entries of ``times`` to ``rows``."""
    import torch
    from icpflow_tpu_torch import SceneFlowEngine, run_frame_pair
    from icpflow_tpu_torch.ops.cuda import nn_kernel
    cfg = bench_config()
    engine = SceneFlowEngine(cfg)
    hdb = SceneFlowEngine(hdbscan_config())
    pairs = scene_pairs(cfg)
    scans = stream_frames()[0]
    reps = {}

    def run_pairs(eng=engine):
        for _, src, dst, _, _, tf in pairs:
            run_frame_pair(eng, src, dst, translation_frame=tf)

    def run_stream(variant):
        with _nn_variant(variant):
            _run_stream(cfg, scans)

    def run_sample(extra=()):
        from icpflow_tpu_torch import cli
        from icpflow_tpu_torch.data.pca import DatasetPCA
        run_offline(cli, DatasetPCA, offline_config(False), SEED, False,
                    extra=extra)

    paths = [("pair", "pair", len(pairs), run_pairs),
             ("stream vpu2", "frame", len(scans) - 1,
              lambda: run_stream("vpu2")),
             ("stream default", "frame", len(scans) - 1,
              lambda: run_stream("auto")),
             ("offline", "sample", 1, run_sample),
             ("hdbscan pair", "pair", len(pairs), lambda: run_pairs(hdb)),
             ("sharded rank 0", "sample", 1,
              lambda: run_sample(SHARDED_ARGV))]
    for label, unit, units, run in paths:
        rec = _record_launches(run)
        for name, groups in _replay(label, unit, units, rec, counted[label],
                                    reps).items():
            rows[name].setdefault("paths", {})[label] = groups
        del rec
        torch.cuda.empty_cache()
    main_times = {}
    for (name, n, m), (b, label, (s, d, mk, sm)) in reps.items():
        form, points = KERNELS[name][:2]
        err = _compare(form, points, s.cpu().numpy(), d.cpu().numpy(),
                       mk.cpu().numpy(),
                       None if sm is None else sm.cpu().numpy())[0]
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
        entry = _time_case(name, form, points, s, d, mk,
                           f"main path ({label})", sm)
        if nn_kernel.split_kind(form, points, m) == "cluster":
            entry["by_slices"] = _time_slices(
                name, form, points, s, d, mk, f"main path ({label})", sm)
        main_times.setdefault(name, []).append(entry)
    _launch_floor()
    for name, entries in main_times.items():
        entries.sort(key=lambda e: -e["bound_ms"])
        rows[name]["times"] = entries + rows[name]["times"]


# the fields of bench.py's line (four renamed: kern_nn_vpu_ms,
# kern_nn_mxu_ms, pallas_xla_max_err, compile_s) and those the port adds
BENCH_FIELDS = (
    "metric", "value", "unit", "vs_baseline", "timing", "pairs_per_sec_min",
    "pairs_per_sec_max", "epe3d", "epe3d_dynamic", "acc3ds", "ref_epe3d",
    "ref_epe3d_dynamic", "sec_per_pair", "stage_cluster_ms",
    "stage_extract_ms", "stage_match_ms", "stage_flow_ms",
    "kern_hist_small_ms", "kern_icp_small_ms", "kern_hist_large_ms",
    "kern_icp_large_ms", "kern_nn_elementwise_ms", "kern_nn_expanded_ms",
    "kern_nn_large_tflops", "nn_bound_ms", "nn_util_vs_bound",
    "kernel_plain_max_err", "first_call_s", "host_io_s", "n_pairs_matched",
    "epe3d_dynamic_gap4x", "heldout_dyn_epe_gap1", "heldout_dyn_epe_gap4",
    "hdbscan_epe3d", "hdbscan_epe3d_dynamic", "hdbscan_sec_per_pair",
    "ego_est_dyn_epe_gap1", "ego_est_dyn_epe_gap4", "budget_s", "elapsed_s",
    "skipped", "device",
    "scene", "power_limit_w", "nn_launches", "nn_plain_calls", "heldout",
    "ego_est", "scene_epe3d_dynamic_gap4x", "hdbscan_path")
NN_UTIL_MAX = 1.05       # nn_util_vs_bound above this: the bound is wrong


def _heldout_diffs(line):
    """{(protocol, seed, gap): (|d epe3d|, |d epe3d_dynamic|)} of the bench
    line's held-out and estimated-ego records against
    ``JAX_HELDOUT_REFERENCE``; every pinned record must be in the line."""
    recs = {(r["protocol"], r["seed"], r["gap"]): r
            for r in line["heldout"]["scenes"] + line["ego_est"]["scenes"]}
    check(sorted(recs) == sorted(JAX_HELDOUT_REFERENCE),
          f"held-out records {sorted(recs)} differ from the pinned "
          f"{sorted(JAX_HELDOUT_REFERENCE)}")
    return {key: tuple(abs(recs[key][k] - ref[k])
                       for k in ("epe3d", "epe3d_dynamic"))
            for key, ref in JAX_HELDOUT_REFERENCE.items()}


def phase_bench(card):
    """Phase 10: the port's bench (``icpflow_tpu_torch.bench.main()``) on
    the card, whole: its one line parsed and printed, every field present,
    nothing skipped but the demo fixture, the held-out records of seeds 7,
    8 and 9 and the estimated-ego ones within EPE_BAND of
    ``JAX_HELDOUT_REFERENCE``, the headline pair's accuracy within it of
    ``JAX_REFERENCE`` (the same pair), the kernel equal to its plain
    version, no plain NN call, and the kernel within its bound."""
    from icpflow_tpu_torch import bench
    t0 = time.time()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        bench.main([])
    seconds = time.time() - t0
    text = out.getvalue().strip().splitlines()
    check(len(text) == 1, f"the bench printed {len(text)} lines on stdout")
    line = json.loads(text[0])
    print(f"[bench line] {text[0]}", flush=True)
    missing = [k for k in BENCH_FIELDS if k not in line]
    check(not missing, f"the bench line lacks {missing}")
    check(line["skipped"] == ["demo_fixture"],
          f"the bench skipped {line['skipped']}")
    check(line["kernel_plain_max_err"] == 0,
          f"kernel vs plain {line['kernel_plain_max_err']}")
    check(line["nn_plain_calls"] == 0 and line["nn_launches"] > 0,
          f"the bench made {line['nn_launches']} NN launches and "
          f"{line['nn_plain_calls']} plain NN calls")
    check(0 < line["nn_util_vs_bound"] <= NN_UTIL_MAX,
          f"nn_util_vs_bound {line['nn_util_vs_bound']}")
    check(line["hdbscan_path"] == "dedup",
          f"the hdbscan section ran hdbscan's {line['hdbscan_path']} path")
    ref = JAX_REFERENCE[1]
    for key in ("epe3d", "epe3d_dynamic"):
        check(abs(line[key] - ref[key]) <= EPE_BAND,
              f"bench headline {key} {line[key]} vs JAX {ref[key]:.5f}")
    diffs = _heldout_diffs(line)
    for (proto, seed) in sorted({k[:2] for k in diffs}):
        gaps = {k[2]: d for k, d in diffs.items() if k[:2] == (proto, seed)}
        gap, worst = max(gaps.items(), key=lambda kv: max(kv[1]))
        print(f"[bench] {proto} seed {seed}: {len(gaps)} gaps, worst gap "
              f"{gap}: |d EPE3D| {worst[0]:.5f} |d dynamic| {worst[1]:.5f} m "
              f"from JAX", flush=True)
    bad = {k: d for k, d in diffs.items() if max(d) > EPE_BAND}
    check(not bad, f"held-out records beyond {EPE_BAND} m of JAX: {bad}")
    ego = {g: JAX_HELDOUT_REFERENCE[("waymo_like_ego_est", 7, g)]
           for g in (1, 4)}
    for g in (1, 4):
        got = line[f"ego_est_dyn_epe_gap{g}"]
        check(abs(got - ego[g]["epe3d_dynamic"]) <= EPE_BAND,
              f"ego_est_dyn_epe_gap{g} {got} vs JAX "
              f"{ego[g]['epe3d_dynamic']}")
    print(f"[bench] {line['value']} pairs/s ({line['pairs_per_sec_min']}-"
          f"{line['pairs_per_sec_max']}), stages ms cluster "
          f"{line['stage_cluster_ms']} extract {line['stage_extract_ms']} "
          f"match {line['stage_match_ms']} flow {line['stage_flow_ms']}, "
          f"nn_util_vs_bound {line['nn_util_vs_bound']}, NN launches "
          f"{line['nn_launches']} | phase 10 {seconds:.1f} s | {card}",
          flush=True)
    return line


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    t0 = time.time()
    card = phase_environment()
    phase_build()
    if "--offline" in sys.argv[1:]:
        phase_offline(card)
        return 0
    if "--hdbscan" in sys.argv[1:]:
        phase_hdbscan(card)
        return 0
    if "--sharded" in sys.argv[1:]:
        phase_sharded(card)
        return 0
    if "--bench" in sys.argv[1:]:
        phase_bench(card)
        return 0
    if "--icp-graph" in sys.argv[1:]:
        phase_icp_graph(card)
        return 0
    if "--dbscan" in sys.argv[1:]:
        phase_dbscan(card)
        return 0
    phase_kabsch()
    if "--kabsch" in sys.argv[1:]:
        phase_kabsch_times(card, (1, 64))
        return 0
    phase_dbscan(card)
    rows = phase_kernels()
    batches = collections.Counter()
    with _kabsch_batches(batches):
        per_kernel, pair_shapes = phase_main_path(card)
        stream_kernel, stream_shapes = phase_stream(card)
    phase_icp_graph(card)
    print(f"[kabsch] launches by batch size, pair and stream paths: "
          f"{dict(sorted(batches.items()))}", flush=True)
    phase_kabsch_times(card, sorted({1} | {b for b, _ in
                                           batches.most_common(3)}))
    offline_kernel, offline_shapes = phase_offline(card)
    hdbscan_kernel, hdbscan_shapes = phase_hdbscan(card)
    sharded_kernel, sharded_shapes = phase_sharded(card)
    phase_launch_table(rows, {"pair": pair_shapes,
                              "stream vpu2": stream_shapes["vpu2"],
                              "stream default": stream_shapes["auto"],
                              "offline": offline_shapes,
                              "hdbscan pair": hdbscan_shapes,
                              "sharded rank 0": sharded_shapes})
    phase_bench(card)
    table = []
    for name, (form, _, rep, _) in KERNELS.items():
        # launches: the frame-pair path's count; the sentinel kernels run
        # only on the vpu2 stream, whose count they carry
        path = stream_kernel if form == "sentinel" else per_kernel
        check(path.get(name, 0) > 0,
              f"kernel {name} was not launched by its main path")
        # one offline sample (seed 7): GT poses, estimated poses, and GT
        # poses under vpu2, which alone launches the sentinel kernels
        offline = {run: offline_kernel[run].get(name, 0)
                   for run in ("gt", "kiss", "vpu2")}
        check(offline["vpu2" if form == "sentinel" else "gt"] > 0,
              f"kernel {name} was not launched by the offline path")
        # the row's own numbers are those of its first entry in ``times``:
        # the launch with the most work (the largest bound) that the main
        # paths made of it
        table.append(dict(name=name, route="cuda", source=SOURCE,
                          replaces=rep, launches=path[name],
                          launches_offline=offline,
                          launches_hdbscan=hdbscan_kernel.get(name, 0),
                          launches_sharded=sharded_kernel.get(name, 0),
                          **rows[name]["times"][0], **rows[name]))
    print(f"[done] {time.time() - t0:.1f} s", flush=True)
    print(card)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
