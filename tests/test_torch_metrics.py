"""The port's metric sweep against the JAX package's.

The same random flows and labels, made from a seed with numpy, go through
``icpflow_tpu.metrics`` and ``icpflow_tpu_torch.metrics``. The meter code is
the same numpy on both sides, so tables, reports and states must be equal to
the last bit; ``compute_epe_sums`` (torch) is held to ``compute_epe_sums_jnp``
within 1e-6 relative (fp32 sums taken in another order).
"""

import dataclasses
import json

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from icpflow_tpu import metrics as JM  # noqa: E402
from icpflow_tpu_torch import metrics as TM  # noqa: E402

SUMS_RTOL = 1e-6


def _sample(seed, num_frames, n=4000, empty_category=False):
    """Random GT and predicted flow with every category populated (or,
    with ``empty_category``, no static foreground and an empty last
    frame)."""
    rng = np.random.default_rng(seed)
    ti = rng.integers(0, num_frames - int(empty_category), n)
    sd = rng.integers(0, 2, n)
    fb = rng.integers(0, 2, n)
    if empty_category:
        fb[sd == 0] = 0
    gt = rng.normal(scale=0.5, size=(n, 3)) * sd[:, None]
    gt = gt.astype(np.float32)
    noise = rng.normal(scale=0.08, size=(n, 3)) * (rng.random((n, 1)) < 0.6)
    pred = (gt + noise).astype(np.float32)
    return dict(flow_pred=pred, flow_gt=gt, sd_labels=sd, fb_labels=fb,
                time_indice=ti, num_frames=num_frames)


def _tables(samples, num_frames):
    jm, tm = JM.make_meters(num_frames), TM.make_meters(num_frames)
    for s in samples:
        JM.update_metrics(jm, **s)
        TM.update_metrics(tm, **s)
    return jm, tm


def test_categories_and_meter_names():
    assert TM.CATEGORIES == JM.CATEGORIES
    for num_frames in (2, 5, 11):
        assert list(TM.make_meters(num_frames)) == list(
            JM.make_meters(num_frames))


@pytest.mark.parametrize("empty_category", [False, True])
@pytest.mark.parametrize("num_frames", [2, 3, 5])
@pytest.mark.parametrize("seed", [0, 1])
def test_update_metrics_equal_to_the_last_bit(seed, num_frames,
                                              empty_category):
    samples = [_sample(10 * seed + k, num_frames,
                       empty_category=empty_category) for k in range(3)]
    jm, tm = _tables(samples, num_frames)
    for name in jm:
        assert dataclasses.asdict(tm[name]) == dataclasses.asdict(jm[name]), \
            name
        for avg in ("epe_avg", "accs_avg", "accr_avg", "outlier_avg",
                    "routlier_avg"):
            assert getattr(tm[name], avg) == getattr(jm[name], avg)
    assert TM.report(tm, num_frames) == JM.report(jm, num_frames)


def test_overall_0_is_weighted_by_the_whole_sequence():
    """The quirk of `utils_eval.py:275`: overall_0 weighs by all points,
    frame 0 included; every other ``<cat>_0`` by its own count."""
    s = _sample(3, 3)
    tm = TM.make_meters(3)
    TM.update_metrics(tm, **s)
    assert tm["overall_0"].num == len(s["flow_pred"])
    assert tm["static_0"].num == int(
        ((s["time_indice"] > 0) & (s["sd_labels"] == 0)).sum())
    assert tm["overall_3"].num == 1


def test_report_format():
    tm = TM.make_meters(2)
    TM.update_metrics(tm, **_sample(5, 2))
    lines = TM.report(tm, 2).splitlines()
    assert len(lines) == 3 * len(TM.CATEGORIES)
    m = tm["overall_0"]
    assert lines[0] == (
        f"{'overall_0':14s} EPE3D: {m.epe_avg:.6f}  ACC3DS: {m.accs_avg:.6f}"
        f"  ACC3DR: {m.accr_avg:.6f}  Outlier: {m.outlier_avg:.6f}  "
        f"Routlier: {m.routlier_avg:.6f}")


@pytest.mark.parametrize("num_frames", [2, 5])
def test_state_round_trip(num_frames):
    jm, tm = _tables([_sample(7, num_frames)], num_frames)
    state = TM.meters_to_state(tm)
    assert state == JM.meters_to_state(jm)
    state = json.loads(json.dumps(state))          # as the CLI stores it
    back = TM.meters_from_state(state, num_frames)
    assert back == tm
    assert JM.meters_from_state(state, num_frames).keys() == back.keys()
    # names the table does not have are dropped, missing ones start empty
    part = {"overall_0": state["overall_0"], "no_such_meter": {}}
    some = TM.meters_from_state(part, num_frames)
    assert some["overall_0"] == tm["overall_0"]
    assert some["static_1"] == TM.AverageMeter()


def test_merge_sums_and_update():
    rng = np.random.default_rng(0)
    jm, tm = JM.AverageMeter(), TM.AverageMeter()
    for _ in range(4):
        vals = rng.random(5).tolist()
        num = int(rng.integers(1, 100))
        jm.update(*vals, num)
        tm.update(*vals, num)
        sums = rng.random(6) * 50
        jm.merge_sums(sums)
        tm.merge_sums(sums)
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    assert TM.AverageMeter().epe_avg == 0.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compute_epe_and_crop_equal(seed):
    s = _sample(seed, 2)
    mask = np.random.default_rng(seed).random(len(s["flow_gt"])) < 0.5
    for m in (None, mask, np.zeros_like(mask)):
        assert TM.compute_epe(s["flow_pred"], s["flow_gt"], m) == \
            JM.compute_epe(s["flow_pred"], s["flow_gt"], m)
    pts = np.random.default_rng(seed).uniform(-40, 40, (500, 4))
    for eval_ground in (False, True):
        kw = dict(range_x=32.0, range_y=30.0, range_z=-1.6, ground_slack=0.3,
                  eval_ground=eval_ground)
        np.testing.assert_array_equal(TM.crop_for_eval(pts, **kw),
                                      JM.crop_for_eval(pts, **kw))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compute_epe_sums_matches_jnp(seed):
    s = _sample(seed, 2, n=3000)
    w = np.random.default_rng(seed).random(3000) < 0.7
    ref = np.asarray(JM.compute_epe_sums_jnp(
        jnp.asarray(s["flow_pred"]), jnp.asarray(s["flow_gt"]),
        jnp.asarray(w)))
    out = TM.compute_epe_sums(torch.as_tensor(s["flow_pred"]),
                              torch.as_tensor(s["flow_gt"]),
                              torch.as_tensor(w))
    assert out.shape == (6,) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=SUMS_RTOL)
    # the sums are the meter's: merged, they give compute_epe's averages
    meter = TM.AverageMeter()
    meter.merge_sums(out.numpy().astype(np.float64))
    epe = TM.compute_epe(s["flow_pred"], s["flow_gt"], w)
    np.testing.assert_allclose(
        [meter.epe_avg, meter.accs_avg, meter.accr_avg, meter.outlier_avg,
         meter.routlier_avg], epe, rtol=1e-5)
