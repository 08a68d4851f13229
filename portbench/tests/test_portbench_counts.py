"""The frozen work counts and the metrics built on them, against sums done
by hand; a share of a roofline or of the peak cannot pass 100 %."""

import json
import os

import pytest

from portbench import counts, registry
from portbench.frozen import work
from portbench.metrics import encode_bwd_roofline, encode_fwd_roofline, mfu, idle_share

SIZES = work.Sizes(resolutions=(16, 32), features=8, plane_specs=((16, 8, 2),), snap_levels=True)


def test_k1_k2_by_hand():
    o, p = 2, 100
    # folded: 2 taps; cp table 3 x 32 (fold_res padded to 32) x 8; planes 3 x (16*8 + 16) x 2
    cp_tab, pl_tab = 3 * 32 * 8, 3 * (16 * 8 + 16) * 2
    nbytes, ops = work.work("K1", SIZES, "bfloat16", o, p)
    assert nbytes == 12 * o * p + o * 2 * (cp_tab + pl_tab) + o * p * 2 * (8 + 6 + 3 * 8 + 2 * 6)
    assert ops == o * p * (6 * 8 * 2 + 2 * 8 + 6 * 13)
    nbytes, ops = work.work("K2", SIZES, "bfloat16", o, p)
    assert nbytes == 12 * o * p + o * p * 2 * (4 * 8 + 3 * 6) + o * 4 * (cp_tab + pl_tab)
    assert ops == o * p * (8 * (6 + 12) + 18 * 6)


def test_hash_by_hand():
    nbytes, ops = work.hash_work("forward", 16, 2, 1000, "bfloat16", 3, 10)
    assert nbytes == 12 * 30 + 3 * 1000 * 2 * 2 + 30 * 16 * 2 * 2
    assert ops == 30 * 16 * (8 * 2 * 2 + 16 + 6)
    nbytes, _ = work.hash_work("backward", 16, 2, 1000, "bfloat16", 3, 10)
    assert nbytes == 12 * 30 + 30 * 16 * 2 * 2 + 3 * 1000 * 2 * 4


def test_mlp_flops_of_the_flagship():
    with open(os.path.join(registry.HERE, "configs", "flagship.json")) as f:
        cfg = json.load(f)
    w = counts.of(cfg, 4, "cuda")
    p = 4096 * 32
    mlp = 3 * 2 * (60 * 64 + 64 * 4) * p
    ladder = tuple(int(round(16 * 12 ** (lv / 5))) for lv in range(6))  # 16 ... 192
    sizes = work.Sizes(ladder, 48, ((128, 64, 4),), True)
    fwd = work.work("K1", sizes, "bfloat16", 4, p)
    bwd = work.work("K2", sizes, "bfloat16", 4, p)
    assert w["flops_per_obj_step"] == pytest.approx(mlp + (fwd[1] + bwd[1]) / 4)
    assert w["encode_fwd_s"] == pytest.approx(work.least_seconds(*fwd))
    # the check in the issue: PR 13's flagship.offline.o10 read 0.325 % at 972 obj-iters/s
    ctx = dict(work=dict(w, flops_per_obj_step=mlp), obj_iters_per_s=972.0,
               profile=dict(busy_s=1.0))
    assert mfu.read(ctx) == pytest.approx(100 * mlp * 972 / 989e12)
    assert 0.3 < mfu.read(ctx) < 0.36


@pytest.mark.parametrize("reader, key, span", [
    (encode_fwd_roofline, "encode_fwd_s", "encode.fwd"),
    (encode_bwd_roofline, "encode_bwd_s", "encode.bwd")])
def test_roofline_share_is_least_over_measured(reader, key, span):
    ctx = dict(work={key: 0.002}, profiled_steps=5, profile=dict(span_s={span: 0.05}))
    assert reader.read(ctx) == pytest.approx(100 * 0.002 / 0.01)
    # a span no longer than the least time is the only way past 100 %
    ctx["profile"]["span_s"][span] = 0.01
    assert reader.read(ctx) == pytest.approx(100.0)
    assert reader.read(dict(ctx, profile=dict(span_s={}))) is None


def test_least_time_is_a_lower_bound():
    nbytes, ops = 3.35e12, 67e12 / 2
    assert work.least_seconds(nbytes, ops) == pytest.approx(1.0)
    assert work.least_seconds(1.0, 67e12 * 2) == pytest.approx(2.0)


def test_idle_share():
    ctx = dict(profile=dict(busy_s=0.04), profiled_steps=5, step_s=0.010)
    assert idle_share.read(ctx) == pytest.approx(20.0)
