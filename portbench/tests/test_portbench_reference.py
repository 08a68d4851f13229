"""The plain reference against the port's own CPU path at tiny sizes, the
control (the reference one precision down) and the planted faults: each
must come out as not correct."""

import numpy as np
import pytest

from conftest import CONFIGS, WORKLOAD, tiny
from portbench import calibrate, faults, run


@pytest.mark.parametrize("config", CONFIGS)
def test_reference_follows_the_port_and_control_departs(config):
    """fp32 on the CPU: the port's plain path and the reference agree to
    fp32 rounding, the EMA too; the control (bf16 forward values) reads far
    above."""
    rows = calibrate.readings(WORKLOAD, [5], control=True, device="cpu",
                              overrides=tiny(WORKLOAD, "float32", config))
    prog, ctl = rows[0]["program"], rows[0]["control"]
    assert prog["loss_gap"] < 1e-5 and prog["grad_gap"] < 1e-5 and prog["change_gap"] < 1e-4
    assert prog["ema_gap"] < 1e-4 and rows[0]["correct"] is True
    assert prog.get("inactive_change", 0.0) == 0.0
    assert max(ctl["loss_gap"] / 1e-5, ctl["grad_gap"] / 1e-5, ctl["change_gap"] / 1e-4) > 3


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("config", CONFIGS)
def test_a_planted_fault_is_not_correct(config, fault):
    """The rest of a run (no look for a card) with the timed path broken
    underneath, against the cell's own limits."""
    out = run.run_cell(WORKLOAD, 2**31 + 3, 0.5, False, device="cpu",
                       overrides=tiny(WORKLOAD, "float32", config), fault=faults.FAULTS[fault]())
    assert out["correct"] is False and out["failed"] == out["attempted"] > 0


@pytest.mark.parametrize("decay", [0.99, 0.05])
def test_a_wrong_ema_fails_ema_gap_alone(decay):
    """An EMA blended with another decay than the stated 0.95 (0.05: its two
    terms swapped) reads `ema_gap` over the cell's limit, and every other
    number within its own."""
    out = run.run_cell(WORKLOAD, 2**31 + 5, 0.5, False, device="cpu",
                       overrides=tiny(WORKLOAD, "float32"), fault=faults.ema_decay(decay))
    failed = {k for k, v in out["compared"].items() if v["value"] > v["limit"]}
    assert out["correct"] is False and failed == {"ema_gap"}


def test_control_at_the_cells_precision_is_not_correct():
    """bf16 stated: the control is fp8, judged by the cell's own limits
    (`check.judge`, as a run judges the program): not correct."""
    rows = calibrate.readings(WORKLOAD, [6], control=True, device="cpu",
                              overrides=tiny(WORKLOAD, "bfloat16"))
    assert rows[0]["control_correct"] is False
    assert np.isfinite(list(rows[0]["control"].values())).all()
