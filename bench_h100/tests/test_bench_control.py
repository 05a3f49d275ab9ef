"""The control at a size a test run holds: the reference in fp8 put in the
program's place fails the cell's limits, and the reference in float32 put
there reads nought on every number compared; on the CPU at the tiny
configuration."""

import importlib.util

import pytest

from bench_h100.harness import BENCH
from bench_h100.reference.judge import detection_numbers, held
from bench_h100.tests.test_bench_faults import tiny_cell


def control():
    spec = importlib.util.spec_from_file_location("bench_h100_control", BENCH / "control.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,config", [("r50.infer", "htd_r50_1x"),
                                         ("r101dcn.infer", "htd_r101_dcn_2x")])
def test_fp8_control_fails_and_float32_passes(name, config):
    cell = tiny_cell(name, config, check_requests=4)
    sides = control().control_pairs(cell, 2**31 + 3, "cpu", ("fp8", "float32"))
    fp8 = detection_numbers(sides["fp8"])
    f32 = detection_numbers(sides["float32"])
    assert not held(fp8, cell.limits["numbers"])[0], fp8
    assert held(f32, cell.limits["numbers"])[0], f32
    assert all(f32[k] == 0.0 for k in cell.limits["numbers"]), f32
