"""The yardstick's counts at the published widths, against hand counts."""

import json

import pytest
import torch

from benchmark import counts
from benchmark.tests.conftest import ROOT


def cfg(name="mpinets-bf16"):
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


def test_padded_multiply_adds_per_env_step():
    m = counts.padded_macs_per_env(cfg())
    # SA0 512 x 128 rows x (4*64 + 64*64 + 64*64); SA1 128 x 128 x (67*128 +
    # 128*128 + 128*256); global 128 x (259*512 + 512*512 + 512*1024)
    assert m["sa0"] == 512 * 128 * (4 * 64 + 64 * 64 + 64 * 64) == 553_648_128
    assert m["sa1"] == 128 * 128 * (67 * 128 + 128 * 128 + 128 * 256) == 945_815_552
    assert m["global"] == 128 * (259 * 512 + 512 * 512 + 512 * 1024) == 117_637_120
    assert m["rest"] == pytest.approx(18.06e6, rel=1e-3)
    assert sum(m.values()) == pytest.approx(1.635e9, rel=1e-3)


@pytest.mark.parametrize("name", ["mpinets-bf16", "mpinets-f32"])
def test_step_work_counts_needed_rows_not_padded(name):
    c = cfg(name)
    b = 2
    count0 = torch.tensor([[0, 3, 200]] * b)      # a centroid with none counts one row
    count1 = torch.tensor([[128, 5]] * b)
    tests0 = torch.tensor([[6272, 6272, 900]] * b)
    tests1 = torch.tensor([[140, 512]] * b)
    w = counts.step_work(c, b, count0, tests0, count1, tests1)
    row0 = 2 * (4 * 64 + 64 * 64 + 64 * 64)
    row1 = 2 * (67 * 128 + 128 * 128 + 128 * 256)
    assert w["sa_mlp"][0][2] == b * (1 + 3 + 128) * row0
    assert w["sa_mlp"][1][2] == b * (128 + 5) * row1
    assert w["sa_select"][0][1] == 9.0 * b * (6272 + 6272 + 900)
    assert w["fps"][0][1] == 9.0 * b * 511 * 6272
    assert w["model_flops"] == (b * (1 + 3 + 128) * row0 + b * (128 + 5) * row1
                                + b * counts.dense_flops_per_env(c))


def test_bound_is_the_longer_of_bytes_and_operations():
    assert counts.bound_s(3.35e12) == pytest.approx(1.0)
    assert counts.bound_s(0, counts.F32_NOFMA_OPS) == pytest.approx(1.0)
    assert counts.bound_s(3.35e12, 0, 2 * 989e12) == pytest.approx(2.0)
    assert counts.bound_s(1.0, 0, 67e12, counts.F32_FLOPS) == pytest.approx(1.0)
    w = {"sa_mlp": [(3.35e12, 0.0, 0.0), (0.0, 0.0, 989e12)]}
    # launch by launch: each launch's own longer side
    assert counts.kernel_bound_s(w, "sa_mlp", cfg()) == pytest.approx(2.0)
