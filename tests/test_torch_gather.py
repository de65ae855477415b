"""The row gather (``gs2d_torch/ops/gather.py``) on the CPU: the wrapper
takes its plain version there, held to NumPy's ``table[idx]`` exactly (a
gather copies). The kernel itself is held to ``table[idx]`` on the card
by tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

from gs2d_torch.ops.gather import gather_rows, gather_rows_reference


@pytest.mark.parametrize("f", [1, 2, 3, 4, 24, 45])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_gather_rows_matches_numpy(f, dtype):
    rng = np.random.default_rng(f)
    n = 257
    table = rng.normal(size=(n, f)).astype(np.float32)
    before = gather_rows.launches
    for m in (0, 1, 1000):
        idx = rng.integers(-n, n, m).astype(dtype)
        out = gather_rows(torch.as_tensor(table), torch.as_tensor(idx))
        assert out.shape == (m, f) and out.dtype == torch.float32
        np.testing.assert_array_equal(out.numpy(), table[idx])
        np.testing.assert_array_equal(
            gather_rows_reference(torch.as_tensor(table),
                                  torch.as_tensor(idx)).numpy(), table[idx])
    assert gather_rows.launches == before      # no kernel on the CPU


@pytest.mark.parametrize("bad", [5, -6, 1 << 40])
def test_gather_rows_out_of_range_raises(bad):
    table = torch.arange(10, dtype=torch.float32).reshape(5, 2)
    dtype = torch.int64 if abs(bad) >= 2 ** 31 else torch.int32
    with pytest.raises(IndexError):
        gather_rows(table, torch.tensor([0, bad, 1], dtype=dtype))


def test_gather_rows_rejects_bad_inputs():
    table = torch.zeros((4, 3))
    idx = torch.zeros(2, dtype=torch.int32)
    for t, i in ((table.double(), idx), (table.T, idx), (table[0], idx),
                 (torch.zeros((4, 0)), idx), (table, idx.float()),
                 (table, idx[None])):
        with pytest.raises(ValueError):
            gather_rows(t, i)
