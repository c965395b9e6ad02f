"""PyTorch port, ``parallel/launch.py`` on gloo ranks on the CPU: a rank's
result comes back to the caller in rank order, tensors included, and a rank
that raises makes the launcher raise with that rank's traceback."""

import pytest
import torch

from matrix_fhe_tpu_torch.parallel import launch
import torch_worlds


def test_returns_tensors_in_rank_order():
    got = launch.run(torch_worlds.rank_tensor, 3, 1 << 16, device="cpu")
    assert [t.shape for t in got] == [(1 << 16,)] * 3
    assert all(torch.equal(t, torch.full((1 << 16,), r)) for r, t in enumerate(got))


def test_a_rank_that_raises():
    with pytest.raises(RuntimeError, match="rank 1 of 2 raised(.|\n)*rank 1 refuses"):
        launch.run(torch_worlds.rank_raises, 2, 1, device="cpu")
