"""The port's CPU tests run with one torch intra-op thread each
(tests/torch_threads.py), and give torch's setting back after."""

import torch

from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401


def test_torch_runs_one_intra_op_thread():
    assert torch.get_num_threads() == 1
