"""PyTorch port, the example scripts (``matrix_fhe_tpu_torch/examples``):
each runs on the CPU and passes every assert of its JAX script
(``examples/<name>.py``) at the same bound, inside its ``main``.

tests/test_examples.py runs the JAX scripts each in a subprocess (an XLA
crash in long-lived processes); the port's need no JAX, so they run in
process, and one subprocess checks the command-line form and that the
port's user-facing modules import no jax.
"""

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from matrix_fhe_tpu_torch.examples import NAMES

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", NAMES)
def test_example(name):
    out = importlib.import_module(f"matrix_fhe_tpu_torch.examples.{name}").main(device="cpu")
    assert out["words"] and out["decoded"]
    for w in out["words"].values():
        assert w.dtype == torch.int64 and w.device.type == "cpu"
    for d in out["decoded"].values():
        assert np.all(np.isfinite(d))


def test_command_line_and_no_jax():
    code = ("import runpy, sys; sys.argv = ['ckks_template', '--device', 'cpu']; "
            "runpy.run_module('matrix_fhe_tpu_torch.examples.ckks_template', "
            "run_name='__main__'); "
            "import matrix_fhe_tpu_torch.flagship, matrix_fhe_tpu_torch.utils.serialization; "
            "import matrix_fhe_tpu_torch.examples; "
            "assert 'jax' not in sys.modules, 'the port imported jax'")
    r = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, f"--- stdout ---\n{r.stdout[-2000:]}\n--- stderr ---\n{r.stderr[-2000:]}"
    assert "template circuit: level 1, max err" in r.stdout
