"""PyTorch port, the shared cache of device constants (utils/device.py).

An eager caller whose constants change from call to call must not grow the
cache: 10,000 distinct scalars through ``Evaluator.mul_const`` leave it at
or under ``MAX_CONSTANTS``, and every product equals the one a fresh
process computes with an empty cache.  The card's side (a captured graph
keeps the constants it reads after the cache is cleared) is in
tests/test_torch_staged_cuda.py.
"""

import subprocess
import sys

import torch

from matrix_fhe_tpu_torch.utils import device

SCALARS = 10_000
# products a fresh process recomputes: the first and last scalars and some
# between, each made, dropped from the cache and made again here
SAMPLED = (0, 1, 2, 4095, 4096, 5000, 9998, 9999)

SESSION = """
import hashlib
import torch
from matrix_fhe_tpu_torch.rlwe import encryptor
from matrix_fhe_tpu_torch.rlwe import keys as K
from matrix_fhe_tpu_torch.schemes import ckks

params = ckks.new_parameters(ckks.CKKSParametersLiteral(
    logn=4, logq=(45, 45, 45), logp=(45,), log_default_scale=40), device="cpu")
sk = K.gen_secret_key(torch.Generator().manual_seed(1), params)
ct = encryptor.encrypt(torch.Generator().manual_seed(2), params, sk,
                       ckks.Encoder(params).encode([0.5, -0.25, 0.125]))
ev = ckks.Evaluator(params)


def scalar(i):
    return 1.0 + i / 16384


def product(i):
    out = ev.mul_const(ct, scalar(i))
    h = hashlib.sha256(str(out.scale).encode())
    for v in out.value:
        h.update(v.numpy().tobytes())
    return h.hexdigest()
"""


def _session() -> dict:
    ns: dict = {}
    exec(SESSION, ns)
    return ns


def test_eager_constants_stay_bounded_and_exact():
    s = _session()
    device.clear_constants()
    digests, most = {}, 0
    for i in range(SCALARS):
        d = s["product"](i)
        most = max(most, device.cached_constants())
        if i in SAMPLED:
            digests[i] = d
    assert most == device.MAX_CONSTANTS  # reached the bound, never past it
    assert device.cached_constants() <= device.MAX_CONSTANTS
    # the products made after their constants were dropped are unchanged
    assert all(s["product"](i) == digests[i] for i in SAMPLED)
    fresh = subprocess.run(
        [sys.executable, "-c", SESSION + f"\nprint(' '.join(product(i) for i in {SAMPLED}))"],
        capture_output=True, text=True, check=True, timeout=120).stdout.split()
    assert fresh == [digests[i] for i in SAMPLED]


def test_holding_keeps_what_the_cache_drops():
    """A constant read inside ``holding`` stays in its dict, and is found
    there first, after the cache drops it."""
    held: dict = {}
    with device.holding(held):
        a = device.constant([3, 5, 7], torch.int64, "cpu")
    device.clear_constants()
    assert device.cached_constants() == 0 and len(held) == 1
    with device.holding(held):
        assert device.constant([3, 5, 7], torch.int64, "cpu") is a
    assert device.constant([3, 5, 7], torch.int64, "cpu") is not a  # made anew outside
    assert device.constant(7, torch.int32, "cpu").shape == ()
