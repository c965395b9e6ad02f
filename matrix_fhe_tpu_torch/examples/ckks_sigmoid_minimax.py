"""Homomorphic sigmoid via a multi-interval Remez (minimax) approximation.

Counterpart of ``examples/ckks_sigmoid_minimax.py`` (the reference's
examples/singleparty/ckks_sigmoid_minimax/main.go): fit the minimax
polynomial of sigmoid over [-8, 8] with the Remez solver
(utils/bignum/minimax_approximation.go) and evaluate homomorphically.

    python -m matrix_fhe_tpu_torch.examples.ckks_sigmoid_minimax [--device cpu]
"""

from __future__ import annotations

from decimal import Decimal

import numpy as np

from matrix_fhe_tpu_torch.circuits import polynomial as poly_circ
from matrix_fhe_tpu_torch.examples import cli, generators
from matrix_fhe_tpu_torch.rlwe import decryptor, encryptor, keys as K
from matrix_fhe_tpu_torch.schemes import ckks
from matrix_fhe_tpu_torch.utils import bignum as bn

K_INTERVAL = 8.0
DEGREE = 15


def sigmoid_decimal(x: Decimal) -> Decimal:
    return 1 / ((-x).exp() + 1)


def main(device="cuda", seed: int = 0) -> dict:
    # Remez minimax fit: equioscillating error, strictly better sup-norm than
    # the same-degree Chebyshev interpolant.
    rp = bn.RemezParameters(
        function=sigmoid_decimal, basis=bn.CHEBYSHEV,
        intervals=[bn.Interval(-K_INTERVAL, K_INTERVAL, nodes=DEGREE + 1)])
    poly = bn.Remez(rp).approximate()
    xs = np.linspace(-K_INTERVAL, K_INTERVAL, 201)
    plain_err = np.max(np.abs([float(poly.evaluate(complex(x)).real)
                               - 1 / (np.exp(-x) + 1) for x in xs]))
    print(f"minimax deg-{DEGREE} sup-norm error: {plain_err:.2e}")

    params = ckks.new_parameters(ckks.CKKSParametersLiteral(
        logn=7, logq=(55,) + (45,) * 5, logp=(61,), log_default_scale=45), device)
    enc = ckks.Encoder(params)
    ks, kr, ke = generators(seed, 3)
    sk = K.gen_secret_key(ks, params)
    rlk = K.gen_relinearization_key(kr, params, sk)
    ev = ckks.Evaluator(params, rlk=rlk)

    rng = np.random.default_rng(seed)
    v = rng.uniform(-K_INTERVAL, K_INTERVAL, params.max_slots)
    ct = encryptor.encrypt(ke, params, sk, enc.encode(v + 0j))

    # change of basis x -> (2x - a - b) / (b - a) into [-1, 1]
    scalar, constant = poly.change_of_basis()
    ct = ev.add_const(ct, float(constant) / float(scalar))
    ct = ev.rescale(ev.mul_const(ct, float(scalar)))

    out = poly_circ.evaluate(ev, enc, ct, poly, params.default_scale)
    pt = decryptor.decrypt(params, sk, out)
    got = np.real(enc.decode(pt))
    want = 1 / (np.exp(-v) + 1)
    err = float(np.max(np.abs(got - want)))
    print(f"homomorphic minimax sigmoid: max err {err:.2e}")
    assert err < plain_err + 1e-3
    return {"words": {"sigmoid": pt.value}, "decoded": {"sigmoid": got}, "err": err,
            "plain_err": float(plain_err)}


if __name__ == "__main__":
    cli(main)
