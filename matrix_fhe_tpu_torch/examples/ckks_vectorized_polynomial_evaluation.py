"""Vectorized polynomial evaluation: different polynomials on different slots.

Counterpart of ``examples/ckks_vectorized_polynomial_evaluation.py`` (the
reference's examples/singleparty/ckks_vectorized_polynomial_evaluation/
main.go): evaluate g0(x) = f'(x)(f(x)-0) on all even slots and
g1(x) = f'(x)(f(x)-1) on all odd slots (f = sigmoid) in a SINGLE
Paterson-Stockmeyer pass over one shared power basis, via a slot-mapped
PolynomialVector.

    python -m matrix_fhe_tpu_torch.examples.ckks_vectorized_polynomial_evaluation [--device cpu]
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


def sigmoid(x: Decimal) -> Decimal:
    return 1 / ((-x).exp() + 1)


def g0(x: Decimal) -> Decimal:
    y = sigmoid(x)
    return y * (1 - y) * (y - 0)


def g1(x: Decimal) -> Decimal:
    y = sigmoid(x)
    return y * (1 - y) * (y - 1)


def main(device="cuda", seed: int = 0) -> dict:
    params = ckks.new_parameters(ckks.CKKSParametersLiteral(
        logn=7, logq=(55,) + (45,) * 6, logp=(61,), log_default_scale=45), device)
    enc = ckks.Encoder(params)
    ks, kr, ke = generators(seed, 3)
    sk = K.gen_secret_key(ks, params)
    rlk = K.gen_relinearization_key(kr, params, sk)
    ev = ckks.Evaluator(params, rlk=rlk)

    # Chebyshev interpolants of g0, g1 over [-K, K] (main.go GetChebyshevPoly)
    itv = bn.Interval(-K_INTERVAL, K_INTERVAL, nodes=31)
    p0 = bn.chebyshev_approximation(g0, itv)
    p1 = bn.chebyshev_approximation(g1, itv)

    # g0 on even slots, g1 on odd slots
    slots = params.max_slots
    even = list(range(0, slots, 2))
    odd = list(range(1, slots, 2))
    polys = poly_circ.PolynomialVector(value=[p0, p1], mapping={0: even, 1: odd})

    rng = np.random.default_rng(seed)
    v = rng.uniform(-K_INTERVAL, K_INTERVAL, slots)
    ct = encryptor.encrypt(ke, params, sk, enc.encode(v + 0j))

    # change of basis x -> (2x - a - b) / (b - a) into [-1, 1]
    scalar, constant = polys.change_of_basis()
    ct = ev.add_const(ct, float(constant) / float(scalar))
    ct = ev.rescale(ev.mul_const(ct, float(scalar)))

    out = poly_circ.evaluate(ev, enc, ct, polys, params.default_scale)
    pt = decryptor.decrypt(params, sk, out)
    got = np.real(enc.decode(pt))

    want = np.where(np.arange(slots) % 2 == 0,
                    [float(p0.evaluate(complex(x)).real) for x in v],
                    [float(p1.evaluate(complex(x)).real) for x in v])
    err = float(np.max(np.abs(got - want)))
    print(f"vectorized g0/g1: levels used {params.max_level - out.level}, "
          f"max err vs interpolants {err:.2e}")
    assert err < 1e-3, err
    print("OK")
    return {"words": {"g0/g1": pt.value}, "decoded": {"g0/g1": got}, "err": err}


if __name__ == "__main__":
    cli(main)
