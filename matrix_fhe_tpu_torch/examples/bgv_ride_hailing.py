"""Privacy-preserving ride hailing: encrypted nearest-car matching.

Counterpart of ``examples/bgv_ride_hailing.py`` (the reference's
examples/singleparty/bgv_ride_hailing/main.go): a rider encrypts their
position; each SIMD slot pair holds one car's position; the platform
computes all squared distances under encryption; the rider decrypts only
the distances and picks the closest car.

    python -m matrix_fhe_tpu_torch.examples.bgv_ride_hailing [--device cpu]
"""

from __future__ import annotations

import numpy as np

from matrix_fhe_tpu_torch.examples import cli, generators
from matrix_fhe_tpu_torch.rlwe import decryptor, encryptor, keys as K
from matrix_fhe_tpu_torch.schemes import bgv

T = 65537           # plaintext modulus (> max squared distance)
GRID = 120          # coordinates in [0, GRID)
N_CARS = 32


def main(device="cuda", seed: int = 0) -> dict:
    params = bgv.new_parameters(bgv.BGVParametersLiteral(
        logn=7, t=T, logq=(55, 45, 45), logp=(61,)), device)
    enc = bgv.Encoder(params)
    ks, kp, kr, ke = generators(seed, 4)
    sk = K.gen_secret_key(ks, params)
    pk = K.gen_public_key(kp, params, sk)
    rlk = K.gen_relinearization_key(kr, params, sk)
    ev = bgv.Evaluator(params, rlk=rlk)

    rng = np.random.default_rng(seed + 3)
    rider = rng.integers(0, GRID, 2)
    cars = rng.integers(0, GRID, (N_CARS, 2))

    # rider broadcasts (x, y, x, y, ...) encrypted; the cars' plaintext is
    # interleaved (x_0, y_0, x_1, y_1, ...)
    rider_vec = np.tile(rider, params.n // 2)
    car_vec = np.zeros(params.n, dtype=np.int64)
    car_vec[:2 * N_CARS] = cars.reshape(-1)
    ct = encryptor.encrypt(ke, params, pk, enc.encode(rider_vec))

    # (rider - car)^2 per coordinate, exact mod t
    diff = ev.sub(ct, enc.encode(car_vec))
    sq = ev.rescale(ev.mul_relin(diff, diff))

    pt = decryptor.decrypt(params, sk, sq)
    dec = enc.decode(pt).astype(np.int64)
    d2 = dec[0:2 * N_CARS:2] + dec[1:2 * N_CARS:2]  # dx^2 + dy^2
    best = int(np.argmin(d2))

    want = np.sum((cars - rider) ** 2, axis=1)
    assert np.array_equal(d2, want % T)
    assert best == int(np.argmin(want))
    print(f"rider at {tuple(rider)}: closest of {N_CARS} cars is "
          f"#{best} at {tuple(cars[best])}, d^2={d2[best]}")
    return {"words": {"squares": pt.value}, "decoded": {"d2": d2, "best": best}}


if __name__ == "__main__":
    cli(main)
