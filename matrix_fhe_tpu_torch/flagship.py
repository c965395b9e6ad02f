"""Flagship workload builders: the CKKS ct-mult + relinearize + rescale step.

Counterpart of ``matrix_fhe_tpu/flagship.py``: one homomorphic multiply with
relinearization followed by a rescale (SURVEY.md section 3.3), the chain
that touches every L1 primitive (NTT/INTT, basis extension, Montgomery MACs,
rescale), on the u64 path.  On a CUDA tensor every NTT there runs kernel B4
(``ops/ntt64_cuda.py``).

The random draws are split as the port's key generators are
(``rlwe/keys.py``): ``sample_flagship`` draws the secret, the
relinearization key's rows and the two encryptions from one
``torch.Generator``, and ``flagship_from_samples`` computes the keys and the
ciphertexts from them.  A test hands the second the arrays the JAX package
drew and gets its objects back.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from matrix_fhe_tpu_torch.rlwe import encryptor, keys as K
from matrix_fhe_tpu_torch.rlwe.elements import Ciphertext
from matrix_fhe_tpu_torch.schemes import ckks


@dataclasses.dataclass(frozen=True)
class FlagshipSamples:
    """The random part of ``build_flagship``: the secret's coefficients, the
    relinearization key's rows and the two ciphertexts' draws."""
    secret: torch.Tensor
    rlk: list[K.ZeroSample]
    ct1: encryptor.SkSample
    ct2: encryptor.SkSample


def flagship_parameters(logn: int = 14, num_q: int = 9, num_p: int = 1,
                        device="cuda") -> ckks.CKKSParameters:
    """PN14QP438-style parameter set (schemes/ckks/example_parameters.go:11:
    logN=14, logQP ~ 438 = 55 + 8*45 + 61), scale 2^45."""
    logq = (55,) + (45,) * (num_q - 1)
    logp = (61,) * num_p
    return ckks.new_parameters(ckks.CKKSParametersLiteral(
        logn=logn, logq=logq, logp=logp, log_default_scale=45), device)


def flagship_vectors(params: ckks.CKKSParameters, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """The two complex slot vectors, drawn from ``default_rng(seed)`` as the
    JAX package draws them."""
    rng = np.random.default_rng(seed)
    slots = params.max_slots
    v1 = rng.uniform(-1, 1, slots) + 1j * rng.uniform(-1, 1, slots)
    v2 = rng.uniform(-1, 1, slots) + 1j * rng.uniform(-1, 1, slots)
    return v1, v2


def sample_flagship(gen: torch.Generator, params: ckks.CKKSParameters) -> FlagshipSamples:
    secret = K.sample_secret(gen, params)
    rlk = K.sample_evaluation_key(gen, params)
    ct1 = encryptor.sample_sk(gen, params)
    return FlagshipSamples(secret=secret, rlk=rlk, ct1=ct1, ct2=encryptor.sample_sk(gen, params))


def flagship_from_samples(params: ckks.CKKSParameters, s: FlagshipSamples, seed: int = 0):
    """(sk, rlk, evaluator, ct1, ct2) from the draws ``s`` and the slot
    vectors of ``seed``."""
    sk = K.secret_key_from_sample(params, s.secret)
    rlk = K.relinearization_key_from_samples(params, sk, s.rlk)
    ev = ckks.Evaluator(params, rlk=rlk)
    enc = ckks.Encoder(params)
    v1, v2 = flagship_vectors(params, seed)
    ct1 = encryptor.encrypt_from_sample(params, sk, enc.encode(v1), s.ct1)
    ct2 = encryptor.encrypt_from_sample(params, sk, enc.encode(v2), s.ct2)
    return sk, rlk, ev, ct1, ct2


def build_flagship(logn: int = 14, num_q: int = 9, num_p: int = 1, seed: int = 0,
                   device="cuda"):
    """The parameters, their secret and relinearization keys, an evaluator
    and two encryptions of ``flagship_vectors(seed)``, on ``device``; the
    draws come from a CPU generator seeded with ``seed``, so every device
    gets the same objects."""
    params = flagship_parameters(logn, num_q, num_p, device)
    s = sample_flagship(torch.Generator().manual_seed(seed), params)
    return (params, *flagship_from_samples(params, s, seed))


def make_step(params, ev, metadata):
    """A (ct0_values, ct1_values, rlk) -> out_values step: rescale(mul_relin)."""
    def step(c0, c1, d0, d1, rlk):
        ev2 = ckks.Evaluator(params, rlk=rlk)
        a = Ciphertext(value=(c0, c1), metadata=metadata)
        b = Ciphertext(value=(d0, d1), metadata=metadata)
        return ev2.rescale(ev2.mul_relin(a, b)).value

    return step
