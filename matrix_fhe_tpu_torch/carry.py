"""Carry the JAX package's objects over to the port.

``carry(obj)`` returns the port's counterpart of a JAX-package object,
reading its arrays through ``np.asarray``: parameters (by their moduli and
literal), literals and distributions, keys (secret, public,
relinearization, galois and evaluation keys, in both gadget flavours),
ciphertexts and plaintexts with their metadata, the bootstrapping
parameters, literal and evaluation keys (the encapsulation keys included),
the 3N ring's literals (RLWE and Matrix-CKKS) and its factorized NTT
tables (with kernel B5's, rebuilt from each limb's modulus and root, which
its twist row gives back), the sharded NTT's four-step tables
(``ShardedNTTTables``, word for word), the BGV literal and parameters
(their ring_t and QMul basis rebuilt from T and the chain), a
RingPackingEvaluator (its parameters, secrets, ring-switching and galois
keys and monomials), RGSW
ciphertexts and blind-rotation keys (their RGSW ciphertexts and galois
keys), the CKKS refresh's shares (``RefreshShare``), and dicts, lists and
tuples of them (the ring-swap key pairs of ``rlwe/ring_switch.py`` and
``schemes/ckks/bridge.py``, and the multiparty protocols' lists of shares
and of (h0, h1) pairs, among them), and numpy arrays (their words).  It works
by the class name and the field names the two packages share, so it
imports nothing of the JAX package; any object with those fields as numpy
arrays is carried the same way.  64-bit words keep their
bits (uint64 arrays are viewed as int64, the port's word type); int32
fast-path limbs stay int32.

The fast-path counterpart for a context's key stacks is
``fast/fckks.py:context_from_arrays``; ``fast/fckks.py:make_context`` builds
a context from carried keys.

``carry_wide(obj, params)`` carries the JAX package's wide-path objects,
whose residues are centered int32 pairs [.., 2, L, N]: a ``WideCKKSContext``
(its rings' moduli, its key stacks and galois elements), wide ciphertexts,
plaintexts and pair arrays.  Each pair becomes the port's canonical word
through ``ops/wide.py:unpack_pair``, read in the JAX mode of the parameter
set (``use_pair31`` over ``params``' q and p moduli; a context carries its
own).
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction

import numpy as np
import torch

from matrix_fhe_tpu_torch.circuits.ckks import bootstrapping as btp
from matrix_fhe_tpu_torch.multiparty import mpckks
from matrix_fhe_tpu_torch.ops import ntt_3n
from matrix_fhe_tpu_torch.ops import ntt_sharded_cuda
from matrix_fhe_tpu_torch.ops import samplers as smp
from matrix_fhe_tpu_torch.ops import wide
from matrix_fhe_tpu_torch.rgsw import blindrot, rgsw
from matrix_fhe_tpu_torch.rlwe import elements as el
from matrix_fhe_tpu_torch.rlwe import keys as K
from matrix_fhe_tpu_torch.rlwe import params as rp
from matrix_fhe_tpu_torch.rlwe import ring_packing as rpk
from matrix_fhe_tpu_torch.schemes import bgv
from matrix_fhe_tpu_torch.schemes.ckks import params as cp
from matrix_fhe_tpu_torch.schemes.matrix_ckks import scheme as mc
from matrix_fhe_tpu_torch.utils.device import resolve_device


def _words(a, device) -> torch.Tensor:
    arr = np.array(a, copy=True, order="C")  # writable, as torch needs
    if arr.dtype == np.uint64:
        arr = arr.view(np.int64)
    return torch.from_numpy(arr).to(device)


def _literal(cls, obj):
    """A port dataclass from the same-named fields of ``obj``."""
    kw = {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)}
    for f in ("xe", "xs"):
        if f in kw:
            kw[f] = _DIST[type(kw[f]).__name__](kw[f])
    return cls(**kw)


_DIST = {
    "DiscreteGaussian": lambda o: smp.DiscreteGaussian(sigma=o.sigma, bound=o.bound),
    "Ternary": lambda o: smp.Ternary(p=o.p, h=o.h),
}


def carry(obj, device="cuda"):
    """The port's counterpart of ``obj`` (see the module docstring), its
    tensors on ``device`` (the card unless told otherwise)."""
    device = resolve_device(device)

    def go(o):
        return carry(o, device)

    def words(a):
        return None if a is None else _words(a, device)

    if obj is None:
        return None
    if isinstance(obj, np.ndarray):
        return words(obj)
    if isinstance(obj, dict):
        return {k: go(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(go(v) for v in obj)
    name = type(obj).__name__
    if name in _DIST:
        return _DIST[name](obj)
    # bootstrapping's literal and parameters share their class names with
    # rlwe's: they are told apart by a field of their own
    if name == "ParametersLiteral" and hasattr(obj, "residual_log_q"):
        return _literal(btp.ParametersLiteral, obj)
    if name == "Parameters" and hasattr(obj, "c2s_lit"):
        return btp.Parameters(go(obj.lit), device)
    if name == "EvaluationKeys":
        return btp.EvaluationKeys(
            rlk=go(obj.rlk), gks=go(obj.gks), evk_dense_to_sparse=go(obj.evk_dense_to_sparse),
            evk_sparse_to_dense=go(obj.evk_sparse_to_dense))
    if name == "ParametersLiteral":
        return _literal(rp.ParametersLiteral, obj)
    if name == "CKKSParametersLiteral":
        return _literal(cp.CKKSParametersLiteral, obj)
    if name == "Parameters3NLiteral":
        return _literal(rp.Parameters3NLiteral, obj)
    if name == "MatrixCKKSParametersLiteral":
        return _literal(mc.MatrixCKKSParametersLiteral, obj)
    if name == "NTT3NTables":
        # the JAX tables hold no moduli: each limb's q and omega are read
        # back from its twist row, and kernel B5's tables built from them
        perm = np.asarray(obj.perm, dtype=np.int64)
        moduli, omegas = zip(*(ntt_3n.modulus_and_root(row) for row in np.asarray(obj.tw1)))
        return ntt_3n.NTT3NTables(
            n=int(obj.n), rows=int(obj.rows), cols=int(obj.cols),
            **{f: words(getattr(obj, f)) for f in ntt_3n.LIMB_FIELDS},
            **{f: torch.from_numpy(np.asarray(getattr(obj, f), dtype=np.int64)).to(device)
               for f in ("perm", "iperm")},
            **ntt_3n.kernel_tables(int(obj.n), moduli, omegas, perm.tolist(), device))
    if name == "ShardedNTTTables":
        return ntt_sharded_cuda.ShardedNTTTables(
            n=int(obj.n), rows=int(obj.rows), cols=int(obj.cols),
            **{f: words(getattr(obj, f))
               for f in ("a_mat", "bt_mat", "tw", "moduli", "qinv", "bhi")})
    if name == "BGVParametersLiteral":
        return _literal(bgv.BGVParametersLiteral, obj)
    if name == "BGVParameters":
        return bgv.new_parameters(bgv.BGVParametersLiteral(
            logn=obj.n.bit_length() - 1, t=int(obj.t), q=tuple(obj.q), p=tuple(obj.p),
            xe=go(obj.xe), xs=go(obj.xs)), device)
    if name == "RingPackingEvaluator":
        return rpk.RingPackingEvaluator.from_keys(
            go(obj.params), go(obj.sk), go(obj.evk_up), go(obj.evk_down), go(obj.gks_min),
            *({ln: [words(m) for m in ms] for ln, ms in getattr(obj, f).items()}
              for f in ("x_pow2", "x_inv_pow2")))
    if name == "CKKSParameters":
        return cp.new_parameters(cp.CKKSParametersLiteral(
            logn=obj.n.bit_length() - 1, q=tuple(obj.q), p=tuple(obj.p),
            log_default_scale=obj.log_default_scale, ring_type=obj.ring_type,
            xe=go(obj.xe), xs=go(obj.xs)), device)
    if name == "Parameters":
        out = rp.Parameters(n=obj.n, nth_root=obj.nth_root, q=list(obj.q), p=list(obj.p),
                            xe=go(obj.xe), xs=go(obj.xs), ring_type=obj.ring_type,
                            ntt_flag=obj.ntt_flag, default_scale=obj.default_scale,
                            device=device)
        if hasattr(obj, "log_default_scale"):  # Matrix-CKKS parameters
            out.log_default_scale = obj.log_default_scale
        return out
    if name == "MetaData":
        return el.MetaData(scale=Fraction(obj.scale),
                           log_dimensions=tuple(obj.log_dimensions),
                           is_batched=obj.is_batched, is_ntt=obj.is_ntt,
                           is_montgomery=obj.is_montgomery)
    if name == "Ciphertext":
        return el.Ciphertext(value=tuple(words(v) for v in obj.value),
                             metadata=go(obj.metadata))
    if name == "Plaintext":
        return el.Plaintext(value=words(obj.value), metadata=go(obj.metadata))
    if name == "QPPoly":
        return K.QPPoly(q=words(obj.q), p=words(obj.p))
    if name == "SecretKey":
        return K.SecretKey(value=go(obj.value))
    if name == "PublicKey":
        return K.PublicKey(value=tuple(go(v) for v in obj.value))
    if name == "GadgetCiphertext":
        return K.GadgetCiphertext(q=words(obj.q), p=words(obj.p), base_two=int(obj.base_two))
    if name == "EvaluationKey":
        return K.EvaluationKey(gadget=go(obj.gadget))
    if name == "RelinearizationKey":
        return K.RelinearizationKey(gadget=go(obj.gadget))
    if name == "GaloisKey":
        return K.GaloisKey(gadget=go(obj.gadget), gal_el=int(obj.gal_el))
    if name == "RGSWCiphertext":
        return rgsw.RGSWCiphertext(g0=go(obj.g0), g1=go(obj.g1))
    if name == "BlindRotationKeys":
        return blindrot.BlindRotationKeys(brks=go(obj.brks), gks=go(obj.gks))
    if name == "RefreshShare":
        return mpckks.RefreshShare(e2s=words(obj.e2s), s2e=words(obj.s2e),
                                   metadata=go(obj.metadata))
    raise TypeError(f"no port counterpart for {name}")


def carry_wide(obj, params=None, device="cuda"):
    """The port's counterpart of a JAX wide-path object (see the module
    docstring), its words on ``device``.  ``params`` (the JAX package's or
    the port's parameters: anything with ``q`` and ``p``) gives the moduli
    of ciphertexts, plaintexts and arrays; a context needs none."""
    from matrix_fhe_tpu_torch.fast import wckks
    device = resolve_device(device)
    name = type(obj).__name__
    if name == "WideCKKSContext":
        Q = [int(q) for q in obj.ring_q.moduli_tuple]
        P = [int(p) for p in obj.ring_p.moduli_tuple]
        pair31 = obj.ring_q.tabs.shift == 31

        def words(a, mods):
            return None if a is None else wide.unpack_pair(np.asarray(a), mods, pair31)

        return wckks.context_from_arrays(
            obj.ring_q.n, Q, P, words(obj.rlk_q, Q), words(obj.rlk_p, P),
            words(obj.gk_q, Q), words(obj.gk_p, P), tuple(obj.gal_els),
            obj.rescale_limbs, device=device)
    Q = [int(q) for q in params.q]
    pair31 = wide.use_pair31(Q + [int(p) for p in (params.p or ())])

    def unpack(a):
        a = np.asarray(a)
        return _words(wide.unpack_pair(a, Q[: a.shape[-2]], pair31), device)

    if name == "Ciphertext":
        return el.Ciphertext(value=tuple(unpack(v) for v in obj.value),
                             metadata=carry(obj.metadata, device))
    if name == "Plaintext":
        return el.Plaintext(value=unpack(obj.value), metadata=carry(obj.metadata, device))
    return unpack(obj)
