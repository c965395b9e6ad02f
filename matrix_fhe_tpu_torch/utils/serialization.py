"""Binary serialization: the FHE analogue of checkpoint/resume.

Counterpart of ``matrix_fhe_tpu/utils/serialization.py`` (the reference's
WriteTo/ReadFrom/MarshalBinary subsystem over utils/buffer, SURVEY.md
section 5.4), in the same wire format: a blob the port writes is byte for
byte the JAX package's blob of the same object, and each package loads the
other's.  It serializes parameters (``rlwe.Parameters`` and its subclasses,
as their literal: they regenerate every table on load,
ring/subring.go:334-417 semantics), plaintexts, ciphertexts, secret and
public keys, gadget ciphertexts, relinearization, evaluation and galois
keys, and RGSW ciphertexts, each with the standard (RNS) gadget: a
base-two gadget is refused, as the format has no field for its digit width
(the JAX package writes it and loads it back as the RNS gadget).

Format: a small JSON header (type tag + metadata + array manifest) length-
prefixed, followed by raw little-endian array payloads.  Words go out as
``uint64``, as the JAX package holds them; the port holds them as int64
(``ops/modmath.py``), so ``save`` views them as uint64 and ``load`` views
them back, on the device it is given.
"""

from __future__ import annotations

import io
import json
import struct
from fractions import Fraction

import numpy as np
import torch

from matrix_fhe_tpu_torch.utils.device import resolve_device

MAGIC = b"MFT1"  # matrix-fhe-tpu wire format v1


# ---------------------------------------------------------------------------
# Core writer/reader.
# ---------------------------------------------------------------------------

def _np(t: torch.Tensor) -> np.ndarray:
    """A tensor as the array the JAX package writes: int64 words as uint64."""
    a = t.detach().cpu().contiguous().numpy()
    return a.view(np.uint64) if a.dtype == np.int64 else a


def _write_blob(w: io.BufferedIOBase, header: dict, arrays: list[torch.Tensor]) -> int:
    arrays = [_np(a) for a in arrays]
    manifest = [{"dtype": str(a.dtype), "shape": list(a.shape)} for a in arrays]
    head = json.dumps({"h": header, "m": manifest}, separators=(",", ":")).encode()
    n = w.write(MAGIC)
    n += w.write(struct.pack("<I", len(head)))
    n += w.write(head)
    for a in arrays:
        n += w.write(a.tobytes())
    return n


def _read_blob(r: io.BufferedIOBase, device: torch.device) -> tuple[dict, list[torch.Tensor]]:
    magic = r.read(4)
    if magic != MAGIC:
        raise ValueError(f"bad magic {magic!r}")
    (hlen,) = struct.unpack("<I", r.read(4))
    meta = json.loads(r.read(hlen).decode())
    arrays = []
    for m in meta["m"]:
        dt = np.dtype(m["dtype"])
        count = int(np.prod(m["shape"])) if m["shape"] else 1
        a = np.frombuffer(r.read(count * dt.itemsize), dtype=dt).reshape(m["shape"])
        if dt == np.uint64:
            a = a.view(np.int64)
        arrays.append(torch.from_numpy(a.copy()).to(device))
    return meta["h"], arrays


def _frac(f: Fraction) -> list[str]:
    return [str(f.numerator), str(f.denominator)]


def _unfrac(v) -> Fraction:
    return Fraction(int(v[0]), int(v[1]))


# ---------------------------------------------------------------------------
# Object codecs.
# ---------------------------------------------------------------------------

def save(obj, w: io.BufferedIOBase | None = None) -> bytes | int:
    """Serialize any supported object; returns bytes if no writer given,
    else the number of bytes written."""
    if w is None:
        buf = io.BytesIO()
        save(obj, buf)
        return buf.getvalue()

    from matrix_fhe_tpu_torch.rgsw import RGSWCiphertext
    from matrix_fhe_tpu_torch.rlwe import keys as K
    from matrix_fhe_tpu_torch.rlwe.elements import Ciphertext, Plaintext
    from matrix_fhe_tpu_torch.rlwe.params import Parameters

    if isinstance(obj, Parameters):
        header = {"t": "params", "n": obj.n, "nth_root": obj.nth_root,
                  "q": [str(q) for q in obj.q], "p": [str(p) for p in obj.p],
                  "ring_type": obj.ring_type, "ntt_flag": obj.ntt_flag,
                  "default_scale": float(obj.default_scale),
                  "xe": [obj.xe.sigma, obj.xe.bound],
                  "xs": ([obj.xs.p, obj.xs.h] if hasattr(obj.xs, "p")
                         else [obj.xs.sigma, obj.xs.bound]),
                  "xs_kind": type(obj.xs).__name__}
        return _write_blob(w, header, [])

    if isinstance(obj, Plaintext):
        return _write_blob(w, {"t": "pt", "md": _metadata_dict(obj.metadata)}, [obj.value])

    if isinstance(obj, Ciphertext):
        return _write_blob(w, {"t": "ct", "md": _metadata_dict(obj.metadata),
                               "deg": obj.degree}, list(obj.value))

    if isinstance(obj, K.SecretKey):
        return _write_blob(w, {"t": "sk", "has_p": obj.value.p is not None},
                           _qp_arrays(obj.value))

    if isinstance(obj, K.PublicKey):
        return _write_blob(w, {"t": "pk", "has_p": obj.value[0].p is not None},
                           _qp_arrays(obj.value[0]) + _qp_arrays(obj.value[1]))

    if isinstance(obj, K.GadgetCiphertext):
        return _write_blob(w, {"t": "gct", "has_p": obj.p is not None}, _qp_arrays(obj))

    if isinstance(obj, K.RelinearizationKey):
        return _save_wrapped(w, "rlk", obj.gadget, {})

    if isinstance(obj, K.EvaluationKey):
        return _save_wrapped(w, "evk", obj.gadget, {})

    if isinstance(obj, K.GaloisKey):
        return _save_wrapped(w, "gk", obj.gadget, {"gal_el": obj.gal_el})

    if isinstance(obj, RGSWCiphertext):
        return _write_blob(w, {"t": "rgsw", "has_p": obj.g0.p is not None},
                           _qp_arrays(obj.g0) + _qp_arrays(obj.g1))

    raise TypeError(f"cannot serialize {type(obj).__name__}")


def _save_wrapped(w, tag, gadget, extra):
    h = {"t": tag, "has_p": gadget.p is not None}
    h.update(extra)
    return _write_blob(w, h, _qp_arrays(gadget))


def _metadata_dict(md) -> dict:
    return {"scale": _frac(md.scale), "log_dims": list(md.log_dimensions),
            "batched": md.is_batched, "ntt": md.is_ntt,
            "mont": md.is_montgomery}


def _metadata_from(d):
    from matrix_fhe_tpu_torch.rlwe.elements import MetaData
    return MetaData(scale=_unfrac(d["scale"]),
                    log_dimensions=tuple(d["log_dims"]),
                    is_batched=d["batched"], is_ntt=d["ntt"],
                    is_montgomery=d["mont"])


def _qp_arrays(qp) -> list[torch.Tensor]:
    """The q part and, where there is one, the p part (a QPPoly or a gadget).
    The format has no field for a base-two gadget's digit width: such a
    blob would load as the RNS gadget, another key, so it is refused."""
    if getattr(qp, "base_two", 0):
        raise ValueError(f"cannot serialize a base-two gadget (base_two={qp.base_two}): "
                         "the wire format has no field for it")
    return [qp.q] if qp.p is None else [qp.q, qp.p]


def load(data: bytes | io.BufferedIOBase, device="cuda"):
    """Deserialize an object written by ``save`` (or by the JAX package's),
    its tensors on ``device`` (the card unless told otherwise)."""
    device = resolve_device(device)
    r = io.BytesIO(data) if isinstance(data, (bytes, bytearray)) else data
    header, arrays = _read_blob(r, device)
    t = header["t"]

    from matrix_fhe_tpu_torch.ops import samplers as smp
    from matrix_fhe_tpu_torch.rgsw import RGSWCiphertext
    from matrix_fhe_tpu_torch.rlwe import keys as K
    from matrix_fhe_tpu_torch.rlwe.elements import Ciphertext, Plaintext
    from matrix_fhe_tpu_torch.rlwe.params import Parameters

    if t == "params":
        if header["xs_kind"] == "Ternary":
            xs = smp.Ternary(p=header["xs"][0], h=header["xs"][1])
        else:
            xs = smp.DiscreteGaussian(sigma=header["xs"][0], bound=header["xs"][1])
        return Parameters(
            n=header["n"], nth_root=header["nth_root"],
            q=[int(x) for x in header["q"]], p=[int(x) for x in header["p"]],
            xe=smp.DiscreteGaussian(*header["xe"]), xs=xs,
            ring_type=header["ring_type"], ntt_flag=header["ntt_flag"],
            default_scale=header["default_scale"], device=device)

    if t == "pt":
        return Plaintext(value=arrays[0], metadata=_metadata_from(header["md"]))
    if t == "ct":
        return Ciphertext(value=tuple(arrays), metadata=_metadata_from(header["md"]))

    def qp(arr_list):
        return K.QPPoly(q=arr_list[0], p=arr_list[1] if header["has_p"] else None)

    if t == "sk":
        return K.SecretKey(value=qp(arrays))
    if t == "pk":
        h = 2 if header["has_p"] else 1
        return K.PublicKey(value=(qp(arrays[:h]), qp(arrays[h:])))
    if t == "gct":
        return _gct(header, arrays)
    if t == "rlk":
        return K.RelinearizationKey(gadget=_gct(header, arrays))
    if t == "evk":
        return K.EvaluationKey(gadget=_gct(header, arrays))
    if t == "gk":
        return K.GaloisKey(gadget=_gct(header, arrays), gal_el=header["gal_el"])
    if t == "rgsw":
        h = 2 if header["has_p"] else 1
        return RGSWCiphertext(g0=_gct(header, arrays[:h]), g1=_gct(header, arrays[h:]))
    raise ValueError(f"unknown type tag {t!r}")


def _gct(header, arrays):
    from matrix_fhe_tpu_torch.rlwe import keys as K
    return K.GadgetCiphertext(q=arrays[0], p=arrays[1] if header["has_p"] else None)
