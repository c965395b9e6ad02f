"""RNS rings over 64-bit words and their negacyclic NTT, as torch ops.

Counterpart of ``matrix_fhe_tpu/ops/rings.py`` (the reference's
ring/ring.go, ring/subring.go and ring/ntt.go) for the standard ring
Z_Q[X]/(X^N + 1), N a power of two:

  * a polynomial is an int64 tensor [..., L, N] of 64-bit words
    (``ops/modmath.py``), canonical in [0, q) at op boundaries;
  * the NTT tables (Montgomery-form psi powers in bit-reversed order,
    ring/subring.go:129-214) are built on the host with Python big ints;
  * the forward / inverse NTT are log N vectorized Cooley-Tukey /
    Gentleman-Sande stages with exact modular arithmetic per stage, so the
    outputs equal the reference's after its final reduction, and the JAX
    package's bit for bit.

These torch-op transforms are the parity oracle of the setup path and the
plain version of kernel B4 (``ops/ntt64_cuda.py``, ``csrc/ntt64.cu``):
``Ring.ntt``/``intt`` run them on a CPU tensor and launch B4 on a CUDA
tensor, with the plain psi powers and Shoup quotients the ring also holds.
The keys, the encoder, the u64 and wide evaluators run on them, and the
int32 fast path (``fast/fring.py``, kernel B1) is held against them.

The conjugate-invariant ring and the 3N "matrix" ring of the JAX package are
not ported yet (ROADMAP A8): ``new_ring`` refuses them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from matrix_fhe_tpu_torch.ops import modmath as mm
from matrix_fhe_tpu_torch.ops import ntt64_cuda
from matrix_fhe_tpu_torch.ops.tables import bit_reverse
from matrix_fhe_tpu_torch.utils import primes as pr
from matrix_fhe_tpu_torch.utils.device import resolve_device

STANDARD = "standard"
CONJUGATE_INVARIANT = "conjugate_invariant"
MATRIX = "matrix"


def _words(values: list[int], device) -> torch.Tensor:
    """int64 [L] tensor holding the 64-bit words ``values`` (Python ints)."""
    return torch.tensor([mm.signed(v) for v in values], dtype=torch.int64,
                        device=device)


def _gen_subring_tables(nth_root: int, q: int) -> dict:
    """Per-prime NTT constants, mirroring ring/subring.go:129-214."""
    mm.check_modulus(q)
    if not pr.is_prime(q):
        raise ValueError(f"modulus {q} is not prime")
    if q % nth_root != 1:
        raise ValueError(f"modulus {q} != 1 mod NthRoot={nth_root}")
    bhi, blo = mm.gen_bred_constant(q)
    g, _ = pr.primitive_root(q)
    psi = pow(g, (q - 1) // nth_root, q)
    psi_inv = pow(g, (q - 1) - (q - 1) // nth_root, q)
    half = nth_root >> 1
    log_half = half.bit_length() - 1
    out = {k: [0] * half for k in ("roots_fwd", "roots_bwd", "psi", "psi_shoup",
                                   "ipsi", "ipsi_shoup")}
    # roots_fwd[bitrev(j)] = psi^j * 2^64 mod q (ring/subring.go:198-211);
    # B4 takes psi^j and its Shoup quotient floor(psi^j * 2^64 / q)
    pw_f, pw_b = 1, 1
    for j in range(half):
        rj = bit_reverse(j, log_half)
        out["psi_shoup"][rj], out["roots_fwd"][rj] = divmod(pw_f << 64, q)
        out["ipsi_shoup"][rj], out["roots_bwd"][rj] = divmod(pw_b << 64, q)
        out["psi"][rj], out["ipsi"][rj] = pw_f, pw_b
        pw_f = pw_f * psi % q
        pw_b = pw_b * psi_inv % q
    ninv = pow(half, q - 2, q)
    return {"qinv": mm.gen_mred_constant(q), "bhi": bhi, "blo": blo,
            "ninv": (ninv << 64) % q, "ninv_plain": ninv,
            "ninv_shoup": (ninv << 64) // q, **out}


@dataclasses.dataclass(frozen=True)
class Ring:
    """An RNS ring R_Q = Z_Q[X]/(X^N + 1) at a given level (ring/ring.go:76).

    Tensor fields have leading dimension L = level + 1 and live on one
    device; ``at_level`` returns a view with sliced tables."""

    n: int
    nth_root: int
    ring_type: str
    moduli_tuple: tuple[int, ...]
    moduli: torch.Tensor     # int64 [L]
    qinv: torch.Tensor       # int64 [L]  q^-1 mod 2^64 (bits)
    bhi: torch.Tensor        # int64 [L]  Barrett constant, high word (bits)
    blo: torch.Tensor        # int64 [L]  Barrett constant, low word (bits)
    ninv: torch.Tensor       # int64 [L]  MForm(N^-1)
    roots_fwd: torch.Tensor  # int64 [L, N] Montgomery psi powers, bit-reversed
    roots_bwd: torch.Tensor  # int64 [L, N]
    # rescale[j-1, i] = MForm(qi - qj^-1 mod qi) for i < j, zero-padded
    # (ring/ring.go:363-380 rewRescaleConstants)
    rescale: torch.Tensor
    # B4's tables: plain psi powers (bit-reversed, as roots_*), their Shoup
    # quotients floor(w * 2^64 / q) (the bits of a uint64), N^-1 and its quotient
    psi: torch.Tensor         # int64 [L, N]
    psi_shoup: torch.Tensor   # int64 [L, N]
    ipsi: torch.Tensor        # int64 [L, N]
    ipsi_shoup: torch.Tensor  # int64 [L, N]
    ninv_plain: torch.Tensor  # int64 [L]
    ninv_shoup: torch.Tensor  # int64 [L]

    @property
    def device(self) -> torch.device:
        return self.moduli.device

    @property
    def level(self) -> int:
        return len(self.moduli_tuple) - 1

    @property
    def num_limbs(self) -> int:
        return len(self.moduli_tuple)

    def at_level(self, level: int) -> "Ring":
        if level == self.level:
            return self
        if level > self.level:
            raise ValueError(f"at_level({level}) above the built level {self.level}")
        return self.limbs(0, level + 1)

    def limbs(self, start: int, end: int) -> "Ring":
        """View of limbs [start, end); the rescale triangle is kept whole
        (its rows are indexed by level)."""
        s = slice(start, end)
        return dataclasses.replace(
            self, moduli_tuple=self.moduli_tuple[s], moduli=self.moduli[s],
            qinv=self.qinv[s], bhi=self.bhi[s], blo=self.blo[s],
            ninv=self.ninv[s], roots_fwd=self.roots_fwd[s],
            roots_bwd=self.roots_bwd[s], psi=self.psi[s], psi_shoup=self.psi_shoup[s],
            ipsi=self.ipsi[s], ipsi_shoup=self.ipsi_shoup[s],
            ninv_plain=self.ninv_plain[s], ninv_shoup=self.ninv_shoup[s])

    def modulus_at_level(self, level: int | None = None) -> int:
        """Product of moduli up to ``level`` (ring/ring.go ModulusAtLevel)."""
        level = self.level if level is None else level
        m = 1
        for q in self.moduli_tuple[: level + 1]:
            m *= q
        return m

    def _c(self, a: torch.Tensor) -> torch.Tensor:
        return a[:, None]

    # -- elementwise ring operations (ring/operations.go) --------------------
    def add(self, p1, p2):
        return mm.cred(p1 + p2, self._c(self.moduli))

    def sub(self, p1, p2):
        q = self._c(self.moduli)
        return mm.cred(p1 + q - p2, q)

    def neg(self, p1):
        return self._c(self.moduli) - p1  # input must be in [0, q)

    def reduce(self, p1):
        return mm.bred_add(p1, self._c(self.moduli), self._c(self.bhi))

    def mform(self, p1):
        return mm.mform(p1, self._c(self.moduli), self._c(self.bhi), self._c(self.blo))

    def imform(self, p1):
        return mm.imform(p1, self._c(self.moduli), self._c(self.qinv))

    def mul_coeffs_montgomery(self, p1, p2):
        return mm.mred(p1, p2, self._c(self.moduli), self._c(self.qinv))

    def mul_coeffs_montgomery_then_add(self, p1, p2, p3):
        return self.add(self.mul_coeffs_montgomery(p1, p2), p3)

    def mul_coeffs_montgomery_then_sub(self, p1, p2, p3):
        return self.sub(p3, self.mul_coeffs_montgomery(p1, p2))

    def mul_coeffs_barrett(self, p1, p2):
        return mm.bred(p1, p2, self._c(self.moduli), self._c(self.bhi),
                       self._c(self.blo))

    def mul_scalar_montgomery(self, p1, scalar_mont):
        """scalar_mont: [L] per-limb Montgomery-form scalars."""
        s = torch.as_tensor(scalar_mont, dtype=torch.int64, device=self.device)
        return mm.mred(p1, self._c(s), self._c(self.moduli), self._c(self.qinv))

    def add_scalar(self, p1, scalar):
        """scalar: Python int or [L] per-limb values."""
        return mm.cred(p1 + self._c(self._scalar_limbs(scalar)), self._c(self.moduli))

    def sub_scalar(self, p1, scalar):
        s = self._scalar_limbs(scalar)
        return mm.cred(p1 + self._c(self.moduli - s), self._c(self.moduli))

    def _scalar_limbs(self, scalar) -> torch.Tensor:
        if isinstance(scalar, int):
            scalar = [scalar % q for q in self.moduli_tuple]
        elif isinstance(scalar, np.ndarray):
            scalar = scalar.astype(np.int64)  # residues < 2^61
        return torch.as_tensor(scalar, dtype=torch.int64, device=self.device)

    # -- NTT: kernel B4 on a CUDA tensor, the torch ops below on the CPU ------
    def ntt(self, p: torch.Tensor) -> torch.Tensor:
        return ntt64_cuda.ntt_fwd(p.contiguous(), self)

    def intt(self, p: torch.Tensor) -> torch.Tensor:
        return ntt64_cuda.ntt_bwd(p.contiguous(), self)


def new_ring(n: int, moduli: list[int], ring_type: str = STANDARD,
             device="cuda") -> Ring:
    """RNS ring with freshly generated NTT tables on ``device`` (the card
    unless told otherwise; ring/ring.go:264-308 NewRing)."""
    if ring_type in (CONJUGATE_INVARIANT, MATRIX):
        raise NotImplementedError(
            f"ring type {ring_type!r} is not ported yet (ROADMAP A8)")
    if ring_type != STANDARD:
        raise ValueError(f"unknown ring type {ring_type!r}")
    device = resolve_device(device)
    if n < 16 or n & (n - 1):
        raise ValueError("N must be a power of two >= 16")
    if len(set(moduli)) != len(moduli):
        raise ValueError("moduli must be distinct")
    moduli = [int(q) for q in moduli]
    nth_root = 2 * n
    tabs = [_gen_subring_tables(nth_root, q) for q in moduli]

    L = len(moduli)
    rescale = [[0] * max(L - 1, 1) for _ in range(max(L - 1, 1))]
    for j in range(L - 1, 0, -1):
        qj = moduli[j]
        for i in range(j):
            qi = moduli[i]
            rescale[j - 1][i] = ((qi - pow(qj, qi - 2, qi)) << 64) % qi

    def col(key):
        return _words([t[key] for t in tabs], device)

    def rows(key):  # [L, N] words (the Shoup quotients may pass 2^63)
        return torch.tensor([[mm.signed(v) for v in t[key]] for t in tabs],
                            dtype=torch.int64, device=device)

    return Ring(
        n=n, nth_root=nth_root, ring_type=STANDARD, moduli_tuple=tuple(moduli),
        moduli=_residues(moduli, device), qinv=col("qinv"), bhi=col("bhi"),
        blo=col("blo"), ninv=col("ninv"),
        roots_fwd=_residues([t["roots_fwd"] for t in tabs], device),
        roots_bwd=_residues([t["roots_bwd"] for t in tabs], device),
        rescale=_residues(rescale, device),
        psi=_residues([t["psi"] for t in tabs], device), psi_shoup=rows("psi_shoup"),
        ipsi=_residues([t["ipsi"] for t in tabs], device), ipsi_shoup=rows("ipsi_shoup"),
        ninv_plain=col("ninv_plain"), ninv_shoup=col("ninv_shoup"))


def _residues(values, device) -> torch.Tensor:
    """int64 tensor of values below 2^63 (residues, moduli)."""
    return torch.tensor(values, dtype=torch.int64, device=device)


# ---------------------------------------------------------------------------
# The NTT (ring/ntt.go), as torch ops.
# ---------------------------------------------------------------------------

def _ntt_standard(x: torch.Tensor, roots: torch.Tensor, q: torch.Tensor,
                  qinv: torch.Tensor) -> torch.Tensor:
    """Negacyclic forward NTT, Cooley-Tukey DIT with bit-reversed Montgomery
    roots; the output order and values of ring/ntt.go:223-257 after its
    final reduction."""
    *batch, L, N = x.shape
    logn = N.bit_length() - 1
    qq, qi = q[:, None, None], qinv[:, None, None]
    for s in range(logn):
        m, t = 1 << s, N >> (s + 1)
        x = x.reshape(*batch, L, m, 2, t)
        F = roots[:, m:2 * m].reshape(L, m, 1)
        u, v = x[..., 0, :], mm.mred(x[..., 1, :], F, qq, qi)
        x = torch.stack([mm.cred(u + v, qq), mm.cred(u + qq - v, qq)], dim=-2)
    return x.reshape(*batch, L, N)


def _intt_standard(x: torch.Tensor, roots: torch.Tensor, ninv: torch.Tensor,
                   q: torch.Tensor, qinv: torch.Tensor) -> torch.Tensor:
    """Negacyclic inverse NTT, Gentleman-Sande DIF (ring/ntt.go:555-606),
    then the scale by NInv (Montgomery form)."""
    *batch, L, N = x.shape
    logn = N.bit_length() - 1
    qq, qi = q[:, None, None], qinv[:, None, None]
    for s in range(logn - 1, -1, -1):
        m, t = 1 << s, N >> (s + 1)
        x = x.reshape(*batch, L, m, 2, t)
        F = roots[:, m:2 * m].reshape(L, m, 1)
        u, v = x[..., 0, :], x[..., 1, :]
        x = torch.stack([mm.cred(u + v, qq), mm.mred(u + qq - v, F, qq, qi)], dim=-2)
    x = x.reshape(*batch, L, N)
    return mm.mred(x, ninv[:, None], q[:, None], qinv[:, None])
