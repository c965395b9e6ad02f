"""RNS rings over 64-bit words and their NTTs, as torch ops.

Counterpart of ``matrix_fhe_tpu/ops/rings.py`` (the reference's
ring/ring.go, ring/subring.go, ring/ntt.go and the fork's ring/ntt_3n.go)
for its three ring types:

  * the standard ring Z_Q[X]/(X^N + 1), N a power of two;
  * the conjugate-invariant (CI) ring Z_Q[X + X^-1]/(X^2N + 1), N a power
    of two, whose NTT is a fold by psi then the standard butterflies over
    the 4N-th roots (ring/ntt.go:737-786, :1090-1311);
  * the fork's 3N ("matrix") ring Z_Q[X]/(X^N - X^{N/2} + 1), N = 2^a 3^b,
    whose NTT evaluates at the N primitive 3N-th roots of unity in
    ascending exponent order (ring/ntt_3n.go): the factorized transform of
    ``ops/ntt_3n.py`` wherever N/2 splits as R C with R >= 2, and dense
    Montgomery evaluation matrices (built at first use, N <= 384) where it
    does not (N = 6).

A polynomial is an int64 tensor [..., L, N] of 64-bit words
(``ops/modmath.py``), canonical in [0, q) at op boundaries; the tables are
built on the host with Python big ints.  Every transform is exact, so the
outputs equal the reference's after its final reduction, and the JAX
package's bit for bit.

On a CUDA tensor ``Ring.ntt``/``intt`` launch a hand-written kernel: B4
(``ops/ntt64_cuda.py``, ``csrc/ntt64.cu``) for the standard and the CI
ring, with the plain psi powers and Shoup quotients the ring also holds
(re-indexed for the CI ring's stages), and B5 (``ops/ntt3n_cuda.py``,
``csrc/ntt3n.cu``) for a factorized 3N ring.  On a CPU tensor they run
the torch ops here and in ``ops/ntt_3n.py``, the kernels' plain versions.
The keys, the encoders, the u64 and wide evaluators and Matrix-CKKS run on
them, and the int32 fast path (``fast/fring.py``, kernel B1) is held
against them.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from matrix_fhe_tpu_torch.ops import modmath as mm
from matrix_fhe_tpu_torch.ops import ntt3n_cuda, ntt64_cuda
from matrix_fhe_tpu_torch.ops import ntt_3n as n3
from matrix_fhe_tpu_torch.ops.tables import bit_reverse_array
from matrix_fhe_tpu_torch.utils import primes as pr
from matrix_fhe_tpu_torch.utils.device import constant, resolve_device

STANDARD = "standard"
CONJUGATE_INVARIANT = "conjugate_invariant"
MATRIX = "matrix"  # the fork's 3N ring type (ring/ring.go:33)
# the dense 3N transform's O(N^3) host setup caps it at N = 384
MAX_DENSE_3N = 384


def is_valid_3n_degree(n: int) -> bool:
    """N = 2^a 3^b with a >= 1, so that X^{N/2} is integral
    (ring/subring.go:12-30)."""
    if n < 2 or n % 2:
        return False
    while n % 2 == 0:
        n //= 2
    while n % 3 == 0:
        n //= 3
    return n == 1


def _words(values: list[int], device) -> torch.Tensor:
    """int64 [L] tensor holding the 64-bit words ``values`` (Python ints)."""
    return torch.tensor([mm.signed(v) for v in values], dtype=torch.int64,
                        device=device)


def _limbs(values, device) -> torch.Tensor:
    """Per-limb scalars (a tensor, or integers < 2^63) as an int64 tensor on
    ``device``; integers are made there once (``constant``)."""
    if isinstance(values, torch.Tensor):
        return values.to(device=device, dtype=torch.int64)
    if isinstance(values, np.ndarray):
        values = values.astype(np.int64)  # residues < 2^61
    return constant(values, torch.int64, device)


def _constants(q: int, limit: int = mm.MAX_MODULUS) -> dict:
    """The reduction constants of one prime below ``limit``."""
    mm.check_modulus(q, limit)
    if not pr.is_prime(q):
        raise ValueError(f"modulus {q} is not prime")
    bhi, blo = mm.gen_bred_constant(q)
    return {"qinv": mm.gen_mred_constant(q), "bhi": bhi, "blo": blo}


def _gen_subring_tables(nth_root: int, q: int, limit: int = mm.MAX_MODULUS) -> dict:
    """Per-prime NTT constants of a power-of-two ring, mirroring
    ring/subring.go:129-214."""
    out = _constants(q, limit)
    if q % nth_root != 1:
        raise ValueError(f"modulus {q} != 1 mod NthRoot={nth_root}")
    g, _ = pr.primitive_root(q)
    psi = pow(g, (q - 1) // nth_root, q)
    psi_inv = pow(g, (q - 1) - (q - 1) // nth_root, q)
    half = nth_root >> 1
    log_half = half.bit_length() - 1
    out.update({k: [0] * half for k in ("roots_fwd", "roots_bwd", "psi", "psi_shoup",
                                        "ipsi", "ipsi_shoup")})
    # roots_fwd[bitrev(j)] = psi^j * 2^64 mod q (ring/subring.go:198-211);
    # B4 takes psi^j and its Shoup quotient floor(psi^j * 2^64 / q)
    pw_f, pw_b = 1, 1
    for j, rj in enumerate(bit_reverse_array(np.arange(half), log_half).tolist()):
        out["psi_shoup"][rj], out["roots_fwd"][rj] = divmod(pw_f << 64, q)
        out["ipsi_shoup"][rj], out["roots_bwd"][rj] = divmod(pw_b << 64, q)
        out["psi"][rj], out["ipsi"][rj] = pw_f, pw_b
        pw_f = pw_f * psi % q
        pw_b = pw_b * psi_inv % q
    ninv = pow(half, q - 2, q)
    out.update(ninv=(ninv << 64) % q, ninv_plain=ninv, ninv_shoup=(ninv << 64) // q)
    return out


def _ci_kernel_tables(t: dict, n: int, q: int) -> dict:
    """B4's tables for the CI ring.  Its butterfly stage s reads entry
    2^s + i of the table (the standard ring's psi powers); the CI ring's
    stage s reads entry 2^(s+1) + i of the 4N-th-root table (``_ntt_ci``),
    so B4 runs it on the table T[j] = psi[j + 2^floor(log2 j)], j >= 1.  Its
    stages end with no scale (``ninv_plain`` = 1): B4's CI mode folds on
    load and on store with the row ``fold_row``: F = psi^N (``roots_fwd[1]``
    out of Montgomery form), psi^-N (``roots_bwd[1]``) and (2N)^-1, each
    beside its Shoup quotient."""
    idx = [0] + [j + (1 << (j.bit_length() - 1)) for j in range(1, n)]
    out = {k: [t[k][i] if j else 0 for j, i in enumerate(idx)]
           for k in ("psi", "psi_shoup", "ipsi", "ipsi_shoup")}
    fold = []
    for v in (t["psi"][1], t["ipsi"][1], pow(2 * n, q - 2, q)):
        fold += [v, (v << 64) // q]
    return dict(t, **out, ninv_plain=1, ninv_shoup=(1 << 64) // q, fold_row=fold)


def _gen_3n_tables(nth_root: int, q: int) -> dict:
    """Per-prime constants of a 3N ring: the reduction constants, MForm(N^-1)
    and the deterministic primitive 3N-th root omega (the reference's
    3N transformer derives its own, ring/ntt_3n.go:39;
    ``utils/primes.find_3n_primitive_root``)."""
    out = _constants(q)
    if q % nth_root != 1:
        raise ValueError(f"modulus {q} != 1 mod NthRoot={nth_root}")
    _, factors = pr.primitive_root(q)
    omega, _ = pr.find_3n_primitive_root(q, nth_root, factors)
    ninv = pow(nth_root // 3, q - 2, q)
    out.update(ninv=(ninv << 64) % q, omega=omega)
    return out


@functools.lru_cache(maxsize=None)
def _dense_3n_matrices(n: int, q: int, omega: int) -> tuple[np.ndarray, np.ndarray]:
    """Montgomery-form evaluation matrix V[k, j] = x_k^j 2^64 mod q, with
    x_k = omega^E[k] (E the sorted totatives of 3N, ring/ntt_3n.go:234-243),
    and its exact inverse mod q (Gauss-Jordan on the host), as int64."""
    three_n = 3 * n
    E = [e for e in range(1, three_n) if math.gcd(e, three_n) == 1]
    assert len(E) == n, f"expected phi(3N)={n} totatives, got {len(E)}"
    V = [[pow(pow(omega, e, q), j, q) for j in range(n)] for e in E]
    A = [row[:] + [int(i == j) for j in range(n)] for i, row in enumerate(V)]
    for col in range(n):
        piv = next(r for r in range(col, n) if A[r][col] % q)
        A[col], A[piv] = A[piv], A[col]
        inv = pow(A[col][col], q - 2, q)
        A[col] = [v * inv % q for v in A[col]]
        for r in range(n):
            if r != col and A[r][col] % q:
                f = A[r][col]
                A[r] = [(v - f * w) % q for v, w in zip(A[r], A[col])]
    fwd = np.array([[(v << 64) % q for v in row] for row in V], dtype=np.int64)
    bwd = np.array([[(v << 64) % q for v in row[n:]] for row in A], dtype=np.int64)
    return fwd, bwd


@dataclasses.dataclass(frozen=True)
class Dense3N:
    """The dense 3N transform of a ring's limbs: its [L, N, N] matrices are
    built at first use.  A ring holds one only where N/2 has no factorized
    split (N = 6); the tests build it beside the factorized one as its
    parity oracle."""
    n: int
    moduli: tuple[int, ...]
    omegas: tuple[int, ...]
    device: torch.device

    def limbs(self, s: slice) -> "Dense3N":
        return dataclasses.replace(self, moduli=self.moduli[s], omegas=self.omegas[s])

    def matrices(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(forward, inverse) [L, N, N] Montgomery matrices."""
        mats = [_dense_3n_matrices(self.n, q, w) for q, w in zip(self.moduli, self.omegas)]
        return tuple(torch.from_numpy(np.stack([m[i] for m in mats])).to(self.device)
                     for i in (0, 1))


# tensor fields with one row a limb (sliced by ``Ring.limbs``)
_LIMB_FIELDS = ("moduli", "qinv", "bhi", "blo", "ninv", "roots_fwd", "roots_bwd", "psi2",
                "ipsi2", "ninv_plain", "ninv_shoup", "fold_row")


@dataclasses.dataclass(frozen=True)
class Ring:
    """An RNS ring R_Q at a given level (ring/ring.go:76).

    Tensor fields have leading dimension L = level + 1 and live on one
    device; ``at_level`` returns a view with sliced tables.  The
    power-of-two rings hold butterfly tables, the 3N ring its factorized
    tables or, without a split, its dense transform."""

    n: int
    nth_root: int
    ring_type: str
    moduli_tuple: tuple[int, ...]
    moduli: torch.Tensor     # int64 [L]
    qinv: torch.Tensor       # int64 [L]  q^-1 mod 2^64 (bits)
    bhi: torch.Tensor        # int64 [L]  Barrett constant, high word (bits)
    blo: torch.Tensor        # int64 [L]  Barrett constant, low word (bits)
    ninv: torch.Tensor       # int64 [L]  MForm(N^-1); MForm((2N)^-1) on the CI ring
    # rescale[j-1, i] = MForm(qi - qj^-1 mod qi) for i < j, zero-padded
    # (ring/ring.go:363-380 rewRescaleConstants)
    rescale: torch.Tensor
    # power-of-two rings: Montgomery psi powers, bit-reversed, [L, NthRoot/2]
    roots_fwd: torch.Tensor | None = None
    roots_bwd: torch.Tensor | None = None
    # B4's tables [L, N, 2]: plain psi powers (bit-reversed as roots_*, and
    # re-indexed on the CI ring), each beside its Shoup quotient
    # floor(w * 2^64 / q) (the bits of a uint64), one 16-byte pair a
    # twiddle; and the scale B4's inverse ends with and its quotient: N^-1,
    # or 1 on the CI ring (its fold scales)
    psi2: torch.Tensor | None = None
    ipsi2: torch.Tensor | None = None
    ninv_plain: torch.Tensor | None = None
    ninv_shoup: torch.Tensor | None = None
    # the CI ring: B4's fold row [L, 6] (``_ci_kernel_tables``)
    fold_row: torch.Tensor | None = None
    # 3N ring: the factorized tables (R >= 2), else the dense transform (N <= 384)
    ntt3n: n3.NTT3NTables | None = None
    dense3n: Dense3N | None = None

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
        sliced = {f: getattr(self, f)[s] for f in _LIMB_FIELDS if getattr(self, f) is not None}
        return dataclasses.replace(
            self, moduli_tuple=self.moduli_tuple[s], **sliced,
            ntt3n=None if self.ntt3n is None else self.ntt3n.limbs(s),
            dense3n=None if self.dense3n is None else self.dense3n.limbs(s))

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
        s = _limbs(scalar_mont, self.device)
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
        return _limbs(scalar, self.device)

    # -- NTT: B4 / B5 on a CUDA tensor, the torch ops below on the CPU --------
    def ntt(self, p: torch.Tensor) -> torch.Tensor:
        if self.ring_type == MATRIX:
            if self.ntt3n is not None:
                return ntt3n_cuda.ntt_fwd(p.contiguous(), self)
            return _ntt_matrix_ring(p, self.dense3n.matrices()[0], self.moduli, self.qinv,
                                    self.bhi)
        if self.ring_type == CONJUGATE_INVARIANT:
            return ntt64_cuda.ntt_ci_fwd(p.contiguous(), self)
        return ntt64_cuda.ntt_fwd(p.contiguous(), self)

    def intt(self, p: torch.Tensor) -> torch.Tensor:
        if self.ring_type == MATRIX:
            if self.ntt3n is not None:
                return ntt3n_cuda.ntt_bwd(p.contiguous(), self)
            return _ntt_matrix_ring(p, self.dense3n.matrices()[1], self.moduli, self.qinv,
                                    self.bhi)
        if self.ring_type == CONJUGATE_INVARIANT:
            return ntt64_cuda.ntt_ci_bwd(p.contiguous(), self)
        return ntt64_cuda.ntt_bwd(p.contiguous(), self)


def new_ring(n: int, moduli: list[int], ring_type: str = STANDARD,
             device="cuda", max_modulus: int = mm.MAX_MODULUS) -> Ring:
    """RNS ring with freshly generated NTT tables on ``device`` (the card
    unless told otherwise; ring/ring.go:264-308 NewRing / NewRingFromType).
    Moduli stop at ``max_modulus``: 2^61, or the wide ring's 2^61 + 2^55
    (``fast/wring.py``)."""
    if ring_type in (STANDARD, CONJUGATE_INVARIANT):
        if n < 16 or n & (n - 1):
            raise ValueError("N must be a power of two >= 16")
        nth_root = 2 * n if ring_type == STANDARD else 4 * n
    elif ring_type == MATRIX:
        if not is_valid_3n_degree(n):
            raise ValueError("N must be of the form 2^a * 3^b (a >= 1) for 3N rings")
        nth_root = 3 * n
    else:
        raise ValueError(f"unknown ring type {ring_type!r}")
    device = resolve_device(device)
    if len(set(moduli)) != len(moduli):
        raise ValueError("moduli must be distinct")
    moduli = [int(q) for q in moduli]

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
        words = np.array([t[key] for t in tabs], dtype=np.uint64).view(np.int64)
        return torch.from_numpy(words).to(device)

    def pairs(key):  # [L, N, 2]: each table word beside its Shoup quotient
        return torch.stack([_residues([t[key] for t in tabs], device), rows(key + "_shoup")],
                           dim=-1)

    if ring_type == MATRIX:
        tabs = [_gen_3n_tables(nth_root, q) for q in moduli]
        omegas = [t["omega"] for t in tabs]
        ntt3n = dense = None
        if n3.split_rc(n // 2)[0] >= 2:
            if device.type == "cuda":
                ntt3n_cuda.check_size(n)
            ntt3n = n3.build_tables(n, moduli, omegas, device)
        elif n <= MAX_DENSE_3N:
            dense = Dense3N(n, tuple(moduli), tuple(omegas), device)
        else:
            raise ValueError(f"N={n}: no factorized split and too large for the dense 3N path")
        extra = dict(ntt3n=ntt3n, dense3n=dense)
    else:
        tabs = [_gen_subring_tables(nth_root, q, max_modulus) for q in moduli]
        extra = {}
        if ring_type == CONJUGATE_INVARIANT:
            tabs = [_ci_kernel_tables(t, n, q) for t, q in zip(tabs, moduli)]
            extra["fold_row"] = rows("fold_row")
        extra.update(
            roots_fwd=_residues([t["roots_fwd"] for t in tabs], device),
            roots_bwd=_residues([t["roots_bwd"] for t in tabs], device),
            psi2=pairs("psi"), ipsi2=pairs("ipsi"),
            ninv_plain=col("ninv_plain"), ninv_shoup=col("ninv_shoup"))
    return Ring(
        n=n, nth_root=nth_root, ring_type=ring_type, moduli_tuple=tuple(moduli),
        moduli=_residues(moduli, device), qinv=col("qinv"), bhi=col("bhi"),
        blo=col("blo"), ninv=col("ninv"), rescale=_residues(rescale, device), **extra)


def _residues(values, device) -> torch.Tensor:
    """int64 tensor of values below 2^63 (residues, moduli)."""
    return torch.from_numpy(np.array(values, dtype=np.int64)).to(device)


# ---------------------------------------------------------------------------
# The NTTs (ring/ntt.go, ring/ntt_3n.go), as torch ops.
# ---------------------------------------------------------------------------

def _ntt_standard(x: torch.Tensor, roots: torch.Tensor, q: torch.Tensor,
                  qinv: torch.Tensor) -> torch.Tensor:
    """Negacyclic forward NTT, Cooley-Tukey DIT with bit-reversed Montgomery
    roots; the output order and values of ring/ntt.go:223-257 after its
    final reduction."""
    return _ct_stages(x, roots, q, qinv, 0)


def _intt_standard(x: torch.Tensor, roots: torch.Tensor, ninv: torch.Tensor,
                   q: torch.Tensor, qinv: torch.Tensor) -> torch.Tensor:
    """Negacyclic inverse NTT, Gentleman-Sande DIF (ring/ntt.go:555-606),
    then the scale by NInv (Montgomery form)."""
    x = _gs_stages(x, roots, q, qinv, 0)
    return mm.mred(x, ninv[:, None], q[:, None], qinv[:, None])


def _ct_stages(x, roots, q, qinv, shift: int):
    """log N Cooley-Tukey stages; stage s reads roots[2^(s+shift) + i]."""
    *batch, L, N = x.shape
    logn = N.bit_length() - 1
    qq, qi = q[:, None, None], qinv[:, None, None]
    for s in range(logn):
        m, t = 1 << s, N >> (s + 1)
        x = x.reshape(*batch, L, m, 2, t)
        F = roots[:, m << shift:(m << shift) + m].reshape(L, m, 1)
        u, v = x[..., 0, :], mm.mred(x[..., 1, :], F, qq, qi)
        x = torch.stack([mm.cred(u + v, qq), mm.cred(u + qq - v, qq)], dim=-2)
    return x.reshape(*batch, L, N)


def _gs_stages(x, roots, q, qinv, shift: int):
    """The inverse of ``_ct_stages`` up to the scale: Gentleman-Sande stages."""
    *batch, L, N = x.shape
    logn = N.bit_length() - 1
    qq, qi = q[:, None, None], qinv[:, None, None]
    for s in range(logn - 1, -1, -1):
        m, t = 1 << s, N >> (s + 1)
        x = x.reshape(*batch, L, m, 2, t)
        F = roots[:, m << shift:(m << shift) + m].reshape(L, m, 1)
        u, v = x[..., 0, :], x[..., 1, :]
        x = torch.stack([mm.cred(u + v, qq), mm.mred(u + qq - v, F, qq, qi)], dim=-2)
    return x.reshape(*batch, L, N)


def ci_fold(x: torch.Tensor, ring: Ring, inverse: bool) -> torch.Tensor:
    """The CI ring's folding stage with F = roots[:, 1] = MForm(psi^N):
    x[j] - F x[(N - j) mod N] for j >= 1.  Forward, before the stages: x[0]
    kept (ring/ntt.go:737-786).  Inverse, after them: x[0] doubled and all
    scaled by NInv = (2N)^-1 (ring/ntt.go:1148-1156, ring/subring.go:183)."""
    n = x.shape[-1]
    roots = ring.roots_bwd if inverse else ring.roots_fwd
    qq, qi = ring.moduli[:, None], ring.qinv[:, None]
    rev = (-torch.arange(n, device=x.device)) % n
    folded = mm.cred(x + qq - mm.mred(x[..., rev], roots[:, 1:2], qq, qi), qq)
    if not inverse:
        return torch.cat([x[..., :1], folded[..., 1:]], dim=-1)
    x0 = mm.cred(x[..., :1] * 2, qq)
    return mm.mred(torch.cat([x0, folded[..., 1:]], dim=-1), ring.ninv[:, None], qq, qi)


def _ntt_ci(x: torch.Tensor, ring: Ring) -> torch.Tensor:
    """Forward NTT on the CI ring Z[X+X^-1]/(X^2N+1): the fold, then log N
    butterfly stages over the 4N-th roots."""
    return _ct_stages(ci_fold(x, ring, inverse=False), ring.roots_fwd, ring.moduli,
                      ring.qinv, 1)


def _intt_ci(x: torch.Tensor, ring: Ring) -> torch.Tensor:
    """The inverse of ``_ntt_ci`` (ring/ntt.go:1090-1311)."""
    return ci_fold(_gs_stages(x, ring.roots_bwd, ring.moduli, ring.qinv, 1), ring,
                   inverse=True)


def _ntt_matrix_ring(x: torch.Tensor, mat: torch.Tensor, q: torch.Tensor,
                     qinv: torch.Tensor, bhi: torch.Tensor) -> torch.Tensor:
    """The 3N transform as a Montgomery mod-matvec: out[k] = sum_j x[j] V[k, j]
    (ring/ntt_3n.go:82-151's semantics)."""
    prod = mm.mred(x[..., None, :], mat, q[:, None, None], qinv[:, None, None])
    return mm.modsum(prod, q[:, None], bhi[:, None], dim=-1)
