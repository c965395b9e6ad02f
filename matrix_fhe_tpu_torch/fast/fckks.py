"""Fast-path CKKS: the ct-mult + relinearize + rescale step in int32.

Counterpart of ``matrix_fhe_tpu/fast/fckks.py``: word-size-reduced CKKS over
many ~22-bit primes, rescaling by pairs of primes, where

  * the tensor product is a plain-domain modular multiply
    (schemes/ckks/evaluator.go:786-918 without the Montgomery detour);
  * relinearization is the hybrid gadget product over digits of LP limbs
    (core/rlwe/evaluator_gadget_product.go:123-190): INTT, digit lift, one
    batched NTT per basis, MAC against the key, ModDown;
  * rescale is DivRoundByLastModulusManyNTT with nb = 2 (ring/scaling.go:130).

Every output equals the JAX package's bit for bit on the same context and
operands.  A context comes from the port's own keys (``make_context``, over
``rlwe/keys.py``), from the plain-domain int32 key stacks of a JAX context
as numpy arrays (``context_from_arrays``), or from uniform keys and operands
drawn from a numpy seed exactly as the JAX function of that name does
(``make_synthetic_context``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from matrix_fhe_tpu_torch.fast import fring, frns
from matrix_fhe_tpu_torch.fast.fring import FastRing
from matrix_fhe_tpu_torch.ops.automorphism import automorphism_ntt_index
from matrix_fhe_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class FastCKKSContext:
    """Device-resident fast-path state for one parameter set at one level."""
    ring_q: FastRing                     # Q chain
    ring_p: FastRing                     # P chain
    dec: frns.FastDecomposer
    mdc: frns.FastModDownConstants
    rlk_q: torch.Tensor                  # int32 [digits, 2, LQ, N], NTT domain
    rlk_p: torch.Tensor                  # int32 [digits, 2, LP, N]
    gk_q: torch.Tensor | None = None     # int32 [G, digits, 2, LQ, N]
    gk_p: torch.Tensor | None = None     # int32 [G, digits, 2, LP, N]
    rescale_limbs: int = 2               # limbs dropped per rescale
    gal_els: tuple[int, ...] = ()        # galois elements of the gk rows
    # int64 [G, N]: the NTT-domain permutation of each galois element,
    # kept on the device so a rotation copies nothing from the host
    gal_index: torch.Tensor | None = dataclasses.field(default=None, init=False)

    def __post_init__(self):
        if self.gal_els:
            n = self.ring_q.n
            idx = np.stack([automorphism_ntt_index(n, 2 * n, g)
                            for g in self.gal_els]).astype(np.int64)
            object.__setattr__(self, "gal_index",
                               torch.from_numpy(idx).to(self.ring_q.device))

    def galois_key(self, gal_el: int):
        if gal_el not in self.gal_els:
            raise KeyError(f"no fast galois key for element {gal_el}")
        g = self.gal_els.index(gal_el)
        return self.gk_q[g], self.gk_p[g]

    def galois_index(self, gal_el: int) -> torch.Tensor:
        if gal_el not in self.gal_els:
            raise KeyError(f"no fast galois key for element {gal_el}")
        return self.gal_index[self.gal_els.index(gal_el)]

    @property
    def level(self) -> int:
        return self.ring_q.level

    def at_level(self, level: int) -> "FastCKKSContext":
        """Level view: rings, decomposer and ModDown constants over
        Q[:level+1], keys sliced to the live digits and limbs."""
        if level == self.level:
            return self
        if level > self.level:
            raise ValueError(
                f"at_level({level}) above the built level {self.level}")
        Q = list(self.ring_q.moduli_tuple[: level + 1])
        P = list(self.ring_p.moduli_tuple)
        dev = self.ring_q.device
        dec = frns.gen_fast_decomposer(Q, P, dev)
        D = dec.num_digits
        return dataclasses.replace(
            self,
            ring_q=self.ring_q.at_level(level),
            dec=dec,
            mdc=frns.gen_fast_moddown_constants(Q, P, dev),
            rlk_q=self.rlk_q[:D, :, : level + 1, :],
            rlk_p=self.rlk_p[:D],
            gk_q=None if self.gk_q is None else self.gk_q[:, :D, :, : level + 1, :],
            gk_p=None if self.gk_p is None else self.gk_p[:, :D],
        )


def _new_context(n, Q, P, rlk_q, rlk_p, gk_q, gk_p, gal_els, rescale_limbs,
                 device) -> FastCKKSContext:
    return FastCKKSContext(
        ring_q=fring.new_fast_ring(n, Q, device),
        ring_p=fring.new_fast_ring(n, P, device),
        dec=frns.gen_fast_decomposer(Q, P, device),
        mdc=frns.gen_fast_moddown_constants(Q, P, device),
        rlk_q=rlk_q, rlk_p=rlk_p, gk_q=gk_q, gk_p=gk_p,
        rescale_limbs=rescale_limbs, gal_els=tuple(gal_els))


def context_from_arrays(n: int, Q, P, rlk_q, rlk_p, gk_q=None, gk_p=None,
                        gal_els=(), rescale_limbs: int = 2, *, device="cuda"
                        ) -> FastCKKSContext:
    """Context from the plain-domain int32 key stacks of a JAX
    ``FastCKKSContext`` (its fields after ``np.asarray``), or of any source
    that produces the same layout: rlk [digits, 2, L, N] per basis, gk
    [G, digits, 2, L, N] in ``gal_els`` order.  On the card unless ``device``
    says otherwise."""
    device = resolve_device(device)
    Q, P = [int(q) for q in Q], [int(p) for p in P]
    D = -(-len(Q) // len(P))

    def put(a, shape, what):
        a = np.asarray(a)
        if a.shape != shape:
            raise ValueError(f"{what}: shape {a.shape}, expected {shape}")
        return torch.from_numpy(a.astype(np.int32)).to(device)

    rq = put(rlk_q, (D, 2, len(Q), n), "rlk_q")
    rp = put(rlk_p, (D, 2, len(P), n), "rlk_p")
    gq = gp = None
    if gal_els:
        G = len(gal_els)
        gq = put(gk_q, (G, D, 2, len(Q), n), "gk_q")
        gp = put(gk_p, (G, D, 2, len(P), n), "gk_p")
    return _new_context(n, Q, P, rq, rp, gq, gp, gal_els, rescale_limbs, device)


def _convert_gadget(params, gadget) -> tuple[torch.Tensor, torch.Tensor]:
    """A u64 gadget ciphertext (NTT + Montgomery form) as plain-domain int32
    stacks: IMForm on its own ring, then a cast (residues < 2^23)."""
    gq = params.ring_q.imform(gadget.q).to(torch.int32)
    gp = params.ring_p.imform(gadget.p).to(torch.int32)
    return gq, gp


def make_context(params, rlk, gks=None, rescale_limbs: int = 2) -> FastCKKSContext:
    """Context from u64-path parameters and keys (``rlwe.Parameters``, a
    ``RelinearizationKey`` and optional galois keys {gal_el: GaloisKey}), on
    the parameters' device.  Each key is taken out of the Montgomery domain
    and cast to int32 once (``fast/fckks.py:make_context`` of the JAX
    package)."""
    Q, P = list(params.q), list(params.p)
    for q in Q + P:
        if q >= fring.MAX_FAST_MODULUS:
            raise ValueError(f"modulus {q} too large for the fast path")
    rlk_q, rlk_p = _convert_gadget(params, rlk.gadget)
    gal_els: tuple[int, ...] = ()
    gk_q = gk_p = None
    if gks:
        gal_els = tuple(sorted(gks))
        conv = [_convert_gadget(params, gks[g].gadget) for g in gal_els]
        gk_q = torch.stack([c[0] for c in conv])
        gk_p = torch.stack([c[1] for c in conv])
    return _new_context(params.n, Q, P, rlk_q, rlk_p, gk_q, gk_p, gal_els,
                        rescale_limbs, params.device)


def make_synthetic_context(logn: int, num_q: int, num_p: int,
                           rescale_limbs: int = 2, seed: int = 0,
                           num_rot: int = 0, *, device="cuda"):
    """Context + four uniform-random NTT-domain operands (c0, c1, d0, d1),
    on the card unless ``device`` says otherwise.

    Draws from ``np.random.default_rng(seed)`` in the JAX function's order
    and shapes (galois keys, then rlk, then the operands), so one seed gives
    both packages the same keys and operands, bit for bit."""
    device = resolve_device(device)
    n = 1 << logn
    moduli = fring.find_fast_primes(n, num_q + num_p)
    Q, P = moduli[:num_q], moduli[num_q:]
    D = -(-num_q // num_p)
    rng = np.random.default_rng(seed)

    def unif(shape, mods):
        hi = np.array(mods, dtype=np.int64).reshape(
            (1,) * (len(shape) - 2) + (len(mods), 1))
        a = (rng.integers(0, 1 << 62, shape, dtype=np.int64) % hi).astype(np.int32)
        return torch.from_numpy(a).to(device)

    gal_els: tuple[int, ...] = ()
    gk_q = gk_p = None
    if num_rot:
        # galois elements 5^k mod 2N (the CKKS rotation group)
        gal_els = tuple(pow(5, k + 1, 2 * n) for k in range(num_rot))
        gk_q = unif((num_rot, D, 2, num_q, n), Q)
        gk_p = unif((num_rot, D, 2, num_p, n), P)
    rlk_q = unif((D, 2, num_q, n), Q)
    rlk_p = unif((D, 2, num_p, n), P)
    ctx = _new_context(n, Q, P, rlk_q, rlk_p, gk_q, gk_p, gal_els,
                       rescale_limbs, device)
    cts = tuple(unif((num_q, n), Q) for _ in range(4))
    return ctx, cts


def tensor(ctx: FastCKKSContext, c0, c1, d0, d1):
    """NTT-domain degree-2 tensor (evaluator.go:786-865)."""
    rq = ctx.ring_q
    t0 = rq.mul_coeffs_montgomery(c0, d0)
    t1 = rq.add(rq.mul_coeffs_montgomery(c0, d1),
                rq.mul_coeffs_montgomery(c1, d0))
    t2 = rq.mul_coeffs_montgomery(c1, d1)
    return t0, t1, t2


def decompose_ks(ctx: FastCKKSContext, x_ntt):
    """Hybrid-KS digit decomposition of an NTT-domain poly (DecomposeNTT,
    core/rlwe/evaluator_gadget_product.go:431-455): all digits lifted in the
    coefficient domain, then one batched NTT per basis.  Returns NTT-domain
    stacks (yq [D, LQ, N], yp [D, LP, N]), shared by every key-switch of
    the same poly."""
    rq, rp = ctx.ring_q, ctx.ring_p
    x_inv = rq.intt(x_ntt)
    yq_c, yp_c = frns.decompose_all_coeff(ctx.dec, x_inv, rq, rp)
    yq = rq.ntt(yq_c)
    yp = rp.ntt(yp_c)
    # splice the NTT-domain source band of each digit (DecomposeSingleNTT
    # keeps limbs [i*alpha, (i+1)*alpha) from the original NTT input)
    D, lq = yq.shape[-3], yq.shape[-2]
    limb = torch.arange(lq, device=yq.device)[None, :, None]
    dig = torch.arange(D, device=yq.device)[:, None, None]
    in_band = (limb >= dig * ctx.dec.alpha) & (limb < (dig + 1) * ctx.dec.alpha)
    yq = torch.where(in_band, x_ntt[..., None, :, :], yq)
    return yq, yp


def ks_mac(ctx: FastCKKSContext, key_q, key_p, yq, yp):
    """MAC of digit stacks against a gadget key (gadgetProductMultiplePLazy,
    evaluator_gadget_product.go:123-190): canonical (d_q [2, LQ, N],
    d_p [2, LP, N]) in the QP basis."""
    rq, rp = ctx.ring_q, ctx.ring_p
    # The JAX reference accumulates lazily in int32 and is exact only while
    # 1.6*D*q < 2^30.  The int64 sums here hold far beyond that, but outside
    # it there is no reference output to hold the port against, so the port
    # accepts the same domain.
    D = ctx.dec.num_digits
    qmax = max(max(rq.moduli_tuple), max(rp.moduli_tuple))
    if int(1.6 * D * qmax) >= 1 << 30:
        raise ValueError(
            f"ks_mac digit sum overflows int32 reduce_once: "
            f"num_digits={D}, max modulus={qmax} "
            f"(need 1.6*D*q < 2^30)")

    def mac(key, y, ring):
        # D products < 2^46 each: the int64 sum is exact
        s = (key.to(torch.int64) * y[..., :, None, :, :].to(torch.int64)
             ).sum(dim=-4, dtype=torch.int64)
        return torch.remainder(s, ring.moduli[:, None].to(torch.int64)).to(torch.int32)

    return mac(key_q, yq, rq), mac(key_p, yp, rp)


def gadget_product_core(ctx: FastCKKSContext, key_q, key_p, x_ntt):
    """Hybrid key-switch of an NTT-domain poly against a gadget key:
    decompose, MAC, ModDown."""
    d_q, d_p = ks_mac(ctx, key_q, key_p, *decompose_ks(ctx, x_ntt))
    return frns.mod_down(d_q, d_p, ctx.mdc, ctx.ring_q, ctx.ring_p, ntt=True)


def gadget_product(ctx: FastCKKSContext, t2):
    """Relinearization key-switch (gadgetProductMultiplePLazy + ModDown,
    core/rlwe/evaluator_gadget_product.go:16-190)."""
    return gadget_product_core(ctx, ctx.rlk_q, ctx.rlk_p, t2)


def automorphism(ctx: FastCKKSContext, c0, c1, gal_el: int):
    """X^i -> X^(i*galEl) on an NTT-domain degree-1 ciphertext
    (core/rlwe/evaluator_automorphism.go:14-60): gadget product of c1 with
    the galois key, add c0, permute both limbs."""
    gk_q, gk_p = ctx.galois_key(gal_el)
    r0, r1 = gadget_product_core(ctx, gk_q, gk_p, c1)
    idx = ctx.galois_index(gal_el)
    return ctx.ring_q.add(r0, c0)[..., idx], r1[..., idx]


def rotations_hoisted(ctx: FastCKKSContext, c0, c1, gal_els):
    """Many rotations of one ciphertext: decompose once, then one
    MAC + ModDown + permute per galois element (RotateHoisted,
    core/rlwe/evaluator_automorphism.go:62-107).  Returns {gal_el: (d0, d1)}."""
    yq, yp = decompose_ks(ctx, c1)
    rq = ctx.ring_q
    out = {}
    for g in gal_els:
        gk_q, gk_p = ctx.galois_key(g)
        d_q, d_p = ks_mac(ctx, gk_q, gk_p, yq, yp)
        r0, r1 = frns.mod_down(d_q, d_p, ctx.mdc, rq, ctx.ring_p, ntt=True)
        idx = ctx.galois_index(g)
        out[g] = (rq.add(r0, c0)[..., idx], r1[..., idx])
    return out


def mul_relin_rescale(ctx: FastCKKSContext, c0, c1, d0, d1):
    """Tensor, relinearize, rescale by ``rescale_limbs`` primes.  All
    operands int32 [LQ, N], NTT domain."""
    t0, t1, t2 = tensor(ctx, c0, c1, d0, d1)
    r0, r1 = gadget_product(ctx, t2)
    rq = ctx.ring_q
    out0 = rq.add(t0, r0)
    out1 = rq.add(t1, r1)
    nb = ctx.rescale_limbs
    return (frns.div_round_by_last_modulus_many_ntt(rq, out0, nb),
            frns.div_round_by_last_modulus_many_ntt(rq, out1, nb))
