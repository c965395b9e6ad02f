"""Wide-path CKKS: ct-mult + relinearize + rescale over 41-61-bit moduli.

Counterpart of ``matrix_fhe_tpu/fast/wckks.py`` for the reference's
production parameter shapes (PN14QP438: 55 + 45x6-bit Q, 55x2-bit P,
schemes/ckks/example_parameters.go:11; the bootstrapping sets' 60/61-bit
primes): the tensor product, the hybrid gadget product
(evaluator_gadget_product.go:123-190), hoisted rotations and the
mul + relin + rescale step, on 64-bit words (``fast/wring.py``) whose NTT is
kernel B4 on the card.  Every output equals ``wide.unpack_pair`` of the JAX
package's on the same moduli and operands.

The JAX package accumulates the key-switch MAC lazily in digit-plane space;
here each product is reduced (Barrett) and the digit sum is taken mod q
(``modmath.modsum``): the same canonical words.  A context comes from the
port's u64 keys (``make_context``: the gadget out of the Montgomery domain,
no packing), or from uniform keys and operands drawn from a numpy seed
exactly as the JAX function of that name draws them
(``make_synthetic_context``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from matrix_fhe_tpu_torch.fast import wring, wrns
from matrix_fhe_tpu_torch.fast.wring import WideRing
from matrix_fhe_tpu_torch.ops import modmath as mm
from matrix_fhe_tpu_torch.ops import wide
from matrix_fhe_tpu_torch.ops.automorphism import automorphism_ntt_index
from matrix_fhe_tpu_torch.utils import primes as pr
from matrix_fhe_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class WideCKKSContext:
    """Device-resident wide-path state for one parameter set at one level."""
    ring_q: WideRing
    ring_p: WideRing
    dec: wrns.WideDecomposer
    mdc: wrns.WideModDownConstants
    rlk_q: torch.Tensor                  # int64 [digits, 2, LQ, N], NTT, plain
    rlk_p: torch.Tensor                  # int64 [digits, 2, LP, N]
    gk_q: torch.Tensor | None = None     # int64 [G, digits, 2, LQ, N]
    gk_p: torch.Tensor | None = None     # int64 [G, digits, 2, LP, N]
    rescale_limbs: int = 1
    gal_els: tuple[int, ...] = ()
    # int64 [G, N]: the NTT-domain permutation of each galois element
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
            raise KeyError(f"no wide galois key for element {gal_el}")
        g = self.gal_els.index(gal_el)
        return self.gk_q[g], self.gk_p[g]

    def galois_index(self, gal_el: int) -> torch.Tensor:
        if gal_el not in self.gal_els:
            raise KeyError(f"no wide galois key for element {gal_el}")
        return self.gal_index[self.gal_els.index(gal_el)]

    @property
    def level(self) -> int:
        return self.ring_q.level

    def at_level(self, level: int) -> "WideCKKSContext":
        """Level view: rings, decomposer and ModDown constants over
        Q[:level+1], keys sliced to the live digits and limbs."""
        if level == self.level:
            return self
        if level > self.level:
            raise ValueError(f"at_level({level}) above the built level {self.level}")
        Q = list(self.ring_q.moduli_tuple[: level + 1])
        P = list(self.ring_p.moduli_tuple)
        dev = self.ring_q.device
        dec = wrns.gen_wide_decomposer(Q, P, dev)
        D = dec.num_digits
        return dataclasses.replace(
            self, ring_q=self.ring_q.at_level(level), dec=dec,
            mdc=wrns.gen_wide_moddown_constants(Q, P, dev),
            rlk_q=self.rlk_q[:D, :, : level + 1, :], rlk_p=self.rlk_p[:D],
            gk_q=None if self.gk_q is None else self.gk_q[:, :D, :, : level + 1, :],
            gk_p=None if self.gk_p is None else self.gk_p[:, :D])


def _new_context(n, Q, P, rlk_q, rlk_p, gk_q, gk_p, gal_els, rescale_limbs,
                 device) -> WideCKKSContext:
    pair31 = wide.use_pair31(list(Q) + list(P))
    return WideCKKSContext(
        ring_q=wring.new_wide_ring(n, Q, pair31, device),
        ring_p=wring.new_wide_ring(n, P, pair31, device),
        dec=wrns.gen_wide_decomposer(Q, P, device),
        mdc=wrns.gen_wide_moddown_constants(Q, P, device),
        rlk_q=rlk_q, rlk_p=rlk_p, gk_q=gk_q, gk_p=gk_p,
        rescale_limbs=rescale_limbs, gal_els=tuple(gal_els))


def convert_gadget(params, gadget) -> tuple[torch.Tensor, torch.Tensor]:
    """A u64 gadget ciphertext (NTT + Montgomery form) as plain-domain words
    (``_convert_gadget`` of the JAX package, without its packing)."""
    return params.ring_q.imform(gadget.q), params.ring_p.imform(gadget.p)


def make_context(params, rlk, gks=None, rescale_limbs: int = 1) -> WideCKKSContext:
    """Context from u64-path parameters and keys (a ``RelinearizationKey``
    and optional galois keys {gal_el: GaloisKey}), on the parameters'
    device; each key taken out of the Montgomery domain once."""
    Q, P = list(params.q), list(params.p)
    rlk_q, rlk_p = convert_gadget(params, rlk.gadget)
    gal_els: tuple[int, ...] = ()
    gk_q = gk_p = None
    if gks:
        gal_els = tuple(sorted(gks))
        conv = [convert_gadget(params, gks[g].gadget) for g in gal_els]
        gk_q = torch.stack([c[0] for c in conv])
        gk_p = torch.stack([c[1] for c in conv])
    return _new_context(params.n, Q, P, rlk_q, rlk_p, gk_q, gk_p, gal_els,
                        rescale_limbs, params.device)


def context_from_arrays(n: int, Q, P, rlk_q, rlk_p, gk_q=None, gk_p=None, gal_els=(),
                        rescale_limbs: int = 1, *, device="cuda") -> WideCKKSContext:
    """Context from canonical uint64/int64 key stacks (numpy arrays): rlk
    [digits, 2, L, N] a basis, gk [G, digits, 2, L, N] in ``gal_els``
    order; ``carry.py`` gives a JAX wide context's pairs in this form."""
    device = resolve_device(device)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a).astype(np.int64))).to(device)

    return _new_context(n, [int(q) for q in Q], [int(p) for p in P], put(rlk_q), put(rlk_p),
                        None if gk_q is None else put(gk_q),
                        None if gk_p is None else put(gk_p), gal_els, rescale_limbs, device)


PN14QP438_Q = (0x80000000080001, 0x2000000A0001, 0x2000000E0001,
               0x2000001D0001, 0x1FFFFFCF0001, 0x1FFFFFC20001,
               0x200000440001)
PN14QP438_P = (0x80000000130001, 0x7FFFFFFFE90001)


def make_synthetic_context(logn: int, num_q: int, num_p: int,
                           q_bits=(55,) + (45,) * 32, p_bits=55,
                           rescale_limbs: int = 1, seed: int = 0,
                           num_rot: int = 0, moduli=None, *, device="cuda"):
    """Context + four uniform-random NTT-domain operands (c0, c1, d0, d1), on
    the card unless ``device`` says otherwise: PN14QP438-shaped by default,
    or over ``moduli=(Q, P)`` (e.g. (PN14QP438_Q, PN14QP438_P)).  The primes
    and the draws from ``np.random.default_rng(seed)`` are the JAX
    function's, in its order (galois keys, rlk, operands), so one seed gives
    both packages the same context and operands."""
    device = resolve_device(device)
    n = 1 << logn
    pools: dict[int, list[int]] = {}

    def take(bits):
        if not pools.get(bits):
            g = pr.NTTFriendlyPrimesGenerator(bits, 2 * n)
            got: list[int] = []
            seen = set(sum(pools.values(), []))
            while len(got) < 40:
                try:
                    p = g.next_alternating_prime()
                except ValueError:
                    break
                if p not in seen:
                    got.append(p)
            pools[bits] = got
        return pools[bits].pop(0)

    used: set[int] = set()

    def next_prime(bits):
        while True:
            p = take(bits)
            if p not in used:
                used.add(p)
                return p

    if moduli is not None:
        Q, P = [int(q) for q in moduli[0]], [int(p) for p in moduli[1]]
        num_q, num_p = len(Q), len(P)
    else:
        Q = [next_prime(q_bits[i]) for i in range(num_q)]
        P = [next_prime(p_bits if isinstance(p_bits, int) else p_bits[i])
             for i in range(num_p)]
    D = -(-num_q // num_p)
    rng = np.random.default_rng(seed)

    def unif(shape, mods):
        x = np.stack([rng.integers(0, q, shape[:-2] + (shape[-1],), dtype=np.uint64)
                      for q in mods], axis=-2)
        return torch.from_numpy(x.astype(np.int64)).to(device)

    gal_els: tuple[int, ...] = ()
    gk_q = gk_p = None
    if num_rot:
        gal_els = tuple(pow(5, k + 1, 2 * n) for k in range(num_rot))
        gk_q = torch.stack([unif((D, 2, num_q, n), Q) for _ in range(num_rot)])
        gk_p = torch.stack([unif((D, 2, num_p, n), P) for _ in range(num_rot)])
    rlk_q = unif((D, 2, num_q, n), Q)
    rlk_p = unif((D, 2, num_p, n), P)
    ctx = _new_context(n, Q, P, rlk_q, rlk_p, gk_q, gk_p, gal_els, rescale_limbs, device)
    cts = tuple(unif((num_q, n), Q) for _ in range(4))
    return ctx, cts


def tensor(ctx: WideCKKSContext, c0, c1, d0, d1):
    """NTT-domain degree-2 tensor (evaluator.go:786-865)."""
    rq = ctx.ring_q
    t0 = rq.mul_coeffs_montgomery(c0, d0)
    t1 = rq.add(rq.mul_coeffs_montgomery(c0, d1), rq.mul_coeffs_montgomery(c1, d0))
    t2 = rq.mul_coeffs_montgomery(c1, d1)
    return t0, t1, t2


def decompose_ks(ctx: WideCKKSContext, x_ntt):
    """Hybrid-KS digit decomposition of an NTT-domain poly (DecomposeNTT,
    evaluator_gadget_product.go:431-455): digits lifted in the coefficient
    domain, one batched NTT per basis, the NTT-domain source band of each
    digit spliced in.  Returns (yq [D, LQ, N], yp [D, LP, N])."""
    rq, rp = ctx.ring_q, ctx.ring_p
    x_inv = rq.intt(x_ntt)
    yq_c, yp_c = wrns.decompose_all_coeff(ctx.dec, x_inv, rq, rp)
    yq = rq.ntt(yq_c)
    yp = rp.ntt(yp_c)
    D, lq = yq.shape[-3], yq.shape[-2]
    limb = torch.arange(lq, device=yq.device)[None, :, None]
    dig = torch.arange(D, device=yq.device)[:, None, None]
    in_band = (limb >= dig * ctx.dec.alpha) & (limb < (dig + 1) * ctx.dec.alpha)
    yq = torch.where(in_band, x_ntt[..., None, :, :], yq)
    return yq, yp


def ks_mac(ctx: WideCKKSContext, key_q, key_p, yq, yp):
    """MAC of digit stacks against a gadget key (gadgetProductMultiplePLazy):
    (d_q [2, LQ, N], d_p [2, LP, N]) in the QP basis, canonical."""
    def mac(key, y, ring):
        q, bhi, blo = ring.moduli[:, None], ring.bhi[:, None], ring.blo[:, None]
        prods = mm.bred(key, y[..., :, None, :, :], q, bhi, blo)  # [.., D, 2, L, N], < q
        # D digits summed 4 a round below 2^61, 3 from there on (6q < 2^64)
        return mm.modsum(prods, q, bhi, dim=-4, fold=mm.sum_fold(ring.moduli_tuple))

    return mac(key_q, yq, ctx.ring_q), mac(key_p, yp, ctx.ring_p)


def gadget_product_core(ctx: WideCKKSContext, key_q, key_p, x_ntt):
    """Hybrid key-switch of an NTT-domain poly against a gadget key:
    decompose, MAC, ModDown."""
    d_q, d_p = ks_mac(ctx, key_q, key_p, *decompose_ks(ctx, x_ntt))
    out = wrns.mod_down(d_q, d_p, ctx.mdc, ctx.ring_q, ctx.ring_p, ntt=True)
    return out[0], out[1]


def gadget_product(ctx: WideCKKSContext, t2):
    return gadget_product_core(ctx, ctx.rlk_q, ctx.rlk_p, t2)


def automorphism(ctx: WideCKKSContext, c0, c1, gal_el: int):
    """NTT-domain automorphism (evaluator_automorphism.go:14-60)."""
    gk_q, gk_p = ctx.galois_key(gal_el)
    r0, r1 = gadget_product_core(ctx, gk_q, gk_p, c1)
    idx = ctx.galois_index(gal_el)
    return ctx.ring_q.add(r0, c0)[..., idx], r1[..., idx]


def rotations_hoisted(ctx: WideCKKSContext, c0, c1, gal_els):
    """Many rotations of one ciphertext: decompose once, then one
    MAC + ModDown + permute per element (RotateHoisted)."""
    yq, yp = decompose_ks(ctx, c1)
    rq = ctx.ring_q
    out = {}
    for g in gal_els:
        gk_q, gk_p = ctx.galois_key(g)
        d_q, d_p = ks_mac(ctx, gk_q, gk_p, yq, yp)
        r = wrns.mod_down(d_q, d_p, ctx.mdc, rq, ctx.ring_p, ntt=True)
        idx = ctx.galois_index(g)
        out[g] = (rq.add(r[0], c0)[..., idx], r[1][..., idx])
    return out


def mul_relin_rescale(ctx: WideCKKSContext, c0, c1, d0, d1):
    """The step on words [LQ, N]: tensor, relinearize, rescale by
    ``rescale_limbs`` primes."""
    t0, t1, t2 = tensor(ctx, c0, c1, d0, d1)
    r0, r1 = gadget_product(ctx, t2)
    rq = ctx.ring_q
    out0 = rq.add(t0, r0)
    out1 = rq.add(t1, r1)
    nb = ctx.rescale_limbs
    return (wrns.div_round_by_last_modulus_many_ntt(rq, out0, nb),
            wrns.div_round_by_last_modulus_many_ntt(rq, out1, nb))
