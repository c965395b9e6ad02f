"""The bootstrap run stage by stage, each stage one CUDA graph.

Counterpart of ``matrix_fhe_tpu/circuits/ckks/staged.py``, where each stage
is one ``jax.jit``.  Here a stage is captured once for each input signature
into a ``torch.cuda.CUDAGraph`` and replayed, so that a steady-state
bootstrap is about a dozen graph launches (and a copy in and out of each)
where the eager pipeline issues every kernel from the host: 26,334 launches
for the fast bootstrap at logN 14, 225,140 for the wide one.

The stages: ``head`` (ScaleDown, the dense-to-sparse key, ModUp), one
``c2s[i]`` for each CoeffsToSlots level group (its matrices, then one
rescale), ``c2s_tail`` (the conjugate split), EvalMod (``evalmod`` on the
repacked ciphertext, or ``evalmod2`` on both parts, then the s2c head that
joins them), one ``s2c[i]`` for each SlotsToCoeffs level group.

On the CPU every stage runs its function eagerly: that is the plain form,
and the results are the same.
"""

from __future__ import annotations

from fractions import Fraction

from matrix_fhe_tpu_torch.circuits.ckks import dft
from matrix_fhe_tpu_torch.rlwe.elements import Ciphertext
from matrix_fhe_tpu_torch.utils import graphs

# The evaluator caches a stage fills on its first, eager run (fast/feval.py,
# fast/weval.py); the u64 evaluator has none.
_CACHES = ("_ctx_cache", "_evk_cache", "_flt_cache", "_wlt_cache")


class GraphedCiphertextFn:
    """A function of ciphertexts, captured into one CUDA graph for each input
    signature and replayed; see ``graph_ciphertext_fn``."""

    def __init__(self, ev, params, fn, n_out: int, memory: graphs.GraphMemory, name: str):
        self.ev, self.fn, self.n_out, self.name = ev, fn, n_out, name
        self.device = params.device
        self._graphed = graphs.GraphedFn(f"stage {name!r}", memory)

    @property
    def entries(self) -> dict:
        """signature -> ``graphs.Graph``, one a signature captured (none on the CPU)."""
        return self._graphed.entries

    @property
    def pool(self):
        """The memory pool the graphs are captured into."""
        return self._graphed.memory.pool(self.device)

    def __call__(self, *cts):
        # a ciphertext's metadata is part of the signature; the outputs' is
        # recorded at capture
        outs = self._graphed.call(self._flat, *((c.metadata, tuple(c.value)) for c in cts),
                                  caches=self._cache_sizes)
        outs = tuple(None if o is None else Ciphertext(value=o[1], metadata=o[0]) for o in outs)
        return outs[0] if self.n_out == 1 else outs

    def _flat(self, *cts):
        outs = self.fn(*(Ciphertext(value=v, metadata=m) for m, v in cts))
        outs = (outs,) if self.n_out == 1 else tuple(outs)
        return tuple(None if o is None else (o.metadata, tuple(o.value)) for o in outs)

    def _cache_sizes(self) -> tuple:
        return tuple(len(getattr(self.ev, n)) for n in _CACHES if hasattr(self.ev, n))


def graph_ciphertext_fn(ev, params, fn, n_out: int = 1, name: str = "stage",
                        memory: graphs.GraphMemory | None = None) -> GraphedCiphertextFn:
    """``fn`` (Ciphertexts in, ``n_out`` Ciphertexts or None out) as one CUDA
    graph for each input signature (each input's metadata, degree and the
    shape, dtype and device of each limb tensor), the counterpart of the
    JAX package's ``jit_ciphertext_fn``, on ``utils/graphs.py``.

    When ``params`` live on a CUDA device, the first call of a signature runs
    fn once eagerly on a side stream, which fills ``ev``'s caches and the
    device constants the stage needs (the graph keeps a reference to each,
    so the shared cache of ``utils/device.py`` may drop them), then captures
    fn on static copies of the inputs and records the outputs' metadata;
    every call copies its inputs into the static buffers, replays, and
    returns clones of the static outputs, so a result is never overwritten
    by the next replay.  Graphs given the same ``memory``
    (``graphs.GraphMemory``; by default one of their own) share one memory
    pool and one pair of streams a device.  A stage that cannot be captured
    (a host synchronisation, a copy from host memory) raises with its
    ``name``; it never runs eagerly instead.  On the CPU fn runs eagerly."""
    return GraphedCiphertextFn(ev, params, fn, n_out,
                               graphs.GraphMemory() if memory is None else memory, name)


def _level_groups(matrix: dft.Matrix) -> list[list]:
    """The matrices of a DFT, split into the groups that share one rescale
    (``dft._dft``: ``levels[i]`` consecutive factors a group)."""
    out, i = [], 0
    for k in matrix.literal.levels:
        out.append(matrix.matrices[i:i + k])
        i += k
    return out


class StagedBootstrapper:
    """A ``bootstrapping.Evaluator`` (u64, fast int32 or wide) run as one
    graph a stage.  ``__call__`` gives what ``bts.bootstrap`` gives, limb for
    limb and with the same metadata; ``on_stage`` (if set) is called with
    each stage's name as it completes."""

    def __init__(self, bts):
        self.bts = bts
        self.on_stage = None
        ev, params = bts.ev, bts.p.params
        lit = bts.c2s_matrix.literal
        if lit.format not in (dft.SPLIT_REAL_AND_IMAG, dft.REPACK_IMAG_AS_REAL):
            raise ValueError(f"CoeffsToSlots format {lit.format!r}: the stages split "
                             f"real and imaginary parts as the bootstrap's formats do")
        self._repack = (lit.format == dft.REPACK_IMAG_AS_REAL
                        and lit.log_slots < params.log_n - 1)
        # one memory pool and one pair of streams for every graph of this
        # bootstrapper
        memory = graphs.GraphMemory()

        def graph(name, fn, n_out=1):
            return graph_ciphertext_fn(ev, params, fn, n_out, name=name, memory=memory)

        def head(ct):
            ct = bts.scale_down(ct)
            if bts.evk_dense_to_sparse is not None:
                ct = ev.apply_evaluation_key(ct, bts.evk_dense_to_sparse)
            return bts.mod_up(ct)

        def group(ct, mats):
            for m in mats:
                ct = ev.evaluate_lintrans(ct, m, bts.gks)
            return ev.rescale(ct)

        def c2s_tail(zv):
            # dft.coeffs_to_slots after the matrices: the conjugate split
            ct_real = ev.conjugate(zv)
            ct_imag = ev.mul_const_complex(ev.sub(zv, ct_real), -1j, scale=Fraction(1))
            ct_real = ev.add(ct_real, zv)
            if self._repack:
                ct_imag = ev.rotate(ct_imag, 1 << lit.log_slots)
                return ev.add(ct_real, ct_imag), None
            return ct_real, ct_imag

        def s2c_head(ct_real, ct_imag):
            return ev.add(ev.mul_const_complex(ct_imag, 1j, scale=Fraction(1)), ct_real)

        self._head = graph("head", head)
        self._c2s = [graph(f"c2s[{i}]", lambda c, ms=ms: group(c, ms))
                     for i, ms in enumerate(_level_groups(bts.c2s_matrix))]
        self._c2s_tail = graph("c2s_tail", c2s_tail, n_out=2)
        self._evalmod = graph("evalmod", bts.eval_mod)
        self._s2c_head = graph("s2c_head", s2c_head)
        self._s2c = [graph(f"s2c[{i}]", lambda c, ms=ms: group(c, ms))
                     for i, ms in enumerate(_level_groups(bts.s2c_matrix))]
        # __call__ returns the last stage's output
        if not self._s2c:
            raise ValueError("the SlotsToCoeffs matrix chain is empty")

    @property
    def graphs(self) -> list[GraphedCiphertextFn]:
        """The graphed functions in the order one bootstrap calls them (EvalMod
        twice, then the s2c head, when it runs on both parts)."""
        mid = [self._evalmod] if self._repack else [self._evalmod, self._evalmod,
                                                    self._s2c_head]
        return [self._head, *self._c2s, self._c2s_tail, *mid, *self._s2c]

    def _tick(self, name):
        if self.on_stage is not None:
            self.on_stage(name)

    def run_stages(self, ct: Ciphertext, eager: bool = False):
        """Generator form of ``__call__``: yields ``(stage_name, ct)`` after
        each stage, to decrypt each intermediate against a reference run.
        ``eager=True`` runs each stage's function without its graph (the
        plain form the graphs are held to)."""
        run = (lambda g, *a: g.fn(*a)) if eager else (lambda g, *a: g(*a))
        ct = run(self._head, ct)
        yield "head", ct
        for i, s in enumerate(self._c2s):
            ct = run(s, ct)
            yield f"c2s[{i}]", ct
        ct_real, ct_imag = run(self._c2s_tail, ct)
        yield "c2s_tail", ct_real
        if self._repack:
            ct = run(self._evalmod, ct_real)
            yield "evalmod", ct
        else:
            ct_real = run(self._evalmod, ct_real)
            ct_imag = run(self._evalmod, ct_imag)
            yield "evalmod2", ct_imag
            ct = run(self._s2c_head, ct_real, ct_imag)
        for i, s in enumerate(self._s2c):
            ct = run(s, ct)
            yield f"s2c[{i}]", ct

    def __call__(self, ct: Ciphertext) -> Ciphertext:
        for name, ct in self.run_stages(ct):
            self._tick(name)
        return ct
