"""Functions of tensors captured into CUDA graphs: the port's counterpart of
``jax.jit``.

``GraphedFn`` runs a function of tensors (nested tuples and lists of
tensors, with ``None`` and other plain values allowed) as one
``torch.cuda.CUDAGraph`` for each input signature: the (shape, dtype,
device) of each input tensor, and the structure and plain values of the
arguments (the caller's static key).  The first call of a
signature runs the function once eagerly on a side stream (a warm-up: it
fills the callers' caches and makes every device constant the function
reads, kept for the graph, ``utils/device.py:holding``), then captures it
on static copies of the inputs; every call copies its inputs into the
static buffers, replays, and returns clones of the static outputs.  Graphs
given the same ``GraphMemory`` share one memory pool and one pair of
streams a device, and their static inputs: one buffer for each (device,
shape, dtype) and place among a call's inputs of that shape, which every
call fills before its replay on the caller's stream.  A function that
cannot be captured (a host synchronisation, a copy from host memory)
raises with its name; it never runs eagerly instead.

A kernel's wrapper counts its launch through ``launched``: 1 when the
kernel runs now, 0 inside a stream capture, where nothing runs.  A capture
of this module's records the launches under the wrappers' names, and each
replay of its graph counts them again into every ``replays()`` window
open, so a window sees every launch the graphs made in it.

As a ``jit`` inside a ``jit`` is inlined, a graphed function called while
another one runs its body, or inside any stream capture, runs eagerly, so
that the outer graph records its kernels.  ``nesting()`` tells the callers
of a cache of graphed functions (``rlwe/evaluator.py``, ``rlwe/keys.py``)
whether such a call is part of a first run (a trace: the JAX package's
caches are looked up then) or of a capture or a replayed signature.

On the CPU a graphed function runs eagerly, which is its plain form; the
first call of a signature counts as a trace, the later ones do not.

Within ``eager()`` every graphed function runs eagerly, the plain form the
graphs are held to.  ``circuits/ckks/staged.py`` runs the bootstrap's
stages on this core.
"""

from __future__ import annotations

import contextlib
import time
import weakref

import torch

from matrix_fhe_tpu_torch.utils import device as devconst

TRACE, QUIET = "trace", "quiet"

_TENSOR = ("tensor",)
_nested: list[str] = []   # the modes of the graphed bodies running, innermost last


class Launches:
    """Kernel launches by (the wrapper's name, the input's shape, the
    tables it was given): their count, and the tables."""

    def __init__(self):
        self._by_key: dict = {}

    def add(self, name: str, shape: tuple, tables, n: int = 1) -> None:
        entry = self._by_key.setdefault((name, shape, id(tables)), [0, tables])
        entry[0] += n

    def update(self, other: "Launches") -> None:
        for (name, shape, _), (n, tables) in other._by_key.items():
            self.add(name, shape, tables, n)

    def items(self):
        """(name, shape, tables, count) for each key."""
        for (name, shape, _), (n, tables) in self._by_key.items():
            yield name, shape, tables, n

    def count(self, name: str) -> int:
        return sum(n for k, (n, _) in self._by_key.items() if k[0] == name)


_tallies: list[Launches] = []   # the launches the captures underway record
_windows: list[Launches] = []   # the open replays() windows


def launched(name: str, x: torch.Tensor, tables) -> int:
    """A wrapper's launch of its kernel ``name`` on the CUDA tensor ``x``
    with ``tables``: 1 when it runs now, 0 inside a stream capture (within
    one of this module's, recorded into the graph, whose replays count it).
    The wrapper adds what this returns to its own count."""
    if not torch.cuda.is_current_stream_capturing():
        return 1
    if _tallies:
        _tallies[-1].add(name, tuple(x.shape), tables)
    return 0


@contextlib.contextmanager
def replays():
    """Within: a ``Launches`` of the kernel launches the graphs replay."""
    window = Launches()
    _windows.append(window)
    try:
        yield window
    finally:
        _windows.remove(window)


def flatten(tree) -> tuple[list, tuple]:
    """The tensors of ``tree`` (nested tuples and lists), in order, and a
    hashable spec of the rest: the structure and every other value."""
    leaves = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x)
            return _TENSOR
        if isinstance(x, (tuple, list)):
            return (type(x), tuple(walk(v) for v in x))
        return ("value", x)
    return leaves, walk(tree)


def unflatten(leaves, spec):
    """The tree ``flatten`` took apart, with ``leaves`` for its tensors."""
    it = iter(leaves)

    def build(s):
        if s is _TENSOR:
            return next(it)
        kind, v = s
        return v if kind == "value" else kind(build(c) for c in v)
    return build(spec)


def nesting(dev: torch.device) -> str | None:
    """How a graphed call on ``dev`` made now is nested: ``TRACE`` inside
    the first run of an outer graphed body (its warm-up, or its first call
    of a signature on the CPU) or inside a stream capture this module did
    not start, ``QUIET`` inside an outer capture or a replayed signature's
    eager run on the CPU, None at the top level."""
    if _nested:
        return _nested[-1]
    if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
        return TRACE
    return None


class _Body:
    """Within: the graphed bodies' nesting mode is ``mode``."""

    def __init__(self, mode: str):
        self.mode = mode

    def __enter__(self):
        _nested.append(self.mode)

    def __exit__(self, *exc):
        _nested.pop()


def eager() -> _Body:
    """Within: every graphed function, and every cache of them, runs its
    function eagerly and looks nothing up (the plain form of the graphs)."""
    return _Body(QUIET)


class GraphMemory:
    """One memory pool and one pair of streams (warm-up, capture) a device,
    shared by the graphs given it: the caching allocator reuses a freed
    block only on the stream that allocated it, so a capture reuses the
    blocks the captures before it freed in the pool, and a warm-up those
    the warm-ups before it freed.  The pool holds an anchor, a graph of one
    kernel that allocates nothing, for as long as this object lives: the
    allocator lets a capture join a pool only while another graph holds it,
    and a cache's graphs may all be evicted.  The graphs share their static
    inputs too (``inputs``), each kept while a graph holds it."""

    def __init__(self):
        self._by_device: dict = {}
        self._inputs = weakref.WeakValueDictionary()

    def inputs(self, leaves) -> tuple:
        """The static input buffers for ``leaves``, outside the pool: the
        k-th input of a (device, shape, dtype) takes that key's k-th
        buffer."""
        out, seen = [], {}
        for t in leaves:
            key = (t.device, tuple(t.shape), t.dtype)
            seen[key] = k = seen.get(key, -1) + 1
            buf = self._inputs.get((key, k))
            if buf is None:
                buf = self._inputs[key, k] = torch.empty(t.shape, dtype=t.dtype, device=t.device)
            out.append(buf)
        return tuple(out)

    def get(self, dev: torch.device) -> tuple:
        """(pool, warm-up stream, capture stream) of ``dev``."""
        if dev not in self._by_device:
            pool, side, stream = (torch.cuda.graph_pool_handle(), torch.cuda.Stream(dev),
                                  torch.cuda.Stream(dev))
            word = torch.zeros(1, dtype=torch.int64, device=dev)
            anchor = torch.cuda.CUDAGraph()
            with torch.cuda.stream(stream), torch.cuda.graph(anchor, pool=pool, stream=stream):
                word.add_(1)
            self._by_device[dev] = (pool, side, stream, anchor, word)
        return self._by_device[dev][:3]

    def pool(self, dev: torch.device):
        return self.get(dev)[0]

    def discard(self, dev: torch.device) -> None:
        """Drop ``dev``'s pool and streams: a failed capture leaves the
        allocator recording to its pool, so the next capture takes new ones."""
        self._by_device.pop(dev, None)


class Graph:
    """One captured graph: its static input buffers and outputs, the
    structure of its outputs, the device constants it reads, the function
    it captured (which keeps alive every tensor the graph reads besides its
    inputs), the kernel launches it replays and the first call's times."""

    def __init__(self, graph, inputs, in_spec, outputs, out_spec, constants, fn, launches,
                 seconds):
        self.graph = graph
        self.inputs = inputs        # the static input tensors, in flatten's order (shared)
        self.in_spec = in_spec
        self.outputs = outputs      # the static output tensors
        self.out_spec = out_spec
        # every utils/device.py constant read while capturing: the graph holds
        # their addresses, not references, and the shared cache may drop them
        self.constants = constants
        self.fn = fn
        self.launches = launches    # a Launches: the wrappers' launches the capture recorded
        self.seconds = seconds      # {"warm-up": s, "capture": s}
        self.replays = 0

    def __call__(self, leaves):
        for dst, src in zip(self.inputs, leaves):
            dst.copy_(src)
        return self.replay()

    def replay(self):
        """Replay on the inputs the static buffers hold; clones of the outputs."""
        self.graph.replay()
        self.replays += 1
        for window in _windows:
            window.update(self.launches)
        return unflatten([o.clone() for o in self.outputs], self.out_spec)

    def eager(self):
        """The captured function run eagerly on the static inputs (the last
        call's of any graph sharing them): the kernels one replay launches."""
        with eager():
            return self.fn(*unflatten(self.inputs, self.in_spec))

    def release(self) -> None:
        self.graph.reset()


def capture(fn, leaves: list, spec, name: str, memory: GraphMemory, caches=tuple) -> Graph:
    """``fn`` on static copies of ``leaves`` (unflattened by ``spec``): run
    once eagerly on ``memory``'s warm-up stream, then captured on its
    capture stream into its pool.  ``caches()`` gives the sizes of the
    caches the warm-up fills; it raises if the capture grew one."""
    dev = leaves[0].device
    inputs = memory.inputs(leaves)
    for dst, src in zip(inputs, leaves):
        dst.copy_(src)
    args = unflatten(inputs, spec)
    pool, side, stream = memory.get(dev)
    t0 = time.perf_counter()
    side.wait_stream(torch.cuda.current_stream(dev))
    held: dict = {}
    with torch.cuda.stream(side), devconst.holding(held), _Body(TRACE):
        fn(*args)
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    sizes = caches()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    tally = Launches()
    _tallies.append(tally)
    try:
        # the outer context puts the current stream back even when a
        # failed capture leaves torch.cuda.graph's own unrestored
        with devconst.holding(held), _Body(QUIET), torch.cuda.stream(stream), \
                torch.cuda.graph(graph, pool=pool, stream=stream):
            out = fn(*args)
    except RuntimeError as e:
        memory.discard(dev)
        raise RuntimeError(f"{name} could not be captured into a CUDA graph: {e}") from e
    finally:
        _tallies.pop()
    if caches() != sizes:
        # an entry made during the capture would hold memory that the
        # graph's next replay writes over
        raise RuntimeError(f"{name} added to its caches during its capture, after an eager "
                           f"run of the same inputs")
    graph.instantiate()
    torch.cuda.synchronize(dev)
    outputs, out_spec = flatten(out)
    return Graph(graph, inputs, spec, outputs, out_spec, held, fn, tally,
                 {"warm-up": t1 - t0, "capture": time.perf_counter() - t1})


class GraphedFn:
    """A function of tensors as one CUDA graph for each input signature
    (see the module's docstring).  ``call(fn, *args, caches=...)`` runs the
    function ``fn`` given at that call (on a new signature it is captured,
    and the graph keeps it); the plain values among ``args`` are the
    caller's static key.  ``memory`` is the pool and streams to capture
    with, ``caches`` as ``capture``'s."""

    def __init__(self, name: str, memory: GraphMemory):
        self.name = name
        self.memory = memory
        self.entries: dict = {}    # signature -> Graph, the captured ones
        self.traced: set = set()   # the signatures run on the CPU

    def call(self, fn, *args, caches=tuple):
        leaves, spec = flatten(args)
        dev = leaves[0].device
        if nesting(dev) is not None:
            # inside an outer graph: inlined
            return fn(*args)
        sig = (spec, tuple((t.shape, t.dtype, t.device) for t in leaves))
        if dev.type != "cuda":
            first = sig not in self.traced
            self.traced.add(sig)
            with _Body(TRACE if first else QUIET):
                return fn(*args)
        entry = self.entries.get(sig)
        if entry is None:
            entry = self.entries[sig] = capture(fn, leaves, spec, self.name, self.memory, caches)
            return entry.replay()
        return entry(leaves)

    def release(self) -> None:
        """Free every graph (an evicted cache entry)."""
        for g in self.entries.values():
            g.release()
        self.entries.clear()
        self.traced.clear()


# The pool and streams of the key-switch caches (rlwe/evaluator.py, rlwe/keys.py).
SHARED = GraphMemory()


def cached(cache, maxsize: int, key, name: str, fn, dev: torch.device, caches=tuple):
    """The counterpart of a lookup in one of the JAX package's bounded jit
    caches (``rlwe/evaluator.py:_pjit``): ``fn`` as the ``GraphedFn`` of
    ``key`` in ``cache`` (an ``OrderedDict``, least recently used first)
    runs it, captured into ``SHARED``.  A miss makes the entry and evicts
    the least recently used ones beyond ``maxsize`` (their graphs freed); a
    hit moves it to the end.  Nested in an outer graphed body (``nesting``)
    it returns ``fn`` to run eagerly: in a trace after the lookup, as a
    ``jit`` traced inside another is looked up and inlined, in a capture or
    a replayed signature without it, as a traced ``jit`` runs no Python."""
    mode = nesting(dev)
    if mode == QUIET:
        return fn
    g = cache.get(key)
    if g is None:
        g = cache[key] = GraphedFn(name, SHARED)
        while len(cache) > maxsize:
            cache.popitem(last=False)[1].release()
    else:
        cache.move_to_end(key)
    if mode == TRACE:
        return fn
    return lambda *args: g.call(fn, *args, caches=caches)
