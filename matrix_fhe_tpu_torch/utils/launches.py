"""What a call does on the card, counted without a profiler.

* ``graph_kernels(fn, calls)``: the calls captured into a CUDA graph (no
  work runs), whose nodes are read back through the driver
  (``graph_nodes``): the name of each kernel node, or the type of any
  other node.  A profiler may drop device events; a captured graph holds
  every launch the calls made.
* ``torch_ops(fn)``: the torch operators one call dispatches (a dispatch
  mode records each; a launch through ctypes is none).

``chip_smoke.py`` (phase 16) and ``tests/test_torch_ntt3n_cuda.py`` check
with them that a CI transform is one kernel and no torch operator on its
words; phase 27 counts the kernels in the staged bootstrap's graphs
(``circuits/ckks/staged.py``) with ``graph_nodes``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# CUgraphNodeType's kernel node (cuda.h)
_KERNEL_NODE = 0


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 (cuda.h)."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared_mem_bytes", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


@functools.lru_cache(maxsize=None)
def _driver() -> ctypes.CDLL:
    lib = ctypes.CDLL("libcuda.so.1")
    p, ref = ctypes.c_void_p, ctypes.POINTER
    lib.cuGraphGetNodes.argtypes = [p, p, ref(ctypes.c_size_t)]
    lib.cuGraphNodeGetType.argtypes = [p, ref(ctypes.c_int)]
    lib.cuGraphKernelNodeGetParams_v2.argtypes = [p, ref(_KernelNodeParams)]
    lib.cuFuncGetName.argtypes = lib.cuKernelGetName.argtypes = [ref(ctypes.c_char_p), p]
    return lib


def _check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} failed: CUresult {err}")


def graph_kernels(fn, calls: int = 3) -> list[str]:
    """``graph_nodes`` of a CUDA graph into which ``calls`` calls of fn()
    are captured.  fn() runs once first, outside the capture (it may build
    or load a kernel)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    out = graph_nodes(graph)
    graph.reset()
    return out


def graph_nodes(graph: torch.cuda.CUDAGraph) -> list[str]:
    """One entry for each node of a captured graph (made with
    ``keep_graph=True``), in the driver's order: a kernel node's function
    name (as compiled), any other node as ``"node type <t>"``."""
    lib, raw = _driver(), ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    _check(lib.cuGraphGetNodes(raw, None, ctypes.byref(count)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * count.value)()
    _check(lib.cuGraphGetNodes(raw, nodes, ctypes.byref(count)), "cuGraphGetNodes")
    out = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        _check(lib.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
        if kind.value != _KERNEL_NODE:
            out.append(f"node type {kind.value}")
            continue
        params, name = _KernelNodeParams(), ctypes.c_char_p()
        _check(lib.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(params)),
               "cuGraphKernelNodeGetParams")
        if params.func:
            _check(lib.cuFuncGetName(ctypes.byref(name), params.func), "cuFuncGetName")
        else:
            _check(lib.cuKernelGetName(ctypes.byref(name), params.kern), "cuKernelGetName")
        out.append(name.value.decode())
    return out


class _Recorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def torch_ops(fn) -> list[str]:
    """The torch operators one call of fn() dispatches, in order."""
    with _Recorder() as rec:
        fn()
    return rec.ops
