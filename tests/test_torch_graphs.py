"""PyTorch port, utils/graphs.py's bookkeeping on the CPU: the static input
buffers that the graphs of one ``GraphMemory`` share, and the launches a
replayed graph counts into the ``replays()`` windows open.  The capture
itself needs a card (``tests/test_torch_graph_cache_cuda.py``).
"""

import gc

import torch

from matrix_fhe_tpu_torch.utils import graphs


def test_static_inputs_shared_by_shape():
    """The k-th input of a (device, shape, dtype) takes one buffer for every
    graph; two inputs of one shape take two; a buffer no graph holds is
    freed."""
    memory = graphs.GraphMemory()
    a, b = torch.zeros(3, 4, dtype=torch.int64), torch.ones(3, 4, dtype=torch.int64)
    first = memory.inputs([a, b, torch.zeros(2, dtype=torch.int64)])
    assert first[0] is not first[1]
    assert [tuple(t.shape) for t in first] == [(3, 4), (3, 4), (2,)]
    assert all(t.is_contiguous() for t in first)
    second = memory.inputs([b.t().contiguous().t(), torch.zeros(2, dtype=torch.int32)])
    assert second[0] is first[0] and second[1] is not first[2]
    assert len(memory._inputs) == 4
    del first, second
    gc.collect()
    assert len(memory._inputs) == 0


def test_launches_count_by_name():
    tables, other = object(), object()
    tally = graphs.Launches()
    tally.add("k.fwd", (2, 8), tables)
    tally.add("k.fwd", (2, 8), tables)
    tally.add("k.fwd", (2, 8), other)
    tally.add("k.bwd", (1, 8), tables)
    window = graphs.Launches()
    for _ in range(3):
        window.update(tally)
    assert window.count("k.fwd") == 9 and window.count("k.bwd") == 3
    assert window.count("k.chain") == 0
    assert sorted((n, s, t is tables, c) for n, s, t, c in window.items()) == [
        ("k.bwd", (1, 8), True, 3), ("k.fwd", (2, 8), False, 3), ("k.fwd", (2, 8), True, 6)]


class _Replayable:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_replays_count_into_the_open_windows():
    """A replay adds the launches its capture recorded to every window open,
    and to none once the window is closed."""
    tally = graphs.Launches()
    tally.add("k.fwd", (4,), None, 2)
    out = torch.arange(4)
    g = graphs.Graph(_Replayable(), (), None, [out], graphs.flatten(out)[1], {}, None, tally,
                     {"warm-up": 0.0, "capture": 0.0})
    with graphs.replays() as outer:
        assert torch.equal(g.replay(), out)
        with graphs.replays() as inner:
            g.replay()
        g.replay()
    g.replay()
    assert inner.count("k.fwd") == 2 and outer.count("k.fwd") == 6
    assert g.replays == g.graph.replays == 4
