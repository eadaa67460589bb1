"""The port runs on the card unless the caller asks for the CPU.

Every entry point that places data takes ``device=None``, which
``mini_tpu_torch.default_device()`` resolves to ``cuda``; with no CUDA
device it raises a ``RuntimeError`` that names ``device="cpu"``, and
nothing falls back to the CPU.  ``torch.cuda.is_available`` is patched
here, so these tests need no card; no tensor is placed on the card.
"""

import numpy as np
import pytest
import torch

import mini_tpu_torch
from mini_tpu_torch.graph import GraphSlice, erdos_renyi
from mini_tpu_torch.graph.banded import get_layout
from mini_tpu_torch.models import gat, gcn, sage
from mini_tpu_torch.ops.frontier import Frontier
from mini_tpu_torch.utils.timing import Timing, time_fn


@pytest.fixture(scope="module")
def host_graph():
    return erdos_renyi(60, 300, seed=5, undirected=True)


def _gen():
    return torch.Generator().manual_seed(0)


def _params_np():
    return [{"w": np.ones((4, 3), np.float32),
             "b": np.zeros(3, np.float32)}]


# entry point -> a call that places data, given the device keyword
ENTRY_POINTS = {
    "GraphSlice.from_host": lambda hg, **kw: GraphSlice.from_host(hg, **kw),
    "gcn_init": lambda hg, **kw: gcn.gcn_init(_gen(), [4, 3], **kw),
    "params_from_jax": lambda hg, **kw: gcn.params_from_jax(_params_np(),
                                                            **kw),
    "gat_init": lambda hg, **kw: gat.gat_init(_gen(), [4, 3], heads=2, **kw),
    "sage_init": lambda hg, **kw: sage.sage_init(_gen(), [4, 3], **kw),
    "Frontier.empty": lambda hg, **kw: Frontier.empty(128, **kw),
    "Frontier.full": lambda hg, **kw: Frontier.full(128, 60, **kw),
    "BandedLayout.dev": lambda hg, **kw: get_layout(
        GraphSlice.from_host(hg, device="cpu"), "pull").dev(**kw),
    "time_fn": lambda hg, **kw: time_fn(lambda: None, warmup=0, repeat=1,
                                        **kw),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_no_card_raises_without_device(monkeypatch, host_graph, name):
    call = ENTRY_POINTS[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        call(host_graph)


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_cpu_when_asked(monkeypatch, host_graph, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = ENTRY_POINTS[name](host_graph, device="cpu")
    if isinstance(out, Timing):
        assert out.runs == 1 and out.min_s >= 0
        return
    tensors = {
        GraphSlice: lambda o: [o.row_offsets, o.csc_weights],
        Frontier: lambda o: [o.mask],
        dict: lambda o: [o["bounds"], o["row_prefix"], *o["ids"]],
        list: lambda o: [v for p in o for v in p.values()],
    }[type(out)](out)
    assert tensors and all(t.device.type == "cpu" for t in tensors)


def test_default_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert mini_tpu_torch.default_device() == torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        mini_tpu_torch.default_device()
