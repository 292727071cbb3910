"""chip_smoke's exact launch counter (``count_kernel_nodes``, ``graph_launches``)
on the CPU, with the CUDA runtime's graph queries stubbed.

On the card ``check_beam_cross_attention`` captures its calls in a CUDA
graph and counts the graph's kernel nodes, instead of counting profiler
records (which can be dropped). Here a stub runtime serves graphs of known
nodes through the same ctypes calling convention: the count takes kernel
nodes only, descends into child graphs, and raises on a CUDA error; where
torch cannot hand out the captured graph or has loaded no CUDA runtime,
``graph_launches`` raises and names what is missing."""

import ctypes

import pytest
import torch

import chip_smoke

KERNEL, MEMCPY, MEMSET, CHILD, EMPTY = 0, 1, 2, 4, 5


class StubRuntime:
    """cudaGraphGetNodes, cudaGraphNodeGetType and
    cudaGraphChildGraphNodeGetGraph over ``graphs``: {graph handle: [(node
    handle, node type, child graph handle or None)]}."""

    def __init__(self, graphs, fail=None):
        self.graphs = graphs
        self.nodes = {n: (kind, child) for g in graphs.values() for n, kind, child in g}
        self.fail = fail
        self.calls = []

        def cudaGraphGetNodes(graph, nodes, count):
            self.calls.append("cudaGraphGetNodes")
            entries = self.graphs[graph.value]
            if nodes is not None:
                for i, (n, _, _) in enumerate(entries[:count.contents.value]):
                    nodes[i] = n
            count.contents.value = len(entries)
            return 0

        def cudaGraphNodeGetType(node, kind):
            self.calls.append("cudaGraphNodeGetType")
            if self.fail == node.value:
                return 400  # cudaErrorInvalidResourceHandle
            kind.contents.value = self.nodes[node.value][0]
            return 0

        def cudaGraphChildGraphNodeGetGraph(node, graph):
            self.calls.append("cudaGraphChildGraphNodeGetGraph")
            graph.contents.value = self.nodes[node.value][1]
            return 0

        self.cudaGraphGetNodes = cudaGraphGetNodes
        self.cudaGraphNodeGetType = cudaGraphNodeGetType
        self.cudaGraphChildGraphNodeGetGraph = cudaGraphChildGraphNodeGetGraph


def _flat(handle, kinds, first=100):
    return {handle: [(first + i, k, None) for i, k in enumerate(kinds)]}


@pytest.mark.parametrize("kinds,want", [
    ([KERNEL, KERNEL], 2),
    ([MEMSET, KERNEL, EMPTY, KERNEL, MEMCPY], 2),
    ([], 0),
    ([KERNEL] * 40, 40),
], ids=["kernels", "other_nodes_skipped", "empty", "forty"])
def test_counts_kernel_nodes_only(kinds, want):
    rt = StubRuntime(_flat(7, kinds))
    assert chip_smoke.count_kernel_nodes(7, rt) == want


def test_descends_into_child_graphs():
    graphs = {1: [(10, KERNEL, None), (11, CHILD, 2), (12, MEMSET, None)],
              2: [(20, KERNEL, None), (21, CHILD, 3), (22, KERNEL, None)],
              3: [(30, KERNEL, None)]}
    rt = StubRuntime(graphs)
    assert chip_smoke.count_kernel_nodes(1, rt) == 4
    assert rt.calls.count("cudaGraphChildGraphNodeGetGraph") == 2


def test_a_cuda_error_raises():
    rt = StubRuntime(_flat(7, [KERNEL, KERNEL]), fail=101)
    with pytest.raises(RuntimeError, match="cudaGraphNodeGetType returned CUDA error 400"):
        chip_smoke.count_kernel_nodes(7, rt)


def test_graph_handles_pass_as_pointers():
    """Handles above 2^32 reach the runtime whole (ctypes.c_void_p, not int)."""
    big = 0x7F00_1234_5678
    rt = StubRuntime({big: [(big + 8, KERNEL, None)]})
    assert chip_smoke.count_kernel_nodes(big, rt) == 1


def test_graph_launches_names_a_torch_without_keep_graph(monkeypatch):
    class OldGraph:
        def __init__(self):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", OldGraph)
    with pytest.raises(RuntimeError, match="takes no keep_graph"):
        chip_smoke.graph_launches(lambda: None, 2)


def test_graph_launches_names_a_graph_it_cannot_read(monkeypatch):
    class NoRawGraph:
        def __init__(self, keep_graph=False):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", NoRawGraph)
    with pytest.raises(RuntimeError, match="has no raw_cuda_graph"):
        chip_smoke.graph_launches(lambda: None, 2)


def test_no_runtime_loaded_is_named(monkeypatch):
    """A torch without a loaded libcudart (this CPU build) cannot count: the
    counter raises rather than fall back to the profiler."""
    monkeypatch.setattr(torch.version, "cuda", "12.4")

    def refuse(name, mode=0):
        raise OSError(f"{name}: cannot open shared object file")

    monkeypatch.setattr(ctypes, "CDLL", refuse)
    with pytest.raises(RuntimeError, match=r"torch has not loaded libcudart\.so\.12"):
        chip_smoke.cuda_runtime()


def test_a_runtime_without_a_query_is_named(monkeypatch):
    class Partial:
        cudaGraphGetNodes = cudaGraphNodeGetType = object()

    monkeypatch.setattr(ctypes, "CDLL", lambda name, mode=0: Partial())
    with pytest.raises(RuntimeError, match="lacks \\['cudaGraphChildGraphNodeGetGraph'\\]"):
        chip_smoke.cuda_runtime()
