"""The program's spans on the tree and BCC paths (``obs``, DESIGN.md §14).

Under a ``Tracer`` the RST flavors and ``biconnectivity`` record their
layer boundaries as spans, nested as the calls are, and a running
``torch.profiler`` sees each as a ``user_annotation`` range of its name;
with no tracer nothing is recorded; outputs and counts are the same either
way. The test marked ``cuda`` holds the doubling kernels' span args to the
passes a tree's counts say they ran, and the host reads of a tree to the
same count with and without a tracer; it skips without a card.
"""
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.core import biconnectivity, rooted_spanning_tree
from repro_torch.data import graphs
from repro_torch.kernels.list_rank.ops import list_rank_double_k
from repro_torch.kernels.pointer_jump.ops import pointer_jump_double_k

TREE = {("rst", None), ("connectivity", "rst"), ("rst.forest", "rst"),
        ("euler.root", "rst")}
# (span, the span it opens inside) for each call, as the calls nest.
NESTING = {
    "gconn_euler": TREE,
    "bfs": {("rst", None), ("bfs.levels", "rst")},
    "bcc": {("bcc", None), ("bcc.numbering", "bcc"), ("bcc.core", "bcc"),
            ("connectivity", "bcc.core")}
           | {(c, p or "bcc") for c, p in TREE},
}


def _call(kind, device="cpu"):
    if kind == "bcc":
        return biconnectivity(graphs.rmat(6, edge_factor=4, device=device),
                              5, device=device)
    return rooted_spanning_tree(graphs.grid2d(6, device=device), 5, kind,
                                device=device)


def _annotations(prof):
    """(name, start_ns, end_ns) of the profiler's user annotations."""
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation()]


def _nesting(ranges):
    """{(name, name of the innermost range around it, or None)}."""
    out, stack = set(), []
    for name, s, e in sorted(ranges, key=lambda r: (r[1], -r[2])):
        while stack and stack[-1][2] <= s:
            stack.pop()
        out.add((name, stack[-1][0] if stack else None))
        stack.append((name, s, e))
    return out


@pytest.mark.parametrize("kind", sorted(NESTING))
def test_spans_nest_as_the_calls_do_and_enter_the_profiler(kind):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.Tracer() as tracer:
            _call(kind)
    ranges = _annotations(prof)
    assert _nesting(ranges) == NESTING[kind]
    assert sorted(r[0] for r in ranges) == \
        sorted(r["name"] for r in tracer.spans())
    for r in tracer.spans():
        assert set(r) == {"v", "type", "name", "ts", "dur", "syncs", "step",
                          "args"}
        assert r["args"] == {} and r["syncs"] == 0
    assert obs.current_tracer() is None


def test_no_tracer_records_no_span():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _call("bcc")
    assert obs.current_tracer() is None
    assert _annotations(prof) == []


def test_a_span_is_a_user_annotation_of_its_name():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.Tracer() as tracer, obs.span("outer", step=3, k=2):
            torch.arange(4).sum()
    assert [r[0] for r in _annotations(prof)] == ["outer"]
    span, = tracer.spans()
    assert (span["name"], span["step"], span["args"]) == ("outer", 3,
                                                          {"k": 2})


def _fields(out):
    return {k: v for k, v in vars(out).items() if v is not None}


@pytest.mark.parametrize("kind", ["gconn_euler", "bfs", "pr_rst", "bcc"])
def test_outputs_and_counts_are_the_same_with_a_tracer(kind):
    plain = _fields(_call(kind))
    with obs.Tracer():
        traced = _fields(_call(kind))
    assert plain.keys() == traced.keys()
    for k, v in plain.items():
        if torch.is_tensor(v):
            assert torch.equal(v, traced[k]), k
        else:
            assert v == traced[k], k


@pytest.mark.cuda
def test_kernel_spans_count_the_passes_a_tree_ran():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    g = graphs.rmat(12, edge_factor=8, device=dev)
    n = g.n_nodes
    launches = (pointer_jump_double_k.launches, list_rank_double_k.launches)
    with obs.Tracer() as tracer:
        r = rooted_spanning_tree(g, 7, "gconn_euler", device=dev)
    torch.cuda.synchronize()

    def passes(name):
        spans = tracer.spans(name)
        return len(spans), sum(s["args"]["entries"] * s["args"]["passes"]
                               for s in spans)

    assert passes("kernel.pointer_jump_double") == (
        pointer_jump_double_k.launches - launches[0], n * 5 * r.compress_syncs)
    assert passes("kernel.list_rank_double") == (
        list_rank_double_k.launches - launches[1],
        2 * (n - 1) * 5 * r.rank_syncs)

    def host_syncs(traced):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                if traced:
                    with obs.Tracer():
                        rooted_spanning_tree(g, 7, "gconn_euler", device=dev)
                else:
                    rooted_spanning_tree(g, 7, "gconn_euler", device=dev)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return sum("called a synchronizing" in str(w.message)
                   for w in caught)

    assert host_syncs(True) == host_syncs(False) > 0
