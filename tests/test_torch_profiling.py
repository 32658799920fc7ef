"""The port's spans and host-read counter (utils/profiling.py) on the CPU:
the records of tiny solve and solve_deflated calls (parents, self time, one
solve id), off meaning nothing at all, the CUDA events read once per root
(with a stand-in for the card's events), the spans against the profiler's
own events, host_reads against a count from the sites, and the results bit
for bit with spans on and off."""
import collections
import dataclasses

import pytest
import torch

import tensorkrylov_tpu_torch as tkt
from tensorkrylov_tpu_torch.utils import profiling

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _solve(orth="lanczos_reorth"):
    op = tkt.laplace(3, 20, device=CPU)
    return tkt.solve(op, tkt.random_rhs(3, 20, seed=1), tkt.SolverConfig(kmax=12, tol=1e-6, orth=orth))


def _deflated(storage):
    op = tkt.laplace(3, 30, shift=50.0, device=CPU)
    return tkt.solve_deflated(op, tkt.random_rhs(3, 30, seed=7),
                              tkt.SolverConfig(kmax=30, tol=1e-7, orth="lanczos_reorth_auto"), m=6,
                              checkpoints=[8, 16, 24, 30], storage=storage)


CALLS = {"solve": _solve, "full": lambda: _deflated("full"), "twopass": lambda: _deflated("twopass")}


def _traced(call):
    before = profiling.solve_records()
    with profiling.tracing():
        res = call()
    after = profiling.solve_records()
    assert len(after) == min(len(before) + 1, profiling.RECORDS_KEPT)
    return res, after[-1]


@pytest.mark.parametrize("kind", sorted(CALLS))
def test_a_record_has_its_parents_self_times_and_one_solve_id(kind):
    res, rec = _traced(CALLS[kind])
    root = rec.root
    assert root.parent is None and root.name == ("solve" if kind == "solve" else "deflated")
    assert {s.solve_id for s in rec.spans} == {rec.solve_id}
    assert rec.solve_id > max([r.solve_id for r in profiling.solve_records()[:-1]] or [0])
    children = collections.defaultdict(list)
    for s in rec.spans[1:]:
        assert s.parent in rec.spans and s.parent.start_ns <= s.start_ns <= s.end_ns <= s.parent.end_ns
        children[id(s.parent)].append(s)
    for s in rec.spans:
        kids = children[id(s)]
        assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))      # in order, never overlapping
        assert s.self_ms * 1e6 == pytest.approx(s.end_ns - s.start_ns - sum(k.end_ns - k.start_ns for k in kids))
        assert s.host_reads >= sum(k.host_reads for k in kids)                  # a span counts its children's
        assert s.device_ms is None                                              # no card
    names = collections.Counter((s.name, s.parent.name) for s in rec.spans[1:])
    k = res.niterations
    if kind == "solve":
        assert names == {("solve.tables", "solve"): 1, ("solve.step", "solve"): k, ("solve.check", "solve"): k,
                         ("solve.finalize", "solve"): 1}
    else:
        want = {("deflated.prepare", "deflated"): 2, ("deflated.upload", "deflated"): 1,
                ("deflated.step", "deflated"): k, ("deflated.evaluate", "deflated"): len(res.checkpoints),
                ("deflated.finish", "deflated"): 1}
        if kind == "twopass":
            want[("deflated.step", "deflated.finish")] = k - 1                   # pass 2 replays steps 1..k-1
        assert names == want


def test_off_means_no_record_no_range_and_no_event(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("touched while spans are off")

    monkeypatch.setattr(profiling, "_Range", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    before = [r.solve_id for r in profiling.solve_records()]
    _solve()
    _deflated("twopass")
    assert [r.solve_id for r in profiling.solve_records()] == before
    off = profiling.span("solve", device=torch.device("cuda"))
    assert off is profiling.span("solve.step") and not isinstance(off, profiling.Span)
    assert profiling.host_read(torch.ones(()), float) == 1.0


class _Event:
    """A stand-in for torch.cuda.Event: the stream it was recorded on and the
    order of its record."""
    order = 0
    syncs = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.at = None

    def record(self, stream):
        assert stream == "stream"
        _Event.order += 1
        self.at = _Event.order

    def synchronize(self):
        _Event.syncs.append(self.at)

    def elapsed_time(self, end):
        return float(end.at - self.at)


def test_cuda_events_are_read_once_when_the_root_closes(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: "stream")
    _Event.syncs = []
    with profiling.tracing():
        with profiling.span("root", device=torch.device("cuda", 0)):
            with profiling.span("root.a"):
                with profiling.span("root.a.b"):
                    assert profiling.host_read(torch.ones(()), bool) is True     # a CPU tensor: not a card read
            assert _Event.syncs == []
            with profiling.span("root.c"):
                pass
    rec = profiling.solve_records()[-1]
    # events recorded in order: root 1, a 2, b 3, b 4, a 5, c 6, c 7, root 8; one wait, on the root's last
    assert [(s.name, s.device_ms) for s in rec.spans] == [("root", 7.0), ("root.a", 3.0), ("root.a.b", 1.0),
                                                         ("root.c", 1.0)]
    assert _Event.syncs == [8] and rec.root.host_reads == 0


def test_spans_are_the_profilers_tk_ranges_on_its_clock():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _solve()
    rec = profiling.solve_records()[-1]
    ranges = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("tk:"):
            ranges[e.name()[3:]].append((e.start_ns(), e.end_ns()))
    assert {name: len(v) for name, v in ranges.items()} == dict(collections.Counter(s.name for s in rec.spans))
    seen = collections.Counter()
    for s in rec.spans:
        start, end = sorted(ranges[s.name])[seen[s.name]]
        seen[s.name] += 1
        assert abs(start - s.start_ns) < 1_000_000 and abs(end - s.end_ns) < 1_000_000, s.name


# reads a step: the lucky-breakdown test, and with 'auto' the drift probe;
# a check: select_bh's digit, order, row and rank, and the status that ends
# it (the dense eigh on the CPU reads nothing)
@pytest.mark.parametrize("orth,per_step", [("lanczos_reorth", 1), ("lanczos_reorth_auto", 2)])
def test_host_reads_of_a_solve_are_the_count_from_its_sites(orth, per_step):
    res, rec = _traced(lambda: _solve(orth))
    k = res.niterations
    assert k == 12
    by_name = collections.defaultdict(int)
    for s in rec.spans:
        if s.name in ("solve.step", "solve.check"):
            by_name[s.name] += s.host_reads
    assert dict(by_name) == {"solve.step": per_step * k, "solve.check": 5 * k}
    assert rec.root.host_reads == (per_step + 5) * k


@pytest.mark.parametrize("to", [bool, int, float, torch.Tensor.cpu, torch.Tensor.item, torch.Tensor.tolist],
                         ids=lambda f: f.__name__)
def test_host_read_returns_the_bare_read(to):
    x = torch.tensor([2.5], dtype=torch.float64)[0] if to is not torch.Tensor.tolist else torch.arange(3)
    with profiling.tracing(), profiling.span("probe", device=CPU) as s:
        got = profiling.host_read(x, to)
        assert profiling.host_read(3, int) == 3                         # not a tensor: not counted
    want = to(x)
    assert type(got) is type(want) and (torch.equal(got, want) if torch.is_tensor(want) else got == want)
    assert s.host_reads == 1


def test_solve_resumable_is_one_record_whose_steps_are_solves():
    op = tkt.laplace(3, 20, device=CPU)
    b, cfg = tkt.random_rhs(3, 20, seed=1), tkt.SolverConfig(kmax=12, tol=1e-6)
    res, rec = _traced(lambda: tkt.solve_resumable(op, b, cfg, chunk=5))
    names = collections.Counter(s.name for s in rec.spans)
    assert rec.root.name == "solve" and names["solve"] == 1
    assert names["solve.step"] == names["solve.check"] == res.niterations == 12
    assert names["solve.tables"] == names["solve.finalize"] == 1
    assert all(s.parent is rec.root for s in rec.spans[1:])


def test_a_layer_called_without_a_root_leaves_no_record():
    before = [r.solve_id for r in profiling.solve_records()]
    with profiling.tracing():
        inner = profiling.span("solve.step")
        assert not isinstance(inner, profiling.Span)
        with inner:
            assert profiling.host_read(torch.ones((), dtype=torch.int64), int) == 1
    assert [r.solve_id for r in profiling.solve_records()] == before


def _fields(res):
    out = {}
    for f in dataclasses.fields(res):
        v = getattr(res, f.name)
        if isinstance(v, tkt.CPTensor):
            out[f.name + ".weights"], out[f.name + ".factors"] = v.weights, v.factors
        else:
            out[f.name] = v
    return out


@pytest.mark.parametrize("kind", sorted(CALLS))
def test_results_are_bit_identical_with_spans_on_and_off(kind):
    off = _fields(CALLS[kind]())
    on = _fields(_traced(CALLS[kind])[0])
    assert list(on) == list(off)
    for name, v in off.items():
        if torch.is_tensor(v):
            assert v.dtype == on[name].dtype and torch.equal(v, on[name]), name
        else:
            assert type(v) is type(on[name]) and v == on[name], name
