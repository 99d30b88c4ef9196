"""Parity of the port's makespan simulator (``repro_torch.core.simulate``)
with the JAX package's (``repro.core.simulate``).

Both are the same standard-library code computing the same Python floats
in the same order, so every comparison here is exact (``==``): every
``SimResult`` field and every replayed trace of ``tests/test_simulator.py``'s
graphs, both benchmarks' simulated makespans for every version at 1-16
ranks in strong and weak scaling shapes, and ``trace_events`` /
``schedule_makespan`` over three Level-A schedules.  Each graph is built
twice by one factory, once from each package's ``SimTask``.
"""

import pytest

from benchmarks import gauss_seidel as jax_gs
from benchmarks import ifsker as jax_ifsker
from repro.core import schedule as jax_schedule
from repro.core import simulate as jax_sim
from repro_torch import obs
from repro_torch.bench import gauss_seidel as gs
from repro_torch.bench import ifsker
from repro_torch.core import schedule, simulate

RANKS = (1, 2, 4, 8, 16)


# tests/test_simulator.py's graphs: (name, n_ranks, workers, simulator
# keywords, factory of the task list from a simulate module, fail=)
def _serial_chain(S):
    return [S.SimTask(0, 0, 1.0),
            S.SimTask(1, 0, 2.0, start_deps=[(0, 0.0)])]


def _width(S):
    return [S.SimTask(i, 0, 1.0) for i in range(4)]


def _edge_latency(S):
    return [S.SimTask(0, 0, 1.0), S.SimTask(1, 1, 1.0, start_deps=[(0, 0.5)])]


def _comm_graph(kind):
    def build(S):
        return [S.SimTask(0, 1, 5.0, name="remote-producer"),
                S.SimTask(1, 0, 0.1, kind=getattr(S, kind),
                          event_deps=[(0, 0.0)], name="comm"),
                S.SimTask(2, 0, 1.0, name="independent-compute")]
    return build


def _paused_deadlock_graph(S):
    return [S.SimTask(0, 0, 0.1, kind=S.COMM_PAUSED, event_deps=[(1, 0.0)]),
            S.SimTask(1, 0, 0.1, kind=S.COMM_PAUSED, event_deps=[(0, 0.0)])]


def _events_release(S):
    return [S.SimTask(0, 1, 3.0),
            S.SimTask(1, 0, 0.1, kind=S.COMM_EVENTS, event_deps=[(0, 0.5)]),
            S.SimTask(2, 0, 1.0, start_deps=[(1, 0.0)])]


def _collective(S):
    """Held, paused and event-bound members of two collective groups and a
    halo round, with a rank death replayed in one case."""
    tasks = []
    kinds = (S.COMM_HELD, S.COMM_PAUSED, S.COMM_EVENTS)
    for r in range(3):
        tasks.append(S.SimTask(len(tasks), r, 0.3 + 0.2 * r, name=f"c{r}"))
    for r in range(3):
        tasks.append(S.SimTask(len(tasks), r, 0.05, kind=kinds[r],
                               start_deps=[(r, 0.0)], group="g",
                               group_latency=0.25, name=f"g{r}"))
    for r in range(3):
        tasks.append(S.SimTask(len(tasks), r, 0.05, kind=kinds[r],
                               start_deps=[(3 + r, 0.1)], name=f"h{r}"))
    for r in range(3):
        tasks[6 + r].neighbors = [(6 + p, 0.1) for p in range(3) if p != r]
    for r in range(3):
        tasks.append(S.SimTask(len(tasks), r, 0.4, start_deps=[(6 + r, 0.0)],
                               name=f"d{r}"))
    return tasks


GRAPHS = [
    ("serial_chain", 1, 1, {}, _serial_chain, None),
    ("width_2", 1, 2, {}, _width, None),
    ("width_4", 1, 4, {}, _width, None),
    ("edge_latency", 2, 1, {}, _edge_latency, None),
    ("held", 2, 1, {}, _comm_graph("COMM_HELD"), None),
    ("paused", 2, 1, {"resume_overhead": 0.01}, _comm_graph("COMM_PAUSED"),
     None),
    ("events", 2, 1, {}, _comm_graph("COMM_EVENTS"), None),
    ("paused_no_deadlock", 1, 1, {}, _paused_deadlock_graph, None),
    ("events_release", 2, 1, {}, _events_release, None),
    ("collective", 3, 2, {"task_overhead": 0.001, "resume_overhead": 0.01,
                          "dispatch_overhead": 0.002}, _collective, None),
    ("collective_rank_death", 3, 2, {"resume_overhead": 0.01}, _collective,
     (1, 0.45)),
]


def _result_fields(res):
    return (res.makespan, res.done_times, res.busy_time, res.held_wait_time,
            res.max_paused, res.resumes, res.failed)


def _replay(S, n_ranks, workers, kw, build, fail):
    tasks = build(S)
    res = S.Simulator(n_ranks, workers, **kw).run(tasks, fail=fail)
    return _result_fields(res), S.trace_events(tasks), \
        res.utilization(workers, n_ranks)


@pytest.mark.parametrize("name,n_ranks,workers,kw,build,fail", GRAPHS,
                         ids=[g[0] for g in GRAPHS])
def test_simulator_results_and_traces_equal_reference(name, n_ranks, workers,
                                                      kw, build, fail):
    got = _replay(simulate, n_ranks, workers, kw, build, fail)
    want = _replay(jax_sim, n_ranks, workers, kw, build, fail)
    assert got == want
    assert obs.validate_trace(got[1]) == []


def test_simulator_deadlock_is_reported_like_the_reference():
    graph = [(0, 0, 0.1, [(1, 0.0)]), (1, 0, 0.1, [(0, 0.0)])]
    for S in (simulate, jax_sim):
        tasks = [S.SimTask(i, r, c, kind=S.COMM_HELD, event_deps=ev)
                 for i, r, c, ev in graph]
        with pytest.raises(RuntimeError, match="deadlock"):
            S.Simulator(1, 1).run(tasks)


@pytest.mark.parametrize("version", gs.VERSIONS)
def test_gauss_seidel_makespans_equal_reference(version):
    """Strong (8 x 8 global blocks split over the ranks) and weak (4 x 4
    blocks a rank) shapes, as the reference's bench runs them, at 4
    iterations."""
    for n in RANKS:
        py, px = gs.grid_dims(n)
        for nby, nbx in ((8 // py, 8 // px), (4, 4)):
            kw = dict(n_ranks=n, nby=nby, nbx=nbx, iters=4)
            assert gs.simulate_version(version, **kw) == \
                jax_gs.simulate_version(version, **kw), (n, nby, nbx)


@pytest.mark.parametrize("version", ifsker.VERSIONS)
def test_ifsker_makespans_equal_reference(version):
    """Strong (64 fields over the ranks, the bench's rows) and weak (4
    fields a rank) shapes."""
    for n in RANKS:
        for n_fields in (64, 4 * n):
            kw = dict(n_ranks=n, n_fields=n_fields)
            assert ifsker.simulate_version(version, **kw) == \
                jax_ifsker.simulate_version(version, **kw), (n, n_fields)


SCHEDULES = [("allreduce", "ring", 4, {"segments": 4}),
             ("allreduce", "doubling", 8, {}),
             ("alltoall", "ring", 5, {})]


@pytest.mark.parametrize("name,alg,n,kw", SCHEDULES,
                         ids=[f"{s[0]}-{s[1]}-{s[2]}" for s in SCHEDULES])
def test_schedule_replay_equals_reference(name, alg, n, kw):
    model = dict(size=1.0, alpha=1e-3, beta=1e-2, gamma=1e-2)
    out = {}
    for S, sched_mod in ((simulate, schedule), (jax_sim, jax_schedule)):
        sched = sched_mod.build(name, alg, n, **kw)
        tasks = S.schedule_tasks(sched, **model)
        res = S.Simulator(n, 1).run(tasks)
        link = S.two_tier_link(2, alpha=1e-3, beta=1e-2, inter_alpha=5e-3,
                               inter_beta=4e-2)
        out[S] = (_result_fields(res), S.trace_events(tasks),
                  S.schedule_makespan(sched, **model),
                  S.schedule_makespan(sched, workers_per_rank=2,
                                      kind=S.COMM_PAUSED,
                                      resume_overhead=1e-3, link=link,
                                      **model))
    assert out[simulate] == out[jax_sim]


def test_progress_cost_equals_reference():
    kw = dict(in_flight=64, ticks=1000, completions=256, test_s=2e-7,
              dispatch_s=3e-6)
    for backend in ("polling", "continuation"):
        assert simulate.progress_cost(backend, **kw) == \
            jax_sim.progress_cost(backend, **kw)


def test_overlap_oracle_through_the_ports_obs():
    """``tests/test_obs.py``'s oracle: a 0.2 s compute task beside a comm
    window closing at 0.5 s on two workers overlaps exactly 0.4."""
    a = simulate.SimTask(0, 0, 0.2, kind=simulate.COMPUTE, name="compute")
    b = simulate.SimTask(1, 0, 0.0, kind=simulate.COMM_EVENTS,
                         event_deps=[(0, 0.3)], name="comm")
    simulate.Simulator(1, 2).run([a, b])
    evs = simulate.trace_events([a, b])
    assert obs.validate_trace(evs) == []
    assert obs.overlap_fraction(evs) == pytest.approx(0.4)
    assert obs.per_rank_overlap(evs) == {0: pytest.approx(0.4)}


# The falsifying example of tests/test_properties.py's
# test_simulator_discipline_ordering, shrunk by hypothesis: one rank, one
# worker; (id, compute, start_deps, event_deps).
DISCIPLINE_EXAMPLE = [(0, 1.0, [], []), (1, 1.0, [], []),
                      (2, 0.0625, [(0, 0.1)], [(1, 0.1)]),
                      (3, 1.0, [(0, 0.1)], [(1, 0.1)]),
                      (4, 1.0, [(2, 0.1)], [])]


@pytest.mark.parametrize("S", [simulate, jax_sim], ids=["port", "reference"])
def test_discipline_ordering_example_is_a_scheduling_anomaly(S):
    """Paused trails held by 0.0725 s, more than the property's budget of
    one resume (0.01) per comm task, with one resume a comm task: task 2
    pauses at 2.0625, the freed worker takes task 3 (1.0 s), so task 2
    resumes only at 3.0725 and its successor 4 starts 0.0725 s later than
    under the held discipline.  The simulator charges no resume twice; the
    property's bound does not hold for list scheduling."""
    def run(kind):
        tasks = [S.SimTask(i, 0, c, kind=kind if ev else S.COMPUTE,
                           start_deps=list(sd), event_deps=list(ev))
                 for i, c, sd, ev in DISCIPLINE_EXAMPLE]
        return S.Simulator(1, 1, resume_overhead=0.01).run(tasks), tasks

    held, _ = run(S.COMM_HELD)
    paused, tasks = run(S.COMM_PAUSED)
    events, _ = run(S.COMM_EVENTS)
    assert (held.makespan, events.makespan) == (4.1, 4.0625)
    assert paused.makespan == pytest.approx(4.1725, abs=1e-12)
    assert paused.resumes == 2 and held.resumes == events.resumes == 0
    assert tasks[2].done_time == pytest.approx(3.0725, abs=1e-12)
    assert paused.makespan > held.makespan + 0.01 * 2 + 1e-6
    assert events.makespan <= paused.makespan
