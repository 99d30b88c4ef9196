"""ULFM-style fault tolerance in the port: the twin of
``tests/test_resilience.py`` over ``repro_torch.core``.

1. **Transport failure model** — ``CommWorld.fail_rank`` fails every
   pending handle naming the dead rank with ``RankFailedError`` through
   the completion callbacks, new posts toward it fail at post time;
   ``revoke`` / ``revoke_group`` reach live-pair traffic.
2. **Shrink agreement** — one shared group once every survivor voted,
   the revocation cleared, voters dying mid-vote tolerated, generations
   independent; ``recover`` end to end.
3. **Epoch-keyed rebuild** — stale compiled programs raise
   ``StaleProgramError``; persistent collectives and halo exchanges
   rebuild themselves after recovery.
4. **FaultInjector + harness** (``tests/torch_fault_harness.py``) —
   injected deaths over both completion modes and both notify backends,
   the deterministic failure-point grid over the four algorithms, the
   late-injection cone, leak-free teardown, and blocking mode surfacing
   out of ``taskwait``.  The grid never draws ``after_ops`` beyond the
   victim's post count without asserting a clean run (the harness counts
   the posts from the schedule; the reference's hypothesis draw does not,
   ROADMAP §3), and adds such cases on purpose.
5. **Simulator rank death** — the failure cone instead of a deadlock.

Where a scenario is cheap and deterministic, it runs through both
packages: the same ranks fail and the survivors' numbers are equal.  The
port's revoke differs from the reference's on purpose (ROADMAP §3): a
revoked group stays revoked and a post is checked against a revoke under
the world lock.  The twin holds the port to that, and runs the reference
only where the reference does not hang.
"""

import numpy as np
import pytest

import fault_harness as jax_harness
from repro.core import Collectives as JaxCollectives
from repro.core import tac as jax_tac
from repro.core.resilience import recover as jax_recover
from repro.core.simulate import Simulator as JaxSimulator
from repro.core.simulate import SimTask as JaxSimTask
from repro_torch.core import (Collectives, CommRevokedError, FaultInjector,
                              HaloExchange, RankFailedError, TaskRuntime,
                              tac)
from repro_torch.core import program as program_ir
from repro_torch.core import schedule as schedule_ir
from repro_torch.core.executor import TaskError
from repro_torch.core.resilience import recover, shrink_world
from repro_torch.core.simulate import (COMM_EVENTS, SimTask, Simulator)

from torch_fault_harness import ALGORITHMS, run_with_failure, victim_posts

pytestmark = pytest.mark.faults


@pytest.fixture(autouse=True)
def _task_multiple():
    tac.init(tac.TASK_MULTIPLE)
    jax_tac.init(jax_tac.TASK_MULTIPLE)
    yield
    tac.init(tac.TASK_MULTIPLE)
    jax_tac.init(jax_tac.TASK_MULTIPLE)


# ---------------------------------------------------------------------------
# 1. transport failure model
# ---------------------------------------------------------------------------
def test_fail_rank_fails_pending_handles_and_new_posts():
    w = tac.CommWorld(4)
    pending = w.irecv(src=3, dst=0, tag="t")
    unrelated = w.irecv(src=1, dst=2, tag="u")
    assert w.epoch == 0 and w.alive == (0, 1, 2, 3)
    w.fail_rank(3)
    assert w.failed == frozenset({3}) and w.alive == (0, 1, 2)
    assert w.epoch == 1
    assert pending.test()
    with pytest.raises(RankFailedError) as ei:
        pending.result
    assert ei.value.rank == 3
    assert not unrelated.test()
    with pytest.raises(RankFailedError):
        w.isend(1.0, src=0, dst=3).result
    with pytest.raises(RankFailedError):
        w.irecv(src=3, dst=1).result
    w.fail_rank(3)
    assert w.epoch == 1


def test_failure_pushes_through_callbacks_not_polls():
    w = tac.CommWorld(2)
    h = w.irecv(src=1, dst=0, tag=0)
    seen = []
    h.on_complete(lambda hh: seen.append(hh.error))
    w.fail_rank(1)
    assert len(seen) == 1 and isinstance(seen[0], RankFailedError)
    late = []
    h.on_complete(lambda hh: late.append(hh.error))
    assert len(late) == 1


def test_revoke_fails_live_pair_traffic():
    w = tac.CommWorld(4)
    h = w.irecv(src=1, dst=2, tag=9)
    w.revoke()
    assert w.revoked
    with pytest.raises(CommRevokedError):
        h.result
    with pytest.raises(CommRevokedError):
        w.isend(1, src=0, dst=1).result
    assert issubclass(CommRevokedError, RankFailedError)


def test_revoke_group_is_scoped_and_sticks():
    """Scoped to the group (the reference's test), and, the port's fix,
    a revoked group stays revoked: a later post fails at once instead of
    parking on peers that have aborted theirs."""
    w = tac.CommWorld(4)
    g = w.group([0, 1, 2])
    sibling = w.group([1, 2, 3])
    hg = g.irecv(src=0, dst=1, tag="a")
    hs = sibling.irecv(src=0, dst=1, tag="a")
    hw = w.irecv(src=0, dst=1, tag="a")
    g.revoke()
    with pytest.raises(CommRevokedError):
        hg.result
    assert not hs.test() and not hw.test()
    assert not w.revoked
    late = g.isend(1.0, src=1, dst=2, tag="late")
    assert late.test()
    with pytest.raises(CommRevokedError):
        late.result


# ---------------------------------------------------------------------------
# 2. shrink agreement
# ---------------------------------------------------------------------------
def test_shrink_agreement_completes_when_all_survivors_vote():
    w = tac.CommWorld(4)
    w.fail_rank(1)
    handles = {r: w.shrink(rank=r) for r in (0, 2)}
    assert not handles[0].test()
    h3 = w.shrink(rank=3)
    groups = [handles[0].result, handles[2].result, h3.result]
    assert all(g is groups[0] for g in groups)
    assert groups[0].ranks == (0, 2, 3)
    groups[0].isend(7.5, src=0, dst=2, tag="x")
    assert groups[0].irecv(src=0, dst=2, tag="x").result == 7.5


def test_shrink_clears_revocation():
    w = tac.CommWorld(3)
    w.fail_rank(0)
    w.revoke()
    assert w.revoked
    g = shrink_world(w)
    assert not w.revoked
    assert g.ranks == (1, 2)
    w.isend(1, src=1, dst=2, tag="post")
    assert w.irecv(src=1, dst=2, tag="post").result == 1


def test_shrink_dead_caller_and_mid_vote_death():
    w = tac.CommWorld(4)
    w.fail_rank(0)
    with pytest.raises(RankFailedError):
        w.shrink(rank=0).result
    h1 = w.shrink(rank=1)
    h2 = w.shrink(rank=2)
    assert not h1.test()
    w.fail_rank(3)
    g = h1.result
    assert g.ranks == (1, 2) and h2.result is g


def test_shrink_generations_are_independent():
    w = tac.CommWorld(3)
    w.fail_rank(2)
    first = [w.shrink(rank=r) for r in (0, 1)]
    second = [w.shrink(rank=r) for r in (0, 1)]
    ga, gb = first[0].result, second[0].result
    assert ga is not gb and ga.ranks == gb.ranks == (0, 1)


def test_recover_helper_end_to_end_matches_reference():
    out = {}
    for pkg, world_cls, coll_cls, rec, err in (
            ("port", tac.CommWorld, Collectives, recover, CommRevokedError),
            ("jax", jax_tac.CommWorld, JaxCollectives, jax_recover,
             jax_tac.CommRevokedError)):
        w = world_cls(5)
        w.fail_rank(2)
        parked = w.irecv(src=0, dst=4, tag="parked")
        g = rec(w)
        assert g.ranks == (0, 1, 3, 4)
        with pytest.raises(err):
            parked.result
        out[pkg] = coll_cls(g).run_group(
            "allreduce", [{"value": np.float64(r) + 0.5} for r in range(4)])
    assert [float(v) for v in out["port"]] == \
        [float(v) for v in out["jax"]] == [8.0] * 4


# ---------------------------------------------------------------------------
# 3. epoch-keyed rebuild
# ---------------------------------------------------------------------------
def test_stale_program_raises_and_recompiles():
    w = tac.CommWorld(4)
    sched = schedule_ir.build("allreduce", "ring", 4)
    prog = program_ir.compile_schedule(sched, w, head=("t",))
    assert prog.epoch == 0
    w.fail_rank(3)
    with pytest.raises(program_ir.StaleProgramError):
        next(prog.gen(0, "k", value=np.float64(1)))
    fresh = program_ir.compile_schedule(sched, w, head=("t",))
    assert fresh is not prog and fresh.epoch == w.epoch


def test_persistent_collective_rebuilds_after_epoch_bump():
    w = tac.CommWorld(4)
    coll = Collectives(w)
    pers = coll.persistent("allreduce", algorithm="ring")
    vals = [np.float64(r) for r in range(4)]
    out = pers.run_group(vals, key="a")
    assert all(float(v) == 6.0 for v in out)
    before = pers._plan()
    w.epoch += 1
    out = pers.run_group(vals, key="b")
    assert all(float(v) == 6.0 for v in out)
    assert pers._plan() is not before


def test_halo_exchange_rebuilds_on_shrunken_cart():
    w = tac.CommWorld(5)
    w.fail_rank(4)
    g = recover(w)
    cart = g.cart((2, 2))
    hx = HaloExchange(cart)
    sends = [{d: np.array([float(r)]) for d, _ in hx.neighbors(r)}
             for r in range(4)]
    out = hx.run_group(sends)
    for r in range(4):
        for d, q in hx.neighbors(r):
            np.testing.assert_array_equal(out[r][d], [float(q)])
    with pytest.raises(ValueError, match="needs"):
        g.cart((2, 3))


# ---------------------------------------------------------------------------
# 4. FaultInjector + harness
# ---------------------------------------------------------------------------
def test_fault_injector_immediate_and_armed():
    w = tac.CommWorld(4)
    inj = FaultInjector(w)
    inj.kill(1)
    assert w.failed == frozenset({1}) and inj.killed == [1]
    inj.arm(2, after_ops=2)
    assert inj.armed
    w.isend(1, src=2, dst=0, tag=0)
    assert 2 not in w.failed
    w.irecv(src=0, dst=2, tag=1)
    assert 2 in w.failed and not inj.armed
    with pytest.raises(ValueError, match="out of range"):
        inj.arm(9)
    with pytest.raises(ValueError, match="after_ops"):
        inj.arm(0, after_ops=0)


def test_armed_injection_counts_only_the_victim():
    w = tac.CommWorld(3)
    inj = FaultInjector(w)
    inj.arm(1, after_ops=1)
    w.isend(1, src=0, dst=2, tag=0)
    w.irecv(src=0, dst=2, tag=0)
    assert not w.failed
    inj.disarm()
    assert not inj.armed
    w.isend(1, src=1, dst=2, tag=1)
    assert not w.failed


def test_victim_post_counts_come_from_the_schedule():
    """The counts the harness bounds ``after_ops`` by: a 2-rank doubling
    allreduce posts one Send and one Recv a rank (the reference draw's
    fault), ring and doubling over 4 ranks more; the reference's schedule
    gives the same counts."""
    from repro.core import collectives as jax_coll
    from repro.core import schedule as jax_schedule
    for n in (2, 3, 4):
        for alg in ALGORITHMS:
            for victim in range(n):
                want = sum(type(o).__name__ in ("Send", "Recv")
                           for o in jax_schedule.build(
                               "allreduce", jax_coll._norm_alg(alg),
                               n).programs[victim])
                assert victim_posts(n, victim, alg) == want
    assert victim_posts(2, 0, "doubling") == 2


@pytest.mark.parametrize("mode", ["blocking", "event"])
@pytest.mark.parametrize("notify", ["polling", "continuation"])
def test_injected_death_surfaces_and_survivors_recover(mode, notify):
    out = run_with_failure(n_ranks=4, victim=2, after_ops=1, mode=mode,
                           notify=notify)
    assert out.survivors.ranks == (0, 1, 3)
    assert 2 not in out.ok_ranks and 2 in out.world.failed


@pytest.mark.parametrize("notify", ["polling", "continuation"])
def test_event_mode_death_matches_reference(notify):
    """Event mode, death on first contact: in both packages every rank
    ends in a result or an error, the victim fails, and the survivors'
    recovered allreduce is the same numbers."""
    port = run_with_failure(n_ranks=4, victim=2, after_ops=1, mode="event",
                            notify=notify)
    ref = jax_harness.run_with_failure(n_ranks=4, victim=2, after_ops=1,
                                       mode="event", notify=notify)
    assert 2 in port.failed_ranks and 2 in ref.failed_ranks
    assert port.survivors.ranks == ref.survivors.ranks == (0, 1, 3)
    for gr in range(3):
        np.testing.assert_array_equal(port.recovered[gr],
                                      ref.recovered[gr])


def test_late_injection_lets_finished_ranks_through():
    """Doubling allreduce, death at the victim's third post: the cone is
    minimal, as in the reference."""
    out = run_with_failure(n_ranks=4, victim=0, after_ops=3,
                           algorithm="doubling", mode="event")
    assert 0 not in out.ok_ranks
    assert out.ok_ranks or out.failed_ranks


def test_runtime_close_leak_free_after_failure():
    for seed in range(5):
        run_with_failure(n_ranks=4, victim=seed % 4, after_ops=1 + seed,
                         mode=("event", "blocking")[seed % 2],
                         recover_after=False, seed=seed)


def test_taskwait_raises_instead_of_hanging_blocking_mode():
    w = tac.CommWorld(3)
    coll = Collectives(w)
    inj = FaultInjector(w)
    inj.arm(1, after_ops=1)
    with TaskRuntime(num_workers=2) as rt:
        for r in range(3):
            def body(r=r):
                coll.allreduce(np.float64(r), rank=r, mode="blocking",
                               key="tw")
            rt.submit(body, name=f"b[{r}]")
        with pytest.raises(TaskError):
            rt.taskwait()


# The reference's fixed grid (4 ranks, after_ops 1, 2, 4), both notify
# backends, and 2-rank cases that straddle the victim's post count: for
# doubling (2 posts a rank) after_ops 2 fires on the last post and 3 never
# fires, which the harness then holds to a clean run.
GRID = [(alg, 4, k) for alg in ALGORITHMS for k in (1, 2, 4)] + \
    [(alg, 2, k) for alg in ("doubling", "tree") for k in (2, 3)] + \
    [("ring", 2, 4), ("ring", 2, 5)]


@pytest.mark.parametrize("notify", ["polling", "continuation"])
@pytest.mark.parametrize("algorithm,n_ranks,after_ops", GRID)
def test_failure_point_sweep_deterministic(algorithm, n_ranks, after_ops,
                                          notify):
    victim = (after_ops + 1) % n_ranks
    out = run_with_failure(n_ranks=n_ranks, victim=victim,
                           after_ops=after_ops, algorithm=algorithm,
                           mode=("event", "blocking")[after_ops % 2],
                           notify=notify, seed=after_ops)
    posts = victim_posts(n_ranks, victim, algorithm)
    assert out.fired == (after_ops <= posts)
    if out.fired:
        assert out.survivors.size == n_ranks - 1
    else:
        assert out.survivors is None and out.ok_ranks == list(range(n_ranks))


# ---------------------------------------------------------------------------
# 5. simulator rank death
# ---------------------------------------------------------------------------
def _chain(task_cls, rank, ids, dep_lat=0.0):
    return [task_cls(i, rank, 1.0,
                     start_deps=[(i - 1, dep_lat)] if j else [])
            for j, i in enumerate(ids)]


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_sim_rank_death_reports_failure_cone(pkg):
    sim, task = ((Simulator, SimTask) if pkg == "port"
                 else (JaxSimulator, JaxSimTask))
    tasks = _chain(task, 0, [0, 1, 2])
    tasks.append(task(3, 1, 1.0, kind=COMM_EVENTS, event_deps=[(1, 0.1)]))
    clean = sim(2, 1).run(tasks)
    assert not clean.failed
    res = sim(2, 1).run(tasks, fail=(0, 1.5))
    assert res.failed == {1, 2, 3}
    assert 0 in res.done_times and 1 not in res.done_times
    assert res.makespan <= clean.makespan


def test_sim_death_cone_equals_reference():
    def run(sim, task):
        tasks = _chain(task, 0, [0, 1, 2, 3], dep_lat=0.25)
        tasks += [task(10 + i, 1, 0.5, kind=COMM_EVENTS,
                       event_deps=[(i, 0.1)]) for i in range(4)]
        return [(r.failed, r.done_times, r.makespan)
                for r in (sim(2, 1).run(tasks, fail=(0, t))
                          for t in (0.5, 1.2, 2.6, 10.0))]
    assert run(Simulator, SimTask) == run(JaxSimulator, JaxSimTask)


def test_sim_death_after_delivery_spares_consumers():
    tasks = _chain(SimTask, 0, [0])
    tasks.append(SimTask(1, 1, 1.0, kind=COMM_EVENTS, event_deps=[(0, 0.5)]))
    res = Simulator(2, 1).run(tasks, fail=(0, 1.2))
    assert res.failed == set()
    assert 1 in res.done_times


def test_sim_fail_validation_and_determinism():
    tasks = _chain(SimTask, 0, [0, 1])
    with pytest.raises(ValueError):
        Simulator(1, 1).run(tasks, fail=(5, 1.0))
    a = Simulator(1, 1).run(tasks, fail=(0, 1.5)).failed
    b = Simulator(1, 1).run(tasks, fail=(0, 1.5)).failed
    assert a == b == {1}
