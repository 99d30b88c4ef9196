"""Port parity: the host task runtime and TAC of ``repro_torch`` against the
JAX package's, on the same scenarios and the same numpy inputs.

Each scenario is one function written against a package's ``core`` module;
it runs once through ``repro.core`` and once through ``repro_torch.core``
under each notify backend, and the observable outcomes (values, execution
order, pause/resume counts) must agree.  Payloads are numpy arrays on the
JAX side and CPU tensors on the port's side.
"""

import threading
import time

import numpy as np
import pytest
import torch

import repro.core as jax_core
import repro_torch.core as torch_core

NOTIFY = ("polling", "continuation")
PACKAGES = {"jax": jax_core, "torch": torch_core}


def _both(scenario, notify, **kw):
    """Run ``scenario`` through both packages; returns (jax, torch)."""
    out = []
    for name in ("jax", "torch"):
        core = PACKAGES[name]
        core.tac.init(core.tac.TASK_MULTIPLE)
        try:
            out.append(scenario(core, notify, **kw))
        finally:
            core.tac.init(core.tac.TASK_MULTIPLE)
    return tuple(out)


def _wait_until(pred, timeout=60.0):
    """Poll ``pred`` until it holds or ``timeout`` passes.  Scenarios
    release what they hold whatever this returns, and report it as part of
    their outcome: an assert inside the runtime's ``with`` would leave a
    paused task behind and hang the close."""
    deadline = time.time() + timeout
    while not pred() and time.time() < deadline:
        time.sleep(0.005)
    return bool(pred())


# ---------------------------------------------------------------------------
# pause/resume (§4.1) and external events (§4.3)
# ---------------------------------------------------------------------------
def _pause_resume(core, notify):
    box, resumed = {}, []

    def blocker():
        ctx = core.get_current_blocking_context()
        box["ctx"] = ctx
        core.block_current_task(ctx)
        resumed.append("resumed")

    with core.TaskRuntime(num_workers=1, notify=notify) as rt:
        rt.submit(blocker)
        ran_other = []
        rt.submit(lambda: ran_other.append(1))
        # the other task runs on the core the paused one freed
        freed = _wait_until(lambda: "ctx" in box and ran_other)
        if "ctx" in box:
            core.unblock_task(box["ctx"])
        rt.taskwait()
    return freed, resumed, ran_other, rt.stats["task_blocks"], \
        rt.stats["task_resumes"]


@pytest.mark.parametrize("notify", NOTIFY)
def test_pause_resume_matches_reference(notify):
    want, got = _both(_pause_resume, notify)
    assert got == want == (True, ["resumed"], [1], 1, 1)


def _deferred_release(core, notify):
    box, order = {}, []

    def producer():
        cnt = core.get_current_event_counter()
        core.increase_current_task_event_counter(cnt, 2)
        box["cnt"] = cnt
        order.append("producer-finished")

    with core.TaskRuntime(num_workers=3, notify=notify) as rt:
        rt.submit(producer, out=["buf"])
        rt.submit(lambda: order.append("consumer"), in_=["buf"])
        _wait_until(lambda: "cnt" in box)
        time.sleep(0.05)
        held_after_finish = list(order)
        core.decrease_task_event_counter(box["cnt"], 1)
        time.sleep(0.05)
        held_after_one = list(order)
        core.decrease_task_event_counter(box["cnt"], 1)
        rt.taskwait()
    return held_after_finish, held_after_one, order


@pytest.mark.parametrize("notify", NOTIFY)
def test_event_counter_defers_release_matches_reference(notify):
    want, got = _both(_deferred_release, notify)
    assert got == want
    assert got[0] == got[1] == ["producer-finished"]
    assert got[2] == ["producer-finished", "consumer"]


# ---------------------------------------------------------------------------
# TAC blocking (§6.1) and non-blocking (§6.2) modes
# ---------------------------------------------------------------------------
def _wait_on_event_handle(core, notify):
    h = core.tac.EventHandle()
    got = []
    with core.TaskRuntime(num_workers=2, notify=notify) as rt:
        rt.submit(lambda: got.append(core.tac.wait(h)))
        paused = _wait_until(lambda: rt.stats.get("task_blocks", 0) == 1)
        h.complete(np.arange(4.0))
        rt.taskwait()
    return paused, [g.tolist() for g in got], rt.stats["task_blocks"], \
        rt.stats["task_resumes"]


@pytest.mark.parametrize("notify", NOTIFY)
def test_tac_wait_pauses_on_event_handle_matches_reference(notify):
    want, got = _both(_wait_on_event_handle, notify)
    assert got == want == (True, [[0.0, 1.0, 2.0, 3.0]], 1, 1)


def _iwait_on_event_handles(core, notify):
    hs = [core.tac.EventHandle() for _ in range(3)]
    hs[1].complete()
    order = []

    def comm():
        core.tac.iwait(hs[0])
        core.tac.iwaitall(hs[1:])
        order.append("comm-done")

    with core.TaskRuntime(num_workers=3, notify=notify) as rt:
        rt.submit(comm, out=["b"])
        rt.submit(lambda: order.append("consumer"), in_=["b"])
        _wait_until(lambda: order == ["comm-done"])
        time.sleep(0.05)
        trace = [list(order)]
        hs[2].complete()
        time.sleep(0.05)
        trace.append(list(order))
        hs[0].complete()
        rt.taskwait()
    trace.append(list(order))
    return trace, rt.stats.get("task_blocks", 0)


@pytest.mark.parametrize("notify", NOTIFY)
def test_tac_iwait_defers_release_matches_reference(notify):
    want, got = _both(_iwait_on_event_handles, notify)
    assert got == want
    assert got[0][-1] == ["comm-done", "consumer"] and got[1] == 0


def _wait_and_iwait_on_arrays(core, notify):
    """Handles over host arrays: the JAX package's over numpy (no device
    work: complete at once), the port's over CPU tensors (complete at
    construction)."""
    make = (np.asarray if core is jax_core
            else (lambda a: torch.from_numpy(np.asarray(a))))
    results = []

    def body():
        h = core.tac.run_async(lambda x: x * 2, make(np.arange(5.0)))
        results.append(np.asarray(core.tac.wait(h)).tolist())
        core.tac.iwait(core.tac.ArrayHandle(make(np.ones(3))))
        core.tac.iwaitall([make(np.zeros(2)), make(np.ones(2))])

    with core.TaskRuntime(num_workers=2, notify=notify) as rt:
        rt.submit(body, out=["x"])
        rt.submit(lambda: results.append("consumer"), in_=["x"])
        rt.taskwait()
    return results, rt.stats.get("task_blocks", 0), \
        rt.continuations.stats["attached"]


@pytest.mark.parametrize("notify", NOTIFY)
def test_tac_on_cpu_array_handles_matches_reference(notify):
    want, got = _both(_wait_and_iwait_on_arrays, notify)
    assert got == want
    assert got == ([[0.0, 2.0, 4.0, 6.0, 8.0], "consumer"], 0, 0)


def test_array_handle_over_cpu_tensors_is_complete():
    tac = torch_core.tac
    x = torch.arange(4.0)
    nested = {"a": [x, (x * 2,)], "b": 3}
    h = tac.ArrayHandle(nested)
    assert h.test() and h.wait() is nested and h.result is nested
    assert [t.tolist() for t in tac._tensor_leaves(nested)] == \
        [[0.0, 1.0, 2.0, 3.0], [0.0, 2.0, 4.0, 6.0]]
    moved = tac.transfer([x, (x,)], "cpu")
    assert moved.test()
    assert torch.equal(moved.result[0], x) and torch.equal(
        moved.result[1][0], x)
    composite = tac.as_handle([x, h])
    assert isinstance(composite, tac.CompositeHandle) and composite.test()
    assert isinstance(tac.as_handle(x), tac.ArrayHandle)


# ---------------------------------------------------------------------------
# Level-A collectives on the Gauss–Seidel path
# ---------------------------------------------------------------------------
def _halo_payloads(hx, n, seed, wrap):
    rng = np.random.default_rng(seed)
    return [{d: wrap(rng.standard_normal(6)) for d, _ in hx.neighbors(r)}
            for r in range(n)]


def _halo_exchange(core, notify, mode):
    wrap = np.asarray if core is jax_core else torch.from_numpy
    world = core.tac.CommWorld(4)
    hx = core.HaloExchange(world.cart_create((2, 2)))
    out = {"group": hx.run_group(_halo_payloads(hx, 4, 5, wrap), key=0)}
    sends = _halo_payloads(hx, 4, 6, wrap)
    got = {}
    with core.TaskRuntime(num_workers=2, notify=notify) as rt:
        for r in range(4):
            def body(r=r):
                got[r] = hx.start(sends[r], rank=r, mode=mode, key=1)
            rt.submit(body, out=[("halo", r)], rank=r)
        rt.taskwait()
    out["tasks"] = [g.result if isinstance(g, core.tac.AsyncHandle) else g
                    for _, g in sorted(got.items())]
    return {k: [{d: np.asarray(v).tolist() for d, v in sorted(rank.items())}
                for rank in per_rank] for k, per_rank in out.items()}


@pytest.mark.parametrize("notify", NOTIFY)
@pytest.mark.parametrize("mode", ["blocking", "event"])
def test_halo_exchange_matches_reference(notify, mode):
    want, got = _both(_halo_exchange, notify, mode=mode)
    assert got == want


def _hierarchical_allreduce(core, notify, mode):
    world = core.tac.CommWorld(4)
    coll = core.HierarchicalCollectives(world, 2).persistent(op="sum")
    vals = [np.float64(v) for v in np.random.default_rng(9)
            .standard_normal(4)]
    group = [float(v) for v in coll.run_group(vals, key=0)]
    got = {}
    lock = threading.Lock()
    with core.TaskRuntime(num_workers=2, notify=notify) as rt:
        for r in range(4):
            def body(r=r):
                h = coll.start(vals[r], rank=r, mode=mode, key=1)
                with lock:
                    got[r] = h
            rt.submit(body, rank=r)
        rt.taskwait()
    tasks = [float(g.result if isinstance(g, core.tac.AsyncHandle) else g)
             for _, g in sorted(got.items())]
    return group, tasks


@pytest.mark.parametrize("notify", NOTIFY)
@pytest.mark.parametrize("mode", ["blocking", "event"])
def test_hierarchical_allreduce_matches_reference(notify, mode):
    want, got = _both(_hierarchical_allreduce, notify, mode=mode)
    assert got == want
    assert len(set(got[0] + got[1])) == 1     # every rank, both drivers


# ---------------------------------------------------------------------------
# ULFM revocation: fixed in the port, so these hold for the port alone
# ---------------------------------------------------------------------------
def test_group_revoke_fails_later_posts():
    """A revoked sub-communicator stays revoked (MPI_Comm_revoke): ops
    posted on it after the revoke fail at post time with
    ``CommRevokedError``, as pending ones do; the world and a sibling group
    still match.  (Before, only pending ops failed: a rank that posted its
    halo round after a peer's revoke parked forever, which hung the
    Gauss–Seidel elastic leg in about one run in 40.)"""
    tac = torch_core.tac
    world = tac.CommWorld(3)
    group, sibling = world.group([0, 1, 2]), world.group([0, 1])
    pending = group.irecv(src=1, dst=0, tag="t")
    group.revoke()
    assert pending.test() and isinstance(pending.error,
                                         tac.CommRevokedError)
    late = [group.irecv(src=2, dst=0, tag="u"),
            group.isend(np.ones(2), src=0, dst=2, tag="u")]
    for h in late:
        assert h.test() and isinstance(h.error, tac.CommRevokedError)
    for comm in (world, sibling):
        r = comm.irecv(src=1, dst=0, tag="v")
        comm.isend(np.arange(3.0), src=1, dst=0, tag="v")
        assert r.test() and r.error is None
        np.testing.assert_array_equal(r.result, np.arange(3.0))


def test_revoke_racing_a_post_never_leaves_it_pending():
    """A post and a revoke on other threads: the post either matches the
    sweep or sees the revoke, never neither (the check and the store share
    the world lock)."""
    tac = torch_core.tac
    for trial in range(200):
        world = tac.CommWorld(2)
        go = threading.Barrier(2)
        box = {}

        def post():
            go.wait()
            box["h"] = world.irecv(src=1, dst=0, tag=trial)

        t = threading.Thread(target=post)
        t.start()
        go.wait()
        world.revoke()
        t.join()
        assert box["h"].test(), trial
