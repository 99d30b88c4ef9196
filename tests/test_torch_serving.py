"""The port's serving path against the JAX package's.

1. **Request/queue mechanics** — state-machine legality, priority-then-FCFS
   admission, failure re-admission at the head of the class.
2. **Scheduling** — slot-bounded admission order, stepwise priority
   preemption, and the prefill→decode cache handoff.
3. **Completion legs** — identical token streams across the four
   completion × notify combinations; the event leg at least matches the
   blocking sentinel under worker starvation; the event leg's handles go
   through the continuation engine.
4. **Failure path** — a rank killed mid-serve: in-flight requests evict to
   the queue head, the world shrinks, every request still finishes with
   its full stream.
5. **The real model** — the port's ``LMAdapter`` (smoke granite-3-2b,
   and smoke zamba2-2.7b and xlstm-350m with a 24-token prompt so that the
   SSD and mLSTM scans pad to their chunk, and smoke olmoe-1b-7b, whose
   MoE blocks run in prefill and decode, fp32, on the CPU) under the
   port's engine gives the same greedy streams as the JAX ``LMAdapter``
   under the JAX engine on the reference's weights and prompt tokens, on
   both legs.  A finished run leaves no reference cycle holding the
   adapter or its model.

Scenarios 1–4 are those of ``tests/test_serving.py`` sections 1–4 on the
port's engine and ``SyntheticAdapter``; every ``run`` finishes in seconds
(bounded sleeps only).
"""

import dataclasses
import gc
import time
import weakref

import jax
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.launch import mesh as jax_meshlib
from repro.models import inputs as jax_inputs
from repro.models import model as jax_model
from repro.runtime.sharding import ShardingPolicy
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro.serving.lm import LMAdapter as JaxLMAdapter
from repro_torch import configs
from repro_torch.core import FaultInjector, tac
from repro_torch.core.executor import TaskRuntime
from repro_torch.models import model as port_model
from repro_torch.serving import (Request, RequestQueue, RequestState,
                                 ServingEngine, SyntheticAdapter, percentile,
                                 token_at)
from repro_torch.serving.lm import LMAdapter


def _synthetic(**kw):
    return SyntheticAdapter(device="cpu", **kw)


# ---------------------------------------------------------------------------
# 1. request + queue mechanics
# ---------------------------------------------------------------------------
def test_request_state_machine_legality():
    r = Request(rid=0, prompt=1, gen_len=4)
    assert r.state is RequestState.QUEUED
    r.to(RequestState.PREFILL)
    r.to(RequestState.DECODE)
    with pytest.raises(RuntimeError, match="illegal"):
        r.to(RequestState.QUEUED)
    r.to(RequestState.EVICTED)
    r.reset_for_requeue()
    assert r.state is RequestState.QUEUED
    assert r.incarnation == 1 and r.evictions == 1
    assert r.tokens == [] and r.cache is None
    assert r.chain != Request(rid=0, prompt=1, gen_len=4).chain


def test_queue_priority_then_fcfs_and_push_front():
    q = RequestQueue()
    a = Request(rid=0, prompt=0, gen_len=1, priority=1)
    b = Request(rid=1, prompt=0, gen_len=1, priority=0)
    c = Request(rid=2, prompt=0, gen_len=1, priority=0)
    d = Request(rid=3, prompt=0, gen_len=1, priority=0)
    for r in (a, b, c):
        q.push(r)
    q.push_front(d)      # failure re-admission: head of its class
    assert [q.pop().rid for _ in range(4)] == [3, 1, 2, 0]
    assert q.pop() is None and not q


# ---------------------------------------------------------------------------
# 2. scheduling: admission order, handoff, preemption
# ---------------------------------------------------------------------------
class RecordingAdapter:
    """Synchronous adapter that logs every protocol call."""

    def __init__(self):
        self.calls = []

    def prefill(self, req):
        self.calls.append(("prefill", req.rid, req.incarnation))
        return token_at(req.prompt, 0), ("cache", req.rid, 0)

    def decode(self, req, state, step):
        # the handoff contract: decode receives the state the PREVIOUS
        # step returned (prefill's cache for step 1)
        assert state == ("cache", req.rid, step - 1)
        self.calls.append(("decode", req.rid, step))
        return token_at(req.prompt, step), ("cache", req.rid, step)

    def detok(self, req, step, tok):
        return int(tok)


@pytest.mark.parametrize("completion", ["event", "blocking"])
def test_prefill_decode_handoff(completion):
    ad = RecordingAdapter()
    eng = ServingEngine(ad, slots=2, completion=completion, num_workers=2)
    reqs = [Request(rid=i, prompt=10 * i, gen_len=3) for i in range(2)]
    rep = eng.run(reqs)
    for r in reqs:
        assert r.state is RequestState.DONE
        assert rep.outputs[r.rid] == [token_at(10 * r.rid, s)
                                      for s in range(3)]
    for rid in (0, 1):
        assert [c for c in ad.calls if c[1] == rid] == [
            ("prefill", rid, 0), ("decode", rid, 1), ("decode", rid, 2)]


def test_slot_bounded_admission_order():
    ad = RecordingAdapter()
    eng = ServingEngine(ad, slots=2, completion="blocking", num_workers=2,
                        sync_every=1)
    reqs = [Request(rid=i, prompt=i, gen_len=2) for i in range(5)]
    eng.run(reqs)
    assert eng.admission_log == [0, 1, 2, 3, 4]
    assert eng.eviction_log == []


def test_priority_preemption_stepwise():
    """A high-priority arrival evicts the worst in-flight request when no
    slot is free (stepwise mode); the victim re-queues, re-runs under a
    new incarnation, and still emits its full stream."""

    class SlowAdapter(RecordingAdapter):
        def decode(self, req, state, step):
            time.sleep(0.02)
            return super().decode(req, state, step)

    ad = SlowAdapter()
    eng = ServingEngine(ad, slots=1, completion="blocking", num_workers=2,
                        sync_every=1)
    low = Request(rid=0, prompt=5, gen_len=6, priority=1)
    high = Request(rid=1, prompt=7, gen_len=2, priority=0, arrival_s=0.05)
    rep = eng.run([low, high])
    assert eng.eviction_log == [0]
    assert low.evictions == 1 and low.state is RequestState.DONE
    assert rep.outputs[0] == [token_at(5, s) for s in range(6)]
    assert rep.outputs[1] == [token_at(7, s) for s in range(2)]
    assert ("prefill", 0, 1) in ad.calls


def test_explicit_evict_requires_inflight():
    eng = ServingEngine(RecordingAdapter(), slots=1)
    with pytest.raises(KeyError):
        eng.evict(99)


# ---------------------------------------------------------------------------
# 3. completion legs: parity and performance
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("notify", ["polling", "continuation"])
@pytest.mark.parametrize("completion", ["event", "blocking"])
def test_token_parity_mode_x_notify(completion, notify):
    with _synthetic(dev_ms=1.0, host_rounds=1, streams=8) as ad:
        ad.warmup()
        eng = ServingEngine(ad, slots=4, completion=completion,
                            num_workers=3, notify=notify)
        reqs = [Request(rid=i, prompt=30 + 7 * i, gen_len=4)
                for i in range(6)]
        rep = eng.run(reqs)
    for r in reqs:
        assert rep.outputs[r.rid] == [token_at(r.prompt, s)
                                      for s in range(4)]
    assert rep.tokens == 24 and rep.recoveries == 0


def test_event_leg_outperforms_blocking_sentinel():
    """Under worker starvation (slots > workers, asynchronous device
    latency) the event-bound leg sustains at least the blocking
    sentinel's throughput with no worse p99."""
    with _synthetic(dev_ms=25.0, host_rounds=8, streams=16) as ad:
        ad.warmup()
        reports = {}
        for leg in ("event", "blocking"):
            ServingEngine(ad, slots=16, completion=leg, num_workers=4) \
                .run([Request(rid=900 + i, prompt=i, gen_len=2)
                      for i in range(4)])
            eng = ServingEngine(ad, slots=16, completion=leg, num_workers=4)
            reports[leg] = eng.run(
                [Request(rid=i, prompt=100 + 17 * i, gen_len=6)
                 for i in range(16)])
    ev, bl = reports["event"], reports["blocking"]
    assert ev.tokens == bl.tokens == 96
    assert ev.tokens_per_s >= bl.tokens_per_s, (
        f"event {ev.tokens_per_s:.0f} < blocking {bl.tokens_per_s:.0f}")
    assert ev.p99_ms <= bl.p99_ms, (
        f"event p99 {ev.p99_ms:.1f} > blocking p99 {bl.p99_ms:.1f}")


def test_event_leg_pushes_through_continuation_engine():
    with _synthetic(dev_ms=3.0, host_rounds=1, streams=8) as ad:
        ad.warmup()
        rt = TaskRuntime(num_workers=3)
        eng = ServingEngine(ad, slots=4, completion="event", runtime=rt)
        eng.run([Request(rid=i, prompt=i, gen_len=3) for i in range(4)])
        stats = rt.continuations.stats
        rt.close()
    assert stats["attached"] > 0
    assert stats["completions"] >= stats["attached"]


def test_percentile_nearest_rank():
    assert percentile([3.0, 1.0, 2.0], 50) == 2.0
    assert percentile([1.0], 99) == 1.0
    with pytest.raises(ValueError):
        percentile([], 50)


# ---------------------------------------------------------------------------
# 4. failure path: eviction under injected rank failure
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("completion", ["event", "blocking"])
def test_eviction_under_rank_failure(completion):
    with _synthetic(dev_ms=1.0, host_rounds=1, streams=8) as ad:
        ad.warmup()
        w = tac.CommWorld(3)
        inj = FaultInjector(w)
        killed = []

        def on_round(eng, rnd):
            if rnd == 4 and not killed:
                inj.kill(2)
                killed.append(2)

        eng = ServingEngine(ad, slots=3, completion=completion,
                            num_workers=4, sync_every=1, world=w,
                            tp_elems=4, on_round=on_round)
        reqs = [Request(rid=i, prompt=50 + 11 * i, gen_len=5)
                for i in range(6)]
        rep = eng.run(reqs)
    assert killed and rep.recoveries == 1
    assert rep.evictions > 0 and eng.eviction_log
    assert eng._coll.world.size == 2
    for r in reqs:
        assert r.state is RequestState.DONE
        assert rep.outputs[r.rid] == [token_at(r.prompt, s)
                                      for s in range(5)]
    assert any(r.incarnation > 0 for r in reqs)


def test_failed_step_does_not_finish_request():
    class FailOnce(RecordingAdapter):
        def __init__(self):
            super().__init__()
            self.failed = False

        def decode(self, req, state, step):
            if step == 2 and not self.failed:
                self.failed = True
                raise tac.RankFailedError("injected")
            return super().decode(req, state, step)

    ad = FailOnce()
    w = tac.CommWorld(2)
    eng = ServingEngine(ad, slots=1, completion="blocking", num_workers=2,
                        sync_every=1, world=w)
    req = Request(rid=0, prompt=3, gen_len=4)
    rep = eng.run([req])
    assert req.state is RequestState.DONE
    assert rep.outputs[0] == [token_at(3, s) for s in range(4)]
    assert req.evictions == 1 and eng.recoveries == 1


# ---------------------------------------------------------------------------
# 5. the real model: port LMAdapter vs JAX LMAdapter
# ---------------------------------------------------------------------------
PROMPT, GEN, N_REQ = 16, 8, 3


def _reference_pair(arch, prompt_len):
    """Smoke ``arch`` in fp32: the JAX params and the port's model holding
    them, and the reference's prompt tokens per seed."""
    jcfg = dataclasses.replace(jax_configs.smoke(arch), dtype="float32")
    pcfg = dataclasses.replace(configs.smoke(arch), dtype="float32")
    params = jax_model.init(jcfg, jax.random.PRNGKey(0))
    model = port_model.params_from_reference(
        pcfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")

    def prompt_tokens(req):
        toks = jax_inputs.make_batch(jcfg, batch=1, seq=prompt_len,
                                     kind="prefill",
                                     key=jax.random.PRNGKey(int(req.prompt)))
        return torch.tensor(np.asarray(toks["tokens"])).long()

    return jcfg, params, pcfg, model, prompt_tokens


def _reference_streams(jcfg, params, prompt_len):
    """The JAX package's serving path as ``launch/serve.py`` builds it."""
    mesh = jax_meshlib.local_mesh(model=1)
    policy = ShardingPolicy(fsdp=False, tp=False, sp=False, remat=None)
    adapter = JaxLMAdapter(jcfg, mesh, policy, params, prompt_len=prompt_len,
                           gen_len=GEN)
    adapter.warmup()
    rep = JaxEngine(adapter, slots=2, completion="event",
                    num_workers=2).run(
        [JaxRequest(rid=i, prompt=100 + i, gen_len=GEN)
         for i in range(N_REQ)])
    return rep.outputs


@pytest.fixture(scope="module")
def lm_pair():
    return _reference_pair("granite-3-2b", PROMPT)


@pytest.fixture(scope="module")
def jax_streams(lm_pair):
    jcfg, params, _, _, _ = lm_pair
    return _reference_streams(jcfg, params, PROMPT)


@pytest.mark.parametrize("completion", ["event", "blocking"])
def test_lm_adapter_streams_equal_jax(lm_pair, jax_streams, completion):
    _, _, pcfg, model, prompt_tokens = lm_pair
    adapter = LMAdapter(pcfg, model, prompt_len=PROMPT, gen_len=GEN,
                        device="cpu", prompt_tokens=prompt_tokens)
    adapter.warmup()
    eng = ServingEngine(adapter, slots=2, completion=completion,
                        num_workers=2)
    rep = eng.run([Request(rid=i, prompt=100 + i, gen_len=GEN)
                   for i in range(N_REQ)])
    assert rep.tokens == N_REQ * GEN
    assert rep.outputs == jax_streams


ZAMBA_PROMPT = 24      # not a multiple of smoke zamba2's SSD chunk (16)


@pytest.fixture(scope="module")
def zamba_pair():
    pair = _reference_pair("zamba2-2.7b", ZAMBA_PROMPT)
    return pair, _reference_streams(pair[0], pair[1], ZAMBA_PROMPT)


@pytest.mark.parametrize("completion", ["event", "blocking"])
def test_lm_adapter_zamba2_streams_equal_jax(zamba_pair, completion):
    """Smoke zamba2-2.7b: each request's cache carries the Mamba2 states
    and conv tails beside the shared block's k/v, and the greedy streams
    equal the JAX ``LMAdapter``'s."""
    (_, _, pcfg, model, prompt_tokens), want = zamba_pair
    adapter = LMAdapter(pcfg, model, prompt_len=ZAMBA_PROMPT, gen_len=GEN,
                        device="cpu", prompt_tokens=prompt_tokens)
    adapter.warmup()
    rep = ServingEngine(adapter, slots=2, completion=completion,
                        num_workers=2).run(
        [Request(rid=i, prompt=100 + i, gen_len=GEN) for i in range(N_REQ)])
    assert rep.tokens == N_REQ * GEN
    assert rep.outputs == want


@pytest.fixture(scope="module")
def xlstm_pair():
    pair = _reference_pair("xlstm-350m", ZAMBA_PROMPT)
    return pair, _reference_streams(pair[0], pair[1], ZAMBA_PROMPT)


@pytest.mark.parametrize("completion", ["event", "blocking"])
def test_lm_adapter_xlstm_streams_equal_jax(xlstm_pair, completion):
    """Smoke xlstm-350m: each request's cache carries every mLSTM block's
    (C, n, m) and the sLSTM block's (c, n, h, m), and the greedy streams
    equal the JAX ``LMAdapter``'s."""
    (_, _, pcfg, model, prompt_tokens), want = xlstm_pair
    adapter = LMAdapter(pcfg, model, prompt_len=ZAMBA_PROMPT, gen_len=GEN,
                        device="cpu", prompt_tokens=prompt_tokens)
    adapter.warmup()
    rep = ServingEngine(adapter, slots=2, completion=completion,
                        num_workers=2).run(
        [Request(rid=i, prompt=100 + i, gen_len=GEN) for i in range(N_REQ)])
    assert rep.tokens == N_REQ * GEN
    assert rep.outputs == want


@pytest.fixture(scope="module")
def olmoe_pair():
    pair = _reference_pair("olmoe-1b-7b", PROMPT)
    return pair, _reference_streams(pair[0], pair[1], PROMPT)


@pytest.mark.parametrize("completion", ["event", "blocking"])
def test_lm_adapter_olmoe_streams_equal_jax(olmoe_pair, completion):
    """Smoke olmoe-1b-7b: every prefill and decode step routes through the
    MoE blocks (the plain expert product on the CPU), and the greedy
    streams equal the JAX ``LMAdapter``'s."""
    (_, _, pcfg, model, prompt_tokens), want = olmoe_pair
    adapter = LMAdapter(pcfg, model, prompt_len=PROMPT, gen_len=GEN,
                        device="cpu", prompt_tokens=prompt_tokens)
    adapter.warmup()
    rep = ServingEngine(adapter, slots=2, completion=completion,
                        num_workers=2).run(
        [Request(rid=i, prompt=100 + i, gen_len=GEN) for i in range(N_REQ)])
    assert rep.tokens == N_REQ * GEN
    assert rep.outputs == want


@pytest.mark.parametrize("completion", ["event", "blocking"])
def test_engine_run_leaves_no_cycle_holding_the_model(completion):
    """With the cyclic collector off, the model dies as soon as the caller
    drops the engine, the adapter and the model after a run (the
    requests and the report stay): nothing but reference counts holds it,
    and every finished request has dropped its cache."""
    cfg = dataclasses.replace(configs.smoke("olmoe-1b-7b"), dtype="float32")
    was_enabled = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        model = port_model.init(cfg, seed=0, device="cpu")
        alive = weakref.ref(model)
        adapter = LMAdapter(cfg, model, prompt_len=6, gen_len=3,
                            device="cpu")
        engine = ServingEngine(adapter, slots=2, completion=completion,
                               num_workers=2)
        reqs = [Request(rid=i, prompt=i, gen_len=3) for i in range(3)]
        rep = engine.run(reqs)
        del engine, adapter, model
        assert alive() is None
        assert all(r.cache is None for r in reqs)
        assert rep.tokens == 9
    finally:
        if was_enabled:
            gc.enable()


def test_lm_adapter_default_prompts_legs_equal(lm_pair):
    """With its own seeded prompts, both legs give the same streams and a
    re-run of one prompt repeats its stream."""
    _, _, pcfg, model, _ = lm_pair
    adapter = LMAdapter(pcfg, model, prompt_len=PROMPT, gen_len=GEN,
                        device="cpu")
    outs = {}
    for leg in ("event", "blocking"):
        rep = ServingEngine(adapter, slots=3, completion=leg,
                            num_workers=3).run(
            [Request(rid=i, prompt=7 + (i % 2), gen_len=GEN)
             for i in range(3)])
        outs[leg] = rep.outputs
    assert outs["event"] == outs["blocking"]
    assert outs["event"][0] == outs["event"][2]
    assert all(len(v) == GEN for v in outs["event"].values())


def test_lm_adapter_model_device_must_match(lm_pair):
    _, _, pcfg, model, _ = lm_pair
    with pytest.raises(ValueError, match="model is on"):
        LMAdapter(pcfg, model, prompt_len=4, gen_len=2, device="meta")


class ArgmaxCheckingAdapter(LMAdapter):
    """Records, for every token handle, the last-position logits that
    produced it (cloned on the request's stream), so a run can check that
    each token read equals their argmax."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.logits = {}
        self.seen = []

    def _token(self, logits):
        handle, tok = super()._token(logits)
        self.logits[id(handle.result)] = logits[:, -1].float().clone()
        return handle, tok

    def detok(self, req, step, tok):
        host = tok.result if isinstance(tok, tac.AsyncHandle) else tok
        val = super().detok(req, step, tok)
        self.seen.append((val, self.logits[id(host)]))
        return val


@pytest.mark.cuda
@pytest.mark.parametrize("completion", ["event", "blocking"])
def test_lm_adapter_tokens_are_argmax_on_card(completion):
    """On the card every request runs on its own stream: each token the
    engine reads is the argmax of the logits that produced it, and the
    prefill attention went through the kernel (2 layers per request)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import flash_attention as fa
    cfg = configs.smoke("granite-3-2b")
    model = port_model.init(cfg, seed=0, device="cuda")
    adapter = ArgmaxCheckingAdapter(cfg, model, prompt_len=64, gen_len=GEN,
                                    device="cuda")
    adapter.warmup()
    adapter.seen.clear()
    before = fa.flash_attention.launches
    rep = ServingEngine(adapter, slots=4, completion=completion,
                        num_workers=4).run(
        [Request(rid=i, prompt=i, gen_len=GEN) for i in range(4)])
    torch.cuda.synchronize()
    assert rep.tokens == 4 * GEN == len(adapter.seen)
    for val, logits in adapter.seen:
        assert val == int(torch.argmax(logits, dim=-1)[0])
    assert fa.flash_attention.launches - before == 4 * cfg.n_layers


@pytest.mark.cuda
def test_serve_cli_defaults_on_card(capsys):
    """The serving CLI with no flags runs on the card: smoke-scale
    granite-3-2b (head dim 16), every prefill attention layer through the
    kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve
    before = fa.flash_attention.launches
    assert serve.main([]) == 0
    assert "device=cuda" in capsys.readouterr().out
    cfg = configs.smoke("granite-3-2b")
    # the warm-up request and the 4 served ones
    assert fa.flash_attention.launches - before == 5 * cfg.n_layers


@pytest.mark.cuda
@pytest.mark.parametrize("completion", ["event", "blocking"])
def test_serve_cli_zamba2_smoke_on_card(capsys, completion):
    """The serving CLI serves smoke zamba2-2.7b on the card (head dim 16,
    P = 64, n = 16, chunk 16, a prompt of 24 that pads to the chunk):
    every Mamba2 prefill through ``mamba2_ssd`` and every shared-attention
    prefill through ``flash_attention``, none in decode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.launch import serve
    before = (ssd.mamba2_ssd.launches, fa.flash_attention.launches)
    assert serve.main(["--arch", "zamba2-2.7b", "--prompt-len", "24",
                       "--gen", "8", "--completion", completion]) == 0
    assert "device=cuda" in capsys.readouterr().out
    # the warm-up request and the 4 served ones; 6 Mamba2 blocks and one
    # shared-attention call per prefill
    assert ssd.mamba2_ssd.launches - before[0] == 5 * 6
    assert fa.flash_attention.launches - before[1] == 5 * 1


@pytest.mark.cuda
@pytest.mark.parametrize("completion", ["event", "blocking"])
def test_serve_cli_xlstm_smoke_on_card(capsys, completion):
    """The serving CLI serves smoke xlstm-350m on the card (mLSTM head dim
    32, chunk 16, a prompt of 24 that pads to the chunk): every mLSTM
    prefill through ``mlstm_chunk``, none in decode; ``--mlstm-impl ref``
    launches it never."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import mlstm_chunk as mk
    from repro_torch.launch import serve
    before = mk.mlstm_chunk.launches
    args = ["--arch", "xlstm-350m", "--prompt-len", "24", "--gen", "8",
            "--completion", completion]
    assert serve.main(args) == 0
    assert "device=cuda" in capsys.readouterr().out
    # the warm-up request and the 4 served ones; 3 mLSTM blocks a prefill
    assert mk.mlstm_chunk.launches - before == 5 * 3
    assert serve.main(args + ["--mlstm-impl", "ref"]) == 0
    assert mk.mlstm_chunk.launches - before == 5 * 3


@pytest.mark.cuda
@pytest.mark.parametrize("completion", ["event", "blocking"])
def test_serve_cli_olmoe_smoke_on_card(capsys, completion):
    """The serving CLI serves smoke olmoe-1b-7b on the card: every MoE
    block of every prefill and decode step runs its three expert products
    through ``moe_gmm``; ``--moe-impl ref`` launches it never."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import moe_gmm as mg
    from repro_torch.launch import serve
    before = mg.moe_gmm.launches
    args = ["--arch", "olmoe-1b-7b", "--prompt-len", "24", "--gen", "8",
            "--completion", completion]
    assert serve.main(args) == 0
    assert "device=cuda" in capsys.readouterr().out
    # warm-up: a prefill and a decode step; 4 requests: a prefill and 7
    # decode steps each; 2 MoE blocks a pass, 3 products a block
    assert mg.moe_gmm.launches - before == (2 + 4 * 8) * 2 * 3
    assert serve.main(args + ["--moe-impl", "ref"]) == 0
    assert mg.moe_gmm.launches - before == (2 + 4 * 8) * 2 * 3
