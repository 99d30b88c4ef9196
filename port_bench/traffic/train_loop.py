"""Traffic kind ``train_loop``: the program's train step run back to back
for the window.

Set-up builds one train state (``steps.build_train_step`` on a mesh of one
rank, a ``Model`` loaded with the benchmark's weights, ``optim.init``) and
one ``data.Prefetcher`` over the benchmark's token batches, then drives
the first ``checked_steps`` steps through that same step and feed (they
also warm up every shape).  The window runs the next steps for
``--seconds`` and ends in a synchronise.  A traced run times that window
untraced as well, and then runs a second one of the same length under the
profiler, so that the rate its readers take is not the profiler's.
Afterwards, with the program's state freed, the plain reference trains
from the same weights on the same batches in fp32 and the runs are
compared: the loss of each checked step and of the window's first
``window_checked`` steps, the first gradient as AdamW got it (its first
moment over 1 - b1) and the parameters' change over the checked steps
(the fp32 masters), leaf by leaf by the gap of their norms.

Parameters: ``batch``, ``seq``, ``checked_steps``, ``window_checked``,
``remat``, ``optimizer`` (``OptimConfig``'s fields) and ``no_decay``
(leaves AdamW does not decay, as the program decides it).
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from port_bench import harness, weights
from port_bench.reference import plain


class TokenBatches:
    """The benchmark's packed token batches, ``batch_at(step)`` as numpy
    (the program's ``Prefetcher`` draws them on its host task): ids
    uniform over the vocabulary, every row different, labels the next
    ids."""

    def __init__(self, seed: int, batch: int, seq: int, vocab: int) -> None:
        self.seed, self.batch, self.seq, self.vocab = seed, batch, seq, vocab

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(np.random.SeedSequence(
            [int(self.seed), 7, int(step)]))
        ids = rng.integers(0, self.vocab, (self.batch, self.seq + 1),
                           dtype=np.int32)
        return {"tokens": ids[:, :-1], "labels": ids[:, 1:]}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _named(net, tree) -> Dict[str, torch.Tensor]:
    """The optimizer tree ``tree`` (``param_tree``'s structure) by
    parameter name."""
    from repro_torch.core.overlap import tree_flatten
    from repro_torch.models import model
    names = {id(p): n for n, p in net.named_parameters()}
    leaves = tree_flatten(model.param_tree(net))[0]
    return {names[id(p)]: t for p, t in zip(leaves, tree_flatten(tree)[0])}


def program_state(run: harness.Run, specs, opt_cfg):
    """(step function, train state, prefetcher) of the program."""
    from repro_torch import optim
    from repro_torch.data import Prefetcher, to_device
    from repro_torch.launch.mesh import local_mesh
    from repro_torch.models import model
    from repro_torch.runtime import steps
    from repro_torch.runtime.sharding import ShardingPolicy
    p, dev = run.cell.params, run.device
    cfg = harness.port_config(run.cell)
    step_fn, _ = steps.build_train_step(
        cfg, local_mesh(device=dev), ShardingPolicy(remat=p["remat"]),
        opt_cfg)
    net = model.Model(cfg, dev)
    w = weights.draw(specs, run.seed, dev, cfg.activation_dtype)
    weights.load_into(net, w)
    del w
    net.requires_grad_(True)
    state = steps.TrainState(net, optim.init(model.param_tree(net)))
    data = TokenBatches(run.seed, p["batch"], p["seq"], cfg.vocab)
    prefetch = Prefetcher(data, device_put_fn=lambda b: to_device(b, dev))
    return step_fn, state, prefetch, data


def reference_run(run: harness.Run, specs, data: TokenBatches,
                  precision: str = "fp32", rows=None) -> Dict:
    """The reference's losses over the checked steps and the window's
    first ``window_checked``, the first clipped gradient's norms and the
    checked steps' change's norms, leaf by leaf.  ``precision="fp8"`` is
    the control; ``rows`` keeps only those positions of each batch (a
    planted fault)."""
    ref = run.reference()
    p, c = run.cell.params, run.cell.port
    plain.strict_fp32()
    mm = plain.Matmul(precision)
    W = {k: v.float() for k, v in weights.draw(
        specs, run.seed, run.device, getattr(torch, c["dtype"])).items()}
    for v in W.values():
        v.requires_grad_(True)
    opt = plain.AdamW(W, p["optimizer"], p["no_decay"])
    checked = p["checked_steps"]
    last = checked + p["window_checked"] - 1
    losses, g1, change = [], None, None
    for s in range(last + 1):
        b = data.batch_at(s)
        toks = torch.from_numpy(b["tokens"]).long().to(run.device)
        labels = torch.from_numpy(b["labels"]).long().to(run.device)
        if rows is not None:
            toks, labels = toks[:, rows], labels[:, rows]
        if s == last:   # the last loss compared needs no update after it
            with torch.no_grad():
                loss = ref.loss(ref.forward(W, toks, c, mm), labels)
            losses.append(float(loss))
            break
        loss = ref.loss(ref.forward(W, toks, c, mm, remat=True), labels)
        grads = torch.autograd.grad(loss, list(W.values()))
        opt.step(dict(zip(W, grads)))
        losses.append(float(loss.detach()))
        del grads, loss
        if s == 0:      # the clipped gradient, as the program's is read
            g1 = plain.norms_of(list(W), lambda k: opt.m[k]
                                / (1 - p["optimizer"]["b1"]))
        if s == checked - 1:
            init = weights.draw(specs, run.seed, run.device,
                                getattr(torch, c["dtype"]))
            change = plain.norms_of(
                list(W), lambda k: W[k].detach() - init[k].float())
            del init
    del opt, W
    gc.collect()
    return {"losses": losses, "grad": g1, "change": change}


def compare(got: Dict, want: Dict) -> Dict[str, float]:
    """The compared numbers: the worst step's relative loss gap, and the
    worst leaf's norm gap of the first gradient and of the change.  Leaves
    whose reference gradient is under a thousandth of the median leaf's
    move by round-off alone and are left out of the change."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                         want["losses"]))
    med = plain.median(list(want["grad"].values()))
    moved = [k for k, g in want["grad"].items() if g >= 1e-3 * med]
    grad_gap, _ = plain.norm_gap(got["grad"], want["grad"])
    change_gap, _ = plain.norm_gap(got["change"], want["change"], moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap}


def _window(run: harness.Run, step_fn, state, prefetch, step: int):
    """Steps back to back for ``run.seconds``, ending in a synchronise:
    (state, last step, losses, data waits, seconds)."""
    losses: List[torch.Tensor] = []
    waits: List[float] = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        step += 1
        tw = time.perf_counter()
        batch = prefetch.get(step)
        waits.append(time.perf_counter() - tw)
        state, met = step_fn(state, batch)
        losses.append(met["loss"])
    _sync(run.device)
    return state, step, losses, waits, time.perf_counter() - t0


def run(run: harness.Run) -> None:
    from repro_torch import optim
    p, dev = run.cell.params, run.device
    ref = run.reference()
    specs = ref.param_specs(run.cell.port)
    opt_cfg = optim.OptimConfig(**p["optimizer"])
    step_fn, state, prefetch, data = program_state(run, specs, opt_cfg)
    net = state.params
    got: Dict = {"losses": []}
    step = 0
    try:
        for step in range(p["checked_steps"]):
            state, met = step_fn(state, prefetch.get(step))
            got["losses"].append(met["loss"])
            if step == 0:
                m1 = _named(net, state.opt.m)
                got["grad"] = plain.norms_of(
                    list(m1), lambda k: m1[k] / (1 - opt_cfg.b1))
                del m1
        masters = _named(net, state.opt.master)
        init = weights.draw(specs, run.seed, dev,
                            harness.port_config(run.cell).activation_dtype)
        got["change"] = plain.norms_of(
            list(masters), lambda k: masters[k] - init[k].float())
        del init, masters
        _sync(dev)
        started = time.perf_counter()
        state, step, losses, waits, window = _window(
            run, step_fn, state, prefetch, step)
        if run.trace:
            with run.tracer.window():
                state, step, traced, _, _ = _window(
                    run, step_fn, state, prefetch, step)
            losses += traced
        if dev.type == "cuda":
            run.memory_peak = torch.cuda.max_memory_allocated(dev)
    finally:
        prefetch.close()
    got["losses"] = [float(x) for x in
                     got["losses"] + losses[:p["window_checked"]]]
    tokens = p["batch"] * p["seq"]
    n = len(waits)      # the steps of the untraced window
    finite = torch.isfinite(torch.stack(losses).float()).tolist()
    run.attempted, run.failed = len(losses), finite.count(False)
    run.metrics["setup_s"] = started - run.started
    run.metrics["train_tokens_per_s"] = n * tokens / window
    run.record.update(steps=n, tokens=n * tokens, window_s=window,
                      data_wait_s=waits)
    if run.trace:
        run.summary = run.tracer.summary()
        run.tracer = None
    del state, net, step_fn, met, losses
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    want = reference_run(run, specs, data)
    nums = compare(got, want)
    for name, value in nums.items():
        run.check(name, value, run.cell.limits[name])
    run.correct = run.failed == 0 and all(
        value <= run.cell.limits[name] for name, value in nums.items())
