"""Attention tensor-parallel over its query heads alone (``"tp_q"``,
``runtime/spmd.py``), where the KV heads do not divide the model axis, and
decode over the KV cache sharded over time (flash-decode).

* The partial softmax terms (``ops.attention_partial``) of the key blocks
  of a cache, combined as the sharded decode combines them, against
  ``ops.attention_ref`` over the whole cache, in fp32 within
  ``COMBINE_TOL``: a decode step's masks (valid length, causal, a sliding
  window) leave one block with every row masked, and a prefill-sized
  query block covers the causal edge inside a key block.
* Smoke granite scaled to 12 query and 3 KV heads on (1, 4): each rank's
  3 query heads straddle KV groups on ranks 1 and 2 (heads 3-5 use KV
  heads 0, 1, 1), so the KV heads are repeated to one a query head there.
  Its sharded prefill and decode steps give the one-rank steps' logits
  within ``SERVE_TOL`` (fp32), with the cache sharded over time and no
  cache piece moved between ranks; the same with a cache length the axis
  does not divide (the cache replicated over the model axis); smoke
  mixtral's sliding-window blocks likewise.  One train
  step's gradients (AdamW's first moment) lie within ``GRAD_RTOL`` |g| +
  ``GRAD_LEAF_ATOL`` max|g_leaf| of the one-rank step's.
"""

import numpy as np
import pytest
import torch

from repro_torch import configs, optim
from repro_torch.data import SyntheticLMData
from repro_torch.kernels import ops, ref
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model
from repro_torch.runtime import sharding, steps
from repro_torch.runtime.sharding import ShardingPolicy
from repro_torch.runtime.spmd import ShardedModel
from torch_threads import one_intra_op_thread  # noqa: F401

COMBINE_TOL = 1e-6
SERVE_TOL = 1e-5
GRAD_RTOL, GRAD_LEAF_ATOL = 1e-4, 1e-5
B, S, N = 2, 16, 4
# a masked score, as the fp32 scores hold it
MASKED = float(torch.tensor(ref.NEG_INF, dtype=torch.float32))


def _blocks(q, k, v, n, **kw):
    """The partial terms of ``n`` equal key blocks of k, v, and their
    combination as ``ShardedModel._flash_decode`` makes it over the model
    axis: the largest m, then the rescaled sums."""
    T = k.shape[1] // n
    parts = [ops.attention_partial(q, k[:, i * T:(i + 1) * T],
                                   v[:, i * T:(i + 1) * T], k_offset=i * T,
                                   **kw) for i in range(n)]
    m_max = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    scaled = [ops.attention_rescale(*p, m_max) for p in parts]
    den = sum(t[0] for t in scaled)
    num = sum(t[1] for t in scaled)
    return parts, (num / den[..., None]).to(q.dtype)


@pytest.mark.parametrize("window", [None, 2])
def test_partial_terms_combine_to_attention(window):
    """A decode step at position 9 of a 32-row cache in 4 blocks of 8:
    blocks 2 and 3 lie beyond the valid length, and with a window of 2
    (keys 8 and 9) block 0 lies before it, so those blocks have every row
    masked."""
    g = torch.Generator().manual_seed(0)
    Bq, T, H, Hkv, D = 2, 32, 8, 2, 16
    q = torch.randn(Bq, 1, H, D, generator=g)
    k = torch.randn(Bq, T, Hkv, D, generator=g)
    v = torch.randn(Bq, T, Hkv, D, generator=g)
    kw = dict(causal=True, window=window, kv_valid_len=10, q_offset=9)
    parts, got = _blocks(q, k, v, 4, **kw)
    want = ops.attention_ref(q, k, v, **kw)
    masked = [float(m.max()) == MASKED for m, _, _ in parts]
    assert masked == [window is not None, False, True, True]
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=COMBINE_TOL, rtol=0)


def test_partial_terms_combine_over_a_query_block():
    """Twelve query rows from position 20 of a 32-row cache in blocks of
    8 (valid length 32, a window of 10): the causal and window edges cut
    through blocks, and block 0 is masked for every row."""
    g = torch.Generator().manual_seed(1)
    q = torch.randn(1, 12, 4, 8, generator=g)
    k = torch.randn(1, 32, 4, 8, generator=g)
    v = torch.randn(1, 32, 4, 8, generator=g)
    kw = dict(causal=True, window=10, kv_valid_len=32, q_offset=20)
    parts, got = _blocks(q, k, v, 4, **kw)
    assert float(parts[0][0].max()) == MASKED
    torch.testing.assert_close(got, ops.attention_ref(q, k, v, **kw),
                               atol=COMBINE_TOL, rtol=0)


def test_pmax_is_the_largest_value_counted_as_an_all_reduce():
    """``LogicalMesh.pmax`` over the model axis of a (2, 2) mesh: every
    rank gets its group's elementwise largest value; the call counts as
    one ``psum`` (XLA's all-reduce) a rank, the operands' bytes."""
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    g = torch.Generator().manual_seed(2)
    xs = [torch.randn(3, 5, generator=g) for _ in range(mesh.size)]
    got = mesh.pmax(xs, "model")
    for group in mesh.groups("model"):
        want = torch.maximum(xs[group[0]], xs[group[1]])
        for r in group:
            assert torch.equal(got[r], want)
    assert mesh.coll_calls["psum"] == [1] * mesh.size
    assert mesh.coll_bytes["psum"] == [xs[0].numel() * 4] * mesh.size
    assert all(x is not y for x, y in zip(xs, got))


def _straddling_cfg():
    """Smoke granite with 12 query and 3 KV heads of 8 (d_model 96)."""
    return configs.smoke("granite-3-2b").scaled(
        dtype="float32", d_model=96, n_heads=12, n_kv_heads=3)


def _serve(cfg, net, mesh, toks, forced, length):
    pol = ShardingPolicy()
    sharded = mesh.size > 1
    params = steps.place_params(net, sharding.param_shardings(
        mesh, net, pol)) if sharded else net
    prefill = steps.build_prefill_step(cfg, mesh, pol)
    decode, template = steps.build_decode_step(cfg, mesh, pol, batch=B,
                                               cache_len=length)
    logits, cache = prefill(params, {"tokens": toks})
    outs = [logits]
    if sharded:
        cache = sharding.place(
            model.pad_cache(cfg, sharding.gather(cache), length),
            sharding.cache_shardings(mesh, template, pol))
        mesh.reset_counts()
    else:
        cache = model.pad_cache(cfg, cache, length)
    for i in range(N):
        logits, cache = decode(params, cache, {"tokens": forced[i][:, None]},
                               S + i)
        outs.append(logits)
    return outs, cache


@pytest.mark.parametrize("length", [S + N, S + N + 1],
                         ids=["time-sharded", "replicated"])
def test_straddling_query_heads_serve_as_one_rank(length):
    cfg = _straddling_cfg()
    mesh = make_mesh((1, 4), ("data", "model"), "cpu")
    assert ShardedModel(cfg, mesh, ShardingPolicy()).tensor_parallel() == \
        {"L0_0_attn": "tp_q", "L0_1_mlp": "tp"}
    net = model.init(cfg, 0, "cpu")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))
    forced = torch.from_numpy(rng.integers(0, cfg.vocab, (N, B)))
    want, _ = _serve(cfg, net, make_mesh((1, 1), ("data", "model"), "cpu"),
                     toks, forced, length)
    got, cache = _serve(cfg, net, mesh, toks, forced, length)
    k = cache["L0_0_attn"]["k"]
    spans = {k.box(r)[2] for r in range(mesh.size)}
    assert len(spans) == (4 if length % 4 == 0 else 1)
    # no cache piece moved between ranks in the decode steps
    assert mesh.coll_bytes["ppermute"] == [0] * mesh.size
    scale = max(float(w.abs().max()) for w in want)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=SERVE_TOL * scale, rtol=0)
        assert torch.equal(a.argmax(-1), b.argmax(-1))


def test_sliding_window_query_heads_serve_as_one_rank():
    """Smoke mixtral (sliding window of 16, 4/2 heads) on (1, 4): its
    SWA blocks run ``"tp_q"`` and its decode steps, at positions 16-19,
    mask the keys that left the window on every rank's time block."""
    cfg = configs.smoke("mixtral-8x22b").scaled(dtype="float32")
    mesh = make_mesh((1, 4), ("data", "model"), "cpu")
    assert ShardedModel(cfg, mesh, ShardingPolicy()).tensor_parallel()[
        "L0_0_swa"] == "tp_q" and cfg.sliding_window == S
    net = model.init(cfg, 0, "cpu")
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))
    forced = torch.from_numpy(rng.integers(0, cfg.vocab, (N, B)))
    want, _ = _serve(cfg, net, make_mesh((1, 1), ("data", "model"), "cpu"),
                     toks, forced, S + N)
    got, _ = _serve(cfg, net, mesh, toks, forced, S + N)
    assert mesh.coll_bytes["ppermute"] == [0] * mesh.size
    scale = max(float(w.abs().max()) for w in want)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=SERVE_TOL * scale, rtol=0)
        assert torch.equal(a.argmax(-1), b.argmax(-1))


def test_straddling_query_heads_train_as_one_rank():
    cfg = _straddling_cfg()
    opt_cfg = optim.OptimConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    batch = SyntheticLMData(cfg, batch=4, seq=32, seed=1).batch_at(0)
    moments = []
    for shape in ((1, 1), (1, 4)):
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        fn, shards = steps.build_train_step(cfg, mesh, ShardingPolicy(),
                                            opt_cfg)
        state = steps.init_train_state(cfg, opt_cfg, 0, device="cpu",
                                       shardings=shards
                                       if mesh.size > 1 else None)
        state, _ = fn(state, batch)
        ref_state = steps.state_to_reference(state)
        moments.append([t.numpy() for t in
                        steps.tree_flatten(ref_state.opt.m)[0]])
    for got, want in zip(*reversed(moments)):
        bound = GRAD_RTOL * np.abs(want) + GRAD_LEAF_ATOL * np.abs(want).max()
        assert (np.abs(got - want) <= bound).all()
