"""Plain-PyTorch versions of the port's kernels.

Each function computes what its hand-written kernel computes, in the same
arithmetic order, with ordinary tensor operations: the CPU path of the
kernel wrappers, the oracle the CPU tests hold the port against the JAX
package with, and the version ``chip_smoke.py`` compares each kernel to on
the card.  Counterpart of the collective-stage oracles in
``repro/kernels/ref.py`` (``combine_stage``, ``quantize_stage``,
``dequantize_stage`` and ``gs_stencil``), of the attention oracles
(``attention``, the dense oracle and decode path, and ``flash_attention``,
the plain version of the attention kernel), and of the Mamba2 SSD ones
(``ssd_chunked``, the plain version of the ``mamba2_ssd`` kernel;
``ssd_sequential``, the stepwise oracle; ``ssd_decode_step``, the decode
path), and of the mLSTM ones (``mlstm_chunked``, the plain version of the
``mlstm_chunk`` kernel; ``mlstm_sequential``, the stepwise oracle;
``mlstm_decode_step``, the decode path), and of the MoE ones (``moe_gmm``,
the plain version of the ``moe_gmm`` kernel; ``gmm``, the ragged oracle).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def gs_update(block: torch.Tensor, top: torch.Tensor, left: torch.Tensor,
              bottom: torch.Tensor, right: torch.Tensor):
    """The 4-point update of :func:`gs_stencil` before rounding: returns
    ``(new, old)``, both fp32, ``new = 0.25 * (((up + down) + left) +
    right)`` with the halos rounded to the block's dtype first."""
    dt = block.dtype
    b = block.float()
    H, W = b.shape
    up = torch.cat([top.to(dt).reshape(1, W).float(), b[:-1, :]], dim=0)
    down = torch.cat([b[1:, :], bottom.to(dt).reshape(1, W).float()], dim=0)
    lft = torch.cat([left.to(dt).reshape(H, 1).float(), b[:, :-1]], dim=1)
    rgt = torch.cat([b[:, 1:], right.to(dt).reshape(H, 1).float()], dim=1)
    return 0.25 * (up + down + lft + rgt), b


def gs_stencil(block: torch.Tensor, top: torch.Tensor, left: torch.Tensor,
               bottom: torch.Tensor, right: torch.Tensor):
    """Fused Gauss–Seidel block stage: 4-point update, fp32 L1 residual
    and the four new boundary edges.

    Returns ``(new_block, residual, (top, bottom, left, right))``.  The
    update sums ``((up + down) + left) + right`` and then scales by 0.25,
    in fp32; the residual ``sum|new - old|`` uses the unrounded fp32
    ``new``; block and edges are rounded to the block's dtype.  The halos
    are rounded to the block's dtype first, as the Pallas wrapper does.
    """
    new, b = gs_update(block, top, left, bottom, right)
    res = torch.sum(torch.abs(new - b))
    new = new.to(block.dtype)
    return new, res, (new[0, :], new[-1, :], new[:, 0].contiguous(),
                      new[:, -1].contiguous())


def combine_stage(acc: torch.Tensor, got: torch.Tensor, scale=None, *,
                  accumulate: bool = True, out=None) -> torch.Tensor:
    """``acc + dequant(got)``: the fused combine of one reduce-scatter
    round, or with ``accumulate=False`` just ``dequant(got)`` (the
    allgather-leg install, which never reads ``acc``).

    ``got`` is cast to ``acc.dtype``, or with ``scale`` (a 0-d fp32
    tensor) first widened to fp32 and multiplied by it, then cast; the add
    runs in the promoted type and rounds once (a bf16 + bf16 add is an fp32
    add rounded to bf16).  ``out`` (may be ``acc`` itself) receives the
    result in place.
    """
    if scale is None:
        g = got.to(acc.dtype)
    else:
        g = (got.float() * scale).to(acc.dtype)
    if not accumulate:
        return g if out is None else out.copy_(g)
    return torch.add(acc, g, out=out)


def quantize_stage(x: torch.Tensor, scale) -> torch.Tensor:
    """Symmetric int8 quantisation: ``round(x / scale)`` in fp32 (a true
    division, rounding half to even), clipped to ±127."""
    q = torch.round(x.float() / scale)
    return q.clamp_(-127.0, 127.0).to(torch.int8)


def dequantize_stage(q: torch.Tensor, scale, dtype=torch.float32, *,
                     out=None) -> torch.Tensor:
    """``q × scale`` in fp32, cast to ``dtype`` (into ``out`` when
    given)."""
    v = (q.float() * scale).to(dtype)
    return v if out is None else out.copy_(v)


# ---------------------------------------------------------------------------
# Attention (GQA, causal / bidirectional, sliding window)
# ---------------------------------------------------------------------------
NEG_INF = -1e30
_PLAIN_BLOCK_K = 128    # key-tile width of the plain flash_attention loop


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              kv_valid_len=None, q_offset=None) -> torch.Tensor:
    """Dense multi-head attention, the oracle (``repro/kernels/ref.py``
    ``attention``) and the decode path (``ops.attention_ref``).

    q: (B, S, H, D); k, v: (B, T, Hkv, D) with H % Hkv == 0.  Scores in
    fp32, masked to ``NEG_INF``, softmax over T, cast to q's dtype.
    ``kv_valid_len`` (B,): only positions < len attend (decode);
    ``q_offset`` (B,): absolute position of q[:, 0] (decode: the cache
    index).  Both may be ints or tensors on q's device.
    """
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    qf, kf, vf = q.float(), k.float(), v.float()
    if rep > 1:
        kf = kf.repeat_interleave(rep, dim=2)
        vf = vf.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", qf, kf) / (D ** 0.5)
    dev = q.device
    q_pos = torch.arange(S, device=dev)[None, :, None]          # (1, S, 1)
    if q_offset is not None:
        q_pos = q_pos + (q_offset if isinstance(q_offset, int)
                         else q_offset.reshape(-1, 1, 1))        # (B, S, 1)
    k_pos = torch.arange(T, device=dev)[None, None, :]          # (1, 1, T)
    mask = torch.ones((q_pos.shape[0], S, T), dtype=torch.bool, device=dev)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    if kv_valid_len is not None:
        mask &= k_pos < (kv_valid_len if isinstance(kv_valid_len, int)
                         else kv_valid_len.reshape(-1, 1, 1))
    scores = scores.masked_fill(~mask[:, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, vf)
    return out.to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """The plain version of the ``flash_attention`` kernel: a loop over key
    tiles of ``_PLAIN_BLOCK_K`` with the online softmax of the Pallas kernel's
    ``_attn_kernel`` (``repro/kernels/flash_attention.py``), all query rows
    at once.

    Per tile: fp32 scores × ``1/sqrt(D)``, masked to ``NEG_INF``; the
    running max ``m``, ``p = exp(s - m_new)`` zeroed where masked,
    ``alpha = 0`` where the previous max is still ``NEG_INF``; at the end
    ``l == 0`` becomes 1 and ``acc / l`` is cast to q's dtype.  Any S and
    T: the last tile is ragged.  q: (B, S, H, D); k, v: (B, T, Hkv, D).
    """
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    scale = 1.0 / (D ** 0.5)
    # (B, Hkv, rep·S, D): the rep query heads of one kv head share its tiles
    qf = q.float().reshape(B, S, Hkv, rep, D).permute(0, 2, 3, 1, 4) \
        .reshape(B, Hkv, rep * S, D)
    kf = k.float().permute(0, 2, 1, 3)                  # (B, Hkv, T, D)
    vf = v.float().permute(0, 2, 1, 3)
    dev = q.device
    q_pos = torch.arange(S, device=dev).repeat(rep)[:, None]   # (rep·S, 1)
    m = torch.full((B, Hkv, rep * S), NEG_INF, device=dev)
    l = torch.zeros((B, Hkv, rep * S), device=dev)
    acc = torch.zeros((B, Hkv, rep * S, D), device=dev)
    for k0 in range(0, T, _PLAIN_BLOCK_K):
        k1 = min(k0 + _PLAIN_BLOCK_K, T)
        if causal and k0 > S - 1:
            break               # every later tile is above the diagonal
        s = torch.matmul(qf, kf[:, :, k0:k1].transpose(-1, -2)) * scale
        k_pos = torch.arange(k0, k1, device=dev)[None, :]
        mask = torch.ones((rep * S, k1 - k0), dtype=torch.bool, device=dev)
        if causal:
            mask &= k_pos <= q_pos
        if window is not None:
            mask &= k_pos > q_pos - window
        s = s.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(mask, p, torch.zeros((), device=dev))
        alpha = torch.where(m == NEG_INF, torch.zeros((), device=dev),
                            torch.exp(m - m_new))
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(p, vf[:, :, k0:k1])
        m = m_new
    l = torch.where(l == 0.0, torch.ones((), device=dev), l)
    out = (acc / l[..., None]).to(q.dtype)
    return out.reshape(B, Hkv, rep, S, D).permute(0, 3, 1, 2, 4) \
        .reshape(B, S, H, D)


# ---------------------------------------------------------------------------
# Mamba2 / SSD (state space dual) -- chunked scan
# ---------------------------------------------------------------------------
_SCAN_WARP = 32


def _block_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum over the last axis in the ``mamba2_ssd`` kernel's
    fixed order, so that both round it alike: within each group of 32 a
    Hillis–Steele scan (``v[i] += v[i - off]`` for off = 1, 2, 4, 8, 16,
    all i at once), then each group adds the totals of the groups before
    it, summed in order.  (The segment sums are differences of these
    cumsums, which reach hundreds over a chunk of 256; another summation
    order moves them by ~1e-5.)"""
    l = x.shape[-1]
    g = -(-l // _SCAN_WARP)
    v = torch.nn.functional.pad(x, (0, g * _SCAN_WARP - l))
    v = v.reshape(tuple(x.shape[:-1]) + (g, _SCAN_WARP))
    off = 1
    while off < _SCAN_WARP:
        v = torch.cat([v[..., :off], v[..., off:] + v[..., :-off]], dim=-1)
        off *= 2
    pre = [torch.zeros_like(v[..., 0, -1])]
    for w in range(1, g):
        pre.append(pre[-1] + v[..., w - 1, -1])
    v = v + torch.stack(pre, dim=-1)[..., None]
    return v.reshape(tuple(x.shape[:-1]) + (g * _SCAN_WARP,))[..., :l]


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T) lower-triangular segment sums:
    ``out[i, j] = sum_{j < k <= i} x[k]`` (as the difference of two
    cumsums) for i >= j, -inf above the diagonal."""
    T = x.shape[-1]
    c = _block_cumsum(x)
    d = c[..., :, None] - c[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return d.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, *, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan (Mamba2's "ssd_minimal_discrete"), fp32 einsums --
    ``repro/kernels/ref.py`` ``ssd_chunked`` and the plain version of the
    ``mamba2_ssd`` kernel, whose cumsum order it takes
    (:func:`_block_cumsum`).

    x: (b, s, h, p); dt: (b, s, h) (> 0); A: (h,) (< 0); B, C: (b, s, n),
    shared across heads; ``init_state`` (b, h, p, n).  ``s % chunk == 0``.
    Returns (y (b, s, h, p) in x's dtype, final state (b, h, p, n) fp32).
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk:
        raise ValueError(f"ssd_chunked: s={s} is not a multiple of "
                         f"chunk={chunk}")
    nc = s // chunk
    f32 = torch.float32
    dtf = dt.to(f32)
    xd = x.to(f32) * dtf[..., None]                     # discretised input
    dA = dtf * A.to(f32)                                # (b, s, h)

    def ch(t):                      # (b, s, ...) -> (b, nc, chunk, ...)
        return t.reshape((b, nc, chunk) + tuple(t.shape[2:]))

    xd_c = ch(xd)                                       # (b,c,l,h,p)
    dA_c = ch(dA).permute(0, 3, 1, 2)                   # (b,h,c,l)
    B_c = ch(B.to(f32))                                 # (b,c,l,n)
    C_c = ch(C.to(f32))

    # 1. intra-chunk (diagonal block) outputs
    L = torch.exp(_segsum(dA_c))                        # (b,h,c,l,l)
    Y_diag = torch.einsum("bcln,bcmn,bhclm,bcmhp->bclhp", C_c, B_c, L, xd_c)

    # 2. per-chunk final states
    dA_cum = _block_cumsum(dA_c)                        # (b,h,c,l)
    decay_states = torch.exp(dA_cum[..., -1:] - dA_cum)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", B_c, decay_states, xd_c)

    # 3. inter-chunk recurrence; prev[:, c] is the state ENTERING chunk c
    chunk_decay = torch.exp(dA_cum[..., -1])            # (b,h,c)
    state = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
             if init_state is None else init_state.to(f32))
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, :, c, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)              # (b,c,h,p,n)

    # 4. chunk-input contribution
    Y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", C_c, prev_states,
                         torch.exp(dA_cum))
    y = (Y_diag + Y_off).reshape(b, s, h, p).to(x.dtype)
    return y, state


def ssd_decode_step(state: torch.Tensor, xt: torch.Tensor, dtt: torch.Tensor,
                    A: torch.Tensor, Bt: torch.Tensor, Ct: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent SSD step in fp32 (``repro/kernels/ref.py``
    ``ssd_decode_step``): state (b, h, p, n), xt (b, h, p), dtt (b, h),
    Bt/Ct (b, n).  Returns (new state, yt (b, h, p) fp32)."""
    f32 = torch.float32
    xt, dtt, Bt, Ct = (t.to(f32) for t in (xt, dtt, Bt, Ct))
    decay = torch.exp(dtt * A.to(f32))[..., None, None]          # (b,h,1,1)
    upd = torch.einsum("bhp,bn->bhpn", xt * dtt[..., None], Bt)
    state = state * decay + upd
    yt = torch.einsum("bhpn,bn->bhp", state, Ct)
    return state, yt


def ssd_sequential(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, *,
                   init_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stepwise oracle of :func:`ssd_chunked`: :func:`ssd_decode_step`
    over every position.  Returns (y in x's dtype, final state fp32)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    ys = []
    for t in range(s):
        state, yt = ssd_decode_step(state, x[:, t], dt[:, t], A, B[:, t],
                                    C[:, t])
        ys.append(yt)
    return torch.stack(ys, dim=1).to(x.dtype), state


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix-memory cell) -- chunked scan, stepwise oracle, decode
# ---------------------------------------------------------------------------
def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``log(sigmoid(x)) = min(x, 0) - log1p(exp(-|x|))``, the formula of
    ``jax.nn.log_sigmoid`` and of the ``mlstm_chunk`` kernel."""
    return torch.clamp_max(x, 0.0) - torch.log1p(torch.exp(-x.abs()))


def mlstm_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  i_gate: torch.Tensor, f_gate: torch.Tensor, *, chunk: int,
                  init: Optional[Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]] = None
                  ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor,
                                                 torch.Tensor]]:
    """Chunkwise stabilised mLSTM -- ``repro/kernels/ref.py``
    ``mlstm_chunked`` and the plain version of the ``mlstm_chunk`` kernel,
    computed as the Pallas body (``repro/kernels/mlstm_chunk.py``
    ``_kernel``) and the Hopper kernel do: the log forget gates' cumsum in
    the kernel's scan order (:func:`_block_cumsum`), the segment sums as
    its differences, masked log-weights and a zero initial state's
    stabiliser at -1e30 rather than -inf, the row maxima taken over the
    masked matrix, the floor ``max(|den|, exp(-m))``.

    q, k, v: (b, s, h, d); i_gate, f_gate: (b, s, h) pre-activation
    logits; ``init`` (C (b, h, d, d), n (b, h, d), m (b, h)) or None.
    ``s % chunk == 0``.  Returns (y (b, s, h, d) in q's dtype,
    (C, n, m) fp32).
    """
    b, s, h, d = q.shape
    if s % chunk:
        raise ValueError(f"mlstm_chunked: s={s} is not a multiple of "
                         f"chunk={chunk}")
    nc = s // chunk
    f32 = torch.float32

    def heads(t):           # (b, s, h, ...) -> (b, h, nc, chunk, ...)
        t = t.to(f32).reshape((b, nc, chunk, h) + tuple(t.shape[3:]))
        return t.movedim(3, 1)

    qf, kf, vf, ig = heads(q), heads(k), heads(v), heads(i_gate)
    lf_cum = _block_cumsum(heads(_log_sigmoid(f_gate.to(f32))))
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=q.device))
    seg = lf_cum[..., :, None] - lf_cum[..., None, :]
    a = torch.where(mask, seg + ig[..., None, :], NEG_INF)  # (b,h,c,l,l)
    m_local = a.amax(dim=-1)                                # (b,h,c,l)
    if init is None:
        C = torch.zeros((b, h, d, d), dtype=f32, device=q.device)
        n = torch.zeros((b, h, d), dtype=f32, device=q.device)
        m = torch.full((b, h), NEG_INF, dtype=f32, device=q.device)
    else:
        C, n, m = (t.to(f32) for t in init)
    ys = []
    for c in range(nc):
        qc, kc, vc, lfc = qf[:, :, c], kf[:, :, c], vf[:, :, c], \
            lf_cum[:, :, c]
        m_in = lfc + m[..., None]                           # (b,h,l)
        m_new = torch.maximum(m_local[:, :, c], m_in)
        w = torch.exp(a[:, :, c] - m_new[..., None])        # (b,h,l,l)
        scores = torch.matmul(qc, kc.transpose(-1, -2)) * w
        num = torch.matmul(scores, vc)
        den = scores.sum(dim=-1)
        scale_in = torch.exp(m_in - m_new)
        num = num + torch.matmul(qc, C) * scale_in[..., None]
        den = den + (qc * n[..., None, :]).sum(dim=-1) * scale_in
        den = torch.maximum(den.abs(), torch.exp(-m_new))
        ys.append(num / den[..., None])
        total = lfc[..., -1]
        m_end = m_new[..., -1]
        w_end = torch.exp(ig[:, :, c] + total[..., None] - lfc
                          - m_end[..., None])
        decay = torch.exp(total + m - m_end)
        kw = kc * w_end[..., None]
        C = C * decay[..., None, None] + torch.matmul(kw.transpose(-1, -2),
                                                      vc)
        n = n * decay[..., None] + kw.sum(dim=-2)
        m = m_end
    y = torch.stack(ys, dim=2).movedim(1, 3).reshape(b, s, h, d)
    return y.to(q.dtype), (C, n, m)


def mlstm_decode_step(state: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                      qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor,
                      it: torch.Tensor, ft: torch.Tensor
                      ) -> Tuple[Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor], torch.Tensor]:
    """One stabilised mLSTM step in fp32 (``repro/kernels/ref.py``
    ``mlstm_decode_step``): state (C (b, h, d, d), n (b, h, d), m (b, h));
    qt/kt/vt (b, h, d); it/ft (b, h).  Returns (new state, yt (b, h, d)
    fp32)."""
    C, n, m = state
    f32 = torch.float32
    qt, kt, vt = qt.to(f32), kt.to(f32), vt.to(f32)
    it = it.to(f32)
    logf = _log_sigmoid(ft.to(f32))
    m_new = torch.maximum(logf + m, it)
    fs = torch.exp(logf + m - m_new)
    is_ = torch.exp(it - m_new)
    C = C * fs[..., None, None] + is_[..., None, None] * (
        kt[..., :, None] * vt[..., None, :])
    n = n * fs[..., None] + is_[..., None] * kt
    num = torch.einsum("bhdj,bhd->bhj", C, qt)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", n, qt).abs(),
                        torch.exp(-m_new))
    return (C, n, m_new), num / den[..., None]


def mlstm_sequential(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     i_gate: torch.Tensor, f_gate: torch.Tensor, *,
                     init: Optional[Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]] = None
                     ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                    torch.Tensor,
                                                    torch.Tensor]]:
    """Stepwise oracle (``repro/kernels/ref.py`` ``mlstm_sequential``,
    xLSTM eqs. 19-27): :func:`mlstm_decode_step` over every position from
    ``init`` or the zero state (m = -inf).  Returns (y in q's dtype,
    (C, n, m) fp32)."""
    b, s, h, d = q.shape
    f32 = torch.float32
    if init is None:
        state = (torch.zeros((b, h, d, d), dtype=f32, device=q.device),
                 torch.zeros((b, h, d), dtype=f32, device=q.device),
                 torch.full((b, h), float("-inf"), dtype=f32,
                            device=q.device))
    else:
        state = tuple(t.to(f32) for t in init)
    ys = []
    for t in range(s):
        state, yt = mlstm_decode_step(state, q[:, t], k[:, t], v[:, t],
                                      i_gate[:, t], f_gate[:, t])
        ys.append(yt)
    return torch.stack(ys, dim=1).to(q.dtype), state


# ---------------------------------------------------------------------------
# Grouped matmul over expert segments (MoE)
# ---------------------------------------------------------------------------
def moe_gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Batched expert matmul, the plain version of the ``moe_gmm`` kernel:
    x (E, C, K) times w (E, K, N), expert by expert, in fp32 (``x.float()``
    and ``w.float()``), cast once to x's dtype.  On the card the product
    stays full fp32: PyTorch's ``allow_tf32`` for matmuls is False by
    default and this function relies on it (TF32 would keep ~3 decimal
    digits)."""
    return torch.bmm(x.float(), w.float()).to(x.dtype)


def gmm(x: torch.Tensor, w: torch.Tensor,
        group_sizes: torch.Tensor) -> torch.Tensor:
    """Ragged grouped matmul (``repro/kernels/ref.py`` ``gmm``): rows of
    ``x`` are sorted by expert and ``group_sizes[e]`` consecutive rows use
    ``w[e]``.  x (T, K), w (E, K, N), group_sizes (E,) summing to T;
    returns (T, N) in x's dtype, computed in fp32.  An oracle for test
    sizes only: it gathers one (K, N) weight per row."""
    T, E = x.shape[0], w.shape[0]
    sizes = group_sizes.to(torch.int64)
    starts = torch.cumsum(sizes, 0) - sizes
    row = torch.arange(T, device=x.device)
    eid = (row[:, None] >= starts[None, :]).sum(dim=1) - 1
    eid = eid.clamp(0, E - 1)
    return torch.einsum("tk,tkn->tn", x.float(),
                        w[eid].float()).to(x.dtype)
