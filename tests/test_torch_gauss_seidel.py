"""Port parity: the Gauss–Seidel benchmark of ``repro_torch`` against the JAX
package's ``benchmarks/gauss_seidel.run_real``, all five versions under
both notify backends, on the CPU.

* ``block_impl=None`` — the unfused float64 path: grid bitwise, residuals
  within 1e-9 (numpy and torch sum the |new - old| terms in different
  orders).
* ``block_impl="ref"`` — the fused fp32 path: grid bitwise, residuals
  within rtol 1e-6 (the per-block fp32 residual sums in another order).
* one leg against the JAX package's Pallas kernel in interpret mode.

Each JAX reference is computed once per module.
"""

import functools

import numpy as np
import pytest
import torch

from benchmarks import gauss_seidel as jax_gs
from repro_torch.bench import gauss_seidel as gs

NOTIFY = ("polling", "continuation")
SIZE = dict(n_ranks=4, nby=2, nbx=2, bs=8, iters=2, seed=3)
RES_TOL = {None: dict(atol=1e-9, rtol=0.0), "ref": dict(atol=0.0,
                                                          rtol=1e-6)}


# The Pallas interpreter costs ~0.3 s a block: its leg runs 8 blocks.
PALLAS_SIZE = dict(n_ranks=4, nby=1, nbx=1, bs=8, iters=2, seed=3)


@functools.lru_cache(maxsize=None)
def _jax_reference(block_impl):
    size = PALLAS_SIZE if block_impl == "pallas_interpret" else SIZE
    return jax_gs.run_real("pure", block_impl=block_impl, **size)


def _assert_matches(port, want, tol):
    grid, stats = port
    ref_grid, ref_stats = want
    assert isinstance(grid, torch.Tensor) and grid.device.type == "cpu"
    np.testing.assert_array_equal(grid.double().numpy(), ref_grid)
    assert stats["residuals"].keys() == ref_stats["residuals"].keys()
    for it, v in ref_stats["residuals"].items():
        np.testing.assert_allclose(stats["residuals"][it], v, **tol)


@pytest.mark.parametrize("block_impl", [None, "ref"])
@pytest.mark.parametrize("notify", NOTIFY)
@pytest.mark.parametrize("version", gs.VERSIONS)
def test_run_real_matches_reference(version, notify, block_impl):
    port = gs.run_real(version, notify=notify, block_impl=block_impl,
                       device="cpu", **SIZE)
    assert port[0].dtype == (torch.float64 if block_impl is None
                             else torch.float32)
    _assert_matches(port, _jax_reference(block_impl), RES_TOL[block_impl])


def test_kernel_path_matches_pallas_interpret():
    """The default ``block_impl="cuda"`` on CPU tensors (the kernel
    wrapper's plain version) against the JAX package's Pallas kernel."""
    port = gs.run_real("interop-nonblk", device="cpu", **PALLAS_SIZE)
    _assert_matches(port, _jax_reference("pallas_interpret"),
                    RES_TOL["ref"])


def test_state_from_reference_is_bit_identical():
    rng = np.random.default_rng(0)
    blocks = [[rng.standard_normal((4, 4)) for _ in range(3)]
              for _ in range(2)]
    f64 = gs.state_from_reference(blocks, device="cpu", dtype=torch.float64)
    f32 = gs.state_from_reference(blocks, device="cpu", dtype=torch.float32)
    for gy in range(2):
        for gx in range(3):
            np.testing.assert_array_equal(f64[gy][gx].numpy(),
                                          blocks[gy][gx])
            np.testing.assert_array_equal(
                f32[gy][gx].numpy(), blocks[gy][gx].astype(np.float32))


def test_gs_block_is_the_reference_update():
    rng = np.random.default_rng(1)
    block, top, left, bottom, right = (rng.standard_normal(s) for s in
                                       ((5, 7), 7, 5, 7, 5))
    want = jax_gs.gs_block(block, top, left, bottom, right)
    got = gs.gs_block(*(torch.from_numpy(a) for a in
                        (block, top, left, bottom, right)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_geometry_helpers_match_reference():
    from repro.core import tac as jax_tac
    from repro_torch.core import tac
    for n in (1, 2, 4, 6, 9):
        assert gs.grid_dims(n) == jax_gs.grid_dims(n)
    cart = tac.CommWorld(6).cart_create(gs.grid_dims(6))
    jcart = jax_tac.CommWorld(6).cart_create(jax_gs.grid_dims(6))
    for r in range(6):
        for d in ((0, -1), (0, 1), (1, -1), (1, 1)):
            assert gs.edge_blocks(cart, 2, 3, r, d) == \
                jax_gs.edge_blocks(jcart, 2, 3, r, d)


@pytest.mark.parametrize("kw,match", [
    (dict(version="hybrid"), "version"),
    (dict(version="pure", block_impl="pallas"), "block_impl")])
def test_run_real_rejects_unknown_options(kw, match):
    with pytest.raises(ValueError, match=match):
        gs.run_real(device="cpu", **kw)


@pytest.mark.parametrize("version", ["pure", "interop-nonblk"])
@pytest.mark.parametrize("block_impl", [None, "cuda"])
def test_run_real_frees_its_blocks_without_gc(version, block_impl):
    """run_real's task closures form reference cycles with its frame; its
    blocks and edges must be freed when it returns, not at the collector's
    next pass (on the card, a full-size run's every generation would stay
    allocated until then)."""
    import gc

    def blocks():
        return sum(1 for o in gc.get_objects()
                   if isinstance(o, torch.Tensor)
                   and tuple(o.shape) == (SIZE["bs"], SIZE["bs"]))

    gc.collect()
    gc.disable()
    try:
        before = blocks()
        grid, stats = gs.run_real(version, block_impl=block_impl,
                                  device="cpu", **SIZE)
        del grid, stats
        assert blocks() == before
    finally:
        gc.enable()


def test_bench_smoke_on_the_cpu():
    """The reference's ``bench(smoke=True)`` through the port: five versions
    and both notify backends bitwise on the float64 path, the fused leg
    (``gs_stencil``'s plain version on the CPU) within 1e-4, and the
    simulated point with event-bound below sentinel, as the same rows."""
    rows = gs.bench(smoke=True, device="cpu", print_fn=lambda *_: None)
    legs = [f"gs_e2e_{v}_{nb}" for v in ("interop-blk", "interop-nonblk")
            for nb in NOTIFY]
    assert [r[0] for r in rows] == legs + ["gs_fused_stencil_interop"] + [
        f"gs_smoke_{v}" for v in gs.VERSIONS]
    for name, us, _ in rows[-len(gs.VERSIONS):]:
        v = name[len("gs_smoke_"):]
        assert us == jax_gs.simulate_version(v, n_ranks=4, nby=4, nbx=4,
                                             iters=4) * 1e6
