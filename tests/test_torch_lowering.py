"""Port parity: the Level-B executor of ``repro_torch`` (``core.lowering``,
``core.overlap``, ``core.pipeline`` on a ``LogicalMesh``) against the JAX
package's lowerings on a forced 8-device CPU host.

jax locks its device count at first init, so ONE subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` runs every JAX
scenario and writes the inputs, the per-rank outputs and the lowered
``collective_permute`` counts to an ``.npz``; each test then runs the same
scenario on the port's logical ranks (CPU tensors, so the stage tier's
``"cuda"`` wrappers take their plain versions) and compares.

Tolerances:

* bitwise where the JAX tests are bitwise: explicit-round rings,
  butterflies and the hierarchical schedule in fp32, every stage tier
  against ``stage_impl=None``, and the bf16 wire;
* the int8 wire against the jnp oracle ``"ref"`` within 2e-6: the int8
  payloads are the same (a true division on both sides, checked bitwise
  in ``test_torch_kernels.py``), but XLA's CPU backend contracts the
  jitted oracle's dequant multiply-add into one FMA where the port rounds
  twice, as ``tests/test_kernels.py`` allows for the Pallas kernel;
* the int8 wire against ``"pallas_interpret"`` (which multiplies by
  ``1/scale``) within one quantisation step, and the narrow wires against
  the exact sum within 2e-2 (bf16) and 5e-2 (int8) of its largest
  magnitude, as ``tests/test_lowering.py`` states them;
* ``psum`` (native), whose summation order XLA picks: 1e-5.

``ppermute`` counts per rank equal the JAX program's
``collective_permute`` count and ``sends_per_rank(sched)`` (plus the
scale permutes of an int8 wire).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.bench import overlap as bench_overlap
from repro_torch.core import lowering, overlap, pipeline
from repro_torch.core import schedule as schedule_ir
from repro_torch.core.mesh import LogicalMesh

ROOT = os.path.join(os.path.dirname(__file__), "..")

_JAX_SCENARIOS = r'''
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro.core import lowering, overlap, pipeline

res = {}
devs = np.array(jax.devices())
assert len(devs) == 8, devs
rng = np.random.default_rng(12)
X8 = rng.standard_normal((8, 1000)).astype(np.float32)
X4 = rng.standard_normal((4, 1000)).astype(np.float32)
X6 = rng.standard_normal((6, 301)).astype(np.float32)
XPAD = rng.standard_normal((8, 173)).astype(np.float32)
XQ = (rng.standard_normal((8, 1003)) * 3).astype(np.float32)
HALO = rng.standard_normal((32, 5)).astype(np.float32)
G = {"w": rng.standard_normal((8, 64, 17)).astype(np.float32),
     "b": rng.standard_normal((8, 7)).astype(np.float32),
     "e": rng.standard_normal((8, 33, 5)).astype(np.float32)}
PW = (rng.standard_normal((4, 16, 16)) / 4).astype(np.float32)
PB = (rng.standard_normal((4, 16)) * 0.1).astype(np.float32)
PX = rng.standard_normal((6, 2, 16)).astype(np.float32)
for k, v in dict(X8=X8, X4=X4, X6=X6, XPAD=XPAD, XQ=XQ, HALO=HALO, PW=PW,
                 PB=PB, PX=PX).items():
    res["in_" + k] = v
for k, v in G.items():
    res["in_G_" + k] = v
INPUTS = dict(X8=X8, X4=X4, X6=X6, XPAD=XPAD)
SHAPES = {"X8": ((8,), ("data",)), "X4": ((4,), ("data",)),
          "X6": ((6,), ("data",)), "XPAD": ((8,), ("data",))}


def mesh(shape, names):
    return Mesh(devs[:int(np.prod(shape))].reshape(shape), names)


def spmd(m, f, *args):
    names = m.axis_names
    spec = P(names if len(names) > 1 else names[0])
    sf = jax.jit(shard_map(f, mesh=m, in_specs=spec, out_specs=spec,
                           axis_names=set(names), check_vma=False))
    out = sf(*args)
    return out, sf.lower(*args).as_text().count("collective_permute")


def allreduce_case(name, inp, shape=None, names=None, **kw):
    shape, names = (shape, names) if shape else SHAPES[inp]
    def f(xl):
        return lowering.allreduce(xl.reshape(-1), names, **kw)[None]
    out, npp = spmd(mesh(shape, names), f, INPUTS[inp])
    res[name] = np.asarray(out, np.float32)
    res[name + "__pp"] = np.int64(npp)


allreduce_case("ring_s1", "X8", algorithm="ring")
allreduce_case("ring_s4", "X8", algorithm="ring", segments=4)
allreduce_case("ring_pad", "XPAD", algorithm="ring", segments=3)
allreduce_case("doubling_8", "X8", algorithm="doubling")
allreduce_case("doubling_4", "X4", algorithm="doubling")
allreduce_case("doubling_6", "X6", algorithm="doubling")
allreduce_case("native_8", "X8")
allreduce_case("hier_2x2", "X4", (2, 2), ("pod", "data"),
               algorithm="hierarchical")
allreduce_case("hier_2x4", "X8", (2, 4), ("pod", "data"),
               algorithm="hierarchical")
allreduce_case("hier_3x2", "X6", (3, 2), ("pod", "data"),
               algorithm="hierarchical")
for impl in ("ref", "pallas_interpret"):
    for alg, seg in (("ring", 1), ("ring", 4), ("doubling", 1)):
        allreduce_case(f"stage_{alg}{seg}_{impl}", "X8", algorithm=alg,
                       segments=seg, stage_impl=impl)
    allreduce_case(f"stage_hier_2x4_{impl}", "X8", (2, 4), ("pod", "data"),
                   algorithm="hierarchical", stage_impl=impl)
    for wire in ("bf16", "int8"):
        allreduce_case(f"wire_{wire}_{impl}", "X8", algorithm="ring",
                       stage_impl=impl, stage_wire=wire)
allreduce_case("wire_int8_s2_ref", "XPAD", algorithm="ring", segments=2,
               stage_impl="ref", stage_wire="int8")


def sync_case(name, shape=(8,), names=("data",), **kw):
    kw.setdefault("bucket_bytes", 1 << 9)
    def f(g):
        g = jax.tree_util.tree_map(lambda a: a[0], g)
        g["e"] = g["e"].astype(jnp.bfloat16)
        out = overlap.sync_grads(g, axes=names, **kw)
        return jax.tree_util.tree_map(lambda a: a[None], out)
    tree = {k: jnp.asarray(v) for k, v in G.items()}
    out, npp = spmd(mesh(shape, names), f, tree)
    for k, v in out.items():
        res[f"{name}__{k}"] = np.asarray(v, np.float32)
    res[name + "__pp"] = np.int64(npp)


for mode in ("fused", "bucketed", "sentinel"):
    sync_case(f"sync_{mode}_ring", mode=mode, algorithm="ring")
sync_case("sync_bucketed_ring_seg2", mode="bucketed", algorithm="ring",
          segments=2)
sync_case("sync_bucketed_native", mode="bucketed")
sync_case("sync_fused_leaf", mode="fused", algorithm="ring",
          reduce_dtype="leaf")
sync_case("sync_bucketed_ring_ref", mode="bucketed", algorithm="ring",
          stage_impl="ref")
sync_case("sync_fused_bf16wire_ref", mode="fused", algorithm="ring",
          stage_impl="ref", stage_wire="bf16")
sync_case("sync_fused_int8wire_ref", mode="fused", algorithm="ring",
          stage_impl="ref", stage_wire="int8")
sync_case("sync_bucketed_compress_bf16", mode="bucketed", algorithm="ring",
          compress="bf16")
sync_case("sync_fused_compress_int8", mode="fused", compress="int8")
sync_case("sync_bucketed_hier", (2, 4), ("pod", "data"), mode="bucketed",
          hierarchical=True)


def qpm(xl):
    return overlap.quantized_psum_mean(xl.reshape(-1), "data")[None]
out, _ = spmd(mesh((8,), ("data",)), qpm, XQ)
res["qpm"] = np.asarray(out)


def halo(xl):
    t, b = overlap.halo_exchange_rows(xl, "data", width=1)
    return jnp.concatenate([t, b], axis=0)
out, npp = spmd(mesh((8,), ("data",)), halo, HALO)
res["halo"] = np.asarray(out)
res["halo__pp"] = np.int64(npp)


def stage_fn(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])
res["pipeline"] = np.asarray(pipeline.pipeline_apply(
    stage_fn, {"w": jnp.asarray(PW), "b": jnp.asarray(PB)},
    jnp.asarray(PX), mesh=mesh((4,), ("stage",))))
np.savez(sys.argv[1], **res)
print("JAX-SCENARIOS-OK")
'''


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    path = tmp_path_factory.mktemp("lowering") / "jax.npz"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", _JAX_SCENARIOS, str(path)],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return dict(np.load(path))


# the jitted oracle's FMA-contracted dequant-add (see the module docstring)
INT8_FMA_ATOL = 2e-6

MESHES = {"X8": ((8,), ("data",)), "X4": ((4,), ("data",)),
          "X6": ((6,), ("data",)), "XPAD": ((8,), ("data",))}


def _run_allreduce(jax_out, inp, shape=None, names=None, **kw):
    shape, names = (shape, names) if shape else MESHES[inp]
    mesh = LogicalMesh(shape, names, device="cpu")
    xs = [torch.from_numpy(x.copy()) for x in jax_out["in_" + inp]]
    out = lowering.allreduce(xs, names, mesh=mesh, **kw)
    for o in out[1:]:
        assert torch.equal(o, out[0])           # ranks bitwise equal
    return np.stack([o.numpy() for o in out]), mesh


def _exact_sum(jax_out, inp):
    return jax_out["in_" + inp].astype(np.float64).sum(axis=0)


EXPLICIT = [
    ("ring_s1", "X8", None, None, dict(algorithm="ring")),
    ("ring_s4", "X8", None, None, dict(algorithm="ring", segments=4)),
    ("ring_pad", "XPAD", None, None, dict(algorithm="ring", segments=3)),
    ("doubling_8", "X8", None, None, dict(algorithm="doubling")),
    ("doubling_4", "X4", None, None, dict(algorithm="doubling")),
    ("hier_2x2", "X4", (2, 2), ("pod", "data"),
     dict(algorithm="hierarchical")),
    ("hier_2x4", "X8", (2, 4), ("pod", "data"),
     dict(algorithm="hierarchical")),
]


def _sched_of(name, kw, shape):
    if kw["algorithm"] == "hierarchical":
        return schedule_ir.build_hierarchical(shape[1], shape[0])
    return schedule_ir.build("allreduce", kw["algorithm"],
                             int(np.prod(shape)),
                             segments=kw.get("segments", 1))


@pytest.mark.parametrize("stage_impl", [None, "ref", "cuda"])
@pytest.mark.parametrize("name,inp,shape,names,kw", EXPLICIT)
def test_explicit_rounds_bitwise_and_counts(jax_out, name, inp, shape,
                                            names, kw, stage_impl):
    """Every explicit-round lowering equals the JAX package's bitwise in
    fp32, whatever the stage tier, with one ppermute per schedule send."""
    got, mesh = _run_allreduce(jax_out, inp, shape, names,
                               stage_impl=stage_impl, **kw)
    np.testing.assert_array_equal(got, jax_out[name])
    assert np.max(np.abs(got[0] - _exact_sum(jax_out, inp))) < 1e-3
    sched = _sched_of(name, kw, shape or MESHES[inp][0])
    want = lowering.sends_per_rank(sched)
    assert int(jax_out[name + "__pp"]) == want
    assert mesh.coll_calls["ppermute"] == [want] * mesh.size


@pytest.mark.parametrize("jax_impl", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("alg,seg", [("ring", 1), ("ring", 4),
                                     ("doubling", 1), ("hier", 1)])
def test_stage_tier_matches_jax_stage_tier(jax_out, alg, seg, jax_impl):
    for port_impl in ("ref", "cuda"):
        if alg == "hier":
            got, _ = _run_allreduce(jax_out, "X8", (2, 4), ("pod", "data"),
                                    algorithm="hierarchical",
                                    stage_impl=port_impl)
            want = jax_out[f"stage_hier_2x4_{jax_impl}"]
        else:
            got, _ = _run_allreduce(jax_out, "X8", algorithm=alg,
                                    segments=seg, stage_impl=port_impl)
            want = jax_out[f"stage_{alg}{seg}_{jax_impl}"]
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("wire,jax_impl", [
    ("bf16", "ref"), ("bf16", "pallas_interpret"), ("int8", "ref"),
    ("int8", "pallas_interpret")])
@pytest.mark.parametrize("port_impl", ["ref", "cuda"])
def test_wire_dtypes(jax_out, wire, jax_impl, port_impl):
    got, mesh = _run_allreduce(jax_out, "X8", algorithm="ring",
                               stage_impl=port_impl, stage_wire=wire)
    want = jax_out[f"wire_{wire}_{jax_impl}"]
    if wire == "int8" and jax_impl == "pallas_interpret":
        # multiply by 1/scale vs divide: a .5 boundary may round apart,
        # one quantisation step of the largest chunk scale
        step = np.max(np.abs(_exact_sum(jax_out, "X8"))) / 127 * 8
        assert np.max(np.abs(got - want)) <= step
    elif wire == "int8":
        np.testing.assert_allclose(got, want, rtol=0, atol=INT8_FMA_ATOL)
    else:
        np.testing.assert_array_equal(got, want)
    exact = _exact_sum(jax_out, "X8")
    rel = np.max(np.abs(got[0] - exact)) / np.max(np.abs(exact))
    assert rel < {"bf16": 2e-2, "int8": 5e-2}[wire]
    ring = schedule_ir.build("allreduce", "ring", 8)
    extra = 2 * 7 if wire == "int8" else 0
    want_pp = lowering.sends_per_rank(ring) + extra
    assert int(jax_out[f"wire_{wire}_{jax_impl}__pp"]) == want_pp
    assert mesh.coll_calls["ppermute"] == [want_pp] * 8


def test_int8_wire_segmented_with_padding(jax_out):
    got, mesh = _run_allreduce(jax_out, "XPAD", algorithm="ring",
                               segments=2, stage_impl="cuda",
                               stage_wire="int8")
    np.testing.assert_allclose(got, jax_out["wire_int8_s2_ref"], rtol=0,
                               atol=INT8_FMA_ATOL)
    ring = schedule_ir.build("allreduce", "ring", 8, segments=2)
    want = lowering.sends_per_rank(ring) + 2 * 7 * 2
    assert mesh.coll_calls["ppermute"] == [want] * 8
    assert int(jax_out["wire_int8_s2_ref__pp"]) == want


@pytest.mark.parametrize("name,inp,shape,names,kw", [
    ("native_8", "X8", None, None, {}),
    ("doubling_6", "X6", None, None, dict(algorithm="doubling")),
    ("hier_3x2", "X6", (3, 2), ("pod", "data"),
     dict(algorithm="hierarchical")),
])
def test_psum_legs_within_tolerance(jax_out, name, inp, shape, names, kw):
    """One psum node (native, non-power-of-two doubling, and the inter
    stage of a 3-pod hierarchy): XLA picks its summation order."""
    got, mesh = _run_allreduce(jax_out, inp, shape, names, **kw)
    np.testing.assert_allclose(got, jax_out[name], atol=1e-5, rtol=1e-5)
    pp = int(jax_out[name + "__pp"])
    assert mesh.coll_calls["ppermute"] == [pp] * mesh.size


SYNC_BUCKET_BYTES = 1 << 9


def _port_grads(jax_out, n=8):
    trees = [{"w": jax_out["in_G_w"][r], "b": jax_out["in_G_b"][r],
              "e": jax_out["in_G_e"][r].astype(np.float32)}
             for r in range(n)]
    grads = bench_overlap.grads_from_reference(trees, device="cpu")
    for g in grads:
        g["e"] = g["e"].to(torch.bfloat16)
    return grads


SYNC = [
    ("sync_fused_ring", dict(mode="fused", algorithm="ring")),
    ("sync_bucketed_ring", dict(mode="bucketed", algorithm="ring")),
    ("sync_sentinel_ring", dict(mode="sentinel", algorithm="ring")),
    ("sync_bucketed_ring_seg2", dict(mode="bucketed", algorithm="ring",
                                     segments=2)),
    ("sync_fused_leaf", dict(mode="fused", algorithm="ring",
                             reduce_dtype="leaf")),
    ("sync_bucketed_ring_ref", dict(mode="bucketed", algorithm="ring",
                                    stage_impl="ref")),
    ("sync_bucketed_ring_ref", dict(mode="bucketed", algorithm="ring",
                                    stage_impl="cuda")),
    ("sync_fused_bf16wire_ref", dict(mode="fused", algorithm="ring",
                                     stage_impl="cuda", stage_wire="bf16")),
    ("sync_fused_int8wire_ref", dict(mode="fused", algorithm="ring",
                                     stage_impl="cuda", stage_wire="int8")),
    ("sync_bucketed_compress_bf16", dict(mode="bucketed", algorithm="ring",
                                         compress="bf16")),
    ("sync_bucketed_hier", dict(mode="bucketed", hierarchical=True)),
]


@pytest.mark.parametrize("name,kw", SYNC,
                         ids=[f"{n}-{k.get('stage_impl')}" for n, k in SYNC])
def test_sync_grads_bitwise(jax_out, name, kw):
    """sync_grads in every mode over a tree with fp32 and bf16 leaves
    (512-byte buckets: two for the fp32 presentation): bitwise, leaf dtypes kept, ppermute counts
    equal, and only the sentinel waits."""
    hier = kw.get("hierarchical", False)
    mesh = (LogicalMesh((2, 4), ("pod", "data"), "cpu") if hier
            else LogicalMesh((8,), ("data",), "cpu"))
    out = overlap.sync_grads(_port_grads(jax_out), mesh=mesh,
                             axes=mesh.axis_names, bucket_bytes=SYNC_BUCKET_BYTES,
                             **kw)
    for r, tree in enumerate(out):
        assert tree["e"].dtype == torch.bfloat16
        assert tree["w"].dtype == tree["b"].dtype == torch.float32
        for k, v in tree.items():
            want = jax_out[f"{name}__{k}"][r]
            if "int8wire" in name:
                np.testing.assert_allclose(v.float().numpy(), want, rtol=0,
                                           atol=INT8_FMA_ATOL)
            else:
                np.testing.assert_array_equal(v.float().numpy(), want)
    assert mesh.coll_calls["ppermute"] == \
        [int(jax_out[name + "__pp"])] * mesh.size
    waits = mesh.token_waits[0]
    assert mesh.token_waits == [waits] * mesh.size
    assert (waits > 0) == (kw["mode"] == "sentinel")


def test_sync_grads_native_within_tolerance(jax_out):
    mesh = LogicalMesh((8,), ("data",), "cpu")
    out = overlap.sync_grads(_port_grads(jax_out), mesh=mesh, axes="data",
                             mode="bucketed", bucket_bytes=SYNC_BUCKET_BYTES)
    for r, tree in enumerate(out):
        for k, v in tree.items():
            # psum's order is XLA's; a bf16 leaf may round one ulp apart
            tol = 2 ** -7 if k == "e" else 1e-6
            np.testing.assert_allclose(
                v.float().numpy(), jax_out[f"sync_bucketed_native__{k}"][r],
                atol=tol, rtol=tol)
    assert mesh.coll_calls["ppermute"] == [0] * 8


def test_sync_grads_compress_int8(jax_out):
    """compress="int8": the quantised all-to-all path; the port's fp32
    sum of the dequantised shards may round apart from XLA's and move a
    re-quantised value by one step of the second scale."""
    mesh = LogicalMesh((8,), ("data",), "cpu")
    out = overlap.sync_grads(_port_grads(jax_out), mesh=mesh, axes="data",
                             mode="fused", compress="int8")
    for r, tree in enumerate(out):
        for k, v in tree.items():
            want = jax_out[f"sync_fused_compress_int8__{k}"][r]
            step = np.max(np.abs(want)) / 127 * 2
            assert np.max(np.abs(v.float().numpy() - want)) <= step
    assert mesh.coll_calls["ppermute"] == [0] * 8


def test_sync_grads_sentinel_equals_bucketed_and_waits(jax_out):
    mesh_b = LogicalMesh((8,), ("data",), "cpu")
    mesh_s = LogicalMesh((8,), ("data",), "cpu")
    kw = dict(axes="data", algorithm="ring", bucket_bytes=SYNC_BUCKET_BYTES,
              stage_impl="cuda")
    b = overlap.sync_grads(_port_grads(jax_out), mesh=mesh_b,
                           mode="bucketed", **kw)
    s = overlap.sync_grads(_port_grads(jax_out), mesh=mesh_s,
                           mode="sentinel", **kw)
    for tb, ts in zip(b, s):
        for k in tb:
            assert torch.equal(tb[k], ts[k])
    n_buckets = len(overlap._make_buckets(
        [4 * n for n in (7, 33 * 5, 64 * 17)], SYNC_BUCKET_BYTES))
    assert n_buckets == 2
    assert mesh_b.token_waits == [0] * 8
    assert mesh_s.token_waits == [n_buckets - 1] * 8


def test_quantized_psum_mean(jax_out):
    mesh = LogicalMesh((8,), ("data",), "cpu")
    xs = [torch.from_numpy(x.copy()) for x in jax_out["in_XQ"]]
    out = overlap.quantized_psum_mean(xs, "data", mesh=mesh)
    want = jax_out["qpm"]
    assert want.shape == (8, 1003)
    for r, o in enumerate(out):
        step = np.max(np.abs(want[r])) / 127
        assert np.max(np.abs(o.numpy() - want[r])) <= step
    mean = jax_out["in_XQ"].mean(axis=0)
    assert np.max(np.abs(out[0].numpy() - mean)) / np.max(np.abs(mean)) < 5e-2


def test_halo_exchange_rows(jax_out):
    mesh = LogicalMesh((8,), ("data",), "cpu")
    g = torch.from_numpy(jax_out["in_HALO"].copy())
    tops, bottoms = overlap.halo_exchange_rows(
        [g[4 * r:4 * r + 4] for r in range(8)], "data", mesh=mesh)
    want = jax_out["halo"]
    for r in range(8):
        np.testing.assert_array_equal(tops[r].numpy()[0], want[2 * r])
        np.testing.assert_array_equal(bottoms[r].numpy()[0],
                                      want[2 * r + 1])
    assert torch.count_nonzero(tops[0]) == 0
    assert torch.count_nonzero(bottoms[7]) == 0
    assert mesh.coll_calls["ppermute"] == \
        [int(jax_out["halo__pp"])] * 8 == [2] * 8


def test_pipeline_apply(jax_out):
    S, M = 4, 6
    mesh = LogicalMesh((S,), ("stage",), "cpu")
    params = {"w": torch.from_numpy(jax_out["in_PW"].copy()),
              "b": torch.from_numpy(jax_out["in_PB"].copy())}

    def stage_fn(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    out = pipeline.pipeline_apply(stage_fn, params,
                                  torch.from_numpy(jax_out["in_PX"].copy()),
                                  mesh=mesh)
    np.testing.assert_allclose(out.numpy(), jax_out["pipeline"], atol=1e-5,
                               rtol=1e-5)
    assert mesh.coll_calls["ppermute"] == [M + S - 1] * S
    assert abs(pipeline.bubble_fraction(4, 6) - 3 / 9) < 1e-12


def test_stage_option_validation():
    mesh = LogicalMesh((8,), ("data",), "cpu")
    xs = [torch.zeros(8) for _ in range(8)]
    for bad in (dict(algorithm="native", stage_impl="ref"),
                dict(algorithm="native", stage_wire="bf16"),
                dict(algorithm="doubling", stage_impl="ref",
                     stage_wire="bf16"),
                dict(algorithm="ring", stage_wire="bf16")):
        with pytest.raises(ValueError):
            lowering.allreduce(xs, "data", mesh=mesh, **bad)
    for jax_only in ("pallas", "pallas_interpret"):
        with pytest.raises(ValueError, match="cuda"):
            lowering.allreduce(xs, "data", mesh=mesh, algorithm="ring",
                               stage_impl=jax_only)
    with pytest.raises(ValueError, match="two DP axes"):
        overlap.sync_grads([{"w": x} for x in xs], mesh=mesh, axes="data",
                           hierarchical=True)
    with pytest.raises(ValueError, match="int8"):
        overlap.sync_grads([{"w": x} for x in xs], mesh=mesh, axes="data",
                           compress="int8", stage_impl="ref")


def test_inplace_overwrites_only_when_asked():
    mesh = LogicalMesh((4,), ("data",), "cpu")
    xs = [torch.full((8,), float(r)) for r in range(4)]
    keep = [x.clone() for x in xs]
    out = lowering.allreduce(xs, "data", mesh=mesh, algorithm="ring")
    assert all(torch.equal(x, k) for x, k in zip(xs, keep))
    out2 = lowering.allreduce(xs, "data", mesh=mesh, algorithm="ring",
                              inplace=True)
    assert all(torch.equal(x, o) for x, o in zip(xs, out2))
    assert all(torch.equal(o, out[0]) for o in out2)


def test_logical_mesh_axes_and_ppermute_zeros():
    mesh = LogicalMesh((2, 3), ("pod", "data"), "cpu")
    assert mesh.axis_size(("pod", "data")) == 6
    assert [mesh.axis_index(r, "data") for r in range(6)] == [0, 1, 2] * 2
    assert [mesh.axis_index(r, "pod") for r in range(6)] == [0] * 3 + [1] * 3
    assert mesh.groups("pod") == [[0, 3], [1, 4], [2, 5]]
    xs = [torch.full((2,), float(r + 1)) for r in range(6)]
    got = mesh.ppermute(xs, "data", [(0, 1), (1, 2)])
    assert [float(g[0]) for g in got] == [0.0, 1.0, 2.0, 0.0, 4.0, 5.0]
    assert mesh.coll_calls["ppermute"] == [1] * 6
    summed = mesh.psum(xs, "pod")
    assert [float(s[0]) for s in summed] == [5.0, 7.0, 9.0] * 2
    with pytest.raises(ValueError, match="permutation"):
        mesh.ppermute(xs, "data", [(0, 1), (2, 1)])
    if not torch.cuda.is_available():       # no device named: CUDA or raise
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LogicalMesh((2,), ("data",))


def test_hubert_xlarge_grad_shapes_match_the_model():
    """The port's copy of hubert-xlarge's gradient tree equals
    ``jax.eval_shape(model.init)`` of the JAX package's config, leaf for
    leaf in tree order (eval_shape allocates nothing)."""
    import jax
    from repro import configs
    from repro.models import model
    cfg = configs.get("hubert_xlarge")
    tree = jax.eval_shape(lambda k: model.init(cfg, k),
                          jax.random.PRNGKey(0))
    want = [(jax.tree_util.keystr(p), tuple(l.shape), str(l.dtype))
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]]
    got = bench_overlap.hubert_xlarge_grad_shapes()
    assert [(("".join(f"['{k}']" for k in p.split("/"))), s,
             str(d).replace("torch.", "")) for p, s, d in got] == want
    assert sum(int(np.prod(s)) for _, s, _ in got) == 944_611_840
    counts = bench_overlap.expected_counts("bucketed")
    assert counts["reductions"] == 7


def test_grads_from_reference_keeps_order_and_bits():
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    trees = [{"z": {"b": jnp.asarray(rng.standard_normal(5), jnp.bfloat16),
                    "a": jnp.asarray(rng.standard_normal((2, 3)),
                                     jnp.float32)},
              "lm": jnp.asarray(rng.standard_normal(4), jnp.bfloat16)}
             for _ in range(2)]
    host = [jax.tree_util.tree_map(np.asarray, t) for t in trees]
    port = bench_overlap.grads_from_reference(host, device="cpu")
    for t, p in zip(trees, port):
        want = jax.tree_util.tree_leaves(t)
        got, _ = overlap.tree_flatten(p)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert str(g.dtype).replace("torch.", "") == str(w.dtype)
            np.testing.assert_array_equal(g.float().numpy(),
                                          np.asarray(w, np.float32))


def test_run_sync_on_cpu_small_tree():
    shapes = [("w", (64, 17), torch.float32), ("e", (33, 5), torch.bfloat16)]
    for mode in ("fused", "bucketed", "sentinel"):
        run = bench_overlap.run_sync(mode, device="cpu", shapes=shapes,
                                     bucket_bytes=1024, stage_wire="int8")
        exp = bench_overlap.expected_counts(mode, shapes=shapes,
                                            bucket_bytes=1024,
                                            stage_wire="int8")
        assert run["ppermute_calls"] == [exp["ppermute_per_rank"]] * 4
        assert run["token_waits"] == [exp["token_waits_per_rank"]] * 4
        assert run["launches"] == {k: 0 for k in bench_overlap.KERNELS}
        assert run["seconds"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("wire", [None, "bf16", "int8"])
def test_sync_grads_on_card_matches_plain(wire):
    """On the card the kernel tier equals the plain tier bitwise, all
    ranks agree, and the kernels were launched the derived times."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    shapes = [("w", (64, 17), torch.float32), ("e", (33, 5), torch.bfloat16),
              ("b", (7,), torch.float32)]
    grads = bench_overlap.make_grads(4, seed=1, device="cuda", shapes=shapes)
    runs = {impl: bench_overlap.run_sync(
        "bucketed", stage_impl=impl, stage_wire=wire, grads=grads,
        bucket_bytes=512, device="cuda") for impl in ("cuda", "ref")}
    exp = bench_overlap.expected_counts("bucketed", stage_wire=wire,
                                        shapes=shapes, bucket_bytes=512)
    assert runs["cuda"]["launches"] == exp["launches"]
    for tree in runs["cuda"]["results"] + runs["ref"]["results"]:
        for k, v in tree.items():
            assert torch.equal(v, runs["cuda"]["results"][0][k])
