"""The plain versions of K12 (``stream_scale``, every scale, float32 and
bfloat16), K13 (``lane_gather`` / ``lane_scatter``) and K14
(``staged_copy``) against the Pallas probes they replace, run as written
in ``experiments/`` in interpret mode on the CPU (``pl.pallas_call`` is
patched with ``interpret=True``; the probe files are imported read-only).
The feature probes and ``callh`` are defined inside their files'
``main()``: their outputs are captured by patching the module's
``try_kernel``; ``vmem_probe`` returns a flag, so its output is captured
from the module's ``sync``.

Tolerances: copies, gathers and x·2 bitwise; the lane scatter within
1e-6 of each column's largest |value| at float32 and one bfloat16 ulp at
bfloat16 (the probe sums duplicates in an MXU dot, in another order than
the port's increasing j).
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from chip_smoke import LANE_PATTERNS, bf16_ulp, lane_offsets
from gene2vec_tpu_torch.kernels import lane, staged_copy, stream_scale

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCATTER_RTOL = 1e-6


class _Stop(Exception):
    """Ends a probe's ``main()`` once the kernel under test has run."""


@pytest.fixture
def probe(monkeypatch):
    """Loads ``experiments/<name>.py`` with every ``pallas_call`` in
    interpret mode."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))

    def load(name):
        spec = importlib.util.spec_from_file_location(
            f"probe_{name}", os.path.join(ROOT, "experiments", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    return load


def to_np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def to_torch(x):
    """A JAX array as a torch tensor of the same type (bfloat16 exactly)."""
    x = jnp.asarray(x)
    t = torch.from_numpy(np.asarray(x.astype(jnp.float32)).copy())
    return t.to(torch.bfloat16) if x.dtype == jnp.bfloat16 else t


def lane_inputs(mod, dtype):
    rng = np.random.RandomState(0)
    table = jnp.asarray(rng.randn(mod.D, mod.V).astype(np.float32)).astype(dtype)
    offs = jnp.asarray(rng.randint(0, mod.BUCKET, (8 * mod.NBUCKETS, mod.BUCKET))
                       .astype(np.int32))
    grads = jnp.asarray((rng.randn(mod.D, mod.V) * 0.01).astype(np.float32)).astype(dtype)
    return table, offs, grads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lane_gather_matches_bucketed_gather(probe, dtype):
    mod = probe("test_lane_gather")
    table, offs, _ = lane_inputs(mod, getattr(jnp, dtype))
    want = to_np(jax.jit(mod.bucketed_gather)(table, offs))
    got = lane.lane_gather(to_torch(table), torch.from_numpy(np.array(offs)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lane_scatter_matches_bucketed_scatter(probe, dtype):
    mod = probe("test_lane_gather")
    table, offs, grads = lane_inputs(mod, getattr(jnp, dtype))
    want = to_np(jax.jit(mod.bucketed_scatter)(table, grads, offs))
    got = lane.lane_scatter(to_torch(table), to_torch(grads),
                            torch.from_numpy(np.array(offs))).float().numpy()
    err = np.abs(got - want)
    if dtype == "float32":
        scale = np.abs(want).max(axis=0)
        assert (err.max(axis=0) <= SCATTER_RTOL * scale).all()
    else:
        assert (err <= bf16_ulp(torch, torch.from_numpy(want)).numpy()).all()
    # the probe's offsets repeat within a bucket: duplicates summed
    o = np.asarray(offs)[0]
    assert len(np.unique(o)) < len(o)
    t0 = to_np(table)
    assert np.abs(got - t0).max() > 0


def test_lane_wrappers_check_offsets():
    table = torch.zeros(4, 256)
    bad = torch.zeros(16, 128, dtype=torch.int32)
    bad[8, 3] = 128
    with pytest.raises(ValueError, match="outside"):
        lane.lane_gather(table, bad)
    with pytest.raises(ValueError, match="outside"):
        lane.lane_scatter(table, table, bad)


#: a small table for the pattern tests: the probe's BlockSpecs read the
#: module's D, V and NBUCKETS when it is called
SMALL_D, SMALL_NB = 24, 4


def small_lane_probe(probe):
    mod = probe("test_lane_gather")
    mod.D, mod.NBUCKETS = SMALL_D, SMALL_NB
    mod.V = SMALL_NB * mod.BUCKET
    return mod


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pattern", LANE_PATTERNS)
def test_lane_gather_matches_bucketed_gather_on_every_pattern(probe, pattern, dtype):
    """The plain gather against the probe on the tie-heavy and clamped
    offset patterns (the clamped offsets given to both), bitwise."""
    mod = small_lane_probe(probe)
    table, _, _ = lane_inputs(mod, getattr(jnp, dtype))
    given, clamped = lane_offsets(pattern, SMALL_NB)
    want = to_np(jax.jit(mod.bucketed_gather)(table, jnp.asarray(clamped)))
    got = lane.lane_gather(to_torch(table), torch.from_numpy(clamped))
    assert got.shape == (SMALL_D, mod.V)
    np.testing.assert_array_equal(got.float().numpy(), want)
    if pattern == "clamped":
        with pytest.raises(ValueError, match="outside"):
            lane.lane_gather(to_torch(table), torch.from_numpy(given))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pattern", LANE_PATTERNS)
def test_lane_scatter_matches_bucketed_scatter_on_every_pattern(probe, pattern, dtype):
    """The plain scatter against the probe's one-hot dot on the same
    patterns, within the module's scatter tolerance: a bucket's 128
    offsets on one column sum 128 contributors into it."""
    mod = small_lane_probe(probe)
    table, _, grads = lane_inputs(mod, getattr(jnp, dtype))
    given, clamped = lane_offsets(pattern, SMALL_NB)
    want = to_np(jax.jit(mod.bucketed_scatter)(table, grads, jnp.asarray(clamped)))
    got = lane.lane_scatter(to_torch(table), to_torch(grads),
                            torch.from_numpy(clamped)).float().numpy()
    err = np.abs(got - want)
    if dtype == "float32":
        assert (err.max(axis=0) <= SCATTER_RTOL * np.abs(want).max(axis=0)).all()
    else:
        assert (err <= bf16_ulp(torch, torch.from_numpy(want)).numpy()).all()
    # columns no offset names keep the table's values
    hit = np.zeros(mod.V, dtype=bool)
    for b in range(SMALL_NB):
        hit[b * mod.BUCKET + clamped[8 * b]] = True
    np.testing.assert_array_equal(got[:, ~hit], to_np(table)[:, ~hit])
    if pattern == "clamped":
        with pytest.raises(ValueError, match="outside"):
            lane.lane_scatter(to_torch(table), to_torch(grads), torch.from_numpy(given))


#: (kernel, d, v, element bytes, SMs) -> rows a tile
PLANS = [
    (("gather", 256, 24576, 4, 132), 32),    # the probe's shape: 1,536 tiles
    (("gather", 256, 24576, 2, 132), 64),    # 768 tiles of 16 KB
    (("scatter", 256, 24576, 4, 132), 32),
    (("scatter", 256, 24576, 2, 132), 32),
    (("scatter", 1024, 24576, 2, 132), 32),
    (("gather", 256, 128, 4, 132), 8),       # one bucket: rows split as far as they go
    (("scatter", 1, 128, 2, 132), 8),
    (("gather", 19, 1024, 2, 132), 8),
    (("scatter", 256, 24576, 4, 16), 32),
    (("gather", 256, 24576, 2, 1000), 8),    # a larger card takes smaller tiles
]


@pytest.mark.parametrize("args,rows", PLANS)
def test_lane_plan_rows(args, rows):
    assert lane.plan(*args) == rows


@pytest.mark.parametrize("kind", ["gather", "scatter"])
@pytest.mark.parametrize("es", [4, 2])
def test_lane_plan_bounds(kind, es):
    """Rows are a power of two from MIN_ROWS to MAX_ROWS; a plan halves
    only while the grid holds fewer than TILES_PER_SM tiles an SM, and a
    one-bucket table of more than 8 rows gets several blocks."""
    top = lane.MAX_ROWS[kind, es]
    for d in (1, 7, 8, 9, 64, 257, 1024, 5000):
        for nb in (1, 3, 192, 1000):
            for sms in (1, 78, 132, 264):
                rows = lane.plan(kind, d, nb * lane.BUCKET, es, sms)
                assert lane.MIN_ROWS <= rows <= top
                assert rows & (rows - 1) == 0
                if rows < top:
                    assert nb * -(-d // (2 * rows)) < lane.TILES_PER_SM * sms
                if rows > lane.MIN_ROWS:
                    assert nb * -(-d // rows) >= lane.TILES_PER_SM * sms
                if nb == 1 and d > 8:
                    assert -(-d // rows) > 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stream_scale_matches_stream_copy(probe, dtype):
    """``stream_copy``'s ``x · 1.0000001``: at bfloat16 the weak-typed
    constant rounds to 1.0, and the port's float32 multiply rounds back to
    x as well."""
    mod = probe("test_lane_gather")
    table, _, _ = lane_inputs(mod, getattr(jnp, dtype))
    want = to_np(jax.jit(mod.stream_copy)(table))
    got = stream_scale.stream_scale(to_torch(table)).float().numpy()
    np.testing.assert_array_equal(got, want)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, to_np(table))


@pytest.mark.parametrize("scale", [stream_scale.SCALE, 2.0, 1.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stream_scale_matches_the_streaming_probe(probe, scale, dtype):
    """K12 at each scale against ``pallas_copy_loop``'s kernel body run
    once (1.0000001, as written) and against XLA's x · scale (2 and 1)."""
    rng = np.random.RandomState(1)
    x = jnp.asarray(rng.randn(512, 256).astype(np.float32)).astype(getattr(jnp, dtype))
    if scale == stream_scale.SCALE:
        mod = probe("test_bw")
        monkey_scan = mod.SCAN
        mod.SCAN = 1
        try:
            want = to_np(mod.pallas_copy_loop(x.shape, x.dtype, 256)(x))
        finally:
            mod.SCAN = monkey_scan
    else:
        want = to_np(jax.jit(lambda v: v * scale)(x))
    got = stream_scale.stream_scale(to_torch(x), scale).float().numpy()
    np.testing.assert_array_equal(got, want)


def _captured_main(mod, wanted):
    """Run ``mod.main()`` with ``try_kernel`` recording (label, output,
    args); stops once every label in ``wanted`` has run."""
    seen = {}

    def try_kernel(label, fn, *args):
        out = jax.jit(fn)(*args)
        key = label.split(":")[0]
        seen[key] = (np.asarray(out), [np.asarray(a) for a in args])
        if wanted <= set(seen):
            raise _Stop
        return out

    mod.try_kernel = try_kernel
    with pytest.raises(_Stop):
        mod.main()
    return seen


#: feature probe → (scale, head, offset argument index or None)
FEATURES = {"a": (2.0, "all", 0), "b": (1.0, 0, None), "c": (2.0, 0, None),
            "d": (1.0, 0, None), "e": (1.0, 0, None), "f": (1.0, 8, 0)}


def test_staged_copy_matches_the_feature_probes(probe):
    mod = probe("test_feature_matrix")
    seen = _captured_main(mod, set(FEATURES))
    for name, (scale, head, off_arg) in FEATURES.items():
        out, args = seen[name]
        x = torch.from_numpy(args[-1])
        offset = torch.from_numpy(args[off_arg]) if off_arg is not None else None
        h = x.shape[0] if head == "all" else head
        got = staged_copy.staged_copy(x, scale, offset=offset, head=h)
        np.testing.assert_array_equal(got.numpy(), out, err_msg=name)
    # callf really shifted: out[0:8] = x[3:11]
    out, args = seen["f"]
    np.testing.assert_array_equal(out[:8], args[1][3:11])


def test_staged_copy_matches_callh(probe):
    mod = probe("test_dma2")
    seen = _captured_main(mod, {"h"})
    out, args = seen["h"]
    got = staged_copy.staged_copy(torch.from_numpy(args[0]), 2.0, tile_rows=8)
    np.testing.assert_array_equal(got.numpy(), out)


def test_staged_copy_matches_vmem_probe(probe):
    mod = probe("test_vmem_dma")
    outs = []
    mod.sync = lambda x: outs.append(np.asarray(x))
    assert mod.vmem_probe(8)
    (out,) = outs
    n = 8 * 1024 * 1024 // 4 // 256
    x = torch.ones((n, 256))
    for tile in (8, 64, 224):
        np.testing.assert_array_equal(staged_copy.staged_copy(x, 2.0, tile_rows=tile).numpy(),
                                      out)


def test_staged_copy_clamps_the_offset_and_checks_arguments():
    x = torch.arange(40, dtype=torch.float32).reshape(10, 4)
    got = staged_copy.staged_copy(x, 1.0, offset=torch.tensor([9], dtype=torch.int32), head=4)
    np.testing.assert_array_equal(got[:4].numpy(), x[6:10].numpy())  # clamped to N - head
    np.testing.assert_array_equal(got[4:].numpy(), x[:6].numpy())
    with pytest.raises(ValueError, match="offset"):
        staged_copy.staged_copy(x, head=2)
    with pytest.raises(ValueError, match="head"):
        staged_copy.staged_copy(x, head=11, offset=torch.zeros(1, dtype=torch.int32))
