"""The serving kernels' launch plans (``gene2vec_tpu_torch/kernels/_topk.py``):
chunks, query groups, staged tiles, shared memory and scratch for every
``keep`` from 1 to past ``MERGE_MAX / 2`` — what the CUDA side of K7-K9r
(``csrc/topk_common.cuh``) is launched with.  CPU only."""

import pytest

from gene2vec_tpu_torch.kernels import _topk

V, D = 24447, 200
KEEPS = [1, 16, 64, 512, 2048, _topk.SORT_MAX, _topk.SORT_MAX + 1, _topk.MERGE_MAX, V]


def _check_regions(p, n, keep, batch):
    assert p.ntiles == -(-n // p.tile) and (p.ntiles - 1) * p.tile < n
    assert p.slot == min(keep, p.tile)
    # every query's region holds its chunks' runs, and its keep survivors
    # in whole SORT_MAX runs when they are sorted in device memory
    assert p.stride >= p.ntiles * p.slot
    if keep > _topk.SORT_MAX:
        assert p.stride >= -(-keep // _topk.SORT_MAX) * _topk.SORT_MAX
    assert p.scratch == batch * p.stride
    # the runs hold at least keep real rows: a sentinel is never selected
    assert sum(min(keep, min(p.tile, n - c * p.tile)) for c in range(p.ntiles)) >= keep


@pytest.mark.parametrize("kind", ["float32", "int8", "bfloat16"])
@pytest.mark.parametrize("batch", [1, 3, 64])
@pytest.mark.parametrize("keep", KEEPS)
def test_staged_plan_fits_and_covers_the_rows(kind, batch, keep):
    p = _topk.plan_staged(V, keep, batch, D, kind, sms=132)
    assert p.rows in (32, 64) and p.tile % p.rows == 0 and p.tile <= _topk.CHUNK_MAX
    assert p.qb == min(batch, _topk.QG_MAX)
    assert _topk.staged_smem(D, kind, p.qb, p.tile, p.rows) <= _topk.SMEM_BUDGET
    # about one block a multiprocessor: every query of a batch in one group
    assert p.ntiles * -(-batch // p.qb) <= 132
    _check_regions(p, V, keep, batch)


def test_staged_plan_at_the_main_shapes():
    """B 64, D 200: 64-row tiles, chunks of 192 rows, 128 blocks; the f32
    block within the card's 227 KB, the int8 block under half of it."""
    for kind, smem_max in (("float32", _topk.SMEM_BUDGET), ("int8", 112 * 1024)):
        p = _topk.plan_staged(V, 16, 64, D, kind, sms=132)
        assert (p.rows, p.tile, p.ntiles, p.slot) == (64, 192, 128, 16)
        assert _topk.staged_smem(D, kind, 64, p.tile, p.rows) <= smem_max


@pytest.mark.parametrize("d,kind", [(37, "float32"), (300, "float32"), (600, "float32"),
                                    (1000, "int8"), (600, "bfloat16")])
def test_staged_plan_shrinks_tiles_and_groups_for_wide_rows(d, kind):
    p = _topk.plan_staged(5000, 64, 64, d, kind, sms=132)
    assert _topk.staged_smem(d, kind, p.qb, p.tile, p.rows) <= _topk.SMEM_BUDGET
    assert p.qb <= 64 and p.rows in (32, 64)
    _check_regions(p, 5000, 64, 64)


def test_staged_plan_refuses_rows_no_block_holds():
    with pytest.raises(ValueError, match="do not fit"):
        _topk.plan_staged(5000, 16, 1, 20000, "float32", sms=132)


@pytest.mark.parametrize("per_query,n,batch", [(False, 625, 64), (False, 625, 1),
                                                (True, 1024, 64), (True, 65536, 3)])
@pytest.mark.parametrize("keep", [1, 8, 64, 1024])
def test_rows_plan_fits_and_covers_the_rows(per_query, n, batch, keep):
    if keep > n:
        keep = n
    qbytes = 800
    p = _topk.plan(n, keep, batch, qbytes, per_query, sms=132)
    assert p.rows == 0 and 64 <= p.tile <= _topk.CHUNK_MAX and p.tile % 64 == 0
    assert p.qb == 1 if per_query else 1 <= p.qb <= min(_topk.QB_MAX, batch)
    assert p.qb * (4 * p.tile + qbytes) + _topk.SELECT_BYTES <= _topk.SMEM_BUDGET
    _check_regions(p, n, keep, batch)


@pytest.mark.parametrize("planner", ["plan", "plan_staged"])
def test_plans_refuse_keep_outside_the_rows(planner):
    for keep in (0, 101):
        with pytest.raises(ValueError, match="keep"):
            if planner == "plan":
                _topk.plan(100, keep, 4, 800, False, sms=132)
            else:
                _topk.plan_staged(100, keep, 4, 200, "int8", sms=132)
