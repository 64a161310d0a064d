"""The serving kernels' launch plans (``gene2vec_tpu_torch/kernels/_topk.py``):
chunks, query groups, staged tiles, shared memory and scratch for every
``keep`` from 1 to past ``MERGE_MAX / 2`` — what the CUDA side of K7-K9r
(``csrc/topk_common.cuh``) is launched with — and the routes of K9's
probe and of the list scans (K9's scan, K9r).  CPU only."""

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


#: (n, keep, batch, d, kind, word) -> (route, blocks a query, lanes a row):
#: K9's scan (n = nprobe * L, keep r) and K9r (n = r, keep k) at the
#: serving shapes, and lists past what a block holds
LIST_ROUTES = [
    ((1024, 64, 64, 200, "int8", 8), (0, 2, 8)),        # K9 at MAIN_SHAPE: 2-block clusters
    ((1024, 1024, 64, 200, "int8", 8), (0, 2, 8)),      # K9 at kb 512: r = n
    ((1024, 64, 1, 200, "int8", 8), (0, 4, 8)),         # one query: 256 positions a block
    ((1024, 64, 64, 200, "bfloat16", 16), (0, 2, 8)),
    ((64, 16, 64, 200, "float32", 16), (0, 1, 16)),     # K9r at MAIN_SHAPE: one block
    ((2048, 512, 64, 200, "float32", 16), (0, 2, 16)),  # K9r at kb 512
    ((2048, 512, 1, 200, "float32", 16), (0, 8, 16)),   # one query, a long list: 8 blocks
    ((64, 16, 64, 37, "int8", 1), (0, 1, 16)),          # byte words
    ((64, 16, 64, 1024, "float32", 16), (0, 1, 32)),    # wide rows: lanes cap at 32
    ((16384, 512, 64, 200, "float32", 16), (0, 2, 16)),  # the longest server bucket
    ((40000, 64, 3, 200, "float32", 16), (0, 8, 16)),   # past a block: a cluster of 8
    ((300000, 64, 3, 200, "float32", 16), (1, None, 16)),  # past a cluster: chunks
    ((24447, 16384, 64, 200, "int8", 8), (1, None, 8)),  # keep past SORT_MAX: chunks
]


@pytest.mark.parametrize("args,want", LIST_ROUTES)
def test_list_plan_routes_at_the_serving_shapes(args, want):
    n, keep, batch, d, kind, word = args
    p = _topk.plan_list(n, keep, batch, d, kind, word, 32, sms=132)
    route, nseg, lanes = want
    assert (p.route, p.lanes) == (route, lanes)
    if nseg is not None:
        assert p.nseg == nseg
    assert p.smem <= _topk.SMEM_BUDGET
    assert p.describe()


@pytest.mark.parametrize("kind,d", [("int8", 200), ("bfloat16", 1520), ("float32", 1024)])
@pytest.mark.parametrize("batch", [1, 64])
@pytest.mark.parametrize("n,keep", [(16, 1), (1024, 64), (5000, 5000), (30000, 512),
                                    (9000, 8193)])
def test_list_plan_fits_and_covers_the_list(kind, d, batch, n, keep):
    word = _topk.list_word(d, kind, 256)
    p = _topk.plan_list(n, keep, batch, d, kind, word, 4 * 8, sms=132)
    assert p.nseg * p.share >= n and (p.nseg - 1) * p.share < n
    assert 1 <= p.lanes <= 32 and p.lanes & (p.lanes - 1) == 0
    qbytes = _topk.list_query_bytes(d, kind)
    if p.route == 0:  # a block's pairs, the leader's candidates and the sort fit
        assert keep <= _topk.SORT_MAX and 1 <= p.nseg <= _topk.CLUSTER_MAX
        ncand = p.nseg * min(keep, p.share) if p.nseg > 1 else 0
        sort = _topk.next_pow2(min(keep, ncand or p.share))
        assert p.smem == _topk.list_smem(p.share, ncand, sort, qbytes, 32)
    else:  # the runs hold at least keep entries; the long-list survivors fit
        assert p.slot == min(keep, p.share) and p.nseg * p.slot >= keep
        assert p.stride >= p.nseg * p.slot
        if keep > _topk.SORT_MAX:
            assert p.stride >= -(-keep // _topk.SORT_MAX) * _topk.SORT_MAX
        assert p.smem == _topk.list_smem(p.share, 0, 0, qbytes, 32)
    assert p.smem <= _topk.SMEM_BUDGET


def _longest(fits, start: int) -> int:
    n = start  # fits(start)
    while fits(2 * n):
        n *= 2
    lo, hi = n, 2 * n  # fits(lo), not fits(hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    return lo


@pytest.mark.parametrize("kind,d", [("float32", 200), ("int8", 200), ("bfloat16", 1520)])
def test_list_plan_takes_the_chunked_route_past_a_cluster(kind, d):
    """Lists past the longest one block holds go to a cluster (route 0, one
    launch), which holds about CLUSTER_MAX times as many; past it (or past
    SORT_MAX kept) the chunked route takes over."""
    word = _topk.list_word(d, kind, 256)
    qbytes = _topk.list_query_bytes(d, kind)
    keep = 64
    one = _longest(lambda n: _topk.list_smem(n, 0, keep, qbytes, 0) <= _topk.SMEM_BUDGET, keep)
    p = _topk.plan_list(one + 1, keep, 3, d, kind, word, 0, sms=132)
    assert p.route == 0 and p.nseg > 1
    most = _longest(lambda n: _topk.plan_list(n, keep, 3, d, kind, word, 0, sms=132).route == 0,
                    keep)
    assert 7 * one <= most <= 8 * one
    assert _topk.plan_list(most, keep, 3, d, kind, word, 0, sms=132).nseg == _topk.CLUSTER_MAX
    assert _topk.plan_list(most + 1, keep, 3, d, kind, word, 0, sms=132).route == 1
    assert _topk.plan_list(9000, _topk.SORT_MAX, 3, d, kind, word, 0, sms=132).route == 0
    assert _topk.plan_list(9000, _topk.SORT_MAX + 1, 3, d, kind, word, 0, sms=132).route == 1


def test_list_word_follows_width_and_address():
    assert _topk.list_word(200, "int8", 256) == 8
    assert _topk.list_word(200, "int8", 260) == 4
    assert _topk.list_word(37, "int8", 256) == 1
    assert _topk.list_word(200, "float32", 256) == 16
    assert _topk.list_word(37, "float32", 256) == 4
    assert _topk.list_word(1520, "bfloat16", 256) == 16
    assert _topk.list_word(37, "bfloat16", 256) == 2
    assert _topk.list_word(38, "bfloat16", 256) == 4


@pytest.mark.parametrize("c,d,batch", [(625, 200, 64), (625, 200, 1), (625, 200, 3),
                                       (40, 37, 5), (625, 1024, 64), (300, 13000, 2)])
def test_probe_plan_fits_and_splits_the_centroids(c, d, batch):
    nprobe = min(8, c)
    p = _topk.plan_probe(c, nprobe, batch, d, True, sms=132)
    assert 1 <= p.cluster <= min(_topk.CLUSTER_MAX, c) and p.cluster & (p.cluster - 1) == 0
    assert p.share * p.cluster >= c and 1 <= p.rows <= p.share
    assert 1 <= p.qg <= batch and p.qpt in (1, 2, 4) and p.qpt >= min(p.qg, 4) // 2
    assert p.cp == int(d % 4 == 0)
    assert p.smem == _topk.probe_smem(c, nprobe, d, p.qg, p.qpt, p.cluster, p.rows, p.tstride)
    assert p.smem <= _topk.SMEM_BUDGET
    # about one block a multiprocessor at a full batch
    assert p.cluster * -(-batch // p.qg) <= 132 or p.qg == batch


def test_probe_plan_at_the_main_shape():
    """C 625, D 200, B 64: clusters of 8 blocks of 79 centroids, each
    staging them all in one tile, for groups of 4 queries: 128 blocks."""
    p = _topk.plan_probe(625, 8, 64, 200, True, sms=132)
    assert (p.cluster, p.share, p.rows, p.qg, p.qpt) == (8, 79, 79, 4, 4)


@pytest.mark.parametrize("planner", ["plan_list", "plan_probe", "plan_staged"])
def test_plans_refuse_keep_outside_the_rows(planner):
    for keep in (0, 101):
        with pytest.raises(ValueError, match="keep"):
            if planner == "plan_list":
                _topk.plan_list(100, keep, 4, 200, "int8", 8, 0, sms=132)
            elif planner == "plan_probe":
                _topk.plan_probe(100, keep, 4, 200, True, sms=132)
            else:
                _topk.plan_staged(100, keep, 4, 200, "int8", sms=132)
