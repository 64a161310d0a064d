"""Host-side data layout of the PyTorch port held against the JAX package:
class segmentation and quotas, the epoch shuffles under the reference's
own draws (recomputed here with its key derivations), the one-time host
preshuffle and the stratified noise spec."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gene2vec_tpu.data import negative_sampling as jns
from gene2vec_tpu.data import pipeline as jpipe
from gene2vec_tpu.io.vocab import Vocab as JVocab
from gene2vec_tpu_torch.data import negative_sampling as tns
from gene2vec_tpu_torch.data import pipeline as tpipe
from gene2vec_tpu_torch.io.vocab import Vocab


def _zipf_pairs(v, n, seed=0):
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, v + 1)
    p /= p.sum()
    return rng.choice(v, size=(n, 2), p=p).astype(np.int32)


def jax_shuffle_draw(key, num_pairs, num_batches, batch_pairs, mode):
    """The draws inside ``gene2vec_tpu.data.pipeline.epoch_shuffle``."""
    span = num_batches * batch_pairs
    if mode == "full":
        return tpipe.ShuffleDraw(0, np.asarray(
            jax.random.permutation(key, num_pairs)[:span]))
    off_key, blk_key = jax.random.split(key)
    block = 512 if span % 512 == 0 else batch_pairs
    return tpipe.ShuffleDraw(
        int(jax.random.randint(off_key, (), 0, num_pairs)),
        np.asarray(jax.random.permutation(blk_key, span // block)),
    )


@pytest.mark.parametrize("bounds", [16, (8, 40), (4, 24), (16, 200)])
@pytest.mark.parametrize("batch_pairs", [256, 100])
def test_segment_corpus_by_head_matches(bounds, batch_pairs):
    pairs = _zipf_pairs(257, 3000, seed=1)
    jp, jq = jpipe.segment_corpus_by_head(pairs, bounds, batch_pairs)
    tp, tq = tpipe.segment_corpus_by_head(pairs, bounds, batch_pairs)
    assert tq == tuple(jq) and sum(tq) == batch_pairs
    assert len(tp) == len(jp) == (6 if isinstance(bounds, tuple) else 3)
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("bounds", [16, (8, 40)])
def test_pool_class_pairs_and_dense_segments_match(bounds):
    """The port's batch (segmented_batch, then both directions) puts each
    class's rows where the reference's dense-slab segments expect them."""
    from gene2vec_tpu.sgns.step import _dense_segments
    from gene2vec_tpu_torch.sgns.step import _examples_from_pairs

    for n in (2, 3):
        assert tpipe.pool_class_pairs(n) == jpipe.pool_class_pairs(n)
    b = 128
    pools, quotas = tpipe.segment_corpus_by_head(_zipf_pairs(257, 3000, seed=4), bounds, b)
    n_classes = len(np.atleast_1d(bounds)) + 1
    pools = tuple(torch.from_numpy(p) for p in pools)
    centers, contexts = _examples_from_pairs(tpipe.segmented_batch(pools, quotas, 3))
    cls = lambda ids: np.searchsorted(np.atleast_1d(bounds), ids.numpy(), side="right")
    c_cls, x_cls = cls(centers), cls(contexts)
    center_segs, context_segs = _dense_segments(quotas, b, n_classes)
    for segs, have in ((center_segs, c_cls), (context_segs, x_cls)):
        want = np.full(2 * b, -1)
        for c, class_segs in enumerate(segs):
            for start, length in class_segs:
                want[start : start + length] = c
        np.testing.assert_array_equal(have, want)


@pytest.mark.parametrize("mode", ["offset", "full"])
@pytest.mark.parametrize("batch_pairs", [128, 100])
def test_epoch_shuffle_matches_under_injected_draws(mode, batch_pairs):
    pairs = _zipf_pairs(97, 2048 + 37, seed=2)
    n = pairs.shape[0]
    nb = n // batch_pairs
    key = jax.random.PRNGKey(5)
    want = jpipe.epoch_shuffle(jnp.asarray(pairs), key, n, nb, batch_pairs, mode)
    draw = jax_shuffle_draw(key, n, nb, batch_pairs, mode)
    got = tpipe.epoch_shuffle(torch.from_numpy(pairs), n, nb, batch_pairs, mode,
                              draw=draw)
    np.testing.assert_array_equal(got.numpy()[: nb * batch_pairs],
                                  np.asarray(want)[: nb * batch_pairs])


@pytest.mark.parametrize("mode", ["offset", "full"])
def test_segmented_epoch_shuffle_matches_under_injected_draws(mode):
    pairs = _zipf_pairs(257, 5000, seed=3)
    pools, quotas = jpipe.segment_corpus_by_head(pairs, (8, 40), 512)
    nb = 5000 // 512
    key = jax.random.PRNGKey(11)
    want = jpipe.segmented_epoch_shuffle(
        tuple(jnp.asarray(p) for p in pools), key, quotas, nb, mode
    )
    keys = jax.random.split(key, len(pools))
    draws = [
        jax_shuffle_draw(k, len(p), nb, q, mode) if q else None
        for p, k, q in zip(pools, keys, quotas)
    ]
    got = tpipe.segmented_epoch_shuffle(
        tuple(torch.from_numpy(p) for p in pools), quotas, nb, mode, draws=draws
    )
    for g, w, q in zip(got, want, quotas):
        np.testing.assert_array_equal(g.numpy()[: nb * q], np.asarray(w)[: nb * q])


def test_disabled_shuffle_is_identity():
    pairs = torch.from_numpy(_zipf_pairs(31, 300))
    assert tpipe.epoch_shuffle(pairs, 300, 2, 128, "offset", enabled=False) is pairs


def test_generator_draws_have_reference_shapes():
    gen = torch.Generator().manual_seed(0)
    d = tpipe.draw_shuffle(5000, 9, 512, "offset", gen)
    assert 0 <= d.offset < 5000 and sorted(d.perm.tolist()) == list(range(9))
    d = tpipe.draw_shuffle(5000, 9, 500, "full", gen)
    assert len(d.perm) == 4500 and len(set(d.perm.tolist())) == 4500


def test_host_preshuffle_matches():
    pairs = _zipf_pairs(50, 999)
    counts = np.bincount(pairs.reshape(-1), minlength=50)
    toks = [f"G{i}" for i in range(50)]
    want = jpipe.host_preshuffle(jpipe.PairCorpus(JVocab(toks, counts), pairs), 3)
    got = tpipe.host_preshuffle(tpipe.PairCorpus(Vocab(toks, counts), pairs), 3)
    np.testing.assert_array_equal(got.pairs, want.pairs)


@pytest.mark.parametrize("v,head,block", [(257, 32, 64), (24447, 256, 512),
                                          (40, 256, 512), (1000, 100, 900)])
def test_build_stratified_spec_matches(v, head, block):
    counts = (np.arange(v, 0, -1) ** 1.3).astype(np.int64) + 1
    want = jns.build_stratified_spec(counts, head, block, 0.75)
    got = tns.build_stratified_spec(counts, head, block, 0.75)
    assert (got.head, got.block, got.nb) == (want.head, want.block, want.nb)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.tail_w.numpy(), np.asarray(want.tail_w))
    np.testing.assert_array_equal(
        tns.noise_distribution(counts), jns.noise_distribution(counts)
    )


def test_vocab_and_reader_match(synthetic_corpus_dir):
    from gene2vec_tpu.io.pair_reader import load_corpus as jload
    from gene2vec_tpu_torch.io.pair_reader import load_corpus as tload

    jv, jp = jload(synthetic_corpus_dir, "txt", use_native=False)
    tv, tp = tload(synthetic_corpus_dir, "txt")
    assert tv.id_to_token == jv.id_to_token
    np.testing.assert_array_equal(tv.counts, jv.counts)
    np.testing.assert_array_equal(tp, jp)
