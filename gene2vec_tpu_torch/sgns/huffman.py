"""Huffman coding tree for hierarchical softmax — the port's own copy of
``gene2vec_tpu/sgns/huffman.py`` (numpy only; the arrays are identical,
which ``tests/test_torch_cbow_hs.py`` checks).

word2vec's HS variant (gensim builds this in ``build_vocab`` when ``hs=1``;
the reference's trainer exposes it implicitly through gensim's constructor,
``src/gene2vec.py:70``) assigns each vocab token a root-to-leaf path through
V-1 internal nodes; the output layer scores one sigmoid per node on the
path.  With ``min_count=1`` (the reference's setting) the tree spans the
full vocabulary.

TPU shape: paths are padded to the tree's max code length L and stored as
two dense (V, L) arrays — ``points`` (internal-node ids) and ``codes``
(branch bits) — plus a (V,) ``lengths`` vector, so a batch's paths are one
gather and every step is shape-static.

Round 4 adds :func:`split_shallow` — the frequency-bucketed path layout
(VERDICT r3 item 6): internal nodes at tree depth < ``depth`` (at most
``2^depth − 1`` of them, shared by every path and carrying ALL of a hot
token's short code) are renumbered into a contiguous prefix of the node
table, and each token's shallow path is re-encoded as a dense ±1/0 sign
row over that prefix.  The HS step then scores the shallow levels with
MXU matmuls against the contiguous prefix slab (zero random node row
ops — the exact analogue of the stratified SGNS head) and pays per-row
gathers/scatters only for the deep levels of rare tokens' paths.
"""

from __future__ import annotations

import heapq
import itertools
from typing import NamedTuple

import numpy as np


class HuffmanTree(NamedTuple):
    points: np.ndarray   # (V, L) int32 — internal-node ids per token path
    codes: np.ndarray    # (V, L) float32 — branch bit per path node (0/1)
    lengths: np.ndarray  # (V,) int32 — true path length per token
    num_nodes: int       # V - 1 internal nodes

    @property
    def max_code_length(self) -> int:
        return int(self.points.shape[1])


class ShallowSplit(NamedTuple):
    """Depth-split Huffman path layout (see module docstring).

    Internal-node ids are PERMUTED relative to the source tree: shallow
    nodes (depth < split depth) occupy ids [0, n_shallow) so the HS step
    can slice them as one contiguous slab.
    """

    sign: np.ndarray          # (V, n_shallow) int8 — +1/−1 if the node is
                              # on the token's shallow path (1 − 2·code), 0 off-path
    points_deep: np.ndarray   # (V, L_deep) int32 — PERMUTED deep node ids
    codes_deep: np.ndarray    # (V, L_deep) float32
    lengths_deep: np.ndarray  # (V,) int32 — max(0, length − depth)
    n_shallow: int            # shallow slab size (< 2^depth)
    perm: np.ndarray          # (num_nodes,) int32 — old node id -> new id


def split_shallow(tree: HuffmanTree, depth: int) -> ShallowSplit:
    """Split ``tree``'s paths at ``depth`` levels, renumbering internal
    nodes so the shallow ones form a contiguous table prefix.

    A node's depth is its (unique) position along any root-to-leaf path
    through it, so membership is well defined.  Deep points keep at least
    one column (all-padding when the whole tree is shallower than
    ``depth``) so downstream shapes stay static and non-degenerate.
    """
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    v, max_len = tree.points.shape
    num_nodes = max(tree.num_nodes, 1)

    on_shallow = np.zeros(num_nodes, bool)
    d_eff = min(depth, max_len)
    for l in range(d_eff):
        live = tree.lengths > l
        on_shallow[tree.points[live, l]] = True
    shallow_ids = np.flatnonzero(on_shallow)
    n_shallow = int(shallow_ids.size)

    perm = np.zeros(num_nodes, np.int32)
    perm[shallow_ids] = np.arange(n_shallow, dtype=np.int32)
    deep_ids = np.flatnonzero(~on_shallow)
    perm[deep_ids] = np.arange(
        n_shallow, num_nodes, dtype=np.int32
    )

    sign = np.zeros((v, max(n_shallow, 1)), np.int8)
    for l in range(d_eff):
        live = np.flatnonzero(tree.lengths > l)
        cols = perm[tree.points[live, l]]
        sign[live, cols] = (1 - 2 * tree.codes[live, l]).astype(np.int8)

    l_deep = max(max_len - depth, 1)
    points_deep = np.zeros((v, l_deep), np.int32)
    codes_deep = np.zeros((v, l_deep), np.float32)
    if max_len > depth:
        points_deep[:, : max_len - depth] = perm[tree.points[:, depth:]]
        codes_deep[:, : max_len - depth] = tree.codes[:, depth:]
    lengths_deep = np.maximum(tree.lengths - depth, 0).astype(np.int32)
    return ShallowSplit(
        sign=sign,
        points_deep=points_deep,
        codes_deep=codes_deep,
        lengths_deep=lengths_deep,
        n_shallow=n_shallow,
        perm=perm,
    )


class ShallowPaths(NamedTuple):
    """Each token's shallow path as a short list, for K6: the nonzero
    entries of its :class:`ShallowSplit` sign row in level order (root
    first).  Fields are numpy arrays from :func:`shallow_paths`, or the
    same arrays as tensors on the training device."""

    ids: object       # (V, Ls) int32 — shallow node ids, level order; 0 past the path
    signs: object     # (V, Ls) int8 — the sign row's entry at each id; 0 past the path
    n_shallow: int    # the node prefix the ids lie in: [0, n_shallow)


def shallow_paths(split: ShallowSplit) -> ShallowPaths:
    """The compact form of ``split.sign``: per token, its nonzero columns
    (at most ``depth`` of them, as a prefix of Ls = the longest row's
    count) in descending column order, which is level order.

    Why descending is level order: internal nodes are numbered in
    creation order, a parent after its children, and ``split_shallow``
    renumbers the shallow ones keeping that order — so along any path
    the ids fall from the root down.  K6 relies on it: a level-l entry
    is the l-th of its row, and the path's codes above it name the
    node's place in level l."""
    sign = split.sign
    v = sign.shape[0]
    rows, rcols = np.nonzero(sign[:, ::-1])         # row-major: descending columns
    cols = sign.shape[1] - 1 - rcols
    count = np.bincount(rows, minlength=v)
    ls = max(int(count.max()) if v else 0, 1)
    pos = np.arange(rows.size) - np.repeat(np.cumsum(count) - count, count)
    ids = np.zeros((v, ls), np.int32)
    signs = np.zeros((v, ls), np.int8)
    ids[rows, pos] = cols
    signs[rows, pos] = sign[rows, cols]
    return ShallowPaths(ids=ids, signs=signs, n_shallow=split.n_shallow)


def build_huffman_tree(counts: np.ndarray) -> HuffmanTree:
    """Standard word2vec Huffman construction over token counts.

    Token ids are the vocab's frequency-sorted ids; internal nodes get ids
    0..V-2 in creation order (leaves merged first = deepest).
    """
    counts = np.asarray(counts, dtype=np.int64)
    v = int(counts.size)
    if v == 0:
        raise ValueError("empty vocabulary")
    if v == 1:
        # degenerate: single token, empty path
        return HuffmanTree(
            points=np.zeros((1, 1), np.int32),
            codes=np.zeros((1, 1), np.float32),
            lengths=np.zeros(1, np.int32),
            num_nodes=0,
        )

    # heap items: (count, tiebreak, node). Leaves are ints < v; internal
    # nodes are ints >= v (id - v = internal node index).
    tiebreak = itertools.count()
    heap = [(int(c), next(tiebreak), i) for i, c in enumerate(counts)]
    heapq.heapify(heap)
    parent = {}
    bit = {}
    next_internal = 0
    while len(heap) > 1:
        c1, _, n1 = heapq.heappop(heap)
        c2, _, n2 = heapq.heappop(heap)
        node = v + next_internal
        next_internal += 1
        parent[n1], bit[n1] = node, 0.0
        parent[n2], bit[n2] = node, 1.0
        heapq.heappush(heap, (c1 + c2, next(tiebreak), node))

    num_nodes = next_internal  # == v - 1
    # walk each leaf to the root, collecting (node, bit) pairs leaf→root,
    # then reverse to get root→leaf order (word2vec convention).
    paths = []
    max_len = 0
    for leaf in range(v):
        pts, cds = [], []
        n = leaf
        while n in parent:
            p = parent[n]
            pts.append(p - v)
            cds.append(bit[n])
            n = p
        pts.reverse()
        cds.reverse()
        paths.append((pts, cds))
        max_len = max(max_len, len(pts))

    points = np.zeros((v, max_len), np.int32)
    codes = np.zeros((v, max_len), np.float32)
    lengths = np.zeros(v, np.int32)
    for i, (pts, cds) in enumerate(paths):
        points[i, : len(pts)] = pts
        codes[i, : len(cds)] = cds
        lengths[i] = len(pts)
    return HuffmanTree(points=points, codes=codes, lengths=lengths, num_nodes=num_nodes)
