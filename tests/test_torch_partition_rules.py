"""The port's partition rules (``parallel/partition_rules.py``, the
mesh-free half) against the JAX package's: the same rules give the same
spec for every name and shape, ``match_partition_rules`` maps the same
trees onto the same specs, and ``parse_rules`` accepts and refuses the
same catalog JSON.  A reference ``PartitionSpec`` is a tuple, so specs
compare as tuples.  The mesh placement (``shard_params`` and the rest)
is ROADMAP A13's."""

import warnings

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as PS

from gene2vec_tpu.parallel import partition_rules as ref
from gene2vec_tpu_torch.parallel import partition_rules as port


def _ref_rules(rules):
    return tuple((p, PS(*spec)) for p, spec in rules)


RULE_SETS = {
    "specific_first": ((r"(^|/)emb$", ("model", None)), (r".*", ())),
    "catchall_first": ((r".*", ()), (r"(^|/)emb$", ("model", None))),
    "all_sharded": ((r".*", ("model", None)),),
    "default": port.DEFAULT_SERVE_RULES,
}

NAMES_SHAPES = [
    ("emb", (8, 4)), ("kernel", (8, 4)), ("emb", ()), ("emb", (1,)), ("emb", (1, 1)),
    ("params/embedding/unit", (16, 4)), ("dense_0/bias", (4,)), ("ctx", (8, 4)),
    ("alpha/embedding/unit", (24, 8)), ("w2", (3, 3)),
]


def test_default_rules_equal_the_reference():
    assert port.DEFAULT_SERVE_RULES == tuple(
        (p, tuple(spec)) for p, spec in ref.DEFAULT_SERVE_RULES)
    assert port.REPLICATED_RULES == tuple(
        (p, tuple(spec)) for p, spec in ref.REPLICATED_RULES)


@pytest.mark.parametrize("rules", sorted(RULE_SETS))
@pytest.mark.parametrize("name,shape", NAMES_SHAPES)
def test_spec_for_name_equals_reference(rules, name, shape):
    """First match wins (ordering is the API), scalars and size-1 leaves
    never partition, for every rule set, name and shape."""
    want = ref.spec_for_name(_ref_rules(RULE_SETS[rules]), name, shape)
    assert port.spec_for_name(RULE_SETS[rules], name, shape) == tuple(want)


def test_no_match_replicates_with_warning_like_reference():
    rules = ((r"(^|/)emb$", ("model", None)),)
    for mod, r in ((port, rules), (ref, _ref_rules(rules))):
        with pytest.warns(RuntimeWarning, match="new_head/kernel"):
            assert tuple(mod.spec_for_name(r, "new_head/kernel", (8, 4))) == ()


def test_match_partition_rules_nested_tree_equals_reference():
    """A Flax-style nested params tree, a list and a tuple inside it: the
    same tree of specs, leaf for leaf, with the scalar forced replicated."""
    rng = np.random.RandomState(0)
    params = {
        "params": {
            "embedding": {"unit": rng.randn(16, 4).astype(np.float32)},
            "dense_0": {"kernel": np.zeros((4, 4), np.float32),
                        "bias": np.zeros((4,), np.float32)},
            "layers": [np.zeros((5, 4), np.float32), np.zeros((1,), np.float32)],
        },
        "emb": (np.zeros((8, 4), np.float32),),
        "step": np.zeros((), np.int32),
    }
    want = ref.match_partition_rules(ref.DEFAULT_SERVE_RULES, params)
    got = port.match_partition_rules(port.DEFAULT_SERVE_RULES, params)
    want_leaves = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, PS))[0]
    got_leaves = jax.tree_util.tree_flatten_with_path(
        got, is_leaf=lambda x: isinstance(x, tuple) and all(
            a is None or isinstance(a, str) for a in x))[0]
    assert [(jax.tree_util.keystr(p), tuple(s)) for p, s in want_leaves] == [
        (jax.tree_util.keystr(p), s) for p, s in got_leaves]
    assert got["params"]["embedding"]["unit"] == ("model", None)
    assert got["step"] == () and got["params"]["layers"][1] == ()


def test_tree_path_name_joins_keys_like_reference():
    tree = {"a": {"b": [np.zeros((2,)), np.zeros((2,))]}}
    ref_names = [ref.tree_path_name(p)
                 for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert ref_names == ["a/b/0", "a/b/1"]
    assert [port.tree_path_name(p) for p in (("a", "b", 0), ("a", "b", 1))] == ref_names


def test_match_partition_rules_emits_no_warning_when_covered():
    params = {name: np.zeros((8, 4), np.float32)
              for name in ("emb", "ctx", "unit", "kernel")}
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        got = port.match_partition_rules(port.DEFAULT_SERVE_RULES, params)
        want = ref.match_partition_rules(ref.DEFAULT_SERVE_RULES, params)
    assert got == {k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("raw", [
    [["(^|/)unit$", ["model", None]], [".*", []]],
    [[".*", None]],
    [["(^|/)(emb|ctx|unit)$", ["model", None]]],
    [],
])
def test_parse_rules_json_form_equals_reference(raw):
    assert port.parse_rules(raw) == [(p, tuple(s)) for p, s in ref.parse_rules(raw)]


@pytest.mark.parametrize("raw,exc", [
    ([["(unclosed", ["model"]]], Exception),   # bad regex
    ([[".*"]], ValueError),                    # not a pair
    ([[".*", "model"]], ValueError),           # axes not a list
])
def test_parse_rules_rejects_bad_shapes_like_reference(raw, exc):
    for mod in (port, ref):
        with pytest.raises(exc):
            mod.parse_rules(raw)
