"""The port's partition-rule tables against the JAX package's.

Ports the rule-table cases of ``tests/test_model_parallel.py``: first match
wins, scalars replicate, a terminal catch-all is required, the generated
alternation reproduces ``dense_alternating_specs``, the family tables are
picked by ``rules_for_params``, and ``respec_axis`` / ``spec_shard_count``
work on a mesh's shape.  One more case holds every leaf of a transformer
and an MLP, carried over from flax by ``convert``, to ``har_tpu``'s spec of
the same leaf: a 2-D weight's spec is the JAX kernel's reversed, any other
leaf's is the same.  Another holds ``dense_alternating_specs`` (the layout
both trainers give a tp mesh) of every neural family, the transformer's
patch and ``scan_layers`` layouts included, to ``har_tpu``'s the same way.
No process group is needed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from har_tpu.models.neural import CNN1D as JaxCNN1D
from har_tpu.models.neural import MLP as JaxMLP
from har_tpu.models.neural import BiLSTM as JaxBiLSTM
from har_tpu.models.transformer import Transformer1D as JaxTransformer1D
from har_tpu.parallel import rules as jax_rules
from har_tpu.parallel.tensor_parallel import dense_alternating_specs as jax_dense_specs
from har_tpu_torch.convert import (
    bilstm_params_from_flax,
    cnn1d_params_from_flax,
    mlp_params_from_flax,
    transformer_params_from_flax,
)
from har_tpu_torch.models.neural import CNN1D, MLP, BiLSTM
from har_tpu_torch.models.transformer import Transformer1D
from har_tpu_torch.parallel import rules
from har_tpu_torch.parallel.rules import P
from har_tpu_torch.parallel.tensor_parallel import dense_alternating_specs

torch.set_num_threads(1)


def test_match_partition_rules_first_match_wins_and_scalar_guard():
    params = {
        "layers.0.weight": np.ones((8, 4), np.float32),
        "layers.0.bias": np.ones((8,), np.float32),
        "layers.1.weight": np.ones((4, 8), np.float32),
        "layers.1.bias": np.ones((4,), np.float32),
        # scalars and one-element leaves replicate whatever rule claims them
        "layers.2.weight": np.float32(3.0),
        "step": np.zeros((), np.int32),
    }
    specs = rules.match_partition_rules(rules.DENSE_MLP_RULES, params)
    assert specs["layers.0.weight"] == P("tp", None)
    assert specs["layers.0.bias"] == P("tp")
    assert specs["layers.1.weight"] == P(None, "tp")
    assert specs["layers.1.bias"] == P()  # catch-all
    assert specs["layers.2.weight"] == P()  # scalar guard
    assert specs["step"] == P()


def test_match_partition_rules_demands_terminal_catchall():
    with pytest.raises(ValueError, match="no partition rule"):
        rules.match_partition_rules(((r"weight$", P("tp", None)),),
                                    {"other": np.ones((2, 2), np.float32)})


def test_alternating_rules_reproduce_dense_alternating_specs():
    """Twelve Dense layers: the generated table resolves to the exact spec
    tree of the kernels-only walk, layers.10 after layers.9."""
    module = MLP(num_classes=8, hidden=(8,) * 11, in_features=8)
    want = dense_alternating_specs(module)
    got = rules.match_partition_rules(rules.alternating_rules(module, kernels_only=True), module)
    assert want == got
    assert got["layers.9.weight"] == got["head.weight"] == P(None, "tp")
    assert got["layers.10.weight"] == P("tp", None)


def test_rules_for_params_family_selection():
    assert rules.rules_for_params(
        {"blocks.0.qkv.weight": np.ones((24, 8)), "head.weight": np.ones((6, 8))}
    ) is rules.TRANSFORMER_RULES
    assert rules.rules_for_params(
        {"layers.0.weight": np.ones((8, 8)), "layers.1.weight": np.ones((8, 8))}
    ) is rules.DENSE_MLP_RULES
    # the MLP with its head, and other trees, get a generated alternation
    arbitrary = {"w1": np.ones((8, 6), np.float32), "b1": np.ones((8,), np.float32),
                 "w2": np.ones((4, 8), np.float32)}
    table = rules.rules_for_params(arbitrary)
    assert table[-1][0] == r".*"
    specs = rules.match_partition_rules(table, arbitrary)
    assert specs == {"w1": P("tp", None), "b1": P(), "w2": P(None, "tp")}
    # the positional list form shards a column kernel's 1-D follower
    flat = [np.ones((8, 6), np.float32), np.ones((8,), np.float32),
            np.ones((4, 8), np.float32)]
    assert rules.match_partition_rules(rules.rules_for_params(flat), flat) == [
        P("tp", None), P("tp"), P(None, "tp")]


def test_respec_axis_and_spec_shard_count():
    assert rules.respec_axis(P("ep"), "ep", "experts") == P("experts")
    assert rules.respec_axis(P(None, "tp"), "tp", "model") == P(None, "model")
    assert rules.respec_axis(P("pp"), "pp", "pp") == P("pp")
    shape = {"dp": 2, "tp": 4}
    assert rules.spec_shard_count(shape, P()) == 1
    assert rules.spec_shard_count(shape, P(None, "tp")) == 4
    assert rules.spec_shard_count(shape, P("dp", "tp")) == 8
    assert rules.spec_shard_count(shape, P(("dp", "tp"))) == 8


def test_shard_divisibility_check():
    params = {"layers.0.weight": np.ones((6, 4), np.float32),
              "layers.1.weight": np.ones((4, 6), np.float32)}
    specs = rules.match_partition_rules(rules.DENSE_MLP_RULES, params)
    rules.shard_divisibility_check(params, specs, {"dp": 2, "tp": 2})
    with pytest.raises(ValueError, match="not divisible by mesh axis 'tp'=4"):
        rules.shard_divisibility_check(params, specs, {"dp": 1, "tp": 4})


def test_zero1_and_literal_tables_match_jax():
    assert rules.zero1_rules(("dp_dcn", "dp")) == ((r".*", P(("dp_dcn", "dp"))),)
    for name in ("int8", "moe"):
        assert [(pat, tuple(s)) for pat, s in rules.RULE_TABLES[name]] == [
            (pat, tuple(s)) for pat, s in jax_rules.RULE_TABLES[name]]
    assert [(p, tuple(s)) for p, s in rules.PIPELINE_RULES] == [
        (p, tuple(s)) for p, s in jax_rules.PIPELINE_RULES]


def _flax_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flax_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _jax_spec_by_port_name(params, specs, to_port):
    """Each flax leaf's spec under the port's name: ``to_port`` converts a
    tree whose leaves are index markers, so the names follow convert's own
    mapping."""
    paths = list(_flax_paths(params))
    marked = jax.tree.map(lambda x: x, params)
    for i, (path, leaf) in enumerate(paths):
        node = marked
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = np.full(np.shape(leaf), i, np.float32)
    port = to_port(marked)
    flat_specs = {tuple(p): s for p, s in _flax_paths(specs)}
    out = {}
    for name, value in port.items():
        i = int(value.reshape(-1)[0])
        out[name] = flat_specs[paths[i][0]]
    return out


def _jax_specs_tree(params, table):
    specs = jax_rules.match_partition_rules(table, params)
    return jax.tree.map(lambda s: s, specs, is_leaf=lambda s: isinstance(s, JP))


@pytest.mark.parametrize("family", ["transformer", "mlp"])
def test_converted_leaf_placement_is_the_jax_spec_transposed(family):
    if family == "transformer":
        jm = JaxTransformer1D(num_classes=6, embed_dim=32, num_heads=2, num_layers=2,
                              dtype=jnp.float32)
        params = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 16, 3)))["params"]
        want_tree = _jax_specs_tree(params, jax_rules.TRANSFORMER_RULES)
        module = Transformer1D(num_classes=6, embed_dim=32, num_heads=2, num_layers=2)
        got = rules.match_partition_rules(rules.rules_for_params(module), module)
        to_port = transformer_params_from_flax
    else:
        jm = JaxMLP(num_classes=6, hidden=(16, 32), dtype=jnp.float32)
        params = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 13)), train=False)["params"]
        want_tree = jax_dense_specs(params)
        module = MLP(num_classes=6, hidden=(16, 32), in_features=13)
        got = rules.match_partition_rules(rules.rules_for_params(module), module)
        to_port = mlp_params_from_flax
    params = jax.tree.map(np.asarray, params)
    want = _jax_spec_by_port_name(params, want_tree, to_port)
    assert set(got) == set(want)
    for name, spec in want.items():
        leaf = module.state_dict()[name]
        expect = tuple(reversed(tuple(spec))) if leaf.dim() == 2 else tuple(spec)
        # trailing Nones are the same placement
        strip = lambda s: tuple(s)[: max([i + 1 for i, e in enumerate(s) if e] or [0])]  # noqa: E731
        assert strip(got[name]) == strip(expect), name
    assert any(tuple(s) for s in got.values())  # something is sharded


_TRANSFORMER = dict(num_classes=6, embed_dim=32, num_heads=2, num_layers=2)
_FAMILIES = {
    "transformer": (lambda: JaxTransformer1D(**_TRANSFORMER, dtype=jnp.float32),
                    lambda: Transformer1D(**_TRANSFORMER), (2, 16, 3), {},
                    transformer_params_from_flax),
    "transformer_patch": (
        lambda: JaxTransformer1D(**_TRANSFORMER, patch_size=4, dtype=jnp.float32),
        lambda: Transformer1D(**_TRANSFORMER, patch_size=4), (2, 16, 3), {},
        transformer_params_from_flax),
    "transformer_scan": (
        lambda: JaxTransformer1D(**dict(_TRANSFORMER, num_layers=3), scan_layers=True,
                                 dtype=jnp.float32),
        lambda: Transformer1D(**dict(_TRANSFORMER, num_layers=3), scan_layers=True),
        (2, 16, 3), {}, transformer_params_from_flax),
    "mlp": (lambda: JaxMLP(num_classes=6, hidden=(16, 32, 8), dtype=jnp.float32),
            lambda: MLP(num_classes=6, hidden=(16, 32, 8), in_features=13), (2, 13),
            {"train": False}, mlp_params_from_flax),
    "cnn1d": (lambda: JaxCNN1D(num_classes=6, channels=(8, 16), dtype=jnp.float32),
              lambda: CNN1D(num_classes=6, channels=(8, 16)), (2, 16, 3),
              {"train": False}, cnn1d_params_from_flax),
    "bilstm": (lambda: JaxBiLSTM(num_classes=6, hidden=8, dtype=jnp.float32),
               lambda: BiLSTM(num_classes=6, hidden=8), (2, 16, 3), {"train": False},
               bilstm_params_from_flax),
}


@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_dense_alternating_specs_are_the_jax_specs_transposed(family):
    """The trainers' tp layout: the port walks a module as JAX walks its
    flax tree, so each weight gets the JAX kernel's spec reversed (the
    transformer's mlp_in/mlp_out and proj/qkv pairs in flax's order, embed
    and head last) and every other leaf the JAX leaf's."""
    jax_module, port_module, shape, kw, to_port = _FAMILIES[family]
    params = jax_module().init(jax.random.PRNGKey(0), jnp.zeros(shape), **kw)["params"]
    params = jax.tree.map(np.asarray, params)
    want = _jax_spec_by_port_name(params, jax_dense_specs(params), to_port)
    module = port_module()
    got = dense_alternating_specs(module)
    assert set(got) == set(want) == set(module.state_dict())
    strip = lambda s: tuple(s)[: max([i + 1 for i, e in enumerate(s) if e] or [0])]  # noqa: E731
    for name, spec in want.items():
        leaf = module.state_dict()[name]
        # a port weight is 2-D where flax may hold the leaf in 3-D (a patch
        # kernel, a scan stack): those are replicated on both sides
        expect = tuple(reversed(tuple(spec))) if leaf.dim() == 2 else tuple(spec)
        assert strip(got[name]) == strip(expect), (name, got[name], spec)
    if family in ("transformer", "mlp"):
        assert any(tuple(s) for s in got.values())
