"""The port's sharding rules (``parallel/sharding.py``, ``launch/specs.py``)
against JAX's, on the CPU.

``spec_for`` on the reference's ``FakeMesh`` cases.  For every arch of
``ARCHS`` at full width and the mesh shapes ``(16, 16)``, ``(2, 16, 16)``
and ``(2, 2, 4)`` (stand-ins with a ``.shape`` dict, as the reference's
test passes): ``infer_param_specs`` on the port's ``init_params`` on
``meta`` equals JAX's ``infer_param_specs`` on ``jax.eval_shape(
init_params)``, leaf by leaf (the port's per-layer leaf against JAX's
stacked leaf with its leading ``None`` dropped), over the same set of
leaves; ``activation_rules`` and ``_cache_leaf_spec`` (on every cache
leaf of both packages' ``init_cache``) equal JAX's for every
``applicable_shapes`` cell.
"""
import functools

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCHS as J_ARCHS
from repro.configs import applicable_shapes as j_shapes
from repro.launch import specs as j_specs
from repro.models.api import get_model as j_model
from repro.parallel import sharding as j_sharding
from repro_torch.configs import ARCHS, applicable_shapes
from repro_torch.launch import specs as t_specs
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models.api import get_model
from repro_torch.parallel import sharding as t_sharding
from repro_torch.parallel.sharding import P

MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "2x2x4": {"pod": 2, "data": 2, "model": 4},
}
STACKED = ("dense", "moe", "vlm", "ssm")


def _fake(shape):
    class FakeMesh:
        pass

    m = FakeMesh()
    m.shape = dict(shape)
    return m


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    cfg = J_ARCHS[arch]
    return jax.eval_shape(
        lambda: j_model(cfg).init_params(cfg, jax.random.PRNGKey(0)))


def _jax_paths(tree) -> dict:
    out = {}

    def one(path, leaf):
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        out[name] = leaf
        return leaf

    jax.tree_util.tree_map_with_path(one, tree)
    return out


def _jax_name(cfg, name: str) -> str:
    """The JAX path of a port parameter: ``layers.3.w_q`` is the stacked
    ``layers/w_q`` for the stacked families, else dots become slashes."""
    parts = name.split(".")
    if cfg.family in STACKED and parts[0] == "layers":
        return "/".join([parts[0]] + parts[2:])
    return "/".join(parts)


# --------------------------------------------------------------- spec_for --
def test_spec_for_divisibility_guard():
    m = _fake({"data": 16, "model": 16})
    # divisible dims shard; non-divisible fall back to replication
    assert t_sharding.spec_for((256, 4096), ("batch", None), m) == P("data", None)
    assert t_sharding.spec_for((15, 64), ("heads", None), m) == P(None, None)
    assert t_sharding.spec_for((32, 64), ("heads", None), m) == P("model", None)
    # one mesh axis never used twice
    assert t_sharding.spec_for((32, 32), ("heads", "ffn"), m) == P("model", None)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shape,logical", [
    ((256, 4096), ("batch", None)), ((3, 4096), ("batch", None)),
    ((64, 32, 128), ("batch", "heads", None)), ((32, 32), ("heads", "ffn")),
    ((8, 2048, 8, 64), ("batch", "seq_kv", "kv_heads", None)),
    ((2048, 16384), ("p_fsdp", "p_tp")), ((128256, 2048), ("vocab", "p_fsdp")),
])
def test_spec_for_equals_jax(mesh, shape, logical):
    m = _fake(MESHES[mesh])
    want = j_sharding.spec_for(shape, logical, m)
    assert tuple(t_sharding.spec_for(shape, logical, m)) == tuple(want)
    rules = {**t_sharding.DEFAULT_RULES, "seq_kv": "model", "p_fsdp": None}
    assert tuple(t_sharding.spec_for(shape, logical, m, rules)) == tuple(
        j_sharding.spec_for(shape, logical, m, rules))


def test_spec_for_reads_the_port_meshes():
    """The port's ``Mesh`` and a stand-in with a ``.shape`` dict give one
    spec; no mesh gives ``P()``; the context installs a mesh and rules."""
    mesh = make_production_mesh(devices=["meta"] * 256)
    fake = _fake({"data": 16, "model": 16})
    for shape, logical in (((256, 64), ("batch", None)),
                           ((32, 32), ("heads", "ffn"))):
        assert t_sharding.spec_for(shape, logical, mesh) == t_sharding.spec_for(
            shape, logical, fake)
    assert t_sharding.spec_for((4, 4), ("batch", None)) == P()
    with t_sharding.sharding_ctx(mesh, {"seq": "model", "knob": 7}):
        assert t_sharding.spec_for((16, 64), ("batch", "seq")) == P("data",
                                                                    "model")
        assert t_sharding.get_rule("knob") == 7
    assert t_sharding.get_rule("knob") is None
    x = torch.ones(3)
    assert t_sharding.shard(x, "batch") is x


def test_partition_spec_is_a_tuple_like_jax():
    assert tuple(P("data", None, ("pod", "data"))) == tuple(
        JP("data", None, ("pod", "data")))
    assert P() == () and repr(P("data")) == "P('data',)"
    ns = t_sharding.NamedSharding(_fake({"pod": 2, "data": 4, "model": 2}),
                                  P(("pod", "data"), None, "model"))
    assert ns.shard_shape((16, 3, 8)) == (2, 3, 4)


# ------------------------------------------------------------ param specs --
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_infer_param_specs_equals_jax(arch, mesh):
    cfg = ARCHS[arch]
    m = _fake(MESHES[mesh])
    params = get_model(cfg).init_params(cfg, 0, device="meta")
    got = t_sharding.infer_param_specs(params, m)
    jtree = _jax_params(arch)
    want = _jax_paths(j_sharding.infer_param_specs(jtree, m))
    shapes = _jax_paths(jtree)
    seen = set()
    for name, spec in got.items():
        jname = _jax_name(cfg, name)
        jspec = tuple(want[jname])
        if cfg.family in STACKED and name.startswith("layers."):
            assert jspec[0] is None, (name, jspec)     # p_stack
            jspec = jspec[1:]
        assert tuple(spec) == jspec, (name, spec, jspec)
        seen.add(jname)
    assert seen == set(shapes), sorted(set(shapes) ^ seen)
    # the mapping form gives the same specs
    named = dict(params.named_parameters())
    assert t_sharding.infer_param_specs(named, m) == got
    tree = t_sharding.named_sharding_tree(params, m)
    assert {n: s.spec for n, s in tree.items()} == got


# ----------------------------------------------- activation and cache specs --
def _cells(arch):
    return [(s.name, s) for s in applicable_shapes(ARCHS[arch])]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_activation_rules_and_cache_specs_equal_jax(arch, mesh):
    cfg, jcfg = ARCHS[arch], J_ARCHS[arch]
    m = _fake(MESHES[mesh])
    jshapes = {s.name: s for s in j_shapes(jcfg)}
    for name, shape in _cells(arch):
        assert t_specs.activation_rules(cfg, shape, m) == \
            j_specs.activation_rules(jcfg, jshapes[name], m), name
        if shape.kind != "decode":
            continue
        b, s = shape.global_batch, shape.seq_len
        jcache = jax.eval_shape(lambda: j_model(jcfg).init_cache(jcfg, b, s))
        jleaves = jax.tree_util.tree_leaves(jcache)
        tcache = get_model(cfg).init_cache(cfg, b, s, device="meta")
        tleaves = t_specs.tensor_leaves(tcache)
        for leaf in jleaves + tleaves:
            shp = tuple(leaf.shape)
            assert tuple(t_specs._cache_leaf_spec(shp, m, cfg)) == tuple(
                j_specs._cache_leaf_spec(shp, m, jcfg)), (name, shp)
        shardings = t_specs.cache_shardings(tcache, m, cfg)
        assert len(tleaves) > 0 and shardings is not None


def test_build_cell_on_the_production_mesh():
    """The train cell of llama3.2-1b × train_4k on the meta production
    mesh: meta arguments, the step's specs and the batch spec."""
    from repro_torch.configs import SHAPE_BY_NAME

    mesh = make_mesh((16, 16), ("data", "model"), devices=["meta"] * 256)
    cfg = ARCHS["llama3.2-1b"]
    cell = t_specs.build_cell(cfg, SHAPE_BY_NAME["train_4k"], mesh)
    params, opt, batch = cell.args
    assert cell.meta["kind"] == "train" and cell.donate_argnums == (0, 1)
    assert all(p.device.type == "meta" for p in params.parameters())
    assert batch["tokens"].shape == (256, 4096)
    assert batch["tokens"].dtype == torch.int32
    assert cell.in_shardings[2]["tokens"].spec == P("data", None)
    assert cell.in_shardings[0]["layers.0.w_q"].spec == P("data", "model")
    assert cell.in_shardings[1].mu["embed"].spec == P("model", "data")
    assert opt.mu["embed"].shape == params.embed.shape
