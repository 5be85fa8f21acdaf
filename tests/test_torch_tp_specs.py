"""The LM sharding rules of the port (`core.partition` ``DEFAULT_RULES``,
``NO_TP``, ``logical_to_spec``; `models.layers.param_pspecs`;
`launch.steps`'s mesh helpers) held exactly to the JAX package's, on the
CPU.  Pure functions: no process group.

The reference returns ``PartitionSpec``\\ s, the port plain tuples with the
same entries; ``tuple(PartitionSpec(...))`` compares them.
"""
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import partition as JP  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.layers import param_pspecs as jax_param_pspecs  # noqa: E402
from repro_torch._tree import flatten  # noqa: E402
from repro_torch.configs import ALL_ARCHS, get_config  # noqa: E402
from repro_torch.core import partition as TP  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.layers import param_pspecs  # noqa: E402

MESHES = [(1, 1), (1, 2), (2, 2), (1, 4), (4, 1), (1, 8)]
AXES = ("data", "model")


def _jax_specs(tree):
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]


def test_rules_equal_reference():
    assert TP.DEFAULT_RULES == JP.DEFAULT_RULES
    assert TP.NO_TP == JP.NO_TP


@pytest.mark.parametrize("rules", ["default", "no_tp"])
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_pspecs_equal_reference(arch, smoke, mesh, rules):
    """Every leaf's spec of every registered arch, FULL and SMOKE, on each
    mesh, under the default rules and under ``NO_TP``."""
    shape = dict(zip(AXES, mesh))
    over = TP.NO_TP if rules == "no_tp" else {}
    with TP.rules_override(**over), JP.rules_override(**over):
        want = _jax_specs(jax_param_pspecs(JT.abstract_params(jax_config(arch, smoke=smoke)),
                                           JP.DEFAULT_RULES, AXES, shape))
        got = TP.spec_leaves(param_pspecs(TT.abstract_params(get_config(arch, smoke=smoke)),
                                       TP.DEFAULT_RULES, AXES, shape))
    assert got == want


LOGICAL = [("batch", "seq", "embed"), ("vocab", "embed"), ("embed", "heads", "head_dim"),
           ("layers", "experts", "embed", "expert_mlp"), ("batch", "kv_heads", "seq_kv_shard"),
           ("ssm_inner", "head_dim_shard"), (None, "mlp")]
DIMS = [(8, 128, 64), (255, 64), (64, 14, 16), (2, 8, 64, 32), (3, 2, 128), (6, 16), (4, 12)]


@pytest.mark.parametrize("mesh_axes", [None, ("data", "model"), ("pod", "data", "model"),
                                       ("model",)])
@pytest.mark.parametrize("i", range(len(LOGICAL)))
def test_logical_to_spec_equal_reference(i, mesh_axes):
    """Absent mesh axes dropped, and (with dims) axes that do not divide the
    dim dropped, as the reference does."""
    axes, dims = LOGICAL[i], DIMS[i]
    assert TP.logical_to_spec(axes, mesh_axes=mesh_axes) == tuple(
        JP.logical_to_spec(axes, mesh_axes=mesh_axes))
    for shape in ({"pod": 2, "data": 2, "model": 4}, {"data": 3, "model": 2}):
        got = TP.logical_to_spec(axes, TP.DEFAULT_RULES, mesh_axes, dims, shape)
        assert got == tuple(JP.logical_to_spec(axes, JP.DEFAULT_RULES, mesh_axes, dims, shape))


@pytest.mark.parametrize("mesh", MESHES)
def test_batch_helpers_equal_reference(mesh):
    jmesh = types.SimpleNamespace(axis_names=AXES, shape=dict(zip(AXES, mesh)))
    tmesh = types.SimpleNamespace(axis_names=AXES, shape=mesh)
    assert TS.batch_pspec(tmesh) == tuple(JS.batch_pspec(jmesh))
    shape = types.SimpleNamespace(global_batch=4)
    jspecs = {"tokens": jax.ShapeDtypeStruct((4, 16), jnp.int32),
              "frames": jax.ShapeDtypeStruct((4, 30, 8), jnp.float32),
              "scalar": jax.ShapeDtypeStruct((4,), jnp.int32)}
    tspecs = {k: torch.empty(v.shape, device="meta") for k, v in jspecs.items()}
    ref = {k: tuple(v.spec) for k, v in JS.batch_shardings(
        jspecs, _NamedMesh(jmesh), shape).items()}
    assert TS.batch_shardings(tspecs, tmesh, 4) == ref


class _NamedMesh(types.SimpleNamespace):
    """Enough of a jax mesh for the reference's ``batch_shardings``, which
    wraps each spec in a ``NamedSharding``: the spec is kept as given."""

    def __init__(self, m):
        super().__init__(axis_names=m.axis_names, shape=m.shape)


@pytest.fixture(autouse=True)
def _named_sharding(monkeypatch):
    monkeypatch.setattr(JS, "NamedSharding", lambda mesh, spec: types.SimpleNamespace(spec=spec))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "whisper-large-v3", "qwen3-moe-235b-a22b",
                                  "jamba-v0.1-52b"])
def test_cache_struct_and_serve_param_shapes_equal_reference(arch):
    jcfg, tcfg = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    # the tensors (the write indices are ints in the port)
    want = [(tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(JS.cache_struct(jcfg, 3, 20))
            if jnp.issubdtype(x.dtype, jnp.floating)]
    got = [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for _, x in flatten(TS.cache_struct(tcfg, 3, 20)) if isinstance(x, torch.Tensor)]
    assert got == want
    for c in (tcfg, tcfg.replace(serve_param_dtype="bfloat16")):
        j = jcfg.replace(serve_param_dtype=c.serve_param_dtype)
        want = [(tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(JS.serve_param_shapes(j))]
        got = [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
               for _, x in flatten(TS.serve_param_shapes(c))]
        assert got == want


@pytest.mark.parametrize("mesh", MESHES)
def test_local_shape_and_named_sharding(mesh):
    m = types.SimpleNamespace(axis_names=AXES, shape=mesh)
    assert TP.local_shape((8, 256, 64), (None, "model", None), m) == (8, 256 // mesh[1], 64)
    assert TP.local_shape((8, 16), (("data", "model"), None), m) == (8 // (mesh[0] * mesh[1]), 16)
    ns = TP.named_sharding(m, ("batch", "seq", "vocab"))
    assert ns.mesh is m and ns.spec == ("data", None, "model")
