"""The port's sharding rules (``sharding/specs.py``), mesh descriptions
(``launch/mesh.py``) and FedKT's member layout
(``launch/fedkt_dryrun.member_shardings``) against the reference's, on
the same shapes and mesh sizes.

The reference runs its spec functions on ``jax.sharding.AbstractMesh``
(no devices); the port on ``launch.mesh.Mesh``.  Every comparison is
exact: a port leaf's spec equals the reference's spec of the same leaf
through ``convert._ref_path``'s mapping, where a leaf stacked over the
periods (or over an encoder-decoder's layers) has one more leading
entry, which must be None (a replicated leaf's spec is () either
way).
"""
import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCH_IDS, INPUT_SHAPES
from repro.configs import get_config as ref_get_config
from repro.models import Model as RefModel
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, fedkt_dryrun, inputs
from repro_torch.launch.mesh import Mesh, make_local_mesh, \
    make_production_mesh
from repro_torch.models import Model
from repro_torch.sharding import specs
from repro_torch.tree_util import flatten_tree, tree_map
from torch_reference import (cache_ref_path, param_ref_path, ref_flat,
                             reference_module)

ref_specs = reference_module("repro.sharding.specs")
ref_inputs = reference_module("repro.launch.inputs")
ref_dryrun = reference_module("repro.launch.dryrun")
ref_fedkt = reference_module("repro.launch.fedkt_dryrun")

MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data",
                                                          "model")),
          ((4, 2), ("data", "model"))]


def _meshes(sizes, names):
    return AbstractMesh(sizes, names), Mesh(names, sizes)


def _ref_params(arch):
    cfg = ref_get_config(arch)
    return jax.eval_shape(lambda: RefModel(cfg).init(jax.random.PRNGKey(0)))


def _same_spec(got, want, stacked):
    """A replicated leaf's spec is () however it is stacked."""
    want = tuple(want)
    if stacked and want:
        assert want[0] is None, want
        want = want[1:]
    assert tuple(got) == want


def _check_tree(cfg, port_tree, ref_tree, ref_path_of):
    """Every port leaf's spec against the reference's, and every
    reference leaf (every row of a stacked one) reached."""
    want = ref_flat(ref_tree)
    rows = {}
    for path, got in flatten_tree(port_tree).items():
        rpath, idx = ref_path_of(cfg, path)
        _same_spec(got.spec, want[rpath].spec, idx is not None)
        rows.setdefault(rpath, set()).add(idx)
    assert set(rows) == set(want)


@pytest.mark.parametrize("sizes,names", MESHES, ids=["16x16", "2x16x16",
                                                      "4x2"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, sizes, names):
    ref_mesh, mesh = _meshes(sizes, names)
    got = specs.param_shardings(Model(get_config(arch)).init_shapes(), mesh)
    want = ref_specs.param_shardings(_ref_params(arch), ref_mesh)
    _check_tree(get_config(arch), got, want, param_ref_path)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_sharding_match_reference(arch):
    """batch_sharding of every input spec of every shape, and
    cache_sharding of every decode shape's cache, on every mesh."""
    for sizes, names in MESHES:
        ref_mesh, mesh = _meshes(sizes, names)
        for name, shape in INPUT_SHAPES.items():
            if (arch, name) in ref_dryrun.SKIPS:
                continue
            rcfg = ref_dryrun.resolve_cfg(arch, name)[0]
            cfg = dryrun.resolve_cfg(arch, name)[0]
            if shape.kind == "decode":
                rtok, rcache, _ = ref_inputs.decode_specs(rcfg, shape)
                tok, cache, _ = inputs.decode_specs(cfg, shape)
                assert tuple(specs.batch_sharding({"t": tok}, mesh)[
                    "t"].spec) == tuple(ref_specs.batch_sharding(
                        {"t": rtok}, ref_mesh)["t"].spec)
                B = shape.global_batch
                _check_tree(cfg, specs.cache_sharding(cache, mesh, B),
                            ref_specs.cache_sharding(rcache, ref_mesh, B),
                            cache_ref_path)
                continue
            for fn in ("train_batch_specs", "prefill_batch_specs"):
                got = specs.batch_sharding(getattr(inputs, fn)(cfg, shape),
                                           mesh)
                want = ref_specs.batch_sharding(
                    getattr(ref_inputs, fn)(rcfg, shape), ref_mesh)
                assert set(got) == set(want)
                for k in got:
                    assert tuple(got[k].spec) == tuple(want[k].spec), k


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "mixtral-8x7b",
                                  "whisper-tiny"])
def test_member_shardings_match_reference(arch):
    ref_mesh, mesh = _meshes((16, 16), ("data", "model"))
    M = 16
    stacked = tree_map(lambda t: inputs.sds((M,) + tuple(t.shape), t.dtype),
                       Model(get_config(arch)).init_shapes())
    got = flatten_tree(fedkt_dryrun.member_shardings(stacked, mesh))
    ref_stacked = jax.tree.map(
        lambda a: jax.ShapeDtypeStruct((M,) + a.shape, a.dtype),
        _ref_params(arch))
    want = ref_flat(ref_fedkt.member_shardings(ref_stacked, ref_mesh))
    cfg = get_config(arch)
    for path, sh in got.items():
        rpath, idx = param_ref_path(cfg, path)
        w = tuple(want[rpath].spec)
        assert w[0] == "data"
        # the reference's stacked member leaf: (M, periods, ...)
        _same_spec(sh.spec[1:], w[1:], idx is not None)
        assert sh.spec[0] == "data"


def test_spec_rules_and_fallbacks():
    class FakeMesh:
        shape = {"data": 16, "model": 16}

    one = Mesh(("data", "model"), (1, 1))
    assert specs.spec_for_param(("blocks", "0", "attn", "wq"), (64, 128),
                                one) == ("data", "model")
    assert specs.spec_for_param(("x", "wo"), (128, 64), one) == \
        ("model", "data")
    assert specs.spec_for_param(("embed", "table"), (512, 64), one) == \
        ("model", "data")
    assert specs.spec_for_param(("norm1", "scale"), (64,), one) == ()
    for shape, kw in [((10, 7), {"model_dim": -1, "data_dim": -2}),
                      ((32, 3072), {"model_dim": -1, "data_dim": -2}),
                      ((24, 128), {"model_dim": -2})]:
        assert tuple(specs._spec(shape, FakeMesh, **kw)) == \
            tuple(ref_specs._spec(shape, FakeMesh, **kw))
    mesh = make_production_mesh()
    assert specs.replicated(mesh) == specs.NamedSharding(mesh, specs.P())
    pshapes = Model(get_config("phi4-mini-3.8b")).init_shapes()
    psh = specs.param_shardings(pshapes, mesh)
    st = specs.opt_state_sharding(None, psh, mesh)
    assert st.step == specs.replicated(mesh) and st.mu is psh and \
        st.nu is psh
    assert specs.shard_bytes(pshapes["embed"]["table"],
                             psh["embed"]["table"].spec, mesh) == \
        200_064 * 3072 * 4 // 256


def test_placements():
    from torch.distributed.tensor import Replicate, Shard
    pod = make_production_mesh(multi_pod=True)
    assert specs.placements(specs.P("data", "model"),
                            make_production_mesh()) == (Shard(0), Shard(1))
    assert specs.placements(specs.P(("pod", "data"), None, "model"), pod) \
        == (Shard(0), Shard(0), Shard(2))
    assert specs.placements(specs.P(None, "model"), pod) == \
        (Replicate(), Replicate(), Shard(1))

    class DeviceMeshLike:
        mesh_dim_names = ("data",)
    assert specs.placements(specs.P(), DeviceMeshLike()) == (Replicate(),)


def test_activation_functions_are_the_no_mesh_path():
    x = torch.ones((2, 3, 4, 8), dtype=torch.bfloat16)
    tree = {"w": torch.ones(3, requires_grad=True),
            "i": torch.zeros(2, dtype=torch.int32)}
    for mesh in (None, make_production_mesh()):
        specs.set_activation_mesh(mesh)
        assert specs.constrain(x, specs.DP, None) is x
        assert specs.shard_heads(x) is x
        got = specs.pregather_params(tree, torch.bfloat16)
        assert got["w"].dtype == torch.bfloat16 and got["w"].requires_grad
        assert got["i"] is tree["i"]
    specs.set_activation_mesh(None)


def test_meshes_describe_the_reference_layouts():
    assert specs.DP == ref_specs.DP
    for multi_pod, shape in [(False, {"data": 16, "model": 16}),
                             (True, {"pod": 2, "data": 16, "model": 16})]:
        mesh = make_production_mesh(multi_pod=multi_pod)
        assert mesh.shape == shape
        assert list(mesh.shape) == list(shape)
        assert mesh.devices.size == (512 if multi_pod else 256)
        assert mesh.devices.shape == tuple(shape.values())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_local_mesh()
