"""The port's sharding rules (``repro_torch.launch.shard_rules``, the
hints of ``repro_torch.models.sharding``, ``launch.mesh``'s elastic
arithmetic) held exactly to the reference's on ``jax.sharding.
AbstractMesh`` -- the production meshes 16x16 and 2x16x16 without a
device -- for every architecture at its full ``CONFIG``: each spec as
the reference's ``PartitionSpec`` tuple, each shard shape as its
``NamedSharding.shard_shape``.  No tolerance."""
import jax
import pytest
from jax.sharding import AbstractMesh

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.launch import shard_rules as ref_rules
from repro.launch import steps as ref_steps
from repro.models import model as ref_model
from repro.models import sharding as ref_sharding
from repro.optim import adamw as ref_adamw
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import shard_rules, steps
from repro_torch.models import model
from repro_torch.models import sharding
from repro_torch.optim import adamw

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(name):
    shape, names = MESHES[name]
    return AbstractMesh(shape, names), dict(zip(names, shape))


def _same(ref_sh, port_sh, shape, what):
    """Spec tuples equal; shard shapes equal, or both refuse."""
    assert tuple(ref_sh.spec) == port_sh.spec, what
    try:
        want = tuple(ref_sh.shard_shape(tuple(shape)))
    except ValueError:
        with pytest.raises(ValueError):
            port_sh.shard_shape(tuple(shape))
        return
    assert port_sh.shard_shape(tuple(shape)) == want, what


def test_archs_match():
    assert sorted(ARCHS) == sorted(REF_ARCHS)
    assert sorted(SHAPES) == sorted(REF_SHAPES)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("fsdp", ["configured", "toggled"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_sharding_matches_reference(arch, fsdp, mesh_name):
    ref_cfg, cfg = ref_config(arch), get_config(arch)
    if fsdp == "toggled":
        ref_cfg = ref_cfg.with_(fsdp=not ref_cfg.fsdp)
        cfg = cfg.with_(fsdp=not cfg.fsdp)
    amesh, axes = _meshes(mesh_name)
    ref_specs = ref_model.param_specs(ref_cfg)
    specs = model.param_specs(cfg)
    assert sorted(specs) == sorted(ref_specs)
    for k, s in specs.items():
        assert tuple(s.shape) == tuple(ref_specs[k].shape), k
        assert s.device.type == "meta"
        assert str(s.dtype).split(".")[-1] == str(ref_specs[k].dtype), k
    ref_sh = ref_rules.param_sharding(ref_cfg, amesh, ref_specs)
    port_sh = shard_rules.param_sharding(cfg, axes, specs)
    for k in specs:
        _same(ref_sh[k], port_sh[k], specs[k].shape, f"{arch}/{k}")


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_opt_state_sharding_matches_reference(arch, compress, mesh_name):
    ref_cfg, cfg = ref_config(arch), get_config(arch)
    amesh, axes = _meshes(mesh_name)
    ref_specs = ref_model.param_specs(ref_cfg)
    specs = model.param_specs(cfg)
    ref_o = ref_adamw.state_specs(
        ref_specs, ref_adamw.AdamWConfig(compress_grads=compress))
    port_o = adamw.state_specs(specs,
                               adamw.AdamWConfig(compress_grads=compress))
    ref_sh = ref_rules.opt_state_sharding(ref_cfg, amesh, ref_specs, ref_o)
    port_sh = shard_rules.opt_state_sharding(cfg, axes, specs, port_o)
    _same(ref_sh.step, port_sh.step, (), "step")
    for field in ("m", "v", "ef"):
        ref_tree, tree = getattr(ref_sh, field), getattr(port_sh, field)
        if ref_tree is None:
            assert tree is None and not compress
            continue
        assert sorted(tree) == sorted(ref_tree)
        for k in tree:
            _same(ref_tree[k], tree[k], specs[k].shape, f"{field}/{k}")


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_batch_sharding_matches_reference(arch, mesh_name):
    ref_cfg, cfg = ref_config(arch), get_config(arch)
    amesh, axes = _meshes(mesh_name)
    for name in sorted(SHAPES):
        ref_specs = ref_steps.input_specs(ref_cfg, REF_SHAPES[name])
        specs = steps.input_specs(cfg, SHAPES[name])
        assert sorted(specs) == sorted(ref_specs)
        ref_sh = ref_rules.batch_sharding(amesh, ref_specs)
        port_sh = shard_rules.batch_sharding(axes, specs)
        for k in specs:
            assert tuple(specs[k].shape) == tuple(ref_specs[k].shape)
            _same(ref_sh[k], port_sh[k], specs[k].shape, f"{name}/{k}")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {f"{prefix}{k}{p}": v for k, sub in tree.items()
                for p, v in _flat(sub, "/").items()}
    return {prefix: tree}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_sharding_matches_reference(arch, mesh_name):
    ref_cfg, cfg = ref_config(arch), get_config(arch)
    amesh, axes = _meshes(mesh_name)
    for name in ("decode_32k", "long_500k"):
        ref_c, _ = ref_steps.decode_extras(ref_cfg, REF_SHAPES[name])
        cache, index = steps.decode_extras(cfg, SHAPES[name])
        assert tuple(index.shape) == ()
        ref_sh = _flat(ref_rules.cache_sharding(ref_cfg, amesh, ref_c))
        port_sh = _flat(shard_rules.cache_sharding(cfg, axes, cache))
        ref_leaves, leaves = _flat(ref_c), _flat(cache)
        assert sorted(port_sh) == sorted(ref_sh) == sorted(leaves)
        for k in port_sh:
            assert tuple(leaves[k].shape) == tuple(ref_leaves[k].shape)
            _same(ref_sh[k], port_sh[k], leaves[k].shape, f"{name}/{k}")


def _hint_cases(cfg):
    """(shape, specs) of every ``hint_first`` call site the models have,
    at every shape of the assigned set."""
    v, d = cfg.padded_vocab, cfg.d_model
    out = []
    for sh in SHAPES.values():
        b, s = sh.global_batch, (1 if sh.kind == "decode" else sh.seq_len)
        hq = cfg.n_heads or 1
        ms = 16
        hp = hq + (-hq) % ms
        out.append(((b, s, hq, cfg.head_dim or 1),
                    [("data", None, "model", None)]))
        out.append(((b, s, hp, cfg.head_dim or 1),
                    [("data", None, "model", None)]))
        if cfg.n_codebooks:
            out.append(((b, s, cfg.n_codebooks, v),
                        [("data", None, None, "model"),
                         ("data", "model", None, None)]))
        else:
            out.append(((b, s, v), [("data", None, "model"),
                                    ("data", "model", None)]))
        out.append(((b, s, d), [("data", "model", None), (None, None, None)]))
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_hint_first_choice_matches_reference(arch, mesh_name):
    cfg = get_config(arch)
    amesh, axes = _meshes(mesh_name)
    import torch

    with ref_sharding.use_mesh_hints(amesh), sharding.use_mesh_hints(axes):
        assert sharding.model_axis_size() == ref_sharding.model_axis_size()
        for shape, specs in _hint_cases(cfg):
            x = torch.empty(shape, device="meta")
            ref_x = jax.ShapeDtypeStruct(shape, jax.numpy.float32)
            want = next((s for s in specs
                         if ref_sharding._CHECK_FN(ref_x, s)), None)
            assert sharding.first_spec(x, specs) == want, (shape, specs)
    assert sharding.model_axis_size() is None


def _ref_elastic(n, model_parallel=16):
    """The reference's arithmetic (``repro/launch/mesh.py:35-40``)."""
    while model_parallel > 1 and n % model_parallel != 0:
        model_parallel //= 2
    data = n // model_parallel
    return data, model_parallel


@pytest.mark.parametrize("model_parallel", [16, 8, 1])
def test_elastic_shape_matches_reference(model_parallel):
    for n in range(1, 513):
        assert tmesh.elastic_shape(n, model_parallel) == \
            _ref_elastic(n, model_parallel), n


def test_elastic_mesh_on_a_fake_world():
    with tmesh.fake_world(512):
        for n in (1, 7, 24, 100, 256, 500, 512):
            m = tmesh.make_elastic_mesh(list(range(n)), device_type="cpu")
            assert tuple(m.shape) == _ref_elastic(n)
            assert m.mesh_dim_names == ("data", "model")
        with pytest.raises(RuntimeError):
            tmesh.make_production_mesh(device_type="cpu")
        prod = tmesh.make_production_mesh(multi_pod=True, device_type="cpu")
        assert tuple(prod.shape) == (2, 16, 16)
    with tmesh.fake_world(256):
        prod = tmesh.make_production_mesh(device_type="cpu")
        assert prod.mesh_dim_names == ("data", "model")
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    axes = {"pod": 2, "data": 16, "model": 16}
    assert sharding.placements((None, ("pod", "data"), "model"), axes) == \
        (Shard(1), Shard(1), Shard(2))
    assert sharding.placements((), axes) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        sharding.placements((("data", "pod"),), axes)
    with pytest.raises(ValueError):
        sharding.placements(("model", "model"), axes)
