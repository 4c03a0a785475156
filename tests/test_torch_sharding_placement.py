"""Placement (``distributed/sharding.py``) against the reference's
``NamedSharding``: for every architecture, on a 4x4 mesh and across two
pods (2x2x4), under both rule styles, the local shape of each placed
parameter — a DTensor over the fake process group, holding this rank's
shard — equals ``NamedSharding(mesh, spec).shard_shape(shape)`` from the
reference on 16 placeholder CPU devices (a module-scoped subprocess).
Also: the placements of a joint ``("pod", "data")`` spec, a real tensor's
slice, and ``shard_hint`` on a plain tensor."""
import json
import os
import subprocess
import sys

import pytest
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs import list_archs
from repro_torch.distributed import sharding as TS
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, device_mesh
from repro_torch.models.model import build_model
from repro_torch.models.params import split_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"4x4": ((4, 4), ("data", "model")), "2x2x4": ((2, 2, 4), ("pod", "data", "model"))}
STYLES = ("tp", "fsdp_tp")

_REF = """
import json
import jax, numpy as np
from repro.configs import get_config, list_archs
from repro.distributed.sharding import ShardingRules
from repro.launch.dryrun import eval_shape_with_axes
from repro.models.model import build_model
MESHES = %r
out = {}
for arch in list_archs():
    model = build_model(get_config(arch))
    struct, axes = eval_shape_with_axes(lambda: model.init(jax.random.PRNGKey(0)))
    paths = jax.tree_util.tree_flatten_with_path(struct)[0]
    for name, (shape, names) in MESHES.items():
        devs = np.array(jax.devices()[:16]).reshape(shape)
        mesh = jax.sharding.Mesh(devs, names)
        for style in %r:
            sh = ShardingRules(mesh, style).tree_shardings(axes, struct)
            leaves = jax.tree_util.tree_leaves(sh)
            for (path, st), s in zip(paths, leaves):
                key = "/".join(str(getattr(k, "key", k)) for k in path)
                out["|".join((arch, name, style, key))] = list(s.shard_shape(st.shape))
print(json.dumps(out))
""" % (MESHES, STYLES)


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=16",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", _REF], env=env, capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {"/".join(prefix): tree}


_TREES = {}


def _tree(arch):
    if arch not in _TREES:
        from repro_torch.configs import get_config

        _TREES[arch] = split_params(build_model(get_config(arch)).init(dryrun.MetaGenerator()))
    return _TREES[arch]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_each_placed_param_holds_the_references_shard(arch, mesh_name, reference):
    values, axes = _tree(arch)
    mesh = Mesh(MESHES[mesh_name][1], MESHES[mesh_name][0])
    for style in STYLES:
        rules = TS.ShardingRules(mesh, style, device_mesh=device_mesh(mesh))
        placed = _flat(rules.tree_place(axes, values))
        specs = _flat(rules.tree_specs(axes, values))
        for path, t in placed.items():
            want = reference["|".join((arch, mesh_name, style, path))]
            assert isinstance(t, DTensor), path
            assert list(t.to_local().shape) == want, (style, path)
            assert list(TS.local_shape(specs[path], tuple(t.shape), mesh)) == want
            assert tuple(t.shape) == tuple(_flat(values)[path].shape)


def test_placements_of_a_joint_spec_and_a_real_tensor():
    mesh = Mesh(("pod", "data", "model"), (2, 2, 4))
    assert TS.placements((("pod", "data"), None, "model"), mesh) == (Shard(0), Shard(0), Shard(2))
    assert TS.placements((), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        TS.placements((("data", "pod"),), mesh)
    rules = TS.ShardingRules(mesh, "tp", device_mesh=device_mesh(mesh))
    x = torch.arange(8 * 3 * 8, dtype=torch.float32).reshape(8, 3, 8)
    placed = rules.place(x, ("batch", None, "heads"))
    # rank 0 of the fake group: the first of 4 batch shards, the first of 4 head shards
    assert torch.equal(placed.to_local(), x[:2, :, :2])
    assert rules.place(x, ("batch", None, "heads")).placements == (Shard(0), Shard(0), Shard(2))


def test_shard_hint_places_a_plain_tensor_and_is_its_own_gradients_layout():
    mesh = Mesh(("data", "model"), (2, 2))
    rules = TS.ShardingRules(mesh, "tp", device_mesh=device_mesh(mesh))
    x = torch.empty(4, 6, 8, device="meta", requires_grad=True)
    with TS.active_rules(rules):
        y = TS.shard_hint(x, ("batch", None, "ff"))
        assert y.placements == (Shard(0), Shard(2)) and tuple(y.to_local().shape) == (2, 6, 4)
        assert TS.shard_hint(y, ("batch", None, "ff")) is y  # already laid out so
        z = TS.placed_zeros((4, 6, 8), ("batch", None, None), dtype=torch.float32,
                            device="meta")
        assert z.placements == (Shard(0), Replicate()) and tuple(z.to_local().shape) == (2, 6, 8)
    assert TS.placed_zeros((4, 6), ("batch", None), dtype=torch.float32,
                           device="cpu").equal(torch.zeros(4, 6))  # no rules: plain
