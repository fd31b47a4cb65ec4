"""The port's mesh and sharding rules (``repro_torch/launch/mesh.py``,
``repro_torch/sharding.py``) against the reference's: ``param_spec`` on
every case of tests/test_sharding.py and on every leaf of every family's
tiny config at model sizes 1, 2, 4 and 16 with and without FSDP, the rule
coverage, the mesh descriptors' fields, ``batch_shardings`` and
``cache_shardings`` on a (2, 4) mesh (the reference's built in one
subprocess on 8 fake host devices), and ``placements`` on a gloo (2, 1)
CPU ``DeviceMesh`` (two processes).  The activation constraints are the
identity on a data axis and the dense family's layout on a model axis,
where the other families raise."""
import functools
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import tiny_cfg  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models.model import init_params as jinit  # noqa: E402
from repro.sharding import _path_str as jpath_str  # noqa: E402
from repro.sharding import param_spec as jparam_spec  # noqa: E402
from repro_torch import sharding as sh  # noqa: E402
from repro_torch.bridge import config_from_jax  # noqa: E402
from repro_torch.device import flatten_tree  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.models.transformer import check_model_axis  # noqa: E402
from repro_torch.serve.decode import _init_cache  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ["dense", "moe", "ssm_rwkv6", "ssm_mamba2", "ssm_gdn", "hybrid",
            "vlm", "audio"]


def _spec_list(specs, like) -> list:
    """The leaves of a tree of specs (tuples, which ``flatten_tree`` would
    open) in the leaf order of ``like``, the tree it was made from."""
    out = []

    def walk(s, t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(s[k], t[k])
        elif isinstance(t, (list, tuple)):
            for a, b in zip(s, t):
                walk(a, b)
        else:
            out.append(s)
    walk(specs, like)
    return out


def _p(spec) -> tuple:
    """A reference PartitionSpec as the port writes one."""
    return tuple(spec)


# the cases of tests/test_sharding.py: (path, shape, model size, n_stack,
# fsdp axis, fsdp size)
SPEC_CASES = [
    ("layer_stacks/0/attn/wq", (36, 4096, 4096), 16, 1, None, 1),
    ("layer_stacks/0/attn/wq", (28, 1536, 1536), 16, 1, None, 1),
    ("layer_stacks/0/attn/wq", (2, 100, 100), 16, 1, None, 1),
    ("layer_stacks/0/attn/wo", (36, 4096, 4096), 16, 1, None, 1),
    ("layer_stacks/1/moe/wi_up", (60, 384, 7168, 2048), 16, 1, None, 1),
    ("layer_stacks/1/moe/router", (60, 7168, 384), 16, 1, None, 1),
    ("embed/table", (151936, 4096), 16, 0, None, 1),
    ("embed/table", (256206, 1024), 16, 0, None, 1),
    ("layer_stacks/0/mlp/wi_up", (36, 4096, 12288), 16, 1, "data", 16),
    ("layer_stacks/0/mlp/wi_up", (24, 1023, 2816), 16, 1, "data", 16),
    ("layer_stacks/0/ssm/in_x", (38, 2048, 4096), 16, 1, None, 1),
    ("layer_stacks/0/ssm/in_B", (38, 2048, 64), 16, 1, None, 1),
    ("layer_stacks/0/ssm/in_dt", (38, 2048, 64), 16, 1, None, 1),
    ("layer_stacks/0/mlp/bi", (24, 2816), 16, 1, None, 1),
    ("layer_stacks/0/mlp/bi", (24, 100), 16, 1, None, 1),
    ("layer_stacks/0/ln1/scale", (36, 4096), 16, 1, None, 1),
]


@pytest.mark.parametrize("case", SPEC_CASES,
                         ids=lambda c: f"{c[0]}-{c[1]}-{c[4]}")
def test_param_spec_matches_reference_case(case):
    path, shape, m, n_stack, fsdp, fsize = case
    want = jparam_spec(path, shape, m, "model", n_stack, fsdp_axis=fsdp,
                       fsdp_size=fsize)
    assert sh.param_spec(path, shape, m, "model", n_stack, fsdp_axis=fsdp,
                         fsdp_size=fsize) == _p(want)


@functools.cache
def _family_params(family):
    """The family's tiny params: the reference's shapes (``eval_shape``,
    nothing computed) and the port's own init (each test only reads
    them)."""
    kw = {"mlp_bias": True} if family == "dense" else {}
    jcfg = tiny_cfg(family, **kw)
    jp = jax.eval_shape(lambda: jinit(jcfg, jax.random.key(0)))
    return jp, init_params(config_from_jax(jcfg),
                           torch.Generator().manual_seed(0), device="cpu")


@pytest.mark.parametrize("family", FAMILIES)
def test_param_specs_match_reference_on_every_leaf(family):
    """Every leaf of the family's tiny config, model sizes 1/2/4/16, with
    and without an FSDP axis of 4: the port's tree of specs (by its own
    paths) equals the reference's ``param_spec`` on the reference's
    paths and shapes."""
    jp, tp = _family_params(family)
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = flatten_tree(tp)
    assert [sh._path_str(p) for p, _ in tflat] == \
        [jpath_str(p) for p, _ in jflat]
    for m in (1, 2, 4, 16):
        for fsdp in (None, "data"):
            desc = tmesh.MeshDescriptor("t", (4, m), ("data", "model"),
                                        ("data",))
            specs = sh.param_specs(tp, desc, fsdp_axis=fsdp)
            got = _spec_list(specs, tp)
            for (path, leaf), g in zip(jflat, got):
                ps = jpath_str(path)
                n_stack = 1 if ("layer_stacks" in ps
                                or ps.startswith("encoder")) else 0
                want = jparam_spec(ps, leaf.shape, m, "model", n_stack,
                                   fsdp, 4 if fsdp else 1)
                want = _p(want)[:len(leaf.shape)]
                assert g == want, (family, m, fsdp, ps)


# the port's copy of tests/test_sharding.py's replicate allowlist
_REPLICATE_ALLOWLIST = [
    r"(^|/)(ln1|ln2|ln_x|final_norm|enc_norm|norm|ln_out|q_norm|k_norm)"
    r"/scale$",
    r"mlp/bo$",
    r"ssm/(conv_w|conv_b|A_log|D|dt_bias|a_bias)$",
    r"tm/(mix|w0|w_lora_a|w_lora_b|u)$",
    r"cm/(mix|wr)$",
]


@pytest.mark.parametrize("family", FAMILIES)
def test_every_port_param_matches_a_rule_or_allowlist(family):
    _, tp = _family_params(family)
    orphans = sorted({
        sh._path_str(p) for p, _ in flatten_tree(tp)
        if not any(re.search(pat, sh._path_str(p)) for pat, _ in sh._RULES)
        and not any(re.search(pat, sh._path_str(p))
                    for pat in _REPLICATE_ALLOWLIST)})
    assert not orphans, orphans


DESCRIPTORS = {
    "single": lambda m: m.production_descriptor(False),
    "multi": lambda m: m.production_descriptor(True),
    "pod64x4": lambda m: m.production_descriptor(shape=(64, 4)),
    "host4": lambda m: m.host_descriptor(4),
}


@pytest.mark.parametrize("name", sorted(DESCRIPTORS))
def test_mesh_descriptor_fields_match_reference(name):
    j, t = DESCRIPTORS[name](jmesh), DESCRIPTORS[name](tmesh)
    for f in ("name", "shape", "axis_names", "data_axes", "model_axis",
              "dci_axes", "device_count", "ici_axes", "data_axis_size"):
        assert getattr(t, f) == getattr(j, f), f
    for a in j.axis_names:
        assert t.axis_size(a) == j.axis_size(a)
    assert tmesh.data_axis_size(t, t.data_axes) == j.data_axis_size


def test_host_descriptor_spans_the_world(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert tmesh.host_descriptor().shape == (1, 1)
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert tmesh.host_descriptor().shape == (2, 1)
    assert tmesh.data_axes(True) == jmesh.data_axes(True)


BATCH_SHAPES = {"tokens": (4, 64), "weight": (4, 64), "odd_rows": (3, 8),
                "extra_embeds": (4, 6, 32), "num_trees": ()}
CACHE_FAMILIES = ["dense", "ssm_rwkv6", "ssm_mamba2", "ssm_gdn", "hybrid",
                  "audio"]

_REFERENCE_SPECS = """
import json, sys
import numpy as np
import jax
from conftest import tiny_cfg
from repro import sharding as sh
from repro.launch.mesh import MeshDescriptor
from repro.serve.decode import _init_cache
batch_shapes, fams = json.loads(sys.argv[1]), json.loads(sys.argv[2])
mesh = MeshDescriptor("t", (2, 4), ("data", "model"), ("data",)).build()
def spec_json(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))[0]
    return {sh._path_str(p): [list(a) if isinstance(a, tuple) else a
                              for a in s.spec] for p, s in flat}
out = {"batch": spec_json(sh.batch_shardings(
    {k: jax.ShapeDtypeStruct(tuple(v), np.int32)
     for k, v in batch_shapes.items()}, mesh))}
for f in fams:
    cache = jax.eval_shape(lambda: _init_cache(tiny_cfg(f), 4, 16, 8))
    out[f] = spec_json(sh.cache_shardings(cache, mesh))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_specs():
    """The reference's batch and cache specs on a (2, 4) mesh of 8 fake
    host devices: one subprocess, which sets XLA_FLAGS before jax starts."""
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}:{ROOT / 'tests'}",
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    res = subprocess.run(
        [sys.executable, "-c", _REFERENCE_SPECS, json.dumps(BATCH_SHAPES),
         json.dumps(CACHE_FAMILIES)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def _json_spec(s):
    return [list(a) if isinstance(a, tuple) else a for a in s]


DESC_2x4 = tmesh.MeshDescriptor("t", (2, 4), ("data", "model"), ("data",))


def test_batch_shardings_match_reference(reference_specs):
    batch = {k: np.zeros(v, np.int32) for k, v in BATCH_SHAPES.items()}
    got = sh.batch_shardings(batch, DESC_2x4)
    assert {k: _json_spec(v) for k, v in got.items()} == \
        reference_specs["batch"]


@pytest.mark.parametrize("family", CACHE_FAMILIES)
def test_cache_shardings_match_reference(family, reference_specs):
    cfg = config_from_jax(tiny_cfg(family))
    cache = _init_cache(cfg, 4, 16, "cpu", enc_len=8)
    specs = sh.cache_shardings(cache, DESC_2x4)
    got = {sh._path_str(p): _json_spec(s)
           for p, s in zip([p for p, _ in flatten_tree(cache)],
                           _spec_list(specs, cache))}
    assert got == reference_specs[family]


_PLACEMENTS = """
import sys
from datetime import timedelta
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard
rank, store = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=2, timeout=timedelta(seconds=60))
from repro_torch import sharding as sh
from repro_torch.launch.mesh import host_descriptor
desc = host_descriptor()
mesh = desc.build("cpu")
assert desc.shape == (2, 1) and mesh.mesh_dim_names == ("data", "model")
assert sh.placements(("data", None), mesh) == (Shard(0), Replicate())
assert sh.placements((None, "model"), mesh) == (Replicate(), Shard(1))
assert sh.placements((None, ("data", "model")), mesh) == (Shard(1), Shard(1))
assert sh.placements((), mesh) == (Replicate(), Replicate())
with sh.use_mesh(mesh):
    ax = sh.data_axis()
    assert (ax.rank, ax.size) == (rank, 2)
dist.destroy_process_group()
print("ok")
"""


def test_placements_on_a_gloo_2x1_mesh(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    store = str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, "-c", _PLACEMENTS, str(r),
                               store], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and out.strip() == "ok", err[-2000:]


def test_param_shardings_are_the_specs_placements():
    _, tp = _family_params("dense")
    desc = tmesh.MeshDescriptor("t", (2, 4), ("data", "model"), ("data",))
    pl = sh.param_shardings(tp, desc, fsdp_axis="data")
    specs = sh.param_specs(tp, desc, fsdp_axis="data")
    assert _spec_list(pl, tp) == [
        sh.placements(s, desc) for s in _spec_list(specs, tp)]


class _FakeMesh:
    """A mesh-shaped stand-in (axis names and sizes; rank 0 of each axis,
    its groups never used)."""
    def __init__(self, shape):
        self.mesh_dim_names = ("data", "model")
        self._shape = shape

    def size(self, i=None):
        return self._shape[i]

    def __getitem__(self, name):
        n = self._shape[self.mesh_dim_names.index(name)]
        return type("Axis", (), {"get_group": lambda s: None,
                                 "get_local_rank": lambda s: 0,
                                 "size": lambda s: n})()


def test_constraints_are_the_identity_on_a_data_axis_and_raise_on_a_model_axis():
    """On a data axis the constraints are the identity.  On a model axis
    they are the dense and MoE families' layout (the residual stream passes
    without sequence parallelism, a 'model' dim keeps this rank's block;
    the collectives themselves run in tests/test_torch_tp.py and
    tests/test_torch_ep.py), and the families the model axis does not run
    yet raise, naming item 7e-ii, as does an MoE model whose 4 experts do
    not divide the axis (model 8)."""
    x, w = torch.randn(2, 3, 4), torch.randn(4, 5)
    assert sh.shard_activation(x) is x and sh.shard_logits(x) is x
    with sh.use_mesh(_FakeMesh((2, 1))):
        assert sh.shard_activation(x) is x
        assert sh.shard_logits(x) is x
        assert sh.shard_spec(x, "data", None, "model") is x
        assert torch.equal(sh.tp_out_proj(x, w), x @ w)
        assert sh.seq_sharded(3) is False
    with sh.use_mesh(_FakeMesh((1, 2))):
        assert sh.shard_activation(x) is x
        assert sh.tp_in(x) is not None and sh.model_block(12) == (0, 6)
        assert torch.equal(sh.shard_logits(x), x[..., :2])
        assert torch.equal(sh.shard_spec(x, "data", None, "model"),
                           x[..., :2])
        assert sh.shard_spec(x, "model", None, None).shape == (1, 3, 4)
        for fam in ("moe", "ssm_mamba2", "hybrid", "vlm", "audio"):
            cfg = config_from_jax(tiny_cfg(fam))
            if fam == "moe":
                check_model_axis(cfg)
                with sh.use_mesh(_FakeMesh((1, 8))), pytest.raises(
                        NotImplementedError, match="7e-ii"):
                    init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
                continue
            with pytest.raises(NotImplementedError, match="7e-ii"):
                init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
        with pytest.raises(NotImplementedError, match="7e-ii"):
            sh.require_no_model_axis("serving")
    with sh.use_mesh(_FakeMesh((1, 2)), seq_parallel=True):
        assert sh.seq_sharded(4) and not sh.seq_sharded(3)
    assert sh.current_mesh() is None
