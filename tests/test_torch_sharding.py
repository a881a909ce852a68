"""The port's sharding rules, meshes and activation-sharding context against
the JAX package's: the same spec for every leaf of every arch's parameter
and cache trees, in every rule set, over the reference's 16x16 and 2x16x16
meshes (JAX's side over ``repro.launch.mesh.make_abstract_mesh``); the cases
of ``tests/test_sharding.py``; and the one-card behaviour of
``shard_activation`` (identity, or a raise over a mesh of more than one
device)."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_get_config
from repro.distributed import sharding as jshd
from repro.launch.mesh import make_abstract_mesh as jax_abstract_mesh
from repro.models import transformer as jtfm
from _torch_util import jax_form
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.distributed import ctx
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as model_lib
from repro_torch.models import transformer as tfm

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
MODES = ("train", "serve", "serve_long")
# the decode cache each rule set plans: decode_32k's batch and length, and
# long_500k's for the long-context rules
CACHE_AT = {"train": (128, 32768), "serve": (128, 32768), "serve_long": (1, 524288)}


def leaves(tree):
    """A port tree's leaves in JAX's flattening order: dict keys sorted,
    named tuples in field order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def rules_pair(mesh: str, mode: str):
    shape, axes = MESHES[mesh]
    return (jshd.make_rules(jax_abstract_mesh(shape, axes), mode),
            shd.make_rules(mesh_lib.make_abstract_mesh(shape, axes), mode))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_match_jax(arch, mode, mesh):
    jrules, prules = rules_pair(mesh, mode)
    want = [tuple(s.spec) for s in
            jax.tree_util.tree_leaves(jshd.param_shardings(jrules, jax_get_config(arch)))]
    got = [s.spec for s in leaves(shd.param_shardings(prules, jax_form(get_config(arch))))]
    assert got == want


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cache_specs_match_jax(arch, mode, mesh):
    jrules, prules = rules_pair(mesh, mode)
    batch, max_len = CACHE_AT[mode]
    want = [tuple(s.spec) for s in jax.tree_util.tree_leaves(
        jshd.cache_shardings(jrules, jax_get_config(arch), batch, max_len))]
    got = [s.spec for s in leaves(shd.cache_shardings(prules, get_config(arch), batch,
                                                      max_len))]
    assert got == want


@pytest.mark.parametrize("mesh", list(MESHES))
def test_per_device_bytes_follow_the_jax_specs(mesh):
    """``per_device_bytes`` against the bytes the JAX package's specs give a
    device (each leaf over the product of its spec's axis sizes), for the
    parameters in bf16 and the decode caches of every arch, serve rules."""
    jrules, prules = rules_pair(mesh, "serve")
    sizes = dict(jrules.mesh.shape)

    def jax_bytes(shardings, shapes, itemsize):
        total = 0
        for sh, sds in zip(jax.tree_util.tree_leaves(shardings),
                           jax.tree_util.tree_leaves(shapes)):
            split = int(np.prod([sizes[a] for part in sh.spec if part is not None
                                 for a in (part if isinstance(part, tuple) else (part,))]))
            total += int(np.prod(sds.shape)) * (itemsize or sds.dtype.itemsize) // split
        return total

    for arch in ARCH_NAMES:
        jcfg, cfg = jax_get_config(arch), jax_form(get_config(arch))
        want = jax_bytes(jshd.param_shardings(jrules, jcfg), jtfm.abstract_params(jcfg), 2)
        got = shd.per_device_bytes(prules, tfm.abstract_params(cfg, torch.bfloat16),
                                   tfm.param_logical_axes(cfg))
        assert got == want, arch
        abstract = jtfm.abstract_cache(jcfg, 128, 32768)
        want = jax_bytes(jshd.cache_shardings(jrules, jcfg, 128, 32768), abstract, None)
        cache = tfm.abstract_cache(cfg, 128, 32768)
        assert shd.per_device_bytes(prules, cache, shd.cache_logical_axes(cache)) == want


def test_per_device_bytes_on_one_device_is_the_whole_tree():
    cfg = get_config("mixtral-8x7b")
    rules = shd.make_rules(mesh_lib.make_abstract_mesh((1, 1), ("data", "model")), "train")
    params = tfm.abstract_params(cfg, torch.bfloat16)
    total = sum(t.numel() * 2 for t in leaves(params))
    assert shd.per_device_bytes(rules, params, tfm.param_logical_axes(cfg)) == total
    assert total == 2 * cfg.param_count()


def test_meshes_match_jax():
    for shape, axes in MESHES.values():
        want = dict(jax_abstract_mesh(shape, axes).shape)
        assert mesh_lib.make_abstract_mesh(shape, axes).shape == want
    assert mesh_lib.make_production_mesh().shape == {"data": 16, "model": 16}
    assert mesh_lib.make_production_mesh(multi_pod=True).shape == {
        "pod": 2, "data": 16, "model": 16}
    assert mesh_lib.make_production_mesh(multi_pod=True).size == 512


def test_local_mesh_is_capped_by_the_devices():
    assert mesh_lib.make_local_mesh(device="cpu").shape == {"data": 1, "model": 1}
    assert mesh_lib.make_local_mesh(4, 2, device="cpu").shape == {"data": 1, "model": 1}


# ----------------------------------------------------------------------
# the cases of tests/test_sharding.py, on the port's rules
@pytest.fixture(scope="module")
def mesh():
    return mesh_lib.make_abstract_mesh((16, 16), ("data", "model"))


@pytest.fixture(scope="module")
def mesh3():
    return mesh_lib.make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))


def test_divisibility_fallback(mesh):
    rules = shd.make_rules(mesh, "train")
    # 8 experts can't shard over data(16) -> falls through to d_model
    spec = rules.spec_for((8, 4096, 14336), ("experts", "d_model", "expert_ff"))
    assert spec == tuple(P(None, "data", "model"))
    # 256 experts can
    spec = rules.spec_for((256, 7168, 2048), ("experts", "d_model", "expert_ff"))
    assert spec == tuple(P("data", None, "model"))


def test_axis_never_reused(mesh):
    rules = shd.make_rules(mesh, "train")
    for shape, dims in [
        ((64, 5120, 64, 128), ("layers", "d_model", "heads", "head_dim")),
        ((256, 4096, 16, 16), ("batch", "seq", "kv_heads", None)),
        ((128, 8, 8, 4096, 512), ("batch", "kv_heads", "heads", "scores_seq", None)),
    ]:
        axes = shd.spec_axes(rules.spec_for(shape, dims))
        assert len(axes) == len(set(axes)), (shape, dims)


def test_scores_seq_fallback(mesh):
    """8 kv-heads can't take the 16-way model axis; the seq dim must."""
    rules = shd.make_rules(mesh, "train")
    spec = rules.spec_for((256, 8, 3, 4096, 4096),
                          ("batch", "kv_heads", "heads", "scores_seq", None))
    assert spec == tuple(P("data", None, None, "model"))


def test_serve_expert_grid(mesh, mesh3):
    rules = shd.make_rules(mesh, "serve")
    # deepseek: 256 routed experts over the full 256-chip grid
    spec = rules.spec_for((256, 7168, 2048), ("experts", "d_model", "expert_ff"))
    assert spec == tuple(P(("data", "model")))
    spec3 = shd.make_rules(mesh3, "serve").spec_for((512, 7168, 2048),
                                                    ("experts", "d_model", "expert_ff"))
    assert spec3 == tuple(P(("pod", "data", "model")))


def test_serve_long_shards_kv_seq(mesh):
    rules = shd.make_rules(mesh, "serve_long")
    spec = rules.spec_for((9, 1, 524288, 8, 128), (None, "batch", "kv_seq", None, None))
    assert spec == tuple(P(None, None, ("data", "model")))


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("mode", ["train", "serve"])
def test_param_shardings_cover_arch(arch, mode, mesh):
    """Train mode (ZeRO-3) leaves essentially nothing replicated; serve mode
    may replicate small attention projections over data, within a small
    HBM budget."""
    cfg = get_config(arch)
    shardings = leaves(shd.param_shardings(shd.make_rules(mesh, mode), cfg))
    shapes = leaves(tfm.abstract_params(cfg))
    assert len(shardings) == len(shapes)
    replicated_bytes = sum(t.numel() * 2 for sh, t in zip(shardings, shapes)
                           if sh.spec == ())
    budget = 64 * 2**20 if mode == "train" else 2 * 2**30
    assert replicated_bytes <= budget, (arch, mode, replicated_bytes / 2**30)


@pytest.mark.parametrize("arch", ["qwen3-32b", "deepseek-v3-671b", "rwkv6-1.6b",
                                  "jamba-1.5-large-398b"])
def test_cache_shardings_cover_arch(arch, mesh):
    shardings = shd.cache_shardings(shd.make_rules(mesh, "serve"), get_config(arch),
                                    batch=128, max_len=32768)
    for leaf in leaves(shardings):
        assert leaf.spec is not None and leaf.mesh is mesh


# ----------------------------------------------------------------------
# shard_activation on one card
def test_shard_activation_is_the_identity_without_rules():
    x = torch.zeros(2, 3, 4)
    assert ctx.current_rules() is None
    assert ctx.shard_activation(x, ("batch", "seq", None)) is x


def test_shard_activation_on_one_device_computes_the_spec():
    rules = shd.make_rules(mesh_lib.make_local_mesh(device="cpu"), "train")
    x = torch.zeros(2, 3, 4)
    with ctx.use_sharding_rules(rules):
        assert ctx.current_rules() is rules
        assert ctx.shard_activation(x, ("batch", "seq", None)) is x
        with pytest.raises(AssertionError):        # dims that do not fit x
            ctx.shard_activation(x, ("batch", "seq"))
    assert ctx.current_rules() is None


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_shard_activation_raises_on_a_mesh_of_many_devices(mesh_name):
    shape, axes = MESHES[mesh_name]
    rules = shd.make_rules(mesh_lib.make_abstract_mesh(shape, axes), "train")
    with ctx.use_sharding_rules(rules):
        with pytest.raises(RuntimeError, match="one card cannot place shards"):
            ctx.shard_activation(torch.zeros(32, 8, 4), ("batch", "seq", None))
    assert ctx.current_rules() is None


def test_model_call_sites_follow_the_rules():
    """The model's call sites (embedding, residual stream, scores, MoE
    buffer, logits): under one-device rules a forward equals the one
    without rules bit for bit; under 16x16 rules it raises."""
    cfg = get_smoke_config("mixtral-8x7b").scaled(dtype="float32")
    params = model_lib.init_params(cfg, 0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(0))
    want, _ = model_lib.forward(cfg, params, tokens)
    one = shd.make_rules(mesh_lib.make_local_mesh(device="cpu"), "train")
    with ctx.use_sharding_rules(one):
        got, _ = model_lib.forward(cfg, params, tokens)
    assert torch.equal(got, want)
    many = shd.make_rules(mesh_lib.make_production_mesh(), "train")
    with ctx.use_sharding_rules(many), pytest.raises(RuntimeError):
        model_lib.forward(cfg, params, tokens)
