"""The port's sharding plan against the JAX package's: parameter and cache
partition specs of every architecture, the dry run's shapes and model
FLOPs, and the data-axis helpers, on a mesh described by its axes only."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402,F401

from repro.configs import ARCH_IDS as JAX_ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.roofline.analysis import model_step_flops as jax_model_step_flops  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.roofline.analysis import model_step_flops  # noqa: E402


def norm(spec):
    """A partition spec as a tuple of axis tuples (``None`` and ``()`` alike
    replicate; ``"a"`` and ``("a",)`` alike shard over one axis)."""
    def entry(e):
        if e is None:
            return ()
        return (e,) if isinstance(e, str) else tuple(e)

    return tuple(entry(e) for e in spec)


def flat_specs(tree, prefix=""):
    """A JAX spec tree (PartitionSpec leaves) or the port's nested spec
    dict, flattened to ``/``-joined keys."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_specs(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = norm(v)
    return out


def test_the_port_has_every_reference_arch():
    assert sorted(ARCH_IDS) == sorted(JAX_ARCH_IDS)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_partition_specs_match_the_reference(arch):
    _, jspec = JaxModel(jax_config(arch)).init(None, abstract=True)
    mine = {k: norm(v) for k, v in Model(get_config(arch)).param_partition_specs().items()}
    assert mine == flat_specs(jspec)
    shapes = {k: s[0] for k, s in Model(get_config(arch)).param_specs().items()}
    assert all(len(mine[k]) == len(shapes[k]) for k in mine)


@pytest.mark.parametrize("dp", [("data",), (), ("pod", "data")])
@pytest.mark.parametrize("seq_axis", ["model", None])
@pytest.mark.parametrize("window", [None, 512])
@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-v2-236b", "mamba2-370m",
                                  "zamba2-1.2b"])
def test_cache_specs_match_the_reference(arch, window, seq_axis, dp):
    jcfg, cfg = jax_config(arch), get_config(arch)
    if window:
        jcfg = dataclasses.replace(jcfg, sliding_window=window)
        cfg = dataclasses.replace(cfg, sliding_window=window)
    want = JaxModel(jcfg).cache_specs(seq_axis=seq_axis, dp=dp)
    got = Model(cfg).cache_specs(seq_axis=seq_axis, dp=dp)
    assert flat_specs(got) == flat_specs(want)


def test_cache_specs_default_to_the_mesh_data_axes():
    want = JaxModel(jax_config("qwen3-8b"), mesh_axes=("pod", "data", "model")).cache_specs()
    got = Model(get_config("qwen3-8b"), mesh_axes=("pod", "data", "model")).cache_specs()
    assert flat_specs(got) == flat_specs(want)


def test_shapes_match_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in tspecs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jspecs.SHAPES.items()}


@pytest.mark.parametrize("shape", list(tspecs.SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_step_flops_and_shape_config_match_the_reference(arch, shape):
    jcfg = jspecs.shape_config(jax_config(arch), jspecs.SHAPES[shape])
    cfg = tspecs.shape_config(get_config(arch), tspecs.SHAPES[shape])
    assert cfg.sliding_window == jcfg.sliding_window
    assert model_step_flops(cfg, tspecs.SHAPES[shape]) == jax_model_step_flops(
        jcfg, jspecs.SHAPES[shape])


@dataclasses.dataclass
class AxesMesh:
    """A mesh described only by its axes, as both packages read one."""
    axis_names: tuple
    shape: dict


MESHES = [AxesMesh(("data", "model"), {"data": 2, "model": 4}),
          AxesMesh(("data", "model"), {"data": 16, "model": 16}),
          AxesMesh(("pod", "data", "model"), {"pod": 2, "data": 16, "model": 16}),
          AxesMesh(("data", "model"), {"data": 1, "model": 1})]


@pytest.mark.parametrize("batch", [1, 2, 8, 32, 128, 256, 6])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m.shape.values())))
def test_dp_axes_match_the_reference(mesh, batch):
    assert tspecs._dp_axes(mesh, batch) == jspecs._dp_axes(mesh, batch)


@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-v3-671b", "zamba2-1.2b"])
@pytest.mark.parametrize("mesh", MESHES[:3], ids=lambda m: "x".join(map(str, m.shape.values())))
def test_dual_axis_and_zero1_specs_match_the_reference(mesh, arch):
    jparams, jspec = JaxModel(jax_config(arch)).init(None, abstract=True)
    model = Model(get_config(arch))
    pspecs = model.param_partition_specs()
    shapes = {k: s[0] for k, s in model.param_specs().items()}
    for mine, ref in ((tspecs._dual_axis_specs, jspecs._dual_axis_specs),
                      (tspecs._zero1_specs, jspecs._zero1_specs)):
        got = {k: norm(v) for k, v in mine(pspecs, shapes, mesh).items()}
        assert got == flat_specs(ref(jspec, jparams, mesh))
