"""Weight layouts are found by ``arch_type``: the dense and SSM trees are
bit for bit what they were before layouts were files, a new family joins
as one file in ``layouts/`` with no edit, every shipped layout builds the
port's tree for each of the port's smoke configurations of its family, and
every group's slices are made again alone, from the seed rule of
``weights.py``."""

import dataclasses
import hashlib
import inspect
import json
import shutil
import subprocess
import sys
import types

import pytest
import torch
from conftest import ROOT, SB, tiny_cfg

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Model
from servebench import weights


def digest(tree) -> str:
    """SHA-256 of a tree's keys, in order, with each leaf's shape, dtype and bits."""
    h = hashlib.sha256()

    def walk(t, pre=""):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{pre}{k}/")
            else:
                h.update(f"{pre}{k}:{tuple(v.shape)}:{v.dtype}".encode())
                h.update(v.contiguous().view(torch.int16).numpy().tobytes())

    walk(tree)
    return h.hexdigest()


# made with the layouts written inline in weights.py, before they were files
@pytest.mark.parametrize("config,seed,want", [
    ("granite-20b", 0, "60b624038ca807049d9e767dcb0fdc1839076852e3fe35a7bf9eedf53a5b184f"),
    ("granite-20b", 2**31 + 17, "c62fbdaa5b0f8e9062fe5a50da32fa802eb18eba3aba6494fa5e7b41b8507166"),
    ("mamba2-370m", 0, "5d30c23422bda77e62cf490855bbd059855fd2803a9fc513d7c171190df7efc1"),
    ("mamba2-370m", 2**31 + 17, "dbfd33945fb9092505c24542d7a04c1db0d0af01f1795bf14ee78744c0161285"),
])
def test_the_trees_are_bit_for_bit_as_before(config, seed, want):
    assert digest(weights.make_params(tiny_cfg(config)["model"], seed, "cpu")) == want


@pytest.mark.parametrize("config,want", [("granite-20b", 40_631_513_088),
                                         ("mamba2-370m", 839_683_072)])
def test_full_size_bytes_are_as_before(config, want):
    cfg = json.loads((SB / "configs" / f"{config}.json").read_text())["model"]
    assert weights.nbytes(cfg) == want


def test_an_unknown_arch_type_names_the_missing_layout():
    cfg = {**tiny_cfg("granite-20b")["model"], "arch_type": "nosuchfamily"}
    for call in (lambda: weights.make_params(cfg, 1, "cpu"), lambda: weights.nbytes(cfg),
                 lambda: weights.leaf(cfg, 1, "embed")):
        with pytest.raises(ValueError, match="servebench/layouts/nosuchfamily.py"):
            call()


SEED_RULE = [weights.Group("", None, [("embed", (8, 4), "normal", 0.02)]),
             weights.Group("shared", None, [("w", (4, 4), "normal", 0.5)]),
             weights.Group("extra", 3, [("w", (4, 2), "normal", 0.5)]),
             weights.Group("layers", 2, [("w", (4, 4), "normal", 0.5), ("ln", (4,), "norm", 0.1)])]


def test_every_kind_of_group_follows_the_seed_rule(monkeypatch):
    monkeypatch.setitem(sys.modules, "servebench.layouts.rule",
                        types.SimpleNamespace(groups=lambda cfg: SEED_RULE))
    cfg, seed = {"arch_type": "rule"}, 2**31 + 3
    p = weights.make_params(cfg, seed, "cpu")
    assert weights.nbytes(cfg) == 2 * (32 + 16 + 3 * 8 + 2 * 20)
    assert torch.equal(p["embed"], weights.leaf(cfg, seed, "embed"))
    assert torch.equal(p["shared"]["w"], weights.leaf(cfg, seed, "shared/w"))
    assert torch.equal(p["extra"]["w"][2], weights.leaf(cfg, seed, "extra/w", 2))
    assert torch.equal(p["layers"]["w"][1], weights.leaf(cfg, seed, "w", 1))
    assert torch.equal(dict(weights.iter_layer(cfg, seed, 1, torch.bfloat16, "cpu"))["ln"],
                       p["layers"]["ln"][1])
    assert torch.equal(dict(weights.iter_group(cfg, seed, "extra", 1, torch.bfloat16, "cpu"))["w"],
                       p["extra"]["w"][1])
    # the same shape and std under another seed key draws other numbers
    assert not torch.equal(p["shared"]["w"], p["layers"]["w"][0])
    with pytest.raises(IndexError):
        weights.leaf(cfg, seed, "extra/w", 3)


def test_a_layout_that_repeats_a_seed_key_is_refused(monkeypatch):
    clash = SEED_RULE + [weights.Group("", None, [("w", (2,), "normal", 1.0)])]
    monkeypatch.setitem(sys.modules, "servebench.layouts.clash",
                        types.SimpleNamespace(groups=lambda cfg: clash))
    with pytest.raises(ValueError, match="seed key 'w'"):
        weights.make_params({"arch_type": "clash"}, 1, "cpu")


MOE = '''
"""The MoE family as the port builds it: MLA attention, ``first_dense_layers``
unrolled dense blocks, a stack of MoE blocks, and DeepSeek-V3's
multi-token-prediction leaves where ``mtp`` is set."""

from servebench.weights import Group, _normal, top_leaves


def _block(cfg, ffn):
    d, H = cfg["d_model"], cfg["num_heads"]
    qr, r = cfg["q_lora_rank"], cfg["kv_lora_rank"]
    nd, rd, vd = cfg["nope_head_dim"], cfg["rope_head_dim"], cfg["v_head_dim"]
    return [("ln1", (d,), "norm", 0.1), _normal("attn/w_dq", (d, qr)),
            ("attn/q_norm", (qr,), "norm", 0.1), _normal("attn/w_uq", (qr, H * (nd + rd))),
            _normal("attn/w_dkv", (d, r + rd)), ("attn/kv_norm", (r,), "norm", 0.1),
            _normal("attn/w_uk", (r, H * nd)), _normal("attn/w_uv", (r, H * vd)),
            _normal("attn/wo", (H * vd, d)), ("ln2", (d,), "norm", 0.1)] + ffn


def _mlp(pre, d, ff):
    return [_normal(f"{pre}/w_gate", (d, ff)), _normal(f"{pre}/w_up", (d, ff)),
            _normal(f"{pre}/w_down", (ff, d))]


def groups(cfg):
    d, E, ff, n = cfg["d_model"], cfg["num_experts"], cfg["moe_d_ff"], cfg["first_dense_layers"]
    moe = [_normal("moe/router", (d, E), 0.02), _normal("moe/we_gate", (E, d, ff)),
           _normal("moe/we_up", (E, d, ff)), _normal("moe/we_down", (E, ff, d))]
    moe += _mlp("moe/shared", d, ff * cfg["num_shared_experts"])
    mtp = [Group("mtp", None, [_normal("proj", (2 * d, d)), ("norm", (d,), "norm", 0.1)])]
    return ([Group("", None, top_leaves(cfg))]
            + [Group(f"dense_{i}", None, _block(cfg, _mlp("mlp", d, cfg["d_ff"])))
               for i in range(n)]
            + [Group("layers", cfg["num_layers"] - n, _block(cfg, moe))]
            + (mtp if cfg.get("mtp") else []))
'''

HYBRID = '''
"""The Zamba2 hybrid as the port builds it: one shared attention block,
then a stack of superblocks of ``shared_attn_every`` Mamba2 layers."""

from servebench.layouts.ssm import mamba
from servebench.weights import Group, _normal, top_leaves


def groups(cfg):
    d, H, KV = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"]
    hd, every = cfg["head_dim"] or d // H, cfg["shared_attn_every"]
    attn = [("ln", (d,), "norm", 0.1), _normal("wq", (d, H * hd)), _normal("wk", (d, KV * hd)),
            _normal("wv", (d, KV * hd)), _normal("wo", (H * hd, d))]
    block = [(f"mamba_{j}/{k}", *rest) for j in range(every) for k, *rest in mamba(cfg)]
    return [Group("", None, top_leaves(cfg)), Group("shared_attn", None, attn),
            Group("layers", cfg["num_layers"] // every, block)]
'''


def check_tree(cfg, seed):
    """The layout's tree against the port's own: keys and shapes those of
    ``Model.param_specs()``, every leaf bf16, ``nbytes`` its bytes, and each
    group's last row made again alone, bit for bit, by ``iter_group`` and by
    ``leaf``.  Returns the groups."""
    params = weights.make_params(cfg, seed, "cpu")
    flat = {}

    def walk(t, pre=""):
        for k, v in t.items():
            walk(v, f"{pre}{k}/") if isinstance(v, dict) else flat.__setitem__(pre + k, v)

    walk(params)
    specs = Model(ModelConfig(**cfg)).param_specs()
    assert {k: tuple(v.shape) for k, v in flat.items()} == {k: s[0] for k, s in specs.items()}
    assert all(v.dtype == torch.bfloat16 for v in flat.values())
    assert weights.nbytes(cfg) == sum(2 * v.numel() for v in flat.values())
    groups = weights.layout(cfg)
    for g in groups:
        row = -1 if g.rows is None else g.rows - 1
        again = dict(weights.iter_group(cfg, seed, g.prefix, row, torch.bfloat16, "cpu"))
        assert list(again) == [k for k, *_ in g.leaves]
        for k, t in again.items():
            path = f"{g.prefix}/{k}" if g.prefix else k
            assert torch.equal(t, flat[path] if row < 0 else flat[path][row]), path
        key = g.leaves[-1][0]
        one = weights.leaf(cfg, seed, key if g.prefix in ("", "layers") else f"{g.prefix}/{key}",
                           row)
        assert torch.equal(one, again[key])
    return groups


# every shipped layout, crossed with the port's smoke configurations of its
# family: a layout file added later gets its cases here with no edit
SHIPPED = [(p.stem, arch) for p in sorted((SB / "layouts").glob("*.py"))
           if p.name != "__init__.py"
           for arch in ARCH_IDS if get_smoke_config(arch).arch_type == p.stem]


@pytest.mark.parametrize("family,arch", SHIPPED, ids=[f"{f}-{a}" for f, a in SHIPPED])
def test_every_shipped_layout_builds_the_ports_tree(family, arch):
    cfg = dataclasses.asdict(get_smoke_config(arch))
    assert cfg["arch_type"] == family
    check_tree(cfg, 2**31 + 41)


# run in a copy of servebench that holds the layout, in a process of its own
DRIVE = '''
import dataclasses, json, sys
sys.path[:0] = [%r, %r]
import numpy as np
import torch
from repro_torch.configs import get_smoke_config
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Model
from repro_torch.serving.engine import Engine, Request
from servebench import weights

assert weights.__file__.startswith(%r), weights.__file__
%s
cfg = dataclasses.asdict(get_smoke_config(%r))
seed = 2**31 + 41
groups = check_tree(cfg, seed)
model = Model(ModelConfig(**cfg))
eng = Engine(model, weights.make_params(cfg, seed, "cpu"), batch=2, max_len=64)
req = Request(rid=0, prompt=np.arange(5, 29, dtype=np.int32), max_new_tokens=4)
eng.admit(req)
eng.step()
print("RESULT", json.dumps({"groups": [[g.prefix, g.rows] for g in groups],
                            "backend": eng.kv_backend, "tokens": req.out_tokens}))
'''


@pytest.mark.parametrize("arch,family,source,want,backend", [
    ("deepseek-v2-236b", "moe", MOE, [["", None], ["dense_0", None], ["layers", 1]], "flat"),
    ("zamba2-1.2b", "hybrid", HYBRID, [["", None], ["shared_attn", None], ["layers", 1]], "paged"),
], ids=["moe", "hybrid"])
def test_a_new_family_joins_as_one_layout_file(tmp_path, arch, family, source, want, backend):
    assert get_smoke_config(arch).arch_type == family
    sb = tmp_path / "servebench"
    shutil.copytree(SB, sb, ignore=shutil.ignore_patterns("__pycache__"))
    # the test's own layout, in place of any shipped file of that name
    (sb / "layouts" / f"{family}.py").write_text(source)
    code = DRIVE % (str(tmp_path), str(ROOT / "src"), str(sb), inspect.getsource(check_tree),
                    arch)
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("RESULT")][-1]
    out = json.loads(line.split(" ", 1)[1])
    assert out["groups"] == want
    assert out["backend"] == backend
    assert len(out["tokens"]) == 2  # one from the admission, one from the step
