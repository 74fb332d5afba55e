"""The port's training substrate (``repro_torch.training`` and
``launch/train.py``) against the JAX package's, on the same bridged
float32 weights and the same batches.

Tolerances, each with its reason:

* batches: bit for bit (one numpy stream, and bf16 rounding is
  round-to-nearest-even in both);
* cross-entropy: 1e-6 relative (float32 logsumexp summed in other orders);
* AdamW: float32 leaves 1e-6 relative, a bf16 leaf within one bf16 step
  (its float32 update may round to either neighbour), the moments 1e-5
  relative;
* the train step's ``loss``, ``ce``, ``aux``, ``mtp`` and ``grad_norm``:
  1e-5 relative at every one of 3 steps (measured about 1e-6);
* parameters after 3 steps: loosely, within 2·lr a step (6e-3 for lr
  1e-3): on a step's first update ``m̂/√v̂`` is about sign(g), so a
  gradient entry near 0 whose sign differs between XLA and PyTorch moves
  its parameter by up to 2·lr.
"""

import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.launch.train import REPRO_100M as JAX_100M  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.training import adamw as jax_adamw  # noqa: E402
from repro.training import checkpoint as jax_checkpoint  # noqa: E402
from repro.training import cross_entropy as jax_cross_entropy  # noqa: E402
from repro.training import data as jax_data  # noqa: E402
from repro.training import make_train_step as jax_make_train_step  # noqa: E402
from repro.training.checkpoint import _flatten  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.common import flatten, unflatten  # noqa: E402
from repro_torch.training import (  # noqa: E402
    adamw, checkpoint, cross_entropy, data, make_train_step,
)

LR = 1e-3
STEPS = 3
METRIC_RTOL = 1e-5
PARAM_ATOL = 2 * LR * STEPS


def bridged(arch, dtype="float32"):
    jcfg = jax_smoke(arch, dtype=dtype)
    cfg = get_smoke_config(arch, dtype=dtype)
    jm = JaxModel(jcfg, remat=False)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    return jcfg, jm, jp, cfg, params_from_jax(_flatten(jp), cfg, device="cpu")


@pytest.mark.parametrize("arch", ["qwen3-8b", "internvl2-1b", "musicgen-large"])
@pytest.mark.parametrize("step", [0, 5])
def test_synthetic_batch_equals_the_reference_bit_for_bit(arch, step):
    jcfg, cfg = jax_smoke(arch), get_smoke_config(arch)
    want = jax_data.synthetic_batch(jcfg, jax_data.DataConfig(batch=3, seq_len=16, seed=2),
                                    step)
    got = data.synthetic_batch(cfg, data.DataConfig(batch=3, seq_len=16, seed=2), step, "cpu")
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        ref = np.asarray(want[k].astype(jnp.float32) if k == "embeds" else want[k])
        assert v.dtype == (torch.bfloat16 if k == "embeds" else torch.int64), k
        np.testing.assert_array_equal(v.float().numpy() if k == "embeds" else v.numpy(), ref)
    if "tokens" in got:
        assert torch.equal(got["labels"], (31 * got["tokens"] + 17) % cfg.vocab_size)


def test_batches_yield_one_batch_a_step():
    cfg = get_smoke_config("qwen3-8b")
    dcfg = data.DataConfig(batch=2, seq_len=8, seed=1)
    got = list(data.batches(cfg, dcfg, 3, "cpu"))
    assert len(got) == 3
    for i, b in enumerate(got):
        assert torch.equal(b["tokens"], data.synthetic_batch(cfg, dcfg, i, "cpu")["tokens"])
    assert not torch.equal(got[0]["tokens"], got[1]["tokens"])


def test_cross_entropy_matches_the_reference():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 50), dtype=np.float32) * 4
    labels = rng.integers(0, 50, size=(3, 7))
    want = float(jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels, jnp.int32)))
    got = cross_entropy(torch.as_tensor(logits), torch.as_tensor(labels))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    # bf16 logits are scored in float32, as the reference scores them
    got16 = cross_entropy(torch.as_tensor(logits).to(torch.bfloat16), torch.as_tensor(labels))
    want16 = jax_cross_entropy(jnp.asarray(logits, jnp.bfloat16), jnp.asarray(labels, jnp.int32))
    np.testing.assert_allclose(float(got16), float(want16), rtol=1e-6)


@pytest.mark.parametrize("case,cfg_kw,grad_scale", [
    ("warmup", dict(lr=1e-2, warmup_steps=3, clip_norm=1e6), 1.0),
    ("clip_engaged", dict(lr=1e-2, warmup_steps=1, clip_norm=0.5), 10.0),
    ("clip_not_engaged", dict(lr=1e-2, warmup_steps=1, clip_norm=1e6), 1e-3),
])
def test_adamw_matches_the_reference_over_three_steps(case, cfg_kw, grad_scale):
    """Warmup, clipping engaged and not, a bf16 leaf among float32 ones
    (a norm weight included, which decays too)."""
    rng = np.random.default_rng(1)
    shapes = {"w": (6, 5), "norm": (5,), "b16": (4, 3)}
    init = {k: rng.standard_normal(s, dtype=np.float32) for k, s in shapes.items()}
    dt = {"w": jnp.float32, "norm": jnp.float32, "b16": jnp.bfloat16}
    jp = {k: jnp.asarray(v, dt[k]) for k, v in init.items()}
    tp = {k: torch.as_tensor(np.array(jp[k].astype(jnp.float32))).to(
        torch.bfloat16 if k == "b16" else torch.float32) for k in init}
    jcfg, cfg = jax_adamw.AdamWConfig(**cfg_kw), adamw.AdamWConfig(**cfg_kw)
    js, ts = jax_adamw.init(jp), adamw.init(tp)
    for step in range(STEPS):
        g = {k: rng.standard_normal(s, dtype=np.float32) * grad_scale for k, s in shapes.items()}
        jg = {k: jnp.asarray(v, dt[k]) for k, v in g.items()}
        tg = {k: torch.as_tensor(np.array(jg[k].astype(jnp.float32))).to(tp[k].dtype)
              for k in g}
        jp, js, jn = jax_adamw.update(jcfg, jg, js, jp)
        tp, ts, tn = adamw.update(cfg, tg, ts, tp)
        assert ts.step == int(js.step) == step + 1
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for k in shapes:
            want = np.asarray(jp[k].astype(jnp.float32))
            got = tp[k].float().numpy()
            assert tp[k].dtype == (torch.bfloat16 if k == "b16" else torch.float32)
            if k == "b16":  # within one bf16 step of the reference
                np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
            # the moments go through the clip scale, whose norm sums in
            # another order, and m's running sum cancels: 1e-5 relative
            np.testing.assert_allclose(ts.mu[k].numpy(), np.asarray(js.mu[k]), rtol=1e-5,
                                       atol=1e-9)
            np.testing.assert_allclose(ts.nu[k].numpy(), np.asarray(js.nu[k]), rtol=1e-5,
                                       atol=1e-12)
    if case == "clip_engaged":
        assert float(tn) > cfg.clip_norm


def test_adam_update_magnitude_is_bounded_by_lr():
    cfg = adamw.AdamWConfig(lr=0.1, clip_norm=1.0, weight_decay=0.0, warmup_steps=1)
    params = {"w": torch.ones((4, 4))}
    state = adamw.init(params)
    before = params["w"].clone()
    params, state, gnorm = adamw.update(cfg, {"w": torch.full((4, 4), 1e6)}, state, params)
    assert float(gnorm) > 1e5
    assert float((params["w"] - before).abs().max()) <= 0.1 * 1.01


@pytest.mark.parametrize("arch", ["qwen3-8b", "granite-20b", "mamba2-370m", "zamba2-1.2b",
                                  "deepseek-v3-671b", "internvl2-1b"])
def test_train_step_matches_the_reference(arch):
    """Three steps of ``make_train_step`` against ``jax.jit`` of the
    reference's, from one bridged init on the same batches."""
    jcfg, jm, jp, cfg, tp = bridged(arch)
    jstep = jax.jit(jax_make_train_step(jm, jax_adamw.AdamWConfig(lr=LR, warmup_steps=2)))
    tstep = make_train_step(Model(cfg, remat=False), adamw.AdamWConfig(lr=LR, warmup_steps=2))
    jo, to = jax_adamw.init(jp), adamw.init(tp)
    for i in range(STEPS):
        jb = jax_data.synthetic_batch(jcfg, jax_data.DataConfig(batch=2, seq_len=32), i)
        tb = data.synthetic_batch(cfg, data.DataConfig(batch=2, seq_len=32), i, "cpu")
        jp, jo, want = jstep(jp, jo, jb)
        tp, to, got = tstep(tp, to, tb)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=METRIC_RTOL,
                                       atol=1e-7, err_msg=f"step {i} {k}")
    if cfg.mtp:
        assert {"mtp", "aux"} <= set(got) and float(got["aux"]) > 0
    want_p = _flatten(jp)
    for k, v in flatten(tp).items():
        np.testing.assert_allclose(v.numpy(), want_p[k], atol=PARAM_ATOL, rtol=0, err_msg=k)


def test_remat_train_step_matches_no_remat():
    """One train step with remat equals one without (the same operations,
    recomputed), parameters included."""
    _, _, _, cfg, tp = bridged("zamba2-1.2b")
    tp2 = unflatten({k: v.clone() for k, v in flatten(tp).items()})
    b = data.synthetic_batch(cfg, data.DataConfig(batch=2, seq_len=32), 0, "cpu")
    opt = adamw.AdamWConfig(lr=LR, warmup_steps=2)
    p1, _, m1 = make_train_step(Model(cfg, remat=False), opt)(tp, adamw.init(tp), b)
    p2, _, m2 = make_train_step(Model(cfg, remat=True), opt)(tp2, adamw.init(tp2), b)
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    for k, v in flatten(p1).items():
        assert torch.equal(v, flatten(p2)[k]), k


def test_loss_falls_on_learnable_data():
    """As the reference's tests/test_training_serving.py holds it: 10
    steps on the affine-rule batches take the loss down by more than 0.3."""
    cfg = get_smoke_config("qwen3-8b")
    model = Model(cfg, remat=False)
    params = model.init(0, device="cpu")
    step = make_train_step(model, adamw.AdamWConfig(lr=1e-3, warmup_steps=5))
    state = adamw.init(params)
    losses = []
    for b in data.batches(cfg, data.DataConfig(batch=4, seq_len=32), 10, "cpu"):
        params, state, metrics = step(params, state, b)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.3


def test_checkpoints_cross_both_ways(tmp_path):
    """The reference's restore reads a port checkpoint into its own tree,
    and the port reads the reference's, with equal arrays, in bf16."""
    _, _, jp, cfg, tp = bridged("zamba2-1.2b", dtype="bfloat16")
    for v in flatten(tp).values():  # a port tree that is not the bridged one
        v.mul_(2)
    port_path, ref_path = str(tmp_path / "port.npz"), str(tmp_path / "sub" / "ref.npz")
    checkpoint.save(port_path, tp)
    into_ref = _flatten(jax_checkpoint.restore(port_path, jp))
    for k, v in flatten(tp).items():
        assert into_ref[k].dtype == np.float32  # _flatten's view of bf16
        np.testing.assert_array_equal(into_ref[k], v.float().numpy(), err_msg=k)
    jax_checkpoint.save(ref_path, jp)
    into_port = checkpoint.restore(ref_path, tp)
    want = _flatten(jp)
    for k, v in flatten(into_port).items():
        assert v.dtype == torch.bfloat16
        np.testing.assert_array_equal(v.float().numpy(), want[k], err_msg=k)


def test_checkpoint_round_trip_keeps_dtypes_and_checks_shapes(tmp_path):
    model = Model(get_smoke_config("qwen3-8b"))
    params = model.init(1, device="cpu")
    path = str(tmp_path / "c.npz")
    checkpoint.save(path, params)
    back = checkpoint.restore(path, params)
    for k, v in flatten(params).items():
        got = flatten(back)[k]
        assert got.dtype == v.dtype and torch.equal(got, v), k
    wrong = Model(get_smoke_config("qwen3-8b", d_model=64, head_dim=16)).init(1, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(path, wrong)


def test_train_cli_runs_on_the_cpu(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt.npz")
    train_cli.main(["--device", "cpu", "--arch", "qwen3-8b", "--smoke", "--steps", "3",
                    "--ckpt", ckpt])
    out = capsys.readouterr().out
    assert "arch=qwen3-smoke params=" in out
    assert len(re.findall(r"^step +\d+ loss [\d.]+ gnorm [\d.]+$", out, re.M)) == 3
    m = re.search(r"done: 3 steps, \d+ tok/s, loss ([\d.]+) -> ([\d.]+)", out)
    assert m and float(m.group(2)) < float(m.group(1))
    params = checkpoint.restore(ckpt, Model(get_smoke_config("qwen3-8b")).init(0, device="cpu"))
    assert all(torch.isfinite(v.float()).all() for v in flatten(params).values())


def test_train_cli_repro_100m_config_is_the_reference():
    assert dataclasses.asdict(train_cli.REPRO_100M) == dataclasses.asdict(JAX_100M)


def test_train_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--smoke", "--steps", "1"])
