"""The port's training forward (``Model.hidden``/``forward``, ``remat``) and
the gradients of its kernel wrappers, against the JAX package's
``Model.forward`` and ``jax.grad`` on the same bridged float32 weights.

Tolerances: float32 logits and aux within 1e-4 (the model tests' float32
bound: XLA and PyTorch sum in other orders); ``remat`` recomputes the same
operations on the CPU, so its values and gradients are held equal."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.configs import long_context_variant as jax_long  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.training.checkpoint import _flatten  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke_config, long_context_variant  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssm_scan as ssm_mod  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan_plain  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.common import flatten, unflatten  # noqa: E402

TOL = 1e-4
# (arch, window): every family, and GQA and MLA under a window shorter than
# the sequence and not dividing it (the serving ring could not take it)
FORWARD_CASES = [(a, None) for a in (
    "qwen3-8b", "granite-20b", "mamba2-370m", "zamba2-1.2b", "deepseek-v2-236b",
    "deepseek-v3-671b", "internvl2-1b", "musicgen-large")] + [
    ("qwen3-8b", 12), ("deepseek-v2-236b", 12)]


def configs(arch, window=None, **overrides):
    """The float32 smoke config of ``arch`` in both packages, windowed."""
    jcfg = jax_smoke(arch, dtype="float32", **overrides)
    cfg = get_smoke_config(arch, dtype="float32", **overrides)
    if window:
        jcfg, cfg = jax_long(jcfg, window), long_context_variant(cfg, window)
    return jcfg, cfg


def bridged(jcfg, cfg, remat=False):
    jm = JaxModel(jcfg, remat=False)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    return jm, jp, Model(cfg, remat=remat), params_from_jax(_flatten(jp), cfg, device="cpu")


def inputs(cfg, B=2, S=32, seed=0):
    """(jax kwargs, torch kwargs): token ids, or bf16-rounded embeddings
    for a stub frontend."""
    rng = np.random.default_rng(seed)
    if cfg.modality != "text":
        emb = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
        emb = np.array(jnp.asarray(emb, jnp.bfloat16).astype(jnp.float32))
        return {"embeds": jnp.asarray(emb)}, {"embeds": torch.as_tensor(emb)}
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    return {"tokens": jnp.asarray(toks)}, {"tokens": torch.as_tensor(toks, dtype=torch.int64)}


@pytest.mark.parametrize("arch,window", FORWARD_CASES)
def test_forward_matches_jax(arch, window):
    jcfg, cfg = configs(arch, window)
    jm, jp, model, tp = bridged(jcfg, cfg)
    jin, tin = inputs(cfg, S=20 if window else 32)
    want_logits, want_aux = jm.forward(jp, **jin)
    with torch.no_grad():
        logits, aux = model.forward(tp, **tin)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=TOL, rtol=TOL)
    assert aux.dtype == torch.float32
    if cfg.arch_type == "moe":
        assert float(aux) > 0


def _loss_and_grads(model, params, tin, seed=1):
    """A scalar of the logits and aux, and its gradient in every leaf."""
    leaves = {k: v.detach().requires_grad_() for k, v in flatten(params).items()}
    logits, aux = model.forward(unflatten(leaves), **tin)
    w = torch.as_tensor(np.random.default_rng(seed).standard_normal(logits.shape,
                                                                    dtype=np.float32))
    loss = (logits * w).mean() + aux
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), dict(zip(leaves, grads))


@pytest.mark.parametrize("arch", ["qwen3-8b", "zamba2-1.2b", "deepseek-v3-671b",
                                  "mamba2-370m"])
def test_remat_matches_no_remat_in_values_and_gradients(arch):
    jcfg, cfg = configs(arch)
    _, _, plain, tp = bridged(jcfg, cfg)
    rematted = Model(cfg, remat=True)
    _, tin = inputs(cfg)
    want_loss, want = _loss_and_grads(plain, tp, tin)
    got_loss, got = _loss_and_grads(rematted, tp, tin)
    assert torch.equal(got_loss, want_loss)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert all(bool(g.abs().sum() > 0) for k, g in want.items() if not k.startswith("mtp/")), \
        "a leaf got no gradient"


def test_gradients_match_jax_and_padded_vocab_gets_zero():
    """jax.grad against autograd through the in-place padded-vocab mask:
    equal gradients, and zero in the head's padded columns."""
    jcfg, cfg = configs("qwen3-8b", vocab_size=500)
    assert cfg.padded_vocab > cfg.vocab_size
    jm, jp, model, tp = bridged(jcfg, cfg)
    jin, tin = inputs(cfg)
    w = np.random.default_rng(1).standard_normal((2, 32, cfg.padded_vocab), dtype=np.float32)

    def jloss(p):
        logits, aux = jm.forward(p, **jin)
        return (logits * w).mean() + aux

    want = _flatten(jax.grad(jloss)(jp))
    _, got = _loss_and_grads(model, tp, tin)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k], atol=TOL, rtol=TOL, err_msg=k)
    assert torch.count_nonzero(got["head"][:, cfg.vocab_size:]) == 0
    assert torch.count_nonzero(got["head"][:, :cfg.vocab_size]) > 0


def _rand(rng, shape, requires_grad=True):
    return torch.as_tensor(rng.standard_normal(shape, dtype=np.float32)).requires_grad_(
        requires_grad)


def _flash_case(rng, window):
    q, k, v = (_rand(rng, (2, 24, n, 32)) for n in (4, 2, 2))
    scale = 32 ** -0.5

    def plain(q, k, v):
        out = fa_mod.flash_attention_plain(*(x.transpose(1, 2) for x in (q, k, v)), scale,
                                           window)
        return out.transpose(1, 2)

    return plain, (q, k, v)


def _scan_case(rng, window):
    x = _rand(rng, (2, 32, 4, 16))
    dt = torch.nn.functional.softplus(_rand(rng, (2, 32, 4), False)).requires_grad_()
    A = (-torch.exp(_rand(rng, (4,), False) * 0.5)).requires_grad_()
    B_, C_ = _rand(rng, (2, 32, 8)), _rand(rng, (2, 32, 8))
    return (lambda *a: ssm_scan_plain(*a, 8)), (x, dt, A, B_, C_)


def _plain_scan_forward(*a):
    """The scan's plain forward half: (y, final, (the entering states,))."""
    return (*ssm_scan_plain(*a), (ssm_mod.ssm_scan_plain_states(*a),))


def _function(case, window):
    """The card's Function for ``case`` with the plain halves: the plain
    forward and the explicit plain backward."""
    if case is _flash_case:
        halves = (fa_mod.flash_attention_plain_lse, fa_mod.flash_attention_bwd_plain)
        return lambda q, k, v: ops.FlashAttentionFn.apply(halves, q, k, v, window,
                                                          1 / np.sqrt(q.shape[-1]))
    halves = (_plain_scan_forward, ssm_mod.ssm_scan_bwd_plain)
    return lambda *a: ops.SsmScanFn.apply(halves, *a, 8)


@pytest.mark.parametrize("case,window", [(_flash_case, None), (_flash_case, 5),
                                         (_scan_case, None)])
@pytest.mark.parametrize("loss_on", ["all", "first"])
def test_plain_gradient_function_backward_equals_plain_autograd(case, window, loss_on):
    """The Functions that the card's flash and scan wrappers take under
    grad, with the plain halves (the plain forward, then the explicit
    backward the kernels follow): the same outputs, and the gradients of
    the plain version's own autograd in every input (with the scan's final
    state unused, as in training, for ``first``), within 1e-5 of the
    largest value of each: the explicit float32 backward sums in another
    order than autograd."""
    plain, args = case(np.random.default_rng(3), window)

    def run(fn):
        rng = np.random.default_rng(4)
        outs = fn(*args)
        outs = outs if isinstance(outs, tuple) else (outs,)
        outs = outs[:1] if loss_on == "first" else outs
        ws = [torch.as_tensor(rng.standard_normal(o.shape, dtype=np.float32)) for o in outs]
        loss = sum((o * w).sum() for o, w in zip(outs, ws))
        return [o.detach() for o in outs], torch.autograd.grad(loss, args)

    want_out, want = run(plain)
    got_out, got = run(_function(case, window))
    for a, b in zip(got_out + list(got), want_out + list(want)):
        _close(a, b)


def _close(got, want, tol=1e-5):
    """Within ``tol`` of the largest |want| (at least 1), and relatively."""
    torch.testing.assert_close(got, want, rtol=tol,
                               atol=tol * max(1.0, want.abs().max().item()))


def test_plain_gradient_function_skips_inputs_without_grad():
    rng = np.random.default_rng(5)
    plain, (q, k, v) = _flash_case(rng, None)
    v = v.detach()
    out = _function(_flash_case, None)(q, k, v)
    assert out.grad_fn is not None
    dq, dk = torch.autograd.grad(out.sum(), (q, k))
    wq, wk = torch.autograd.grad(plain(q, k, v).sum(), (q, k))
    _close(dq, wq)
    _close(dk, wk)


def test_cpu_wrappers_under_grad_are_differentiable_and_count_no_launch():
    rng = np.random.default_rng(6)
    _, (q, k, v) = _flash_case(rng, None)
    _, scan_args = _scan_case(rng, None)
    ops.reset_launches()
    out = ops.flash_attention(q, k, v)
    y, final = ops.ssm_scan(*scan_args, chunk=8)
    assert out.grad_fn is not None and y.grad_fn is not None and final.grad_fn is not None
    assert ops.launches() == dict.fromkeys(ops.launches(), 0)


def test_decode_wrappers_raise_under_grad():
    """Training never reaches the decode kernels, which have no gradient:
    given an input that requires grad under grad mode they raise, on the
    CPU as on a card; under no_grad they run."""
    rng = np.random.default_rng(7)
    q = _rand(rng, (2, 1, 4, 32))
    k, v = _rand(rng, (2, 16, 2, 32), False), _rand(rng, (2, 16, 2, 32), False)
    valid = torch.ones((2, 16), dtype=torch.bool)
    pool = _rand(rng, (5, 4, 2, 32), False)
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    lengths = torch.tensor([5, 8], dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no gradient"):
        ops.decode_attention(q, k, v, valid)
    with pytest.raises(RuntimeError, match="no gradient"):
        ops.paged_decode_attention(q, pool, pool, tables, lengths)
    with torch.no_grad():
        assert ops.decode_attention(q, k, v, valid).shape == q.shape
        assert ops.paged_decode_attention(q, pool, pool, tables, lengths).shape == q.shape
    with pytest.raises(RuntimeError, match="no gradient"):
        ops.decode_attention(q.detach(), k.requires_grad_(), v, valid)


def test_training_forward_reaches_the_kernel_wrappers(monkeypatch):
    """hidden() goes through ops.flash_attention (GQA) and ops.ssm_scan
    (Mamba2), once a layer, and recomputes them once more under remat."""
    calls = {"flash_attention": 0, "ssm_scan": 0}
    for name in calls:
        real = getattr(ops, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(ops, name, spy)
    jcfg, cfg = configs("zamba2-1.2b")
    _, _, model, tp = bridged(jcfg, cfg, remat=True)
    _, tin = inputs(cfg)
    _loss_and_grads(model, tp, tin)
    depth = cfg.num_layers // cfg.shared_attn_every
    assert calls == {"flash_attention": 2 * depth, "ssm_scan": 2 * cfg.num_layers}


def test_remat_is_a_model_field_that_serving_ignores():
    cfg = get_smoke_config("qwen3-8b", dtype="float32")
    assert Model(cfg).remat is True
    tp = Model(cfg).init(0, device="cpu")
    toks = torch.arange(1, 9)[None]
    a, _ = Model(cfg, remat=True).prefill(tp, toks)
    b, _ = Model(cfg, remat=False).prefill(tp, toks)
    assert torch.equal(a, b)
