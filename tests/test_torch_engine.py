"""The port's serving engine: the ragged continuous-batching oracle of the
reference's engine tests replayed on the port, the port's tokens against
the JAX engine's on the same bridged weights, and admission control."""

import dataclasses
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.serving import Engine as JaxEngine  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServeStats as JaxServeStats  # noqa: E402
from repro.serving import run_closed_loop as jax_run_closed_loop  # noqa: E402
from repro.training.checkpoint import _flatten  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    Engine, OutOfPages, Request, ServeStats, run_closed_loop,
)

ARCH = "qwen3-8b"
# the deepseek-v2 smoke config with GQA in place of MLA (the MoE family on
# the paged backend)
GQA_MOE = "deepseek-v2-236b+gqa"
MLA_ARCHS = ("deepseek-v2-236b", "deepseek-v3-671b")
ARCHS = ("qwen3-8b", "mamba2-370m", "zamba2-1.2b", "phi4-mini-3.8b", "llama3-405b",
         "internvl2-1b", "musicgen-large") + MLA_ARCHS + (GQA_MOE,)
# (backend, arch): MLA's latent cache has no paged layout
BACKEND_CASES = [(b, a) for a in ARCHS for b in ("flat", "paged")
                 if b == "flat" or a not in MLA_ARCHS]
MAX_LEN = 64
NEW_TOKENS = 6
_CACHE = {}


def variant(get, arch, **overrides):
    """``get(arch)`` of either package's registry; ``+gqa`` swaps MLA for GQA."""
    base = arch.removesuffix("+gqa")
    cfg = get(base, **overrides)
    return dataclasses.replace(cfg, attention_kind="gqa") if base != arch else cfg


def port_model(arch=ARCH):
    """The port's smoke model with its own seeded weights (bf16, as served)."""
    if ("port", arch) not in _CACHE:
        m = Model(variant(get_smoke_config, arch))
        _CACHE[("port", arch)] = (m, m.init(0, device="cpu"))
    return _CACHE[("port", arch)]


def bridged_fp32(arch=ARCH):
    if ("bridged", arch) not in _CACHE:
        jm = JaxModel(variant(jax_smoke, arch, dtype="float32"), remat=False)
        jp, _ = jm.init(jax.random.PRNGKey(0))
        m = Model(variant(get_smoke_config, arch, dtype="float32"))
        _CACHE[("bridged", arch)] = (
            jm, jp, m, params_from_jax(_flatten(jp), m.cfg, device="cpu"))
    return _CACHE[("bridged", arch)]


def make_prompts(cfg, lengths, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, size=L).astype(np.int32) for L in lengths]


def solo_tokens(m, params, prompt, new_tokens=NEW_TOKENS):
    """The oracle: the request decoded alone in a batch-1 flat engine."""
    eng = Engine(m, params, batch=1, max_len=MAX_LEN, kv_backend="flat")
    req = Request(rid=0, prompt=prompt, max_new_tokens=new_tokens)
    run_closed_loop(eng, [req])
    return list(req.out_tokens)


@pytest.mark.parametrize("backend,arch", BACKEND_CASES)
def test_ragged_oracle_staggered_admits(backend, arch):
    """Three requests of different prompt lengths, admitted at staggered
    steps: every request's tokens equal its solo decode ("paged" gives the
    flat state cache for the pure SSM model, as in the reference)."""
    m, params = port_model(arch)
    prompts = make_prompts(m.cfg, (3, 5, 9))
    solo = [solo_tokens(m, params, p) for p in prompts]
    eng = Engine(m, params, batch=3, max_len=MAX_LEN, kv_backend=backend)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS) for i, p in enumerate(prompts)]
    eng.admit(reqs[0])
    eng.step()
    eng.step()
    eng.admit(reqs[1])
    eng.step()
    eng.admit(reqs[2])
    while eng.num_live:
        eng.step()
    for req, want in zip(reqs, solo):
        assert req.out_tokens == want, (req.rid, req.out_tokens, want)


@pytest.mark.parametrize("backend,arch", BACKEND_CASES)
def test_ragged_oracle_slot_reuse(backend, arch):
    """More requests than slots: freed slots are re-admitted at new offsets
    and the oracle still holds for every request."""
    m, params = port_model(arch)
    prompts = make_prompts(m.cfg, (4, 7, 3, 6, 5), seed=11)
    solo = [solo_tokens(m, params, p) for p in prompts]
    eng = Engine(m, params, batch=2, max_len=MAX_LEN, kv_backend=backend)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS) for i, p in enumerate(prompts)]
    stats = run_closed_loop(eng, reqs)
    assert stats.served == len(reqs)
    for req, want in zip(reqs, solo):
        assert req.out_tokens == want, (req.rid, req.out_tokens, want)


@pytest.mark.parametrize("backend,arch", BACKEND_CASES)
def test_tokens_equal_jax_engine_on_bridged_weights(backend, arch):
    """Token for token, the port's engine and the JAX engine agree on the
    same float32 weights, through slot reuse and a 16-token bucket (or
    16-step SSM chunk) boundary."""
    jm, jp, m, tp = bridged_fp32(arch)
    prompts = make_prompts(m.cfg, (4, 17, 3, 9, 12), seed=5)
    jreqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=NEW_TOKENS) for i, p in enumerate(prompts)]
    treqs = [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS) for i, p in enumerate(prompts)]
    jax_run_closed_loop(JaxEngine(jm, jp, batch=2, max_len=MAX_LEN, kv_backend=backend), jreqs)
    eng = Engine(m, tp, batch=2, max_len=MAX_LEN, kv_backend=backend)
    assert eng.kv_backend == ("flat" if m.cfg.arch_type == "ssm" else backend)
    run_closed_loop(eng, treqs)
    for j, t in zip(jreqs, treqs):
        assert t.out_tokens == j.out_tokens, (t.rid, t.out_tokens, j.out_tokens)


def test_moe_prompts_are_not_padded(monkeypatch):
    """A MoE model's prompt reaches the prefill at its own length (padding
    tokens would compete for expert capacity); a dense model's is padded to
    the 16-token bucket."""
    for arch, want in ((GQA_MOE, [5, 12]), ("deepseek-v2-236b", [5, 12]),
                       ("qwen3-8b", [16, 16])):
        m, params = port_model(arch)
        eng = Engine(m, params, batch=2, max_len=MAX_LEN)
        seen = []
        prefill = eng._prefill

        def spy(p, toks, lens, prefill=prefill):
            seen.append(toks.shape[1])
            return prefill(p, toks, lens)

        eng._prefill = spy
        for i, L in enumerate((5, 12)):
            eng.admit(Request(rid=i, prompt=np.arange(1, L + 1, dtype=np.int32),
                              max_new_tokens=2))
        assert eng.pad_to == (1 if m.cfg.arch_type == "moe" else 16)
        assert seen == want, arch


def test_mla_takes_the_flat_backend_and_refuses_paged():
    """As in the reference: "auto" gives the flat latent cache for MLA, and
    "paged" raises ValueError, at the engine and at the model."""
    for arch in MLA_ARCHS:
        m, params = port_model(arch)
        assert not m.supports_paged_kv
        assert Engine(m, params, batch=1, max_len=MAX_LEN).kv_backend == "flat"
        with pytest.raises(ValueError, match="paged KV unsupported"):
            Engine(m, params, batch=1, max_len=MAX_LEN, kv_backend="paged")
        with pytest.raises(ValueError, match="paged KV unsupported"):
            m.init_paged_cache(1, 4, 16, 2, device="cpu")
        jm = JaxModel(variant(jax_smoke, arch))
        with pytest.raises(ValueError, match="paged KV unsupported"):
            JaxEngine(jm, jm.init(jax.random.PRNGKey(0))[0], batch=1, max_len=MAX_LEN,
                      kv_backend="paged")
    m, params = port_model(GQA_MOE)
    assert Engine(m, params, batch=1, max_len=MAX_LEN).kv_backend == "paged"


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", GQA_MOE])
def test_moe_decode_rows_compete_for_capacity_as_in_the_jax_engine(arch):
    """Sixteen slots under ``capacity_factor`` 0.25, so a decode step has
    C = 8 slots an expert for 16 rows and drops assignments: idle rows take
    part in arrival order, as the reference's do, and the port's tokens
    equal the JAX engine's through staggered admissions and slot reuse."""
    jcfg = variant(jax_smoke, arch, dtype="float32", capacity_factor=0.25)
    cfg = variant(get_smoke_config, arch, dtype="float32", capacity_factor=0.25)
    assert jmoe.capacity(16, jcfg) == 8
    jm = JaxModel(jcfg, remat=False)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    m = Model(cfg)
    tp = params_from_jax(_flatten(jp), cfg, device="cpu")
    prompts = make_prompts(cfg, [3 + (5 * i) % 11 for i in range(20)], seed=9)
    jreqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=NEW_TOKENS) for i, p in enumerate(prompts)]
    treqs = [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS) for i, p in enumerate(prompts)]
    jax_run_closed_loop(JaxEngine(jm, jp, batch=16, max_len=MAX_LEN), jreqs)
    run_closed_loop(Engine(m, tp, batch=16, max_len=MAX_LEN), treqs)
    for j, t in zip(jreqs, treqs):
        assert t.out_tokens == j.out_tokens, (t.rid, t.out_tokens, j.out_tokens)


def test_auto_backend_is_paged_and_rejects_unknown():
    m, params = port_model()
    assert Engine(m, params, batch=1, max_len=MAX_LEN).kv_backend == "paged"
    with pytest.raises(ValueError):
        Engine(m, params, batch=1, max_len=MAX_LEN, kv_backend="ring")


def test_admission_refused_on_pool_exhaustion_then_recovers():
    """A pool too small for the whole batch refuses admission (OutOfPages,
    never a silent clamp); the loop completes once slots free up and every
    page returns to the pool."""
    m, params = port_model()
    eng = Engine(m, params, batch=3, max_len=MAX_LEN, kv_backend="paged",
                 page_size=4, num_pages=6)
    reqs = [Request(rid=i, prompt=np.arange(1, 8, dtype=np.int32), max_new_tokens=2)
            for i in range(4)]
    e2 = Engine(m, params, batch=3, max_len=MAX_LEN, kv_backend="paged",
                page_size=4, num_pages=1)
    with pytest.raises(OutOfPages):
        e2.admit(Request(rid=99, prompt=np.arange(1, 8, dtype=np.int32), max_new_tokens=2))
    assert e2.pool.free_pages == 1 and e2.num_live == 0
    stats = run_closed_loop(eng, reqs)
    assert stats.served == 4
    assert stats.preempted == 0  # nobody grows past 2 pages
    assert all(r.done for r in reqs)
    assert eng.pool.free_pages == eng.pool.num_pages


def test_mid_decode_exhaustion_preempts_and_completes():
    m, params = port_model()
    eng = Engine(m, params, batch=3, max_len=MAX_LEN, kv_backend="paged",
                 page_size=4, num_pages=5)
    reqs = [Request(rid=i, prompt=np.arange(1, 6, dtype=np.int32), max_new_tokens=8)
            for i in range(4)]
    stats = run_closed_loop(eng, reqs)
    assert stats.served == 4
    assert stats.preempted > 0
    assert all(len(r.out_tokens) == 8 for r in reqs)
    assert eng.pool.free_pages == eng.pool.num_pages


def test_failed_prefill_releases_pool_reservation():
    m, params = port_model()
    eng = Engine(m, params, batch=2, max_len=MAX_LEN, kv_backend="paged",
                 page_size=4, num_pages=8)
    free_before = list(eng.pool._free)
    req = Request(rid=0, prompt=np.arange(1, 6, dtype=np.int32), max_new_tokens=2)
    good_prefill = eng._prefill

    def boom(*a, **k):
        raise RuntimeError("injected prefill failure")

    eng._prefill = boom
    with pytest.raises(RuntimeError, match="injected"):
        eng.admit(req)
    assert eng.pool._free == free_before
    assert eng.slots == [None, None] and req.out_tokens == []
    eng._prefill = good_prefill
    eng.admit(req)  # the same rid re-admits cleanly
    while eng.num_live:
        eng.step()
    assert req.done
    assert eng.pool.free_pages == eng.pool.num_pages


def test_ttft_includes_the_prefill():
    """TTFT runs from the start of admission, prefill included (the
    reference stamps ``submitted_s`` only after its prefill)."""
    m, params = port_model()
    eng = Engine(m, params, batch=1, max_len=MAX_LEN)
    prefill = eng._prefill

    def slow_prefill(*a):
        time.sleep(0.05)
        return prefill(*a)

    eng._prefill = slow_prefill
    req = Request(rid=0, prompt=np.arange(1, 5, dtype=np.int32), max_new_tokens=2)
    stats = run_closed_loop(eng, [req])
    assert stats.ttft_s[0] >= 0.05


def test_ttft_includes_the_wait_for_a_slot():
    """``run_closed_loop`` submits every request at its start: on one slot
    the second request's TTFT holds the first one's whole service."""
    m, params = port_model()
    eng = Engine(m, params, batch=1, max_len=MAX_LEN)
    reqs = [Request(rid=i, prompt=np.arange(1, 5, dtype=np.int32), max_new_tokens=3)
            for i in range(2)]
    stats = run_closed_loop(eng, reqs)
    first, second = reqs
    assert first.submitted_s == second.submitted_s
    assert stats.ttft_s[1] >= first.finished_s - first.submitted_s > 0.0


def test_seeded_sampling_reproducible():
    m, params = port_model()
    prompts = make_prompts(m.cfg, (4, 4, 4), seed=3)

    def run(temp, seed):
        eng = Engine(m, params, batch=2, max_len=MAX_LEN, temperature=temp, top_k=8)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
        run_closed_loop(eng, reqs, seed=seed)
        return [list(r.out_tokens) for r in reqs]

    assert run(0.0, 0) == run(0.0, 1)
    assert run(0.8, 5) == run(0.8, 5)
    assert run(0.8, 5) != run(0.8, 6)


def test_measured_feedback_is_duck_typed():
    m, params = port_model()
    seen = []

    class Measured:
        def observe(self, service, size, batch, throughput):
            seen.append((service, size, batch, throughput))

    reqs = [Request(rid=i, prompt=np.arange(1, 5, dtype=np.int32), max_new_tokens=3)
            for i in range(3)]
    run_closed_loop(Engine(m, params, batch=2, max_len=MAX_LEN), reqs,
                    measured=Measured(), service=ARCH, size=16)
    assert len(seen) == 1 and seen[0][:3] == (ARCH, 16, 2) and seen[0][3] > 0


def test_stats_summary_schema_equals_reference():
    stats = ServeStats(served=3, tokens=12, ttft_s=[0.1, 0.2], tpot_s=[0.01], wall_s=2.0)
    ref = JaxServeStats(served=3, tokens=12, ttft_s=[0.1, 0.2], tpot_s=[0.01], wall_s=2.0)
    assert stats.summary(ARCH) == ref.summary(ARCH)


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != GQA_MOE])
def test_serve_cli_on_cpu_writes_stats_json(tmp_path, capsys, arch):
    out = tmp_path / "stats.json"
    serve.main(["--arch", arch, "--device", "cpu", "--requests", "3", "--batch", "2",
                "--new-tokens", "3", "--stats-json", str(out)])
    printed = capsys.readouterr().out
    assert "served=3" in printed and f"arch={get_smoke_config(arch).name}" in printed
    summary = json.loads(out.read_text())
    assert summary["counters"]["serving.completed"] == 3.0
    assert set(summary["latency"]) == set(ServeStats().summary()["latency"])


# -- the fixed-shape paged decode step (the one a CUDA graph captures) ----------

FIXED_ARCHS = ("qwen3-8b", "phi4-mini-3.8b", "internvl2-1b", "musicgen-large", "granite-20b")


def _pools(cache):
    return cache["layers"].get("attn", cache["layers"])  # the hybrid's sit under attn/


def _paged_step_inputs(m, B, live, page_size=4, max_pages=4, seed=0):
    """A paged cache over random pool contents, page tables as a pool
    hands them out (distinct pages to live slots, page 0 to idle ones), and
    each live slot's position a page apart; returns (cache, positions,
    num_pages)."""
    rng = np.random.default_rng(seed)
    num_pages = B * max_pages
    cache = m.init_paged_cache(B, num_pages, page_size, max_pages, device="cpu")
    for leaf in ("pool_k", "pool_v"):
        pool = _pools(cache)[leaf]
        pool.copy_(torch.as_tensor(rng.standard_normal(pool.shape), dtype=pool.dtype))
    perm = rng.permutation(num_pages)
    pt = np.zeros((B, max_pages), np.int32)
    pos = np.full(B, -1, np.int64)
    for b in np.flatnonzero(live):
        pt[b] = perm[b * max_pages:(b + 1) * max_pages]
        pos[b] = page_size - 2 + 3 * b % (page_size * (max_pages - 1))
    cache["page_tables"].copy_(torch.from_numpy(pt))
    return cache, pos, num_pages


def _clone_tree(tree):
    return {k: _clone_tree(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _decode_paged_by_rows(p, cfg, x, cache, page_tables, pos):
    """The paged attention's row-indexed form: the live slots looked up
    (a wait for the device), only their k/v written, idle lengths 0."""
    B = x.shape[0]
    cpos, live = tattn.normalize_pos(pos, B, x.device)
    q, k_new, v_new = tattn._gqa_qkv(p, cfg, x, cpos[:, None])
    ps = cache["pool_k"].shape[1]
    rows = live.nonzero().flatten()
    page = page_tables[rows, cpos[rows] // ps].long()
    cache["pool_k"][page, cpos[rows] % ps] = k_new[rows, 0]
    cache["pool_v"][page, cpos[rows] % ps] = v_new[rows, 0]
    lengths = torch.zeros(B, dtype=torch.int32)
    lengths[rows] = (cpos[rows] + 1).to(torch.int32)
    o = ops.paged_decode_attention(q, cache["pool_k"], cache["pool_v"], page_tables, lengths)
    return o.reshape(B, 1, -1) @ p["wo"], cache


@pytest.mark.parametrize("arch", ["granite-20b", "qwen3-8b", "zamba2-1.2b", GQA_MOE])
@pytest.mark.parametrize("live", [
    (False, True, False, True, False),  # idle at both ends and in the middle
    (True, False, False, True, True),
    (True, True, True, True, True),
    (False, False, False, False, True),
], ids=["ends-and-middle", "middle-run", "all-live", "last-only"])
def test_fixed_shape_paged_step_matches_the_row_form_and_writes_idle_rows_to_the_sink(
        arch, live, monkeypatch):
    """Three ragged steps, crossing page boundaries: the paged step (no
    live-row lookup in its attention) gives the live slots the same
    logits, bit for bit, as the row-indexed form, and the same writes into
    every real page; an idle slot writes the sink page only."""
    m, params = port_model(arch)
    live = np.array(live)
    B = live.size
    cache, pos, num_pages = _paged_step_inputs(m, B, live)
    rows_cache, fixed_cache = _clone_tree(cache), _clone_tree(cache)
    rng = np.random.default_rng(1)
    for _ in range(3):
        tok = torch.as_tensor(rng.integers(1, m.cfg.vocab_size, size=(B, 1)))
        with monkeypatch.context() as mp:
            mp.setattr(tattn, "gqa_decode_paged", _decode_paged_by_rows)
            want, _ = m.decode_step_paged(params, rows_cache, tok, torch.from_numpy(pos))
        got, _ = m.decode_step_paged(params, fixed_cache, tok, torch.from_numpy(pos))
        assert torch.equal(got[live], want[live])
        pos = np.where(live, pos + 1, pos)
    for leaf in ("pool_k", "pool_v"):
        before = _pools(cache)[leaf]
        rows_pool, fixed_pool = _pools(rows_cache)[leaf], _pools(fixed_cache)[leaf]
        assert fixed_pool.shape[1] == num_pages + 1
        assert torch.equal(fixed_pool[:, :num_pages], rows_pool[:, :num_pages])
        assert torch.equal(rows_pool[:, num_pages], before[:, num_pages])
        # the real pages written are the live slots' own
        written = (fixed_pool[:, :num_pages] != before[:, :num_pages]).flatten(2).any(-1)
        pages = set(np.flatnonzero(written.any(0).numpy()))
        assert pages <= set(cache["page_tables"][live].flatten().tolist())
        assert len(pages) >= live.sum()
        sink_written = bool((fixed_pool[:, num_pages] != before[:, num_pages]).any())
        assert sink_written == (not live.all())


@pytest.mark.parametrize("arch", FIXED_ARCHS + ("zamba2-1.2b", GQA_MOE))
def test_paged_engine_holds_a_sink_page_and_captures_no_graph_on_the_cpu(arch):
    """Every paged engine's pools hold one sink page past the pool's
    pages; on the CPU the step runs eagerly (graphs are the card's) and
    serves."""
    m, params = port_model(arch)
    eng = Engine(m, params, batch=2, max_len=MAX_LEN, kv_backend="paged", page_size=4,
                 num_pages=9)
    kv = _pools(eng.cache)
    assert kv["pool_k"].shape[1] == kv["pool_v"].shape[1] == 9 + 1
    assert eng._graph is None and eng._decode == m.decode_step_paged
    reqs = [Request(rid=i, prompt=p, max_new_tokens=3)
            for i, p in enumerate(make_prompts(m.cfg, (5, 3)))]
    run_closed_loop(eng, reqs)
    assert all(r.done for r in reqs)
    assert eng.graph_captures == eng.graph_replays == 0
    eng.close()  # nothing to free


@pytest.mark.parametrize("backend", ["paged", "flat"])
def test_a_dropped_engine_is_freed_without_the_collector(backend):
    """An engine holds no reference cycle, so dropping it frees its cache
    (and on a card its decode graph) there and then."""
    import gc
    import weakref

    m, params = port_model("granite-20b")
    eng = Engine(m, params, batch=2, max_len=MAX_LEN, kv_backend=backend)
    run_closed_loop(eng, [Request(rid=0, prompt=make_prompts(m.cfg, (5,))[0],
                                  max_new_tokens=3)])
    ref = weakref.ref(eng)
    gc.disable()
    try:
        del eng
        assert ref() is None
    finally:
        gc.enable()


@pytest.mark.parametrize("num_pages,budget_pages", [(1, None), (5, None), (13, None),
                                                    (None, 7), (None, 7.5)])
def test_page_pool_never_hands_out_the_sink_page(num_pages, budget_pages):
    """Every page the pool holds, drawn until it is exhausted, lies below
    the sink, which is the cache's last page, at any ``num_pages`` or HBM
    budget; so no page table ever names it."""
    from repro_torch.serving.engine import page_hbm_bytes

    m, params = port_model("granite-20b")
    budget = None if budget_pages is None else int(budget_pages * page_hbm_bytes(m.cfg, 4))
    eng = Engine(m, params, batch=4, max_len=MAX_LEN, kv_backend="paged", page_size=4,
                 num_pages=num_pages, hbm_budget_bytes=budget)
    sink = eng.cache["layers"]["pool_k"].shape[1] - 1
    assert sink == eng.pool.num_pages == (num_pages or int(budget_pages))
    rids = []
    while eng.pool.free_pages:
        eng.pool.admit(len(rids))
        eng.pool.append_tokens(len(rids), 4 * min(eng.pool.free_pages,
                                                  eng.pool.max_pages_per_req))
        rids.append(len(rids))
    with pytest.raises(OutOfPages):
        eng.pool.admit(len(rids))
        eng.pool.append_tokens(len(rids), 1)
    held = [p for r in rids for p in eng.pool.request(r).page_ids]
    assert sorted(held) == list(range(sink))
    pt, _ = eng.pool.tables((rids + [None] * 4)[:4])
    assert pt.max() < sink


def test_fixed_shape_paged_engine_matches_the_flat_engine_through_preemption():
    """Staggered admissions, finishes, slots refilled mid-run, contexts
    crossing page boundaries, and a pool small enough to preempt: the
    fixed-shape paged engine's tokens equal the flat engine's."""
    m, params = port_model("granite-20b")
    lens, news = (9, 3, 14, 6, 11, 4), (12, 5, 9, 14, 3, 10)
    outs = {}
    for backend, kw in (("flat", {}), ("paged", {"page_size": 4, "num_pages": 12})):
        eng = Engine(m, params, batch=3, max_len=MAX_LEN, kv_backend=backend, **kw)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=n)
                for i, (p, n) in enumerate(zip(make_prompts(m.cfg, lens, seed=4), news))]
        stats = run_closed_loop(eng, reqs)
        outs[backend] = ([r.out_tokens for r in reqs], stats.preempted)
    assert outs["paged"][1] > 0 and outs["flat"][1] == 0
    assert outs["paged"][0] == outs["flat"][0]
