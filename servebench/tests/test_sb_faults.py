"""The check catches a broken timed path: the harness runs the whole cell
(past its look for a card) with the program broken underneath, and
``correct`` comes out false, for each fault a served cell can have:

* a decode step that returns its state unchanged (no KV row, no SSM
  state written);
* half of the batch left out of a step (its slots neither read nor write
  their cache);
* a token altered where it is produced (a decode step's output).

The exchange between chips cannot be left out: every cell runs on one."""

import pytest

from servebench import harness

CELLS = ("tiny.chat", "tiny.burst", "tiny.code")


def frozen_state(model_cls):
    orig = model_cls._decode

    def decode(self, params, cache, token, pos, paged):
        saved = {}

        def keep(t, pre=""):
            for k, v in t.items():
                if isinstance(v, dict):
                    keep(v, f"{pre}{k}/")
                elif k != "page_tables":
                    saved[pre + k] = (v, v.clone())

        keep(cache)
        out = orig(self, params, cache, token, pos, paged)
        for v, old in saved.values():
            v.copy_(old)
        return out

    return decode


def half_batch(model_cls):
    orig = model_cls._decode
    steps = [0]

    def decode(self, params, cache, token, pos, paged):
        # every other slot, the odd ones on one step and the even ones on
        # the next: half of each step's batch, and every request in turn
        steps[0] += 1
        pos = pos.clone()
        pos[steps[0] % 2::2] = -1
        return orig(self, params, cache, token, pos, paged)

    return decode


def altered_token(engine_cls):
    orig = engine_cls.step

    def step(self, rng=None):
        # each request's third token is altered as the step produces it
        finished = orig(self, rng)
        for req in [r for r in self.slots if r is not None] + finished:
            if len(req.out_tokens) == 3:
                req.out_tokens[-1] = (req.out_tokens[-1] + 1) % self.cfg.vocab_size
        return finished

    return step


def run(base, cell):
    return harness.run_cell(cell, 2**31 + 17, 1.5, False, device="cpu", bench=base[1],
                            base=base[0])


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(tiny_base, cell):
    out = run(tiny_base, cell)
    assert out["correct"], out["checks"]
    assert out["checks"]["logit_gap"]["value"] < out["checks"]["logit_gap"]["limit"]


@pytest.mark.parametrize("fault", ["frozen_state", "half_batch", "altered_token"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(tiny_base, monkeypatch, cell, fault):
    from repro_torch.models.transformer import Model
    from repro_torch.serving.engine import Engine

    if fault == "altered_token":
        monkeypatch.setattr(Engine, "step", altered_token(Engine))
    else:
        monkeypatch.setattr(Model, "_decode", globals()[fault](Model))
    out = run(tiny_base, cell)
    assert not out["correct"], out["checks"]
    assert out["checks"]["logit_gap"]["value"] > out["checks"]["logit_gap"]["limit"]
