"""The port's continuous batcher (``repro_torch.serve.continuous``) against
the reference's (``repro.serve.continuous``), on every ported smoke
config, with the reference's weights carried across.

In float32 the outputs agree token for token and the requests finish in
the same order: the reference's two scenarios (tests/test_serve.py: 5
requests on 2 slots, 2 requests on 1 slot) and a recycled slot, where
three equal prompts served through one slot give three different outputs
in both packages, since the slots share one cache length that never
resets (ROADMAP C9).  In bfloat16 the finish order and the output lengths
agree.  Past ``max_seq`` the reference's attention cache write clamps to
the last row and it completes; the port refuses with ``ValueError``."""

import jax
import numpy as np
import pytest

from test_torch_lm import ARCHS, _model
from test_torch_parity import torch
from torch_lm_cases import BATCHER_SCENARIOS as SCENARIOS

from repro.serve.continuous import ContinuousBatcher as JaxBatcher
from repro.serve.continuous import Request as JaxRequest
from repro_torch.serve import (ContinuousBatcher, Engine, Request,
                               SamplingParams)
from repro_torch.serve import continuous


def _serve(batcher_cls, request_cls, cfg, params, scenario, run_arg, **kw):
    n_slots, max_seq, reqs = SCENARIOS[scenario] if isinstance(scenario, str) else scenario
    cb = batcher_cls(cfg, params, max_seq=max_seq, n_slots=n_slots, eos_id=-1, **kw)
    for rid, (prompt, new) in enumerate(reqs):
        cb.submit(request_cls(rid=rid, prompt=list(prompt), max_new_tokens=new))
    done = cb.run(run_arg, max_steps=200)
    return cb, [(r.rid, list(r.out)) for r in done]


def _both(model, scenario):
    arch, dtype, jcfg, tcfg, jparams, tparams = model
    _, want = _serve(JaxBatcher, JaxRequest, jcfg, jparams, scenario,
                     jax.random.PRNGKey(0))
    cb, got = _serve(ContinuousBatcher, Request, tcfg, tparams, scenario, None,
                     device="cpu")
    assert cb.active == 0 and not cb.queue
    return want, got


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_batcher_matches_the_reference_in_float32(arch, scenario):
    want, got = _both(_model(arch, "float32"), scenario)
    assert got == want
    n_reqs = len(SCENARIOS[scenario][2])
    assert len(got) == n_reqs
    if scenario == "recycled_slot":
        # the same prompt three times, one after another in the one slot:
        # each later request starts at a later shared position, over the
        # earlier ones' rows or state
        assert len({tuple(out) for _, out in got}) == 3


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_batcher_finish_order_and_lengths_match_the_reference_in_bf16(arch, scenario):
    want, got = _both(_model(arch, "bfloat16"), scenario)
    assert [(rid, len(out)) for rid, out in got] == [(rid, len(out)) for rid, out in want]
    vocab = _model(arch, "bfloat16")[3].vocab_size
    assert all(0 <= t < vocab for _, out in got for t in out)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_first_wave_equals_engine_generate(arch, dtype):
    """Requests admitted together at the first step run on a fresh cache in
    lockstep, as the Engine's static batch does: the same tokens."""
    _, _, _, tcfg, _, tparams = _model(arch, dtype)
    prompts = np.random.default_rng(3).integers(1, tcfg.vocab_size, (3, 6))
    new = 5
    cb, got = _serve(ContinuousBatcher, Request, tcfg, tparams,
                     (3, 32, [(p.tolist(), new) for p in prompts]), None,
                     device="cpu")
    eng = Engine(tcfg, tparams, max_seq=32, batch_size=3, device="cpu")
    want = eng.generate(None, torch.from_numpy(prompts.astype(np.int32)), new)
    assert [rid for rid, _ in got] == [0, 1, 2]
    assert [out for _, out in got] == want.tolist()


def test_past_max_seq_the_reference_clamps_and_the_port_refuses():
    """The shared length counts every step: 4 requests of 2 + 3 tokens on one
    slot take 16 steps, past a max_seq of 8, though each request alone
    fits.  The reference writes the later rows onto row 7 and completes;
    the port's step refuses, and the batcher says why."""
    arch, dtype, jcfg, tcfg, jparams, tparams = _model("llama3-8b", "float32")
    scenario = (1, 8, [([3 + rid, 4], 3) for rid in range(4)])
    jcb, want = _serve(JaxBatcher, JaxRequest, jcfg, jparams, scenario,
                       jax.random.PRNGKey(0))
    assert len(want) == 4 and int(jcb.cache["len"]) == 16 > 8
    with pytest.raises(ValueError, match="share one cache length.*every step"):
        _serve(ContinuousBatcher, Request, tcfg, tparams, scenario, None,
               device="cpu")
    # what the port serves before it refuses is the reference's
    cb = ContinuousBatcher(tcfg, tparams, max_seq=8, n_slots=1, eos_id=-1, device="cpu")
    for rid, (prompt, new) in enumerate(scenario[2]):
        cb.submit(Request(rid=rid, prompt=prompt, max_new_tokens=new))
    for _ in range(8):
        cb.step()
    assert [(r.rid, r.out) for r in cb._finished] == want[:2]


def test_past_max_seq_an_rwkv_batcher_runs_on_in_both():
    """RWKV keeps no per-position rows, so past max_seq there is nothing to
    clamp or refuse: both packages serve on, and agree."""
    model = _model("rwkv6-7b", "float32")
    scenario = (1, 8, [([3 + rid, 4], 3) for rid in range(4)])
    arch, dtype, jcfg, tcfg, jparams, tparams = model
    _, want = _serve(JaxBatcher, JaxRequest, jcfg, jparams, scenario,
                     jax.random.PRNGKey(0))
    cb, got = _serve(ContinuousBatcher, Request, tcfg, tparams, scenario, None,
                     device="cpu")
    assert got == want and cb.cache["len"] == 16


def test_retire_on_eos_and_on_max_seq():
    """The reference's retire test as it stands: EOS, the budget, or the
    request's own prompt and output reaching max_seq."""
    _, _, _, tcfg, _, tparams = _model("llama3-8b", "float32")
    _, got = _serve(ContinuousBatcher, Request, tcfg, tparams,
                        (1, 64, [([5, 6], 3)]), None, device="cpu")
    first = got[0][1][0]
    cb = ContinuousBatcher(tcfg, tparams, max_seq=64, n_slots=1, eos_id=first,
                           device="cpu")
    cb.submit(Request(rid=0, prompt=[5, 6], max_new_tokens=3))
    assert [r.out for r in cb.run(None)] == [[first]]
    cb = ContinuousBatcher(tcfg, tparams, max_seq=5, n_slots=1, eos_id=-1,
                           device="cpu")
    cb.submit(Request(rid=0, prompt=[5, 6], max_new_tokens=10))
    done = cb.run(None)
    assert len(done[0].out) == 2 and done[0].done          # 3 + 2 >= 5


def test_temperature_sampling_stays_in_the_top_k_support(monkeypatch):
    _, _, _, tcfg, _, tparams = _model("granite-moe-3b-a800m", "float32")
    seen = []
    sample = continuous.sample_token

    def recording(logits, sp, generator=None):
        tok = sample(logits, sp, generator)
        seen.append((logits, tok))
        return tok
    monkeypatch.setattr(continuous, "sample_token", recording)
    sp = SamplingParams(temperature=1.0, top_k=3)
    scenario = (2, 64, [([1 + rid, 2, 3], 6) for rid in range(4)])
    outs = [_serve(ContinuousBatcher, Request, tcfg, tparams, scenario,
                   torch.Generator().manual_seed(0), sp=sp, device="cpu")[1]
            for _ in range(2)]
    assert outs[0] == outs[1]              # the generator decides the draws
    for logits, tok in seen:
        top = torch.topk(logits, 3, dim=-1).indices
        assert bool((top == tok[:, None].long()).any(-1).all())
    greedy = _serve(ContinuousBatcher, Request, tcfg, tparams, scenario, None,
                    device="cpu")[1]
    assert outs[0] != greedy               # it draws, not only argmaxes


def test_default_device_raises_without_a_gpu(monkeypatch):
    _, _, _, tcfg, _, tparams = _model("llama3-8b", "float32")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousBatcher(tcfg, tparams, max_seq=8, n_slots=1)
