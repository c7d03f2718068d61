"""The port's engine knobs together (``ray_tpu``'s
test_engine_compat_matrix.py on the port), on the CPU.

Speculative decoding, int8 weights, chunked prefill and paged decode share
one contract: greedy tokens identical to the plain engine (int8 compared
within the same quantized weights). Each of ray_tpu's four fast combos
(test_engine_compat_matrix.py:85-90) is held against the port's own plain
baseline at its quantization level AND against ray_tpu's engine with the
same combo on the same weights.
"""

import dataclasses
import threading
import time

import jax
import numpy as np
import pytest

from ray_tpu.models import llama as jllama
from ray_tpu.serve.llm import LLMEngine as JEngine
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.serve.llm import LLMEngine as TEngine

PROMPTS = [
    [7] * 12,                 # repetitive: prompt lookup drafts
    list(range(2, 32)),       # 30 tokens: chunks under prefill_chunk=8
    [9, 8, 7] * 6,            # mid-length repetitive
    [1, 2, 3],                # short
    list(range(2, 32)),       # repeat: prefix reuse mid-run
]
N_NEW = 16
# A request of this tiny model takes well under a second; a wait this long
# means the engine stopped, and fails the test instead of stalling the run.
WAIT_S = 60

FAST_COMBOS = [
    (2, None, 8, True),       # spec + chunked + paged, f32
    (2, "int8", 8, True),     # everything on at once
    (0, None, 8, False),      # chunked alone
    (0, None, 0, True),       # paged alone
]


@pytest.fixture(scope="module")
def tiny():
    jcfg = jllama.tiny_config(max_seq_len=64)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(7))
    tcfg = tllama.tiny_config(max_seq_len=64)
    tree = jax.tree.map(np.asarray, jax.device_get(jparams))
    return jcfg, jparams, tcfg, tllama.from_jax_params(tree, tcfg, "cpu")


def _kw(**kw):
    for k, v in dict(max_batch=2, max_len=64, prompt_buckets=[8, 16],
                     prefix_block=8).items():
        kw.setdefault(k, v)
    return kw


def _run(engine):
    try:
        outs = [engine.generate(p, max_new_tokens=N_NEW,
                                timeout=WAIT_S)["token_ids"]
                for p in PROMPTS]
        return outs, engine.stats()
    finally:
        engine.close()


def _port(tiny, cfg=None, **kw):
    return _run(TEngine(cfg or tiny[2], tiny[3], device="cpu", **_kw(**kw)))


def _combo_kw(spec, quant, chunked, paged):
    kw = {}
    if spec:
        kw.update(spec_draft_len=spec, spec_chunk=2)
    if quant:
        kw.update(quantize=quant)
    if chunked:
        kw.update(prefill_chunk=chunked)
    if paged:
        kw.update(paged_decode=True)
    return kw


@pytest.fixture(scope="module")
def baselines(tiny):
    """The port's plain engine (multi-step off) per quantization level."""
    return {None: _port(tiny, multi_step=False)[0],
            "int8": _port(tiny, multi_step=False, quantize="int8")[0]}


@pytest.mark.parametrize("spec,quant,chunked,paged", FAST_COMBOS)
def test_combo_tokens_match_plain_and_jax(tiny, baselines, spec, quant,
                                          chunked, paged):
    kw = _combo_kw(spec, quant, chunked, paged)
    outs, stats = _port(tiny, **kw)
    assert outs == baselines[quant], kw
    jouts, _ = _run(JEngine(tiny[0], tiny[1], **_kw(**kw)))
    assert outs == jouts, kw
    admissions = len(PROMPTS)
    assert stats["host_syncs"]["prefill"] == admissions
    if spec:
        assert stats["spec_chunks"] > 0
        assert stats["dispatches"]["verify"] == stats["spec_chunks"]
    if chunked:
        # The 30-token prompt splits into 8+8+8+6 (or its uncached
        # suffix into more than one chunk): more prefill dispatches than
        # admissions, still one counted prefill sync per admission.
        assert stats["dispatches"]["prefill"] > admissions
    else:
        assert stats["dispatches"]["prefill"] == admissions
    if quant:
        assert stats["quantize"] == "int8"
        assert stats["weight_bytes"] < stats["weight_bytes_f32"] / 2


def test_cfg_level_paged_decode_pads_cache(tiny, baselines):
    """LlamaConfig.paged_decode with no engine kwarg keeps its own page
    (24) and the engine pads the cache to it: 64 -> 72 rows."""
    cfg = dataclasses.replace(tiny[2], paged_decode=True, decode_page=24)
    eng = TEngine(cfg, tiny[3], device="cpu", **_kw())
    assert eng.cache["k"].shape[3] == 72
    assert eng.cfg.decode_page == 24
    outs, _ = _run(eng)
    assert outs == baselines[None]


def test_engine_kwarg_paged_uses_prefix_block_pages(tiny):
    eng = TEngine(tiny[2], tiny[3], device="cpu", paged_decode=True,
                  spec_draft_len=4, **_kw(prefix_block=16))
    try:
        # 64 rows + a 5-row scratch strip, padded to 16-row pages.
        assert eng.cache["k"].shape[3] == 80
        assert eng.cfg.decode_page == 16 and eng.paged_decode
    finally:
        eng.close()


def test_chunked_prefill_prefix_reuse_and_streaming(tiny):
    """A warm repeat reuses the prefix cache and gives the cold tokens; a
    long prompt chunked while another request streams changes neither
    output (ray_tpu's test_engine_compat_matrix.py:341-377)."""
    eng = TEngine(tiny[2], tiny[3], device="cpu", prefill_chunk=8,
                  decode_chunk=4, **_kw())
    long_prompt = list(range(2, 32))
    try:
        cold = eng.generate(long_prompt, max_new_tokens=8, timeout=WAIT_S)
        assert cold["cached_prefix_len"] == 0
        warm = eng.generate(long_prompt, max_new_tokens=8, timeout=WAIT_S)
        assert warm["cached_prefix_len"] == 24
        assert warm["token_ids"] == cold["token_ids"]
        alone = {"decode": eng.generate([5, 4, 3], 20,
                                        timeout=WAIT_S)["token_ids"],
                 "long": eng.generate(list(range(32, 60)), 6,
                                      timeout=WAIT_S)["token_ids"]}
        got = {}

        def consume(name, prompt, n):
            got[name] = list(eng.generate_stream(prompt, max_new_tokens=n,
                                                  timeout=WAIT_S))

        t1 = threading.Thread(target=consume,
                              args=("decode", [5, 4, 3], 20))
        t1.start()
        deadline = time.monotonic() + WAIT_S
        while eng.metrics.requests < 5 and time.monotonic() < deadline:
            time.sleep(0.001)
        consume("long", list(range(32, 60)), 6)
        t1.join(timeout=WAIT_S)
        stats = eng.stats()
    finally:
        eng.close()
    assert got == alone
    assert stats["host_syncs"]["prefill"] == 6
    assert stats["dispatches"]["prefill"] > 6
