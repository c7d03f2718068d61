"""Prompt-lookup draft proposer + per-request adaptive draft control.

Speculative decoding (Leviathan et al. 2023) needs a cheap source of
candidate continuations; a separate draft model is a deployment burden
(two sets of weights, two compiles) and is useless on the tiny-cpu test
config. Prompt-lookup decoding (vLLM's ``[ngram]`` speculator / PLD)
is model-free: the longest n-gram that ends the current context
(``prompt_ids + generated``) is searched for an EARLIER occurrence in
the same context, and the tokens that followed that occurrence are
proposed as the draft. It bites exactly where serving traffic repeats
itself — code edits, RAG quotes, structured output, and the repetition
loops greedy decode itself falls into. The scan is bounded
(``lookback`` most recent tokens) and chronic misses back off through
the same controller as rejections, so non-repetitive contexts stop
paying even the lookup after a few ticks.

Everything here is host-side and framework-free (unit-testable without
a model): the device-side verification of these drafts lives in
``decode_loop.DecodeLoop.verify_chunk``. A copy of
``ray_tpu/serve/engine/drafter.py`` (the port keeps its own copies of
``ray_tpu``'s framework-free modules).

Adaptive draft length: drafting is speculative WORK — every drafted
token widens the verify window the device must compute. ``SpecControl``
tracks the per-request accept rate and resizes the request's draft
allowance multiplicatively (double on >= ``grow_rate`` acceptance,
halve below ``shrink_rate``, floor 0). A request whose drafts keep
getting rejected stops drafting entirely — once NO active request drafts, the
engine dispatches the plain (non-speculative) decode program, so an
adversarial workload pays nothing over speculation-off — and a
periodic probe re-tries a minimal draft in case the generation has
become repetitive since.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence


class PromptLookupDrafter:
    """Longest-suffix n-gram matcher over the request's own context.

    ``lookback`` bounds the scanned region (most recent tokens): the
    right-to-left scan is O(ngram sizes x lookback) of Python slice
    compares per tick, on the engine thread — unbounded context length
    must not grow it. Repetition that matters for drafting is local
    (the current loop), so a bounded window loses almost nothing.
    """

    def __init__(self, ngram_max: int = 3, ngram_min: int = 1,
                 lookback: int = 512):
        if ngram_min < 1 or ngram_max < ngram_min:
            raise ValueError("need 1 <= ngram_min <= ngram_max")
        if lookback < 2:
            raise ValueError("lookback must be >= 2")
        self.ngram_max = ngram_max
        self.ngram_min = ngram_min
        self.lookback = lookback

    def draft(self, context: Sequence[int], need: int) -> List[int]:
        """Up to ``need`` proposed continuation tokens for ``context``.

        Tries suffix n-grams longest-first; for the first n-gram with an
        earlier occurrence, returns the tokens that followed its MOST
        RECENT earlier occurrence (recent matches track the current
        repetition loop better than distant ones). Empty list = no
        match — the caller should skip speculation this tick.
        """
        ctx = list(context)[-self.lookback:]
        L = len(ctx)
        if need <= 0 or L < self.ngram_min + 1:
            return []
        for n in range(min(self.ngram_max, L - 1), self.ngram_min - 1, -1):
            pat = ctx[L - n:]
            # Most recent earlier occurrence: scan right-to-left.
            for start in range(L - n - 1, -1, -1):
                if ctx[start:start + n] == pat:
                    # Read the continuation from the match point; when
                    # it runs off the end of the context, keep reading
                    # from the draft itself (self-extension). A match
                    # near the tail — THE common case for a generation
                    # in a repetition loop, where the best match ends
                    # one period back — would otherwise yield only a
                    # period's worth of tokens; self-extension unrolls
                    # the loop to the full ``need``.
                    out: List[int] = []
                    j = start + n
                    for _ in range(need):
                        out.append(ctx[j] if j < L else out[j - L])
                        j += 1
                    return out
        return []


@dataclasses.dataclass
class SpecControl:
    """Per-request adaptive draft allowance (lives on EngineRequest).

    ``allowance`` is the TOTAL tokens this request may draft per decode
    tick (the device consumes them window by window); ``max_allowance``
    is the draft-buffer capacity (``spec_chunk * draft_len``).

    The controller is deliberately ASYMMETRIC: it doubles on a good
    tick but needs ``bad_limit`` CONSECUTIVE bad ticks to switch off.
    Repetitive generations are bursty — runs of perfect acceptance
    punctuated by one-window breaks — and a controller that halves to
    zero on every break spends most ticks in the (slower) plain path
    waiting out a probe cooldown; that fallback-thrash was measured at
    ~70% plain ticks on a workload with 0.8 in-run accept. Sustained
    rejection (a prompt whose lookups never verify) still drives the
    allowance to a hard 0 within ``bad_limit`` ticks, after which only
    a 1-token probe every ``probe_interval`` ticks remains. (The
    plain-program fallback is roster-wide: it kicks in on ticks where
    NO active request drafted — a backed-off request co-batched with a
    drafting neighbor still rides that tick's verify dispatch.)
    """
    allowance: int
    max_allowance: int
    grow_rate: float = 0.5
    shrink_rate: float = 0.25
    bad_limit: int = 4
    probe_interval: int = 8
    drafted: int = 0          # lifetime drafted tokens
    accepted: int = 0         # lifetime accepted draft tokens
    _bad_streak: int = 0
    _cooldown: int = 0

    def budget(self) -> int:
        """Draft allowance for this tick (0 = skip speculation). A
        request backed off to 0 probes a 1-token draft every
        ``probe_interval`` ticks so it can rejoin if the generation
        turns repetitive."""
        if self.allowance > 0:
            return self.allowance
        self._cooldown -= 1
        if self._cooldown <= 0:
            self._cooldown = self.probe_interval
            return 1
        return 0

    def miss(self) -> None:
        """A tick where lookup found nothing to draft. Misses count
        toward the same bad streak as rejections: a chronically
        non-repetitive context otherwise pays the lookup scan on the
        engine thread EVERY tick forever (back-off only triggered on
        dispatched-then-rejected drafts). Once the streak zeroes the
        allowance, the lookup itself runs only on the periodic probe."""
        self._bad_streak += 1
        if self._bad_streak >= self.bad_limit and self.allowance:
            self.allowance = 0
            self._cooldown = self.probe_interval

    def observe(self, drafted: int, accepted: int) -> None:
        """Fold one tick's verify outcome into the allowance."""
        if drafted <= 0:
            return
        self.drafted += drafted
        self.accepted += accepted
        rate = accepted / drafted
        if rate >= self.grow_rate:
            self._bad_streak = 0
            self.allowance = min(self.max_allowance,
                                 max(1, self.allowance) * 2)
        elif rate < self.shrink_rate:
            self._bad_streak += 1
            self.allowance = max(1, self.allowance // 2)
            if self._bad_streak >= self.bad_limit:
                self.allowance = 0
                self._cooldown = self.probe_interval
        else:
            self._bad_streak = 0
