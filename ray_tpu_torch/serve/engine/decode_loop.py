"""Device-resident multi-token decode loop
(``ray_tpu/serve/engine/decode_loop.py``: ``prefill``, ``decode_step``,
``decode_chunk``, ``verify_step``, ``verify_chunk``).

``decode_chunk`` advances every slot ``chunk`` greedy steps with no host
sync, carrying on the device

- per-slot cache write positions (``lengths``),
- per-slot remaining token budgets,
- per-slot EOS ids (-1 = none), and
- a done mask (EOS seen / budget exhausted / row cap hit),

so the engine fetches at most once per ``chunk`` tokens. Slots that finish
mid-chunk freeze: their length and budget stop advancing, they keep
re-emitting their final token (and writing its KV at their frozen row, as
``ray_tpu`` does), and ``n_valid`` says how many of the chunk's tokens
were live.

``ray_tpu`` ``vmap``s one slot's forward with a scalar cache index; here
the step is batched: each slot writes its own row and attends over its own
``lengths[b] + 1`` rows (``models/llama.forward_with_cache`` with a
per-slot index tensor). ``lax.scan`` is a Python loop; PyTorch queues the
kernels asynchronously, so the loop itself does not wait on the card.
The cache is updated in place.

Speculative verification (``spec_window`` W > 1) adds ``verify_chunk``:
each of its ``spec_chunk`` iterations forwards a [B, W] window (the last
committed token + W-1 host-drafted tokens) in one batched call, computes
the greedy accept mask on the device (longest prefix where draft ==
argmax), applies the same EOS / budget / row-cap stops per window
position, and emits between 1 and W tokens per live slot — still one
host sync per chunk. The engine allocates ``scratch_rows`` extra cache
rows past ``max_len``: done slots park their whole W-row window there
(rows [max_len, max_len + W)), and a live slot's window, which starts
below max_len - 1, ends inside it. ``ray_tpu`` relies on XLA clamping
never firing; here the per-slot index bound is asserted on the device
(``forward_with_cache``).

KV page transfer (``kv_page`` P > 0, built when the engine has a
prefill/decode role or the fleet tier on): ``export_page`` copies one
P-row page of a slot out of the cache, ``install_page`` writes a page, or
a run of pages stacked along the row axis, back in place. ``ray_tpu``'s
``dynamic_slice``/``dynamic_update_slice`` clamp where torch slicing
would truncate, so both clamps are written out and rows land where
``ray_tpu`` lands them.
"""

from __future__ import annotations

from typing import Dict

import torch

from ray_tpu_torch.devtools import cuda_debug
from ray_tpu_torch.models import llama

#: The loop's device programs, in the order ``program_counts`` lists them.
PROGRAMS = ("prefill", "decode_chunk", "decode_step", "verify_chunk",
            "export_page", "install_page")


def to_card(t: torch.Tensor, device) -> torch.Tensor:
    """Host->device copy that never makes the host wait for the card: a
    CPU tensor bound for a card is staged in pinned memory and copied
    without blocking (a pageable copy synchronizes the stream, which
    stalls the engine behind the chunk it just queued). Anything else is
    ``t.to(device)``."""
    if t.device.type == "cpu" and torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class DecodeLoop:
    """Prefill + chunked greedy decode for one model and cache."""

    def __init__(self, cfg: llama.LlamaConfig, params: llama.Params, *,
                 max_len: int, chunk: int = 8, spec_window: int = 1,
                 spec_chunk: int = 0, kv_page: int = 0,
                 prefill_budget: int = 0):
        self.cfg = cfg
        self.params = params
        self.layers = llama.layer_views(params)
        self.max_len = max_len
        self.chunk = max(1, int(chunk))
        self.spec_window = max(1, int(spec_window))
        # Verify iterations per dispatch: by default the token positions
        # scanned per dispatch stay comparable to the plain chunk
        # (chunk // window), as in ray_tpu.
        self.spec_chunk = (max(1, int(spec_chunk)) if spec_chunk
                           else max(1, self.chunk // self.spec_window))
        # Rows of one exported or installed KV page (0 = no transfer).
        self.kv_page = max(0, int(kv_page))
        # Calls per program (a prefill chunk, a decode chunk, a verify
        # chunk, a page export or install), for the engine's stats.
        self.dispatches = {"prefill": 0, "decode": 0, "verify": 0}
        if self.kv_page:
            self.dispatches.update(export_page=0, install_page=0)
        # Declared prefill signatures (one a prompt bucket; 0 = count
        # only) for the RTPU_DEBUG_CUDA signature witness.
        self.prefill_budget = max(0, int(prefill_budget))
        self._witness()

    def _witness(self) -> None:
        """Under RTPU_DEBUG_CUDA=1, wrap every device program in the
        signature witness with its DECLARED steady-state budget: one
        decode chunk signature (+ one verify signature when speculation
        is on), at most one prefill signature per prompt bucket. Off,
        nothing is wrapped: the methods are the class's own."""
        if not cuda_debug.enabled():
            return
        budgets = {"prefill": self.prefill_budget or None,
                   "decode_chunk": 1, "decode_step": 1}
        if self.spec_window > 1:
            budgets["verify_chunk"] = 1
        if self.kv_page:
            budgets.update(export_page=1, install_page=1)
        for name, budget in budgets.items():
            setattr(self, name, cuda_debug.wrap_program(
                getattr(self, name), f"decode_loop.{name}", budget=budget))

    def program_counts(self) -> dict:
        """{program name: distinct signatures} when the RTPU_DEBUG_CUDA
        witness wrapped this loop; {} otherwise."""
        out = {}
        for name in PROGRAMS:
            fn = self.__dict__.get(name)
            if isinstance(fn, cuda_debug.ProgramWitness):
                out[name] = fn.program_count
        return out

    @property
    def scratch_rows(self) -> int:
        """Extra KV rows past ``max_len`` the engine must allocate so every
        verify window lands inside the cache (0 without speculation)."""
        return self.spec_window if self.spec_window > 1 else 0

    @torch.no_grad()
    def prefill(self, cache: Dict[str, torch.Tensor], tokens: torch.Tensor,
                slot: int, cache_index: int):
        """tokens [1, Pb] written into ``slot``'s rows at [cache_index,
        cache_index+Pb) — cache_index > 0 is the prefix-cache path (only
        the uncached suffix re-prefills). Returns (logits, cache)."""
        n_slots = cache["k"].shape[1]
        if not 0 <= slot < n_slots:
            raise IndexError(f"slot {slot} outside {n_slots} cache slots")
        row = {k: v[:, slot:slot + 1] for k, v in cache.items()}
        self.dispatches["prefill"] += 1
        logits, _ = llama.forward_with_cache(self.params, tokens, row,
                                             cache_index, self.cfg,
                                             layers=self.layers)
        return logits, cache

    @torch.no_grad()
    def decode_step(self, cache: Dict[str, torch.Tensor],
                    tokens: torch.Tensor, lengths: torch.Tensor):
        """One decode step for every slot: tokens [B,1] written at rows
        ``lengths`` [B]. Returns (next ids [B] int32, cache)."""
        logits, _ = llama.forward_with_cache(self.params, tokens, cache,
                                             lengths, self.cfg,
                                             layers=self.layers)
        return logits[:, -1].argmax(dim=-1).to(torch.int32), cache

    @torch.no_grad()
    def decode_chunk(self, cache: Dict[str, torch.Tensor],
                     tokens: torch.Tensor, lengths: torch.Tensor,
                     remaining: torch.Tensor, eos_ids: torch.Tensor,
                     done: torch.Tensor):
        """``chunk`` greedy steps, no host sync.

        tokens [B,1] int32 (each slot's last token), lengths [B] int32,
        remaining [B] int32 (token budget), eos_ids [B] int32 (-1 = none),
        done [B] bool (True = slot inactive / already finished).

        Returns (chunk_tokens [B, K], n_valid [B], next_tokens [B, 1],
        new_lengths [B], new_remaining [B], done [B], cache).
        chunk_tokens[b, j] for j >= n_valid[b] are frozen repeats of the
        slot's final token. The trailing carry is the exact input state of
        the next chunk for an unchanged roster (the engine's multi-step
        tick feeds it straight back)."""
        self.dispatches["decode"] += 1
        tok, ln, rem, dn = tokens, lengths, remaining, done
        emitted, was_done = [], []
        for _ in range(self.chunk):
            # The class's step, not the instance's: a witnessed
            # decode_step counts standalone steps only, as ray_tpu's
            # chunk program does not run its step program.
            nxt, cache = DecodeLoop.decode_step(self, cache, tok, ln)
            emit = torch.where(dn, tok[:, 0], nxt)
            ln = torch.where(dn, ln, ln + 1)
            rem = torch.where(dn, rem, rem - 1)
            # The scheduler's termination rules (scheduler.is_finished):
            # budget exhausted, per-slot EOS, or the slot's rows are full.
            fin = (emit == eos_ids) | (rem <= 0) | (ln + 1 >= self.max_len)
            emitted.append(emit)
            was_done.append(dn)
            dn = dn | fin
            tok = emit[:, None]
        n_valid = self.chunk - torch.stack(was_done).sum(
            dim=0, dtype=torch.int32)
        return (torch.stack(emitted, dim=1), n_valid, tok, ln, rem, dn,
                cache)

    @torch.no_grad()
    def verify_step(self, cache: Dict[str, torch.Tensor],
                    tokens: torch.Tensor, lengths: torch.Tensor):
        """One W-token forward for every slot: tokens [B, W] written at rows
        [lengths[b], lengths[b] + W). Returns (greedy targets [B, W] int32,
        cache): targets[b, j] is the model's next token after the context
        plus tokens[b, :j+1]."""
        logits, _ = llama.forward_with_cache(self.params, tokens, cache,
                                             lengths, self.cfg,
                                             layers=self.layers)
        return logits.argmax(dim=-1).to(torch.int32), cache

    @torch.no_grad()
    def verify_chunk(self, cache: Dict[str, torch.Tensor],
                     tokens: torch.Tensor, drafts: torch.Tensor,
                     ndraft: torch.Tensor, lengths: torch.Tensor,
                     remaining: torch.Tensor, eos_ids: torch.Tensor,
                     done: torch.Tensor):
        """``spec_chunk`` speculative verify iterations, no host sync.

        tokens [B,1] (each slot's last committed token), drafts [B,
        spec_chunk, K] int32 (iteration i consumes row i), ndraft [B]
        (valid drafted tokens per slot, consumed front to back),
        lengths / remaining / eos_ids / done as in ``decode_chunk``.

        Returns (emits [B, spec_chunk, W], counts [B, spec_chunk],
        new_lengths [B], done [B], cache): iteration i of slot b emitted
        ``emits[b, i, :counts[b, i]]`` — the accepted draft prefix plus the
        model's bonus or correction token, cut at the first EOS / budget /
        row-cap stop. The emitted tokens are exactly those ``decode_chunk``
        would emit, in order, for any draft content."""
        if self.spec_window < 2:
            raise ValueError("verify_chunk needs spec_window >= 2")
        self.dispatches["verify"] += 1
        w_, k_ = self.spec_window, self.spec_window - 1
        b, dev = tokens.shape[0], tokens.device
        jj = torch.arange(w_, device=dev)
        kk = torch.arange(k_, device=dev)
        first = torch.ones((b, 1), dtype=torch.bool, device=dev)
        tok, ln, rem, nd, dn = tokens, lengths, remaining, ndraft, done
        targets, counts = [], []
        for i in range(self.spec_chunk):
            window_drafts = drafts[:, i]                       # [B, K]
            window = torch.cat([tok, window_drafts], dim=1)    # [B, W]
            # Done slots park their W-row window write in the scratch
            # strip [max_len, max_len + W).
            idx = torch.where(dn, self.max_len, ln)
            t, cache = self.verify_step(cache, window, idx)
            nd_eff = nd.clamp(0, k_)
            match = ((kk[None, :] < nd_eff[:, None])
                     & (window_drafts == t[:, :k_]))
            # acc = longest accepted draft prefix, in [0, K].
            acc = match.to(torch.int32).cumprod(dim=1).sum(dim=1)
            # Per-position stops on the candidate emission t_j, as
            # decode_chunk checks them: after emitting position j the
            # length is ln+j+1 and the budget rem-j-1.
            ln_j = ln[:, None] + jj[None, :] + 1
            rem_j = rem[:, None] - jj[None, :] - 1
            stop = ((t == eos_ids[:, None]) | (rem_j <= 0)
                    | (ln_j + 1 >= self.max_len))
            # Position j emits iff every earlier position emitted without
            # stopping and j is within the accepted prefix (+1 for the
            # bonus token).
            elig = jj[None, :] <= acc[:, None]
            prev_ok = torch.cat([first, ~stop[:, :-1]], dim=1)
            alive = (~dn)[:, None] & (
                (elig & prev_ok).to(torch.int32).cumprod(dim=1) > 0)
            m = alive.sum(dim=1, dtype=torch.int32)            # [B]
            new_dn = dn | (alive & stop).any(dim=1)
            last = t.gather(1, (m - 1).clamp(min=0).long()[:, None])
            tok = torch.where((m > 0)[:, None], last, tok)
            ln = ln + m
            rem = rem - m
            # Drafts carry into the next window only after a FULL window
            # (all K accepted, no stop): a partial accept means the
            # drafted continuation diverged from the generation.
            nd = torch.where(~new_dn & (m == w_), nd - k_, 0)
            dn = new_dn
            targets.append(t)
            counts.append(m)
        return (torch.stack(targets, dim=1), torch.stack(counts, dim=1),
                ln, dn, cache)

    # ------------------------------------------------------ KV transfer

    def _page_start(self, cache: Dict[str, torch.Tensor], slot: int,
                    start: int) -> int:
        """``ray_tpu``'s ``jnp.clip(start, 0, S - P)``; the slot is bounded
        by contract there and checked here."""
        if not self.kv_page:
            raise RuntimeError("DecodeLoop built without KV transfer "
                               "(kv_page=0)")
        n_slots, s = cache["k"].shape[1], cache["k"].shape[3]
        if not 0 <= slot < n_slots:
            raise IndexError(f"slot {slot} outside {n_slots} cache slots")
        return min(max(int(start), 0), s - self.kv_page)

    @torch.no_grad()
    def export_page(self, cache: Dict[str, torch.Tensor], slot: int,
                    start: int):
        """-> (k_page, v_page), each [L, KH, P, D]: copies of rows
        [start, start + P) of ``slot``, start clamped into the cache."""
        start = self._page_start(cache, slot, start)
        self.dispatches["export_page"] += 1
        return tuple(cache[key][:, slot, :, start:start + self.kv_page]
                     .clone() for key in ("k", "v"))

    @torch.no_grad()
    def install_page(self, cache: Dict[str, torch.Tensor],
                     k_page: torch.Tensor, v_page: torch.Tensor, slot: int,
                     start: int) -> Dict[str, torch.Tensor]:
        """Write a page [L, KH, R, D] (R = P, or a run of pages stacked
        along the row axis) into ``slot`` at rows [start, start + R), in
        the cache's dtype, in place. ``start`` is clamped as
        ``export_page``'s, then to S - R, as ``dynamic_update_slice``
        clamps a run longer than one page."""
        start = self._page_start(cache, slot, start)
        s, rows = cache["k"].shape[3], k_page.shape[2]
        if v_page.shape != k_page.shape or rows > s:
            raise ValueError(f"pages {tuple(k_page.shape)}/"
                             f"{tuple(v_page.shape)} for a {s}-row cache")
        start = min(start, s - rows)
        self.dispatches["install_page"] += 1
        for key, page in (("k", k_page), ("v", v_page)):
            dst = cache[key][:, slot, :, start:start + rows]
            dst.copy_(to_card(page, dst.device).to(dst.dtype))
        return cache
