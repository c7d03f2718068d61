#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``ray_tpu_torch``) end to end on one CUDA
card and check it.

    python3 chip_smoke.py              # phases 1-8, the smoke
    python3 chip_smoke.py --spec-ab    # phases 1-2, then speculation off
                                       # against on (bf16), no result line
    python3 chip_smoke.py --flash [DIR]     # phases 1-2, the flash kernels
                                            # and phase 8, no result line
    python3 chip_smoke.py --flash-ab DIR    # --flash on the checkout at DIR
                                            # and on this one, in turns
    python3 chip_smoke.py --decode [DIR]    # phases 1-2, the decode and
                                            # RoPE kernels, no result line
    python3 chip_smoke.py --decode-ab DIR   # --decode for DIR and this one

``--flash`` runs against the package of the checkout at DIR (default:
this one): the flash kernels against their plain versions at phase 3's
flash shapes, their times at phase 8's shape (phase 6's L2-flushed
medians and 20 back-to-back calls with L2 warm, SDPA's beside them), the
backward's device time by kernel, then phase 8. ``--flash-ab DIR`` runs
it for DIR, this checkout, this checkout and DIR, one process each, so
two versions of the kernels are compared on one card in one call.
``--decode [DIR]`` and ``--decode-ab DIR`` do the same for the decode
kernels (contiguous and paged) and RoPE: their checks at phase 3's shapes,
the launch floor, and their times at the shapes of ``decode_rope_times``.

Phases, in the order ``main()`` runs them; any failure raises and the
script exits non-zero without printing its last line:

1. Device: the card's name and power limit (``nvidia-smi``).
2. Build: compile every kernel from ``ray_tpu_torch/csrc`` with nvcc; for
   every kernel instantiation, by name and template arguments, ptxas'
   registers and spills and (decode, flash) the dynamic shared memory of
   its launch.
3. Kernels against their plain PyTorch versions on the card, at the
   slice's shapes, in bf16 and f32 (tolerances below); the paged decode
   kernel also bit-equal to the contiguous one through the identity
   table, through a scattered table, over NaN-poisoned tails; the flash
   attention forward and backward at the training shape, at S=384, and
   at ragged S with B > 1.
4. Model: a 2-layer model at Llama-3-8B widths in f32, prefill + 8
   decode steps through the kernels, against the same model on the plain
   versions; then in f32 and bf16 with ``paged_decode=True``, logits
   bit-equal to the contiguous decode kernel's; then the loss and every
   gradient through the flash and fused kernels under remat against the
   plain route.
5. Engine: ``LLMEngine`` on full-depth Llama-3-8B in bf16 (random weights
   from a seed), 16 requests from 8 client threads; checks every request's
   token count, prefix-cache hits, and that every kernel of its path was
   launched; a profiled decode chunk shows one decode launch a layer and
   step and no merge kernel.
7. Engines with the slice-2 knobs, full-depth Llama-3-8B bf16: (a) phase
   5's configuration and traffic with ``paged_decode=True`` — the paged
   kernel runs, the contiguous one does not; (b) paged decode,
   speculation, chunked prefill and int8 weights all on, with repetitive,
   long and short prompts — speculation and chunked prefill both run.
8. Training, after the engines are gone: full-depth Llama-3-8B in bf16
   (random weights from a seed), ``spmd.init_train_state`` ->
   ``make_train_step(default_optimizer(lr=1e-4, warmup=1))``, 5 steps on
   one batch of B=1, S=2048 from a numpy seed; finite losses and gradient
   norms, a falling loss, the kernels' launch counts per step, step time,
   tokens/s, MFU, peak memory and the device time by group.
6. Timing, last: an empty kernel (the launch floor), then each kernel,
   its plain version and (where one exists) the one PyTorch call that
   computes the same function, with CUDA events, at the decode shapes of
   phase 3 (the flash kernels at phase 8's training shape, with their
   TFLOP/s, share of the bound and, for the backward, each of its three
   kernels' device time); the decode kernels also at S=4096 and at phase
   5's slot lengths, RoPE also at phase 8's shape; then the host
   cost of the fused ops' autograd ``Function``. The ``kernels`` JSON
   line (phase 7a's launches for the paged kernel, phase 8's for the
   flash kernels) is printed just before the last line.

The last line is ``{"ok": true, "device": {...}}``. Needs one card; exits
non-zero at once without one.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

# Tolerances (rtol = atol), those of ray_tpu's own kernel tests:
TOL = {
    # tests/test_decode_attention.py:52 (f32), :120 (bf16)
    "decode_attention": {torch.float32: 2e-3, torch.bfloat16: 2e-2},
    # tests/test_paged_decode.py:83-84 (f32), :152-154 (bf16)
    "paged_decode_attention": {torch.float32: 2e-5, torch.bfloat16: 2e-2},
    # tests/test_fused_ops.py:33-83 (f32); bf16 as test_fused_ops.py:92-94
    "rms_norm": {torch.float32: 1e-6, torch.bfloat16: 2e-2},
    "rms_norm_residual": {torch.float32: 1e-6, torch.bfloat16: 2e-2},
    "swiglu": {torch.float32: 1e-6, torch.bfloat16: 2e-2},
    # attention kernels: test_decode_attention.py:52 (f32), :120 (bf16)
    "flash_attention": {torch.float32: 2e-3, torch.bfloat16: 2e-2},
}
# fused_qk_rope f32: rtol 1e-5, atol 1e-6 (test_fused_ops.py:53-58).
ROPE_TOL = {torch.float32: (1e-5, 1e-6), torch.bfloat16: (2e-2, 2e-2)}
# Phase 4 logits: test_decode_attention.py:84-86 (kernel vs plain model);
# phase 4's loss and gradients: the same, of each tensor's largest value.
MODEL_TOL = 2e-3

# The engines of phases 5 and 7: Llama-3-8B, 8 slots of 512 rows, 16-row
# prefix blocks (= pages). Phase 7b's cache adds the speculative scratch
# strip (draft_len + 1 rows) and pads to a page: 528 rows, the paged
# kernel's S in phases 3 and 6 (checked against the engine's own cache).
ENGINE_KW = dict(max_batch=8, max_len=512, prompt_buckets=[32, 64],
                 decode_chunk=8, prefix_block=16, seed=0)
SPEC_DRAFT_LEN = 4
PAGE = ENGINE_KW["prefix_block"]
PAGED_S = -(-(ENGINE_KW["max_len"] + SPEC_DRAFT_LEN + 1) // PAGE) * PAGE
# Phase 8, the training cell (bench.py's 8B training shape at batch 1).
TRAIN_B, TRAIN_S, TRAIN_STEPS = 1, 2048, 5

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, FLOP/s.
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12      # tensor cores, bf16 inputs
F32_SIMT_FLOPS = 67e12   # elementwise f32 math outside the tensor cores

KERNEL_META = {
    "decode_attention": ("ray_tpu_torch/csrc/decode_attention.cu",
                         "ray_tpu/ops/decode_attention.py:108"),
    "paged_decode_attention": ("ray_tpu_torch/csrc/decode_attention.cu",
                               "ray_tpu/ops/paged_decode.py:130"),
    "rms_norm": ("ray_tpu_torch/csrc/fused.cu", "ray_tpu/ops/fused.py:183"),
    "rms_norm_residual": ("ray_tpu_torch/csrc/fused.cu",
                          "ray_tpu/ops/fused.py:191"),
    "qk_rope": ("ray_tpu_torch/csrc/fused.cu", "ray_tpu/ops/fused.py:266"),
    "swiglu": ("ray_tpu_torch/csrc/fused.cu", "ray_tpu/ops/fused.py:337"),
    "flash_attention": ("ray_tpu_torch/csrc/flash_attention.cu",
                        "ray_tpu/ops/attention.py:162"),
    "flash_attention_bwd": ("ray_tpu_torch/csrc/flash_attention.cu",
                            "ray_tpu/ops/attention.py:162"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def close_enough(got, want, rtol, atol, what):
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite output")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} elements out of "
                             f"tolerance, max abs err {err.max().item()}")
    return err.max().item()


# ----------------------------------------------------------- phase 1, 2

def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    name = torch.cuda.get_device_name(0)
    log(f"phase 1 device: {name}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} card(s)")
    # f32 references must be full f32 (TF32 keeps ~3 digits).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi, name


def phase_build():
    from ray_tpu_torch import ops
    from ray_tpu_torch.ops import _build

    t0 = time.perf_counter()
    ops.build_kernels()
    log(f"phase 2 build: {time.perf_counter() - t0:.3f} s "
        f"({', '.join(_build.SOURCES)})")
    for name in _build.SOURCES:
        if name == "flash_attention":
            flash_ptxas_report()
        else:
            kernel_ptxas_report(name)


def template_args(mangled):
    """A mangled kernel name's template arguments, readable:
    ``...decode_kernelI13__nv_bfloat16Li128ELi4ELb0EE...`` -> ('bf16',
    '128', '4', '0')."""
    m = re.search(r"\d+\w+?_kernelI", mangled)
    if not m:
        return ()
    args, rest = [], mangled[m.end():]
    while True:
        t = re.match(r"13__nv_bfloat16|f|L[ib](-?\d+)E", rest)
        if not t:
            return tuple(args)
        args.append(t.group(1) or ("f32" if t.group(0) == "f" else "bf16"))
        rest = rest[t.end():]


def kernel_ptxas_report(lib):
    """One line per kernel instantiation of ``csrc/<lib>.cu``: its name and
    template arguments, ptxas' registers and spills, and (decode) the
    dynamic shared memory a CTA asks for."""
    import ctypes

    from ray_tpu_torch.ops import _build

    smem = getattr(_build.load(lib), "rtt_decode_attention_smem", None)
    if smem is not None:
        smem.argtypes = [ctypes.c_int] * 3
    entry = spill = None
    for line in _build.build_log(lib).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry, spill = m.group(1), ""
        elif entry and "spill" in line:
            spill = line.strip()
        elif entry and "Used" in line:
            kind = re.search(r"\d+([a-z]\w*?_kernel)", entry)
            args = template_args(entry)
            dyn = ""
            if smem is not None and kind and kind.group(1) == "decode_kernel":
                dt, d, g, paged = args
                dyn = (f"; dynamic smem {smem(int(dt == 'bf16'), int(d), int(g))}"
                       f" bytes{' + 4 a page' if paged == '1' else ''}")
            log(f"  ptxas {lib} {kind.group(1) if kind else entry}"
                f"<{', '.join(args)}>: {line.split(':', 1)[-1].strip()}; "
                f"{spill}{dyn}")
            entry = None
    clusters = getattr(_build.load(lib), "rtt_decode_attention_clusters",
                       None)
    if clusters is not None:
        # What split_plan's one-wave rule rests on, at the engine's B=8,
        # H=32, KH=8, D=128, bf16.
        clusters.argtypes = [ctypes.c_int] * 9
        fit = {n: clusters(8, 32, 8, 4096, 128, 4096 // n, n, 16, 1)
               for n in (1, 2, 4, 8)}
        log(f"  decode_kernel clusters resident at once by cluster size "
            f"(cudaOccupancyMaxActiveClusters): {fit}")


# A flash kernel in ptxas' report: (name, dtype, head_dim) from the
# mangled name.
FLASH_ENTRY = re.compile(r"(fwd_sm90|dkdv_sm90|dq_sm90|fwd_kernel|"
                         r"dkdv_kernel|dq_kernel|delta_kernel)"
                         r"I(13__nv_bfloat16|f)?Li(\d+)E")


def flash_ptxas_report():
    """One line per flash kernel: ptxas' registers and spills and the
    dynamic shared memory a CTA of it asks for (the TMA + wgmma kernels
    then move registers with setmaxnreg: 24 for the producer, 240 for
    each consumer warpgroup)."""
    import ctypes

    from ray_tpu_torch.ops import _build

    smem = getattr(_build.load("flash_attention"),
                   "rtt_flash_attention_smem", None)  # older checkouts lack it
    if smem is not None:
        smem.argtypes = [ctypes.c_int] * 3
    which = {"fwd": 0, "dkdv": 1, "dq": 2}
    entry = spill = None
    for line in _build.build_log("flash_attention").splitlines():
        m = FLASH_ENTRY.search(line)
        if "Compiling entry" in line and m:
            entry, spill = m.groups(), ""
        elif entry and "spill" in line:
            spill = line.strip()
        elif entry and "Used" in line:
            kind, dt, d = entry
            dtype = 1 if kind.endswith("sm90") or dt == "13__nv_bfloat16" \
                else 0
            base = kind.split("_")[0]
            dyn = (f"{smem(which[base], int(d), dtype)} bytes"
                   if base in which and smem is not None else "none")
            log(f"  ptxas flash_attention {kind}<{('f32', 'bf16')[dtype]}, "
                f"D={d}>: {line.split(':', 1)[-1].strip()}; {spill}; "
                f"dynamic smem {dyn}")
            entry = None


# ---------------------------------------------------------------- phase 3

def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


def _randn(shape, dtype, seed, scale=1.0):
    return (torch.randn(shape, generator=_gen(seed), device="cuda")
            * scale).to(dtype)


def decode_inputs(b, h, kh, d, s, dtype, seed, lengths):
    q = _randn((b, h, d), dtype, seed)
    k = _randn((b, kh, s, d), dtype, seed + 1)
    v = _randn((b, kh, s, d), dtype, seed + 2)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, k, v, lens


def check_decode(dtype, s, d=128, seed=0):
    from ray_tpu_torch.ops import decode_attention, decode_attention_reference

    b, h, kh = 8, 32, 8
    lengths = [0, 1, s, s // 2 + 3, 17, s - 1, 100, 257]
    q, k, v, lens = decode_inputs(b, h, kh, d, s, dtype, seed, lengths)
    kp, vp = k.clone(), v.clone()
    for i, n in enumerate(lengths):     # poison every row past the length
        kp[i, :, n:] = 1e4
        vp[i, :, n:] = float("nan")
    got = decode_attention(q, kp, vp, lens, layout="bksd")
    want = decode_attention_reference(q, k, v, lens)
    tol = TOL["decode_attention"][dtype]
    err = close_enough(got, want, tol, tol,
                       f"decode_attention {dtype} S={s} D={d}")
    if got[0].abs().max().item() != 0.0:
        raise AssertionError("decode_attention: length-0 slot is not 0")
    log(f"  decode_attention {str(dtype)[6:]} B=8 H=32 KH=8 D={d} S={s} "
        f"ragged+poisoned: max abs err {err} (tol {tol})")
    return err


def identity_table(b, s, page=PAGE):
    return torch.arange(b * (s // page), dtype=torch.int32,
                        device="cuda").reshape(b, s // page)


def scatter_pages(k, v, page, seed):
    """Every (slot, page) of k/v moved to a random page of an equally
    sized pool; returns (pool_k, pool_v, table)."""
    b, kh, s, d = k.shape
    np_row = s // page
    perm = torch.randperm(b * np_row, generator=_gen(seed), device="cuda")
    pools = []
    for src in (k, v):
        pages = src.reshape(b, kh, np_row, page, d).transpose(1, 2).reshape(
            b * np_row, kh, page, d)
        flat = torch.empty_like(pages)
        flat[perm] = pages
        pools.append(flat.reshape(b, np_row, kh, page, d).transpose(1, 2)
                     .reshape(b, kh, s, d).contiguous())
    return pools[0], pools[1], perm.reshape(b, np_row).to(torch.int32)


def check_paged(dtype, s, d=128, seed=50):
    """(a) identity table bit-equal to decode_attention; (b) a scattered
    table within tolerance of the contiguous plain version; (c) every row
    at or past each length (whole pages included) NaN-poisoned, lengths
    0, 1, a partial page and S among them."""
    from ray_tpu_torch.ops import (decode_attention,
                                   decode_attention_reference,
                                   paged_decode_attention)

    b, h, kh = 8, 32, 8
    lengths = [0, 1, s, s // 2 + 3, 17, s - 1, 100, 257]
    q, k, v, lens = decode_inputs(b, h, kh, d, s, dtype, seed, lengths)
    want = decode_attention_reference(q, k, v, lens)
    kp, vp = k.clone(), v.clone()
    for i, n in enumerate(lengths):
        kp[i, :, n:] = float("nan")
        vp[i, :, n:] = float("nan")
    got = paged_decode_attention(q, kp, vp, identity_table(b, s), lens,
                                 page_size=PAGE)
    if not torch.equal(got, decode_attention(q, kp, vp, lens,
                                             layout="bksd")):
        raise AssertionError(f"paged_decode_attention {dtype} S={s}: "
                             "identity table not bit-equal to "
                             "decode_attention")
    if got[0].abs().max().item() != 0.0:
        raise AssertionError("paged_decode_attention: length-0 slot is "
                             "not 0")
    tol = TOL["paged_decode_attention"][dtype]
    err = close_enough(got, want, tol, tol,
                       f"paged_decode_attention identity {dtype} S={s}")
    pool_k, pool_v, table = scatter_pages(kp, vp, PAGE, seed + 3)
    got = paged_decode_attention(q, pool_k, pool_v, table, lens,
                                 page_size=PAGE)
    err = max(err, close_enough(
        got, want, tol, tol, f"paged_decode_attention scattered {dtype} "
        f"S={s}"))
    log(f"  paged_decode_attention {str(dtype)[6:]} B=8 H=32 KH=8 D={d} "
        f"S={s} page {PAGE}: identity table bit-equal to decode_attention;"
        f" identity and scattered tables, ragged+NaN-poisoned: max abs err "
        f"{err} (tol {tol})")
    return err


def check_paged_refuses():
    from ray_tpu_torch.ops import paged_decode_attention

    q, k, v, lens = decode_inputs(1, 32, 8, 128, PAGED_S - 8,
                                  torch.bfloat16, 60, [5])
    try:
        paged_decode_attention(q, k, v, identity_table(1, PAGED_S), lens,
                               page_size=PAGE)
    except ValueError as e:
        if "multiple" not in str(e):
            raise
        log(f"  paged_decode_attention S={PAGED_S - 8} page {PAGE}: "
            f"refused ({e})")
        return
    raise AssertionError("paged_decode_attention took S % page != 0")


def check_fused(dtype, rows_shape, seed=10):
    from ray_tpu_torch.ops import (fused_qk_rope, fused_rms_norm,
                                   fused_rms_norm_residual, fused_swiglu,
                                   rms_norm, apply_rope, swiglu_reference)

    errs = {}
    tag = f"{str(dtype)[6:]} {list(rows_shape)}"
    d, f, b, s = 4096, 14336, rows_shape[0], rows_shape[1]
    x = _randn((b, s, d), dtype, seed)
    r = _randn((b, s, d), dtype, seed + 1)
    sc = _randn((d,), dtype, seed + 2, scale=0.2)
    tol = TOL["rms_norm"][dtype]
    errs["rms_norm"] = close_enough(fused_rms_norm(x, sc, 1e-5),
                                    rms_norm(x, sc, 1e-5), tol, tol,
                                    f"rms_norm {tag}")
    y, u = fused_rms_norm_residual(x, r, sc, 1e-5)
    u_want = x + r
    errs["rms_norm_residual"] = max(
        close_enough(u, u_want, tol, tol, f"rms_norm_residual sum {tag}"),
        close_enough(y, rms_norm(u_want, sc, 1e-5), tol, tol,
                     f"rms_norm_residual norm {tag}"))
    q = _randn((b, s, 32, 128), dtype, seed + 3)
    k = _randn((b, s, 8, 128), dtype, seed + 4)
    pos = (torch.randint(0, 512, (b, 1), generator=_gen(seed + 5),
                         device="cuda")
           + torch.arange(s, device="cuda")).to(torch.int32)
    rtol, atol = ROPE_TOL[dtype]
    qr, kr = fused_qk_rope(q, k, pos, 500000.0)
    errs["qk_rope"] = max(
        close_enough(qr, apply_rope(q, pos, 500000.0), rtol, atol,
                     f"qk_rope q {tag}"),
        close_enough(kr, apply_rope(k, pos, 500000.0), rtol, atol,
                     f"qk_rope k {tag}"))
    g = _randn((b, s, f), dtype, seed + 6)
    up = _randn((b, s, f), dtype, seed + 7)
    tol = TOL["swiglu"][dtype]
    errs["swiglu"] = close_enough(fused_swiglu(g, up),
                                  swiglu_reference(g, up), tol, tol,
                                  f"swiglu {tag}")
    log(f"  fused {tag}: " + ", ".join(f"{k_} {v_}" for k_, v_ in
                                       errs.items()))
    return errs


def check_rope_bwd(dtype, seed=20):
    """The RoPE backward as the training path runs it: the kernel at the
    negated positions 0..-(S-1), reached through the autograd Function,
    against ``apply_rope`` of the cotangents at the same positions, at
    phase 8's q and k shapes."""
    from ray_tpu_torch.ops import apply_rope, fused_qk_rope

    b, s = TRAIN_B, TRAIN_S
    tag = f"{str(dtype)[6:]} q [{b},{s},32,128] k [{b},{s},8,128]"
    q = _randn((b, s, 32, 128), dtype, seed).requires_grad_()
    k = _randn((b, s, 8, 128), dtype, seed + 1).requires_grad_()
    gq, gk = _randn(q.shape, dtype, seed + 2), _randn(k.shape, dtype, seed + 3)
    pos = torch.arange(s, device="cuda", dtype=torch.int32).expand(b, s)
    dq, dk = torch.autograd.grad(fused_qk_rope(q, k, pos, 500000.0), (q, k),
                                 (gq, gk))
    rtol, atol = ROPE_TOL[dtype]
    err = max(close_enough(dq, apply_rope(gq, -pos, 500000.0), rtol, atol,
                           f"qk_rope backward dq {tag}"),
              close_enough(dk, apply_rope(gk, -pos, 500000.0), rtol, atol,
                           f"qk_rope backward dk {tag}"))
    log(f"  qk_rope backward {tag}, the kernel at positions 0..-{s - 1}: "
        f"max abs err {err} (rtol {rtol}, atol {atol})")


def flash_inputs(b, s, h, kh, d, dtype, seed):
    return (_randn((b, s, h, d), dtype, seed),
            _randn((b, s, kh, d), dtype, seed + 1),
            _randn((b, s, kh, d), dtype, seed + 2),
            _randn((b, s, h, d), dtype, seed + 3))


# (B, S, H, KH, D) of phase 3's flash checks: phase 8's shape, S=384 (three
# 128-row tiles), ragged S with B > 1 and GQA groups of 8 and 1.
FLASH_SHAPES = ((TRAIN_B, TRAIN_S, 32, 8, 128), (2, 384, 4, 2, 64),
                (3, 200, 16, 2, 128), (2, 320, 8, 8, 64))


def check_flash(dtype, b, s, h, kh, d, seed=70):
    """Forward (out, lse) and backward (dq, dk, dv from the kernel's own
    out and lse) against the plain versions."""
    from ray_tpu_torch.ops import (flash_attention, flash_attention_bwd,
                                   flash_attention_bwd_reference,
                                   flash_attention_reference)

    q, k, v, dout = flash_inputs(b, s, h, kh, d, dtype, seed)
    tol = TOL["flash_attention"][dtype]
    tag = f"{str(dtype)[6:]} B={b} S={s} H={h} KH={kh} D={d}"
    out, lse = flash_attention(q, k, v)
    want_out, want_lse = flash_attention_reference(q, k, v)
    err = max(close_enough(out, want_out, tol, tol, f"flash out {tag}"),
              close_enough(lse, want_lse, tol, tol, f"flash lse {tag}"))
    grads = flash_attention_bwd(q, k, v, out, lse, dout)
    want = flash_attention_bwd_reference(q, k, v, out, lse, dout)
    err_b = max(close_enough(g, w, tol, tol, f"flash {n} {tag}")
                for n, g, w in zip(("dq", "dk", "dv"), grads, want))
    log(f"  flash_attention {tag}: forward max abs err {err}, backward "
        f"{err_b} (tol {tol})")


def phase_kernels():
    log("phase 3 kernels against their plain versions")
    for dtype in (torch.float32, torch.bfloat16):
        for s in (512, 4096):
            check_decode(dtype, s)
        check_decode(dtype, 512, d=64)        # LLAMA3_1B head_dim
        for s in (PAGED_S, 4096):
            check_paged(dtype, s)
        for shape in ((8, 1), (1, 64), (TRAIN_B, TRAIN_S)):
            check_fused(dtype, shape)
        check_rope_bwd(dtype)
        for shape in FLASH_SHAPES:
            check_flash(dtype, *shape)
    check_paged_refuses()
    torch.cuda.synchronize()


# ---------------------------------------------------------------- phase 4

def phase_model():
    from ray_tpu_torch.models import llama

    base = dataclasses.replace(llama.LLAMA3_8B, n_layers=2,
                               dtype=torch.float32, max_seq_len=128)
    cfg_k = dataclasses.replace(base, fused_ops=True, use_decode_kernel=True)
    cfg_p = dataclasses.replace(base, fused_ops=False,
                                use_decode_kernel=False)
    params = llama.init_params(cfg_k, _gen(4), device="cuda")
    b, t, steps = 4, 16, 8
    cache_k = llama.init_kv_cache(cfg_k, b, 128, device="cuda")
    cache_p = llama.init_kv_cache(cfg_p, b, 128, device="cuda")
    prompt = torch.randint(0, cfg_k.vocab_size, (b, t), generator=_gen(5),
                           device="cuda", dtype=torch.int32)
    worst = 0.0
    with torch.no_grad():
        lk, _ = llama.forward_with_cache(params, prompt, cache_k, 0, cfg_k)
        lp, _ = llama.forward_with_cache(params, prompt, cache_p, 0, cfg_p)
        worst = max(worst, close_enough(lk, lp, MODEL_TOL, MODEL_TOL,
                                        "model prefill logits"))
        tok = lk[:, -1].argmax(-1).to(torch.int32)[:, None]
        for i in range(steps):
            idx = torch.full((b,), t + i, dtype=torch.int32, device="cuda")
            lk, _ = llama.forward_with_cache(params, tok, cache_k, idx, cfg_k)
            lp, _ = llama.forward_with_cache(params, tok, cache_p, idx, cfg_p)
            worst = max(worst, close_enough(lk, lp, MODEL_TOL, MODEL_TOL,
                                            f"model decode step {i}"))
            tok = lk[:, -1].argmax(-1).to(torch.int32)[:, None]
    log(f"phase 4 model: 2 layers at 8B widths f32, prefill {t} + {steps} "
        f"decode steps, kernels vs plain max abs logit err {worst} "
        f"(tol {MODEL_TOL})")
    del params, cache_k, cache_p
    torch.cuda.empty_cache()
    for dtype in (torch.float32, torch.bfloat16):
        phase_model_paged(base, dtype)
    phase_model_train(base)


def phase_model_paged(base, dtype, b=4, t=16, steps=8):
    """The same 2-layer model with paged_decode=True: logits bit-equal to
    the contiguous decode kernel's at every decode step."""
    from ray_tpu_torch.models import llama

    cfg_c = dataclasses.replace(base, dtype=dtype, fused_ops=True,
                                use_decode_kernel=True)
    cfg_p = dataclasses.replace(cfg_c, paged_decode=True, decode_page=PAGE)
    params = llama.init_params(cfg_c, _gen(6), device="cuda")
    caches = [llama.init_kv_cache(c, b, 128, device="cuda")
              for c in (cfg_c, cfg_p)]
    prompt = torch.randint(0, cfg_c.vocab_size, (b, t), generator=_gen(7),
                           device="cuda", dtype=torch.int32)
    with torch.no_grad():
        outs = [llama.forward_with_cache(params, prompt, c, 0, cfg)[0]
                for c, cfg in zip(caches, (cfg_c, cfg_p))]
        for i in range(steps):
            tok = outs[0][:, -1].argmax(-1).to(torch.int32)[:, None]
            idx = torch.full((b,), t + i, dtype=torch.int32, device="cuda")
            outs = [llama.forward_with_cache(params, tok, c, idx, cfg)[0]
                    for c, cfg in zip(caches, (cfg_c, cfg_p))]
            if not torch.equal(outs[0], outs[1]):
                raise AssertionError(f"paged model {dtype} decode step {i}: "
                                     "logits differ from the contiguous "
                                     "kernel's")
            if not torch.isfinite(outs[1].float()).all():
                raise AssertionError("paged model: non-finite logits")
    log(f"phase 4 model: 2 layers at 8B widths {str(dtype)[6:]}, prefill "
        f"{t} + {steps} decode steps with paged_decode=True: logits "
        f"bit-equal to the contiguous decode kernel's")
    del params, caches
    torch.cuda.empty_cache()


def phase_model_train(base, b=2, s=256, chunk=128):
    """The 2-layer model's loss and every gradient through the flash and
    fused kernels under remat (``loss_fn``), against the plain route
    (``fused_ops`` off, no remat, and explicit positions, which keep
    attention position-masked and off the flash gate), f32; S=256 is the
    flash gate's smallest length, the CE in chunks of 128."""
    from ray_tpu_torch import ops
    from ray_tpu_torch.models import llama

    cfg_k = dataclasses.replace(base, fused_ops=True, remat=True)
    cfg_p = dataclasses.replace(base, fused_ops=False, remat=False)
    positions = torch.arange(s, device="cuda").expand(b, s)
    params = llama.init_params(cfg_k, _gen(9), device="cuda")
    tokens = torch.randint(0, base.vocab_size, (b, s), generator=_gen(10),
                           device="cuda")
    runs = []
    for cfg in (cfg_k, cfg_p):
        p = {n: (v.clone().requires_grad_() if n != "blocks" else
                 {k_: w.clone().requires_grad_() for k_, w in v.items()})
             for n, v in params.items()}
        for fn in ops.KERNELS.values():
            fn.launches = 0
        if cfg is cfg_k:
            loss, _ = llama.loss_fn(p, tokens, cfg, logits_chunk=chunk)
        else:
            x = llama.forward_hidden(p, tokens, cfg, positions=positions)
            loss, _ = llama.loss_from_hidden(p, x, tokens, cfg,
                                             logits_chunk=chunk)
        loss.backward()
        runs.append((loss.detach(), p,
                     {n: fn.launches for n, fn in ops.KERNELS.items()}))
        del loss
    (lk, pk, nk), (lp, pp, n_plain) = runs
    if (nk["flash_attention"], nk["flash_attention_bwd"], nk["qk_rope"]) \
            != (4, 2, 6) or n_plain["flash_attention"] != 0:
        raise AssertionError(f"phase 4 train launches: kernels {nk}, plain "
                             f"{n_plain}")
    worst = close_enough(lk, lp, MODEL_TOL, MODEL_TOL, "model loss")
    pairs = [(n, pk[n], pp[n]) for n in ("embed", "ln_out", "lm_head")] + [
        (n, pk["blocks"][n], pp["blocks"][n]) for n in pk["blocks"]]
    for name, got, want in pairs:
        top = want.grad.abs().max().item()
        err = close_enough(got.grad, want.grad, MODEL_TOL, MODEL_TOL * top,
                           f"model grad {name}")
        worst = max(worst, err / max(top, 1e-30))
    log(f"phase 4 model: 2 layers at 8B widths f32, B={b} S={s}, loss "
        f"{lk.item()} (plain {lp.item()}) and every gradient through the "
        f"flash and fused kernels under remat vs the plain route: worst "
        f"error {worst} of the tensor's largest value (tol {MODEL_TOL}); "
        f"launches {nk}")
    del params, runs, pk, pp
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 5

def make_engine(label, smi, **knobs):
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = dataclasses.replace(llama.LLAMA3_8B, fused_ops=True,
                              use_decode_kernel=True)
    assert cfg.dtype == torch.bfloat16 and cfg.n_layers == 32
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    eng = LLMEngine(cfg, **ENGINE_KW, **knobs)
    torch.cuda.synchronize()
    log(f"{label} engine: Llama-3-8B bf16, 32 layers, "
        f"{cfg.param_count() / 1e9:.2f}B params, knobs {knobs or 'none'}, "
        f"built in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    return eng


def serve(label, eng, prompts, warmup, smi, new_tokens=32):
    """8 client threads, 2 requests each, streamed; after one warm-up
    request. Every kernel count is set to 0 just before the 16 requests
    and read just after. Returns (launches, stats)."""
    from ray_tpu_torch import ops

    vocab = eng.cfg.vocab_size
    results = [None] * len(prompts)
    errors = []

    def client(i):
        try:
            for j in (i, i + 8):
                t_start = time.perf_counter()
                toks, ttft = [], None
                for tok in eng.generate_stream(prompts[j],
                                               max_new_tokens=new_tokens,
                                               timeout=600):
                    if ttft is None:
                        ttft = time.perf_counter() - t_start
                    toks.append(tok)
                results[j] = (toks, ttft)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    try:
        # Warm-up request (cuBLAS handles, first launches), then the run.
        eng.generate(warmup, max_new_tokens=8, timeout=600)
        for fn in ops.KERNELS.values():
            fn.launches = 0
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in ops.KERNELS.items()}
        stats = eng.stats()
    finally:
        eng.close()
    if errors:
        raise errors[0]
    for j, res in enumerate(results):
        if res is None or len(res[0]) != new_tokens:
            raise AssertionError(f"{label} request {j}: "
                                 f"{res and len(res[0])} tokens, expected "
                                 f"{new_tokens}")
        if not all(0 <= t_ < vocab for t_ in res[0]):
            raise AssertionError(f"{label} request {j}: token out of vocab")
    admissions = len(prompts) + 1
    if stats["host_syncs"]["prefill"] != admissions:
        raise AssertionError(f"{label}: prefill syncs {stats['host_syncs']}"
                             f" != {admissions} admissions")
    ttfts = sorted(r[1] for r in results)
    decode_tokens = sum(len(r[0]) - 1 for r in results)
    n = len(prompts)
    log(f"  {label} run: {n} requests x {new_tokens} tokens in {wall} s; "
        f"decode tokens/s {decode_tokens / wall} (all tokens/s "
        f"{n * new_tokens / wall}); p50 TTFT {ttfts[n // 2] * 1e3} ms "
        f"(client-side, streamed, upper median of {n}); engine ttft_ms_p50 "
        f"{stats['ttft_ms_p50']}, tpot_ms_p50 {stats['tpot_ms_p50']}; spec "
        f"drafted {stats['spec_drafted']}, accepted {stats['spec_accepted']}"
        f" in {stats['spec_chunks']} verify chunks; on {smi}")
    log(f"  {label} stats: prefix_hits {stats['prefix_hits']}, "
        f"prefix_tokens_reused {stats['prefix_tokens_reused']}, "
        f"host_syncs {stats['host_syncs']}, dispatches "
        f"{stats['dispatches']}, decode_utilization "
        f"{stats['decode_utilization']}")
    log(f"  {label} kernel launches: {launches}")
    stats["decode_tokens_s"] = decode_tokens / wall
    return launches, stats


def phase5_prompts(vocab):
    rng = np.random.RandomState(0)
    prefix = rng.randint(0, vocab, 32).tolist()
    prompts = []
    for i in range(16):
        if i in (0, 1, 8, 9):       # same 32-token prefix, threads 0 and 1
            prompts.append(prefix + rng.randint(0, vocab,
                                                rng.randint(1, 17)).tolist())
        else:
            prompts.append(rng.randint(0, vocab,
                                       rng.randint(16, 49)).tolist())
    # The warm-up leaves the shared prefix resident in the slot that is
    # last in LRU order, so one of the wave's prefix requests must hit it.
    return prompts, prefix + prompts[2][:8]


# Kernels of the training path only: a serving phase launches them 0 times.
TRAIN_ONLY = ("flash_attention", "flash_attention_bwd")


def require_launches(label, launches, expect_zero, may_be_zero=()):
    """Every kernel launched at least once, except those expected not to
    run at all and those the traffic may or may not reach."""
    for name, n in launches.items():
        if name in expect_zero:
            if n != 0:
                raise AssertionError(f"{label}: {name} launched {n} times, "
                                     "expected 0")
        elif n <= 0 and name not in may_be_zero:
            raise AssertionError(f"{label}: kernel {name} was not launched")
    log(f"  {label} launch check passed (expected 0: "
        f"{', '.join(expect_zero) or 'none'}; may be 0: "
        f"{', '.join(may_be_zero) or 'none'})")


def phase_engine(smi):
    eng = make_engine("phase 5", smi)
    prompts, warmup = phase5_prompts(eng.cfg.vocab_size)
    launches, stats = serve("phase 5", eng, prompts, warmup, smi)
    if stats["prefix_hits"] < 1:
        raise AssertionError(f"no prefix-cache hit: {stats}")
    require_launches("phase 5", launches,
                     ("paged_decode_attention",) + TRAIN_ONLY)
    decode_breakdown(eng, smi)
    return launches


def phase_paged_engine(smi):
    eng = make_engine("phase 7a", smi, paged_decode=True)
    prompts, warmup = phase5_prompts(eng.cfg.vocab_size)
    launches, _ = serve("phase 7a", eng, prompts, warmup, smi)
    require_launches("phase 7a", launches, ("decode_attention",) + TRAIN_ONLY)
    decode_breakdown(eng, smi)
    return launches


def phase7b_prompts(vocab):
    """Phase 7b's traffic: (16 prompts, warm-up prompt)."""
    rng = np.random.RandomState(1)
    prompts = []
    for i in range(16):
        kind = i % 8
        if kind < 3:      # 6 repetitive: an 8-token pattern x 6
            prompts.append(rng.randint(0, vocab, 8).tolist() * 6)
        elif kind < 5:    # 4 long: 130-200 tokens, 5-7 prefill chunks
            prompts.append(rng.randint(0, vocab,
                                       rng.randint(130, 201)).tolist())
        else:             # 6 short: 16-48 tokens
            prompts.append(rng.randint(0, vocab,
                                       rng.randint(16, 49)).tolist())
    return prompts, rng.randint(0, vocab, 40).tolist()


def phase_all_knobs(smi):
    eng = make_engine("phase 7b", smi, paged_decode=True,
                      spec_draft_len=SPEC_DRAFT_LEN, prefill_chunk=32,
                      quantize="int8")
    if eng.cache["k"].shape[3] != PAGED_S:
        raise AssertionError(f"phase 7b cache rows {eng.cache['k'].shape} "
                             f"!= {PAGED_S}")
    prompts, warmup = phase7b_prompts(eng.cfg.vocab_size)
    launches, stats = serve("phase 7b", eng, prompts, warmup, smi)
    # The paged kernel runs on the plain ticks only; a tick that drafts
    # verifies through causal attention, so it may launch 0 times here.
    require_launches("phase 7b", launches, ("decode_attention",) + TRAIN_ONLY,
                     may_be_zero=("paged_decode_attention",))
    if stats["spec_chunks"] <= 0:
        raise AssertionError(f"phase 7b: no verify chunk ran: {stats}")
    admissions = len(prompts) + 1
    if stats["dispatches"]["prefill"] <= admissions:
        raise AssertionError(f"phase 7b: {stats['dispatches']} prefill "
                             f"dispatches for {admissions} admissions: "
                             "chunked prefill did not run")
    ratio = stats["weight_bytes"] / (stats["weight_bytes_f32"] / 2)
    if not 0.45 <= ratio <= 0.6:
        raise AssertionError(f"phase 7b: int8 weight bytes are {ratio} of "
                             "bf16's")
    log(f"  phase 7b int8 weights: {stats['weight_bytes']} bytes, {ratio} "
        f"of the same tree in bf16 ({stats['weight_bytes_f32'] // 2})")
    decode_breakdown(eng, smi)
    return launches


def spec_ab(smi):
    """Speculation's own share of tokens/s: phase 7b's traffic and knobs
    without int8, ``spec_draft_len`` 0 and SPEC_DRAFT_LEN in turns (off,
    on, on, off), one engine each, in one call."""
    rates = {"off": [], "on": []}
    accept = []
    for arm in ("off", "on", "on", "off"):
        label = f"spec A/B, spec {arm}"
        eng = make_engine(label, smi, paged_decode=True, prefill_chunk=32,
                          spec_draft_len=SPEC_DRAFT_LEN if arm == "on" else 0)
        prompts, warmup = phase7b_prompts(eng.cfg.vocab_size)
        _, stats = serve(label, eng, prompts, warmup, smi)
        del eng     # free its weights and cache before the next engine
        if arm == "on":
            if stats["spec_chunks"] <= 0:
                raise AssertionError(f"{label}: no verify chunk ran")
            accept.append(stats["spec_accept_rate"])
        rates[arm].append(stats["decode_tokens_s"])
    mean = {a: sum(r) / len(r) for a, r in rates.items()}
    log(f"spec A/B, bf16: decode tokens/s off {rates['off']}, on "
        f"{rates['on']}; on/off {mean['on'] / mean['off']} (means); accept "
        f"rate {accept}; on {smi}")


def decode_breakdown(eng, smi, chunks=3):
    """Where a steady decode chunk's time goes, with all 8 slots live: the
    host's time to enqueue it, its wall time (to a synchronize), and the
    card's busy time from torch.profiler's kernel records, in a separate
    profiled chunk (the profiler slows the host, not the kernels). Runs on
    the closed engine's loop and cache: nothing else touches them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    loop, b, k = eng.loop, eng.max_batch, eng.loop.chunk
    gen = _gen(40)
    state = [torch.randint(0, eng.cfg.vocab_size, (b, 1), generator=gen,
                           device="cuda", dtype=torch.int32),
             (64 + 8 * torch.arange(b, device="cuda")).to(torch.int32),
             torch.full((b,), 10_000, dtype=torch.int32, device="cuda"),
             torch.full((b,), -1, dtype=torch.int32, device="cuda"),
             torch.zeros(b, dtype=torch.bool, device="cuda")]

    def chunk():
        out = loop.decode_chunk(eng.cache, *state)
        state[:3] = out[2], out[3], out[4]
        return out

    with torch.no_grad():
        chunk()
        torch.cuda.synchronize()
        host, wall = [], []
        for _ in range(chunks):
            t0 = time.perf_counter()
            chunk()
            host.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            chunk()
            torch.cuda.synchronize()
    groups = {"port kernels": 0.0, "matmul": 0.0, "other": 0.0}
    others = {}
    ours = ("decode_kernel", "rms_kernel", "rope_kernel", "swiglu_kernel")
    counts = dict.fromkeys(ours, 0)
    merges = 0
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = ev.time_range.elapsed_us()
        name = ev.name.lower()
        merges += "merge" in name
        mine = next((o for o in ours if o in name), None)
        if mine:
            groups["port kernels"] += us
            counts[mine] += 1
        elif any(g in name for g in ("nvjet", "gemm", "gemv", "cutlass",
                                     "xmma", "cublas")):
            groups["matmul"] += us
        else:
            groups["other"] += us
            others[ev.name[:60]] = others.get(ev.name[:60], 0.0) + us
    step_wall = sorted(wall)[len(wall) // 2] / k * 1e3
    step_host = sorted(host)[len(host) // 2] / k * 1e3
    busy = sum(groups.values()) / k / 1e3
    busy_txt = (f"device busy {busy} ms/step (idle share "
                f"{1 - busy / step_wall}); by group ms/step: " + ", ".join(
                    f"{g} {v / k / 1e3}" for g, v in groups.items())
                if busy > 0 else "device busy not measured (the profiler "
                "recorded no kernel)")
    log(f"  decode chunk breakdown, {b} live slots, K={k}, paged "
        f"{eng.paged_decode}, weights {eng.quantize or 'bf16'}: wall "
        f"{step_wall} ms/step, host enqueue {step_host} ms/step, "
        f"{busy_txt}; on {smi}")
    top = sorted(others.items(), key=lambda kv: -kv[1])[:6]
    log("  largest 'other' kernels, ms/step: " + "; ".join(
        f"{n} {v / k / 1e3}" for n, v in top))
    per_step = {n: c / k for n, c in counts.items()}
    log(f"  port kernel launches per step (profiler): {per_step}; kernels "
        f"named *merge*: {merges}")
    # One decode launch a layer (the splits merge inside it), no merge
    # kernel; a profiler that recorded nothing proves nothing either way.
    if busy > 0 and (per_step["decode_kernel"] != eng.cfg.n_layers
                     or merges):
        raise AssertionError(f"decode step: {per_step['decode_kernel']} "
                             f"decode launches a step for "
                             f"{eng.cfg.n_layers} layers, {merges} merge "
                             "kernels")


# ---------------------------------------------------------------- phase 8

# Device kernels by group, matched on the profiler's kernel names.
TRAIN_GROUPS = (
    ("flash forward", ("::fwd_sm90<", "::fwd_kernel<")),
    ("flash backward", ("::dkdv_sm90<", "::dq_sm90<", "::delta_kernel<",
                        "::dkdv_kernel<", "::dq_kernel<")),
    ("fused kernels", ("rms_kernel", "rope_kernel", "swiglu_kernel")),
    ("optimizer", ("multi_tensor_apply", "fused_adam", "FusedAdam")),
    ("matmul", ("nvjet", "gemm", "gemv", "cutlass", "xmma", "cublas")),
)


def train_breakdown(prof):
    """Device microseconds by group over the profiled step, and the
    largest kernels of the remainder. User-annotated ranges on the device
    timeline (``Optimizer.step#AdamW.step``) span other kernels and are
    skipped."""
    from torch.autograd import DeviceType

    groups = {g: 0.0 for g, _ in TRAIN_GROUPS}
    groups["other"] = 0.0
    others = {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA or ev.is_user_annotation:
            continue
        us = ev.time_range.elapsed_us()
        group = next((g for g, keys in TRAIN_GROUPS
                      if any(k_ in ev.name for k_ in keys)), "other")
        groups[group] += us
        if group == "other":
            others[ev.name[:60]] = others.get(ev.name[:60], 0.0) + us
    return groups, others


def phase_train(smi):
    """Phase 8, the training cell: full-depth Llama-3-8B bf16 through the
    port's training entry points, every kernel count set to 0 just before
    the 5 steps and read just after. Returns the launch counts."""
    import gc

    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch import ops
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import spmd

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    if held >= 2 * 2**30:
        raise AssertionError(f"phase 8: {held} bytes still allocated after "
                             "the engines")
    cfg = dataclasses.replace(llama.LLAMA3_8B, fused_ops=True)
    assert (cfg.n_layers, cfg.d_model, cfg.dtype, cfg.remat,
            cfg.remat_policy) == (32, 4096, torch.bfloat16, True, "nothing")
    tx = spmd.default_optimizer(lr=1e-4, warmup=1)
    t0 = time.perf_counter()
    state = spmd.init_train_state(cfg, _gen(11), tx)
    torch.cuda.synchronize()
    log(f"phase 8 train: Llama-3-8B bf16, 32 layers, "
        f"{cfg.param_count() / 1e9:.2f}B params, B={TRAIN_B} S={TRAIN_S}, "
        f"remat {cfg.remat_policy}, fused AdamW; init {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
        f"({held} bytes before)")
    tokens = torch.from_numpy(np.random.RandomState(8).randint(
        0, cfg.vocab_size, (TRAIN_B, TRAIN_S))).to("cuda")
    step = spmd.make_train_step(cfg, tx)
    torch.cuda.reset_peak_memory_stats()
    for fn in ops.KERNELS.values():
        fn.launches = 0
    losses, gnorms, walls = [], [], []
    prof = None
    for i in range(TRAIN_STEPS):
        t = time.perf_counter()
        if i == TRAIN_STEPS - 1:   # the last step under the profiler
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                state, metrics = step(state, tokens)
                torch.cuda.synchronize()
        else:
            state, metrics = step(state, tokens)
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        losses.append(metrics["loss"].item())
        gnorms.append(metrics["grad_norm"].item())
    launches = {name: fn.launches for name, fn in ops.KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    log(f"  losses {losses}; grad norms {gnorms}; step wall s {walls}")
    if not all(np.isfinite(losses + gnorms)):
        raise AssertionError("phase 8: a non-finite loss or grad norm")
    if not losses[-1] < losses[1]:
        raise AssertionError(f"phase 8: the loss did not fall: {losses}")
    per_step = {"flash_attention": 64, "flash_attention_bwd": 32,
                "qk_rope": 96, "rms_norm": 65, "rms_norm_residual": 64,
                "swiglu": 64, "decode_attention": 0,
                "paged_decode_attention": 0}
    want = {n: c * TRAIN_STEPS for n, c in per_step.items()}
    if launches != want:
        raise AssertionError(f"phase 8 launches {launches}, expected {want}")
    log(f"  phase 8 launch check passed: per step {per_step}")
    steady = sorted(walls[1:-1])[len(walls[1:-1]) // 2]
    tokens_s = TRAIN_B * TRAIN_S / steady
    flops = cfg.flops_per_token(TRAIN_S) * TRAIN_B * TRAIN_S
    groups, others = train_breakdown(prof)
    busy = sum(groups.values()) / 1e3
    log(f"  phase 8 step: {steady * 1e3} ms (median of steps 1-"
        f"{TRAIN_STEPS - 2}, unprofiled; step 0 {walls[0] * 1e3} ms with "
        f"AdamW's state made), {tokens_s} tokens/s, MFU {flops / steady / BF16_FLOPS} "
        f"({flops / 1e12} TFLOP a step by flops_per_token), peak memory "
        f"{peak / 1e9} GB ({peak / 2**30} GiB); on {smi}")
    log(f"  phase 8 device time of the profiled step: busy {busy} ms "
        f"(idle share against the unprofiled step {1 - busy / (steady * 1e3)}); "
        "by group ms: " + ", ".join(f"{g} {v / 1e3}"
                                    for g, v in groups.items()))
    top = sorted(others.items(), key=lambda kv: -kv[1])[:8]
    log("  largest 'other' kernels, ms: " + "; ".join(
        f"{n} {v / 1e3}" for n, v in top))
    ops_ = sorted((e for e in prof.key_averages()
                   if e.key.startswith("aten::") or e.key.endswith("Backward")),
                  key=lambda e: -e.self_device_time_total)
    log("  largest ops (aten ops and autograd backward nodes) by their own "
        "device time, ms (calls): " + "; ".join(
            f"{e.key} {e.self_device_time_total / 1e3} ({e.count})"
            for e in ops_[:12]))
    del state, metrics, step
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase 6

class Timer:
    """Per-call device time with CUDA events. Before each timed call a
    256 MB buffer is read so the call finds the 50 MB L2 cold (as a decode
    step does: the other layers' weights pass through L2 between two
    calls of one layer) and clean: overwriting the buffer instead left up
    to 50 MB of dirty lines whose write-back shared the card's bandwidth
    with the timed call, which slowed memory-bound calls and not the empty
    kernel. A sleep kernel first lets the host queue all calls ahead of
    the card, so host overhead does not show in the device timeline."""

    def __init__(self):
        self.flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8,
                                     device="cuda")
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        torch.cuda._sleep(10_000_000)
        e.record()
        torch.cuda.synchronize()
        self.cycles_per_ms = 10_000_000 / max(s.elapsed_time(e), 1e-3)

    def __call__(self, fn, iters=30, warmup=3):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        evs = [(torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        torch.cuda._sleep(int(self.cycles_per_ms * 50))
        for s, e in evs:
            self.flush_buf.max()
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        times = sorted(s.elapsed_time(e) for s, e in evs)
        return times[len(times) // 2]


# Phase 5's slot lengths while it decodes: prompts of 16-48 tokens plus up
# to 32 new ones, in a 512-row cache.
REAL_LENGTHS = [16, 25, 34, 43, 52, 61, 70, 80]


def launch_floor(timer):
    """The empty kernel's time under ``timer`` (ms): what a launch costs
    with no work. None for a checkout without it."""
    import ctypes

    from ray_tpu_torch.ops import _build

    fn = getattr(_build.load("fused"), "rtt_empty_kernel", None)
    if fn is None:
        return None
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    return timer(lambda: fn(stream))


def decode_rope_times(timer, floor):
    """Rows 1, 2 and 5 at the shapes their redesign is judged at, each
    beside its bytes bound (each input read once, each output written
    once): both decode kernels at B=8 H=32 KH=8 D=128 bf16 with every row
    valid (S=512 contiguous, the engine's S=528 paged, both at S=4096) and
    at phase 5's lengths; RoPE at the decode shape and at phase 8's.
    Returns {label: ms}."""
    from ray_tpu_torch.ops import KERNELS

    b, h, kh, d, dt = 8, 32, 8, 128, torch.bfloat16
    times = {}

    def show(label, fn, nbytes):
        ms = timer(fn)
        bound = nbytes / HBM_BYTES_S * 1e3
        times[label] = ms
        vs_floor = f", {ms / floor} x the launch floor" if floor else ""
        log(f"  {label}: {ms} ms, bytes bound {bound} ms ({bound / ms} of "
            f"it){vs_floor}")

    for name, s, lengths, tag in (
            ("decode_attention", 512, [512] * b, "all rows valid"),
            ("decode_attention", 512, REAL_LENGTHS, "phase 5's lengths"),
            ("decode_attention", 4096, [4096] * b, "all rows valid"),
            ("paged_decode_attention", PAGED_S, [512] * b, "512 rows valid"),
            ("paged_decode_attention", PAGED_S, REAL_LENGTHS,
             "phase 5's lengths"),
            ("paged_decode_attention", 4096, [4096] * b, "all rows valid")):
        q, k, v, lens = decode_inputs(b, h, kh, d, s, dt, 24, lengths)
        nbytes = sum(lengths) * kh * d * 2 * 2 + 2 * q.numel() * 2 + 4 * b
        if name == "decode_attention":
            fn = (lambda q=q, k=k, v=v, lens=lens: KERNELS[name](
                q, k, v, lens, layout="bksd"))
        else:
            table = identity_table(b, s)
            nbytes += 4 * sum(-(-n // PAGE) for n in lengths)
            fn = (lambda q=q, k=k, v=v, lens=lens, table=table: KERNELS[name](
                q, k, v, table, lens, page_size=PAGE))
        show(f"{name} S={s} {tag}", fn, nbytes)
        del q, k, v
    for bb, ss, tag in ((8, 1, "decode"), (TRAIN_B, TRAIN_S, "phase 8")):
        q = _randn((bb, ss, 32, 128), dt, 33)
        k = _randn((bb, ss, 8, 128), dt, 34)
        # Contiguous positions: the wrapper copies an expanded tensor, a
        # second launch the timing would include.
        pos = (torch.arange(ss, device="cuda", dtype=torch.int32)
               + 300).expand(bb, ss).contiguous()
        show(f"qk_rope {tag} q {list(q.shape)} k {list(k.shape)}",
             lambda q=q, k=k, pos=pos: KERNELS["qk_rope"](q, k, pos,
                                                          500000.0),
             2 * (q.numel() + k.numel()) * 2 + bb * ss * 4 + 64 * 4)
    return times


def _bound(nbytes, flops, flop_rate):
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def row_ms(rows, name):
    return next(r["ms"] for r in rows if r["name"] == name)


def phase_timing(launches):
    from ray_tpu_torch.ops import (KERNELS, apply_rope,
                                   decode_attention_reference,
                                   paged_decode_attention_reference,
                                   rms_norm, swiglu_reference)

    dt = torch.bfloat16
    it = 2
    timer = Timer()
    floor = launch_floor(timer)
    rows = []

    def entry(name, kernel, plain, library, nbytes, flops, rate):
        got, want = kernel(), plain()
        if isinstance(got, tuple):
            err = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(got, want))
        else:
            err = (got.float() - want.float()).abs().max().item()
        bound, by = _bound(nbytes, flops, rate)
        row = {"name": name, "route": "cuda",
               "source": KERNEL_META[name][0],
               "replaces": KERNEL_META[name][1],
               "launches": launches[name], "max_abs_err": err,
               "ms": timer(kernel), "plain_ms": timer(plain),
               "bound_ms": bound, "bound_by": by,
               "library_ms": timer(library) if library else None,
               "floor_ms": floor}
        rows.append(row)
        log(f"  {name}: {row['ms']} ms (plain {row['plain_ms']}, library "
            f"{row['library_ms']}, bound {bound} by {by}, launch floor "
            f"{floor}), max abs err {err}")
        return row

    log("phase 6 timing (bf16, decode shapes of phase 3, L2 flushed)")
    log(f"  launch floor, an empty kernel (one CTA of 128 threads): {floor} "
        "ms")
    # paged decode attention: the phase-7b engine's cache (S = PAGED_S),
    # every slot at 512 rows, read through the identity table.
    b, h, kh, d, s = 8, 32, 8, 128, PAGED_S
    q, k, v, lens = decode_inputs(b, h, kh, d, s, dt, 22, [512] * b)
    table = identity_table(b, s)
    n_pages = (lens + PAGE - 1) // PAGE
    kv_bytes = int(n_pages.sum().item()) * PAGE * kh * d * 2 * it
    entry("paged_decode_attention",
          lambda: KERNELS["paged_decode_attention"](q, k, v, table, lens,
                                                    page_size=PAGE),
          lambda: paged_decode_attention_reference(q, k, v, table, lens,
                                                   PAGE),
          None,
          kv_bytes + 2 * q.numel() * it + lens.numel() * 4
          + int(n_pages.sum().item()) * 4,
          4 * int(lens.sum().item()) * h * d, BF16_FLOPS)
    # decode attention: the engine's cache, every row valid.
    b, h, kh, d, s = 8, 32, 8, 128, 512
    q, k, v, lens = decode_inputs(b, h, kh, d, s, dt, 20, [s] * b)
    mask = (torch.arange(s, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    kv_bytes = int(lens.clamp(max=s).sum().item()) * kh * d * 2 * it
    entry("decode_attention",
          lambda: KERNELS["decode_attention"](q, k, v, lens, layout="bksd"),
          lambda: decode_attention_reference(q, k, v, lens),
          lambda: F.scaled_dot_product_attention(
              q[:, :, None], k, v, attn_mask=mask, enable_gqa=True),
          kv_bytes + 2 * q.numel() * it + lens.numel() * 4,
          4 * int(lens.sum().item()) * h * d, BF16_FLOPS)
    del q, k, v
    decode_rope_times(timer, floor)

    n, dm = 8, 4096
    x = _randn((n, 1, dm), dt, 30)
    r = _randn((n, 1, dm), dt, 31)
    sc = _randn((dm,), dt, 32, scale=0.2)
    w = (1.0 + sc.float()).to(dt)
    entry("rms_norm", lambda: KERNELS["rms_norm"](x, sc, 1e-5),
          lambda: rms_norm(x, sc, 1e-5),
          lambda: F.rms_norm(x, (dm,), weight=w, eps=1e-5),
          (2 * n * dm + dm) * it, 4 * n * dm, F32_SIMT_FLOPS)
    entry("rms_norm_residual",
          lambda: KERNELS["rms_norm_residual"](x, r, sc, 1e-5),
          lambda: (rms_norm(x + r, sc, 1e-5), x + r), None,
          (4 * n * dm + dm) * it, 5 * n * dm, F32_SIMT_FLOPS)
    qd = _randn((n, 1, 32, 128), dt, 33)
    kd = _randn((n, 1, 8, 128), dt, 34)
    pos = torch.randint(0, 512, (n, 1), generator=_gen(35), device="cuda",
                        dtype=torch.int32)
    entry("qk_rope", lambda: KERNELS["qk_rope"](qd, kd, pos, 500000.0),
          lambda: (apply_rope(qd, pos, 500000.0),
                   apply_rope(kd, pos, 500000.0)), None,
          2 * (qd.numel() + kd.numel()) * it + pos.numel() * 4 + 64 * 4,
          3 * (qd.numel() + kd.numel()) + 40 * n * 64, F32_SIMT_FLOPS)
    g = _randn((n, 1, 14336), dt, 36)
    up = _randn((n, 1, 14336), dt, 37)
    entry("swiglu", lambda: KERNELS["swiglu"](g, up),
          lambda: swiglu_reference(g, up), None,
          3 * g.numel() * it, 5 * g.numel(), F32_SIMT_FLOPS)
    del x, r, g, up
    flash_timing(entry, timer)
    return rows


def sdpa_calls(q, k, v, dout):
    """F.scaled_dot_product_attention (is_causal, enable_gqa) on the same
    values laid out [B,H,S,D]: (its forward, its backward alone from one
    forward's graph, kept, and its forward + backward)."""
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dt_ = dout.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    def sdpa_fwd():
        with torch.no_grad():
            return sdpa()

    sdpa_out = sdpa()
    return (sdpa_fwd,
            lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dt_,
                                        retain_graph=True),
            lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dt_))


def flash_timing(entry, timer):
    """The flash rows at phase 8's shape (B=1, S=2048, H=32, KH=8, D=128,
    bf16). Operations: 4*D per causal (query, key) pair forward (QK^T and
    PV), 10*D backward (QK^T recomputed, dV, dP, dQ, dK); bytes: each
    input read once and each output written once. The library call is
    F.scaled_dot_product_attention (is_causal, enable_gqa) on the same
    values laid out [B,H,S,D]: its forward, and its backward alone (from
    one forward's graph, kept); its forward + backward is printed."""
    from ray_tpu_torch.ops import (KERNELS, flash_attention_bwd_reference,
                                   flash_attention_reference)

    b, s, h, kh, d = TRAIN_B, TRAIN_S, 32, 8, 128
    q, k, v, dout = flash_inputs(b, s, h, kh, d, torch.bfloat16, 80)
    pairs = b * h * s * (s + 1) // 2
    qo_bytes, kv_bytes, lse_bytes = q.numel() * 2, k.numel() * 2, b * h * s * 4
    out, lse = KERNELS["flash_attention"](q, k, v)
    sdpa_fwd, sdpa_bwd, sdpa_fwd_bwd = sdpa_calls(q, k, v, dout)

    fwd = entry("flash_attention", lambda: KERNELS["flash_attention"](q, k, v),
                lambda: flash_attention_reference(q, k, v), sdpa_fwd,
                2 * qo_bytes + 2 * kv_bytes + lse_bytes, 4 * d * pairs,
                BF16_FLOPS)
    log(f"  flash_attention: {4 * d * pairs / fwd['ms'] / 1e9} TFLOP/s, "
        f"{fwd['bound_ms'] / fwd['ms']} of its bound; SDPA "
        f"{4 * d * pairs / fwd['library_ms'] / 1e9} TFLOP/s")
    bwd = entry("flash_attention_bwd",
                lambda: KERNELS["flash_attention_bwd"](q, k, v, out, lse,
                                                       dout),
                lambda: flash_attention_bwd_reference(q, k, v, out, lse,
                                                      dout),
                sdpa_bwd, 4 * qo_bytes + 4 * kv_bytes + lse_bytes,
                10 * d * pairs, BF16_FLOPS)
    log(f"  flash_attention_bwd: {10 * d * pairs / bwd['ms'] / 1e9} TFLOP/s "
        f"counted at 10*D a pair ({14 * d * pairs / bwd['ms'] / 1e9} "
        f"executed, 14*D), {bwd['bound_ms'] / bwd['ms']} of its bound; SDPA "
        f"{10 * d * pairs / bwd['library_ms'] / 1e9} TFLOP/s at 10*D")
    flash_bwd_parts(lambda: KERNELS["flash_attention_bwd"](q, k, v, out, lse,
                                                           dout))
    log(f"  SDPA forward + backward: {timer(sdpa_fwd_bwd)} ms")


def flash_bwd_parts(bwd, calls=10):
    """The backward's device time by kernel (delta, dK/dV, dQ), mean of
    ``calls`` back-to-back calls under torch.profiler (L2 warm)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    bwd()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            bwd()
        torch.cuda.synchronize()
    parts = {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        m = re.search(r"(delta_kernel|dkdv_sm90|dq_sm90|dkdv_kernel|"
                      r"dq_kernel)", ev.name)
        key = m.group(1) if m else ev.name[:40]
        parts[key] = parts.get(key, 0.0) + ev.time_range.elapsed_us()
    log("  flash_attention_bwd device ms per call by kernel (profiler, L2 "
        "warm): " + ", ".join(f"{k_} {v_ / calls / 1e3}"
                              for k_, v_ in parts.items()))


def back_to_back(fn, calls=20, warmup=3):
    """Mean ms of ``calls`` launches in a row, L2 warm, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    for _ in range(calls):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / calls


def flash_probe(smi, root):
    """``--flash``: the flash kernels of the package at ``root`` against
    their plain versions, their times at phase 8's shape, then phase 8."""
    from ray_tpu_torch.ops import KERNELS

    log(f"flash probe of {root}: kernels against their plain versions")
    for dtype in (torch.float32, torch.bfloat16):
        for shape in FLASH_SHAPES:
            check_flash(dtype, *shape)
    q, k, v, dout = flash_inputs(TRAIN_B, TRAIN_S, 32, 8, 128,
                                 torch.bfloat16, 80)
    out, lse = KERNELS["flash_attention"](q, k, v)
    sdpa_fwd, sdpa_bwd, _ = sdpa_calls(q, k, v, dout)
    timer = Timer()
    for name, fn in (
            ("flash_attention", lambda: KERNELS["flash_attention"](q, k, v)),
            ("flash_attention_bwd",
             lambda: KERNELS["flash_attention_bwd"](q, k, v, out, lse, dout)),
            ("SDPA forward", sdpa_fwd), ("SDPA backward alone", sdpa_bwd)):
        log(f"  {name} B={TRAIN_B} S={TRAIN_S} H=32 KH=8 D=128 bf16: "
            f"{timer(fn)} ms (median, L2 flushed), {back_to_back(fn)} ms "
            f"(20 back to back, L2 warm); on {smi}")
    flash_bwd_parts(lambda: KERNELS["flash_attention_bwd"](q, k, v, out, lse,
                                                           dout))
    del q, k, v, dout, out, lse, timer, sdpa_fwd, sdpa_bwd
    phase_train(smi)


def decode_probe(smi, root):
    """``--decode``: the decode kernels and RoPE of the package at
    ``root`` against their plain versions at phase 3's shapes, the launch
    floor, then their times at the shapes of ``decode_rope_times``."""
    log(f"decode probe of {root}: kernels against their plain versions")
    for dtype in (torch.float32, torch.bfloat16):
        for s in (512, 4096):
            check_decode(dtype, s)
        for s in (PAGED_S, 4096):
            check_paged(dtype, s)
        for shape in ((8, 1), (TRAIN_B, TRAIN_S)):
            check_fused(dtype, shape)
        check_rope_bwd(dtype)
    timer = Timer()
    floor = launch_floor(timer)
    log(f"  launch floor, an empty kernel: {floor} ms; on {smi}")
    times = decode_rope_times(timer, floor)
    log("decode A/B times, ms: " + json.dumps(times))
    wrapper_host_cost(smi)


def wrapper_host_cost(smi, calls=500, rounds=5):
    """Host microseconds a call of the decode wrappers and RoPE's forward
    take at the decode shapes (median of ``rounds`` x ``calls`` calls): what
    a decode step's 32 calls of each cost its host enqueue."""
    from ray_tpu_torch.ops import (decode_attention, paged_decode_attention,
                                   fused)

    dt, b = torch.bfloat16, 8
    q, k, v, lens = decode_inputs(b, 32, 8, 128, PAGED_S, dt, 26, [64] * b)
    table = identity_table(b, PAGED_S)
    qd, kd = _randn((b, 1, 32, 128), dt, 27), _randn((b, 1, 8, 128), dt, 28)
    pos = torch.arange(b, device="cuda", dtype=torch.int32)[:, None]
    arms = {"decode_attention": lambda: decode_attention(q, k, v, lens,
                                                         layout="bksd"),
            "paged_decode_attention": lambda: paged_decode_attention(
                q, k, v, table, lens, page_size=PAGE),
            "qk_rope": lambda: fused._rope_fwd(qd, kd, pos, 500000.0)}
    out = {}
    with torch.no_grad():
        for name, fn in arms.items():
            runs = []
            for _ in range(rounds + 1):     # the first round warms up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn()
                runs.append((time.perf_counter() - t0) / calls * 1e6)
                torch.cuda.synchronize()
            out[name] = sorted(runs[1:])[rounds // 2]
    log(f"decode wrappers' host us a call (median of {rounds} x {calls}): "
        f"{json.dumps(out)}; on {smi}")


def fused_apply_cost(smi, calls=500, rounds=5):
    """What the fused ops' autograd Functions cost the serving step's host
    with gradients off: per call, each op's ``Function.apply`` against its
    bare forward at the decode shapes (the two alternate, ``calls`` calls
    each, median of ``rounds``), summed over one decode step's 129 fused
    calls (33 RMSNorm, 32 of each other op)."""
    from ray_tpu_torch.ops import fused as fz

    dt = torch.bfloat16
    x, r = _randn((8, 1, 4096), dt, 90), _randn((8, 1, 4096), dt, 91)
    sc = _randn((4096,), dt, 92, scale=0.2)
    qd, kd = _randn((8, 1, 32, 128), dt, 93), _randn((8, 1, 8, 128), dt, 94)
    pos = torch.arange(8, device="cuda", dtype=torch.int32)[:, None]
    g, up = _randn((8, 1, 14336), dt, 95), _randn((8, 1, 14336), dt, 96)
    arms = {
        "rms_norm": (33, lambda: fz._RmsNorm.apply(x, sc, 1e-5),
                     lambda: fz._rms_norm_fwd(x, sc, 1e-5)),
        "rms_norm_residual": (
            32, lambda: fz._RmsNormResidual.apply(x, r, sc, 1e-5),
            lambda: fz._rms_res_fwd(x, r, sc, 1e-5)),
        "qk_rope": (32, lambda: fz._QkRope.apply(qd, kd, pos, 500000.0),
                    lambda: fz._rope_fwd(qd, kd, pos, 500000.0)),
        "swiglu": (32, lambda: fz._SwiGLU.apply(g, up),
                   lambda: fz._swiglu_fwd(g, up)),
    }

    def host_us(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        us = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        return us

    extra_ms, parts = 0.0, []
    with torch.no_grad():
        for name, (per_step, apply, bare) in arms.items():
            host_us(apply), host_us(bare)          # warm-up
            t_apply, t_bare = [], []
            for _ in range(rounds):
                t_apply.append(host_us(apply))
                t_bare.append(host_us(bare))
            a = sorted(t_apply)[rounds // 2]
            b = sorted(t_bare)[rounds // 2]
            extra_ms += per_step * (a - b) / 1e3
            parts.append(f"{name} {a} vs {b}")
    log("fused ops with gradients off, host us per call, Function.apply "
        f"vs the bare forward (median of {rounds} x {calls} calls): "
        + "; ".join(parts) + f"; over a decode step's 129 fused calls "
        f"{extra_ms} ms of host time; on {smi}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    here = os.path.dirname(os.path.abspath(__file__))
    if args[:1] in (["--flash-ab"], ["--decode-ab"]) and len(args) == 2:
        other, mode = os.path.abspath(args[1]), args[0][:-3]
        for root in (other, here, here, other):
            log(f"{mode[2:]} A/B arm: {root}")
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            mode, root], check=True, timeout=900)
        return 0
    root = os.path.abspath(args[1]) if args[:1] in (["--flash"], [
        "--decode"]) and len(args) == 2 else here
    sys.path.insert(0, root)
    import ray_tpu_torch  # noqa: F401 — fails outside a checkout

    t_start = time.perf_counter()
    smi, name = phase_device()
    phase_build()
    if args == ["--spec-ab"]:
        spec_ab(smi)
        log(f"total {time.perf_counter() - t_start:.1f} s on {smi}")
        return 0
    if args[:1] in (["--flash"], ["--decode"]):
        (flash_probe if args[0] == "--flash" else decode_probe)(smi, root)
        log(f"total {time.perf_counter() - t_start:.1f} s on {smi}")
        return 0
    phase_kernels()
    phase_model()
    launches = phase_engine(smi)
    paged = phase_paged_engine(smi)
    launches["paged_decode_attention"] = paged["paged_decode_attention"]
    phase_all_knobs(smi)
    train = phase_train(smi)
    for kernel in TRAIN_ONLY:
        launches[kernel] = train[kernel]
    rows = phase_timing(launches)
    fused_apply_cost(smi)
    log(f"total {time.perf_counter() - t_start:.1f} s on {smi}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
