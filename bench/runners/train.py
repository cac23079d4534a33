"""The training runner: ``repro_torch.launch.steps.make_train_step``
with the program's AdamW state, on seeded token rows.

Set-up builds the step, the model and the optimizer state once, drives
them through the traffic's ``checked_steps`` first steps (each on rows
of its own) and hands the same objects to the window, which keeps
stepping on further rows.  A step ends in a host read of its loss, as a
training loop that logs it does.

The first steps are what ``correct`` is decided on: each step's loss and
unclipped gradient norm (the step's own outputs), each leaf's norm of
the first gradient as the optimizer got it (its first moment after one
step over 1 − β1), and each leaf's change over the checked steps, read
before the window moves the parameters on.  After the window and once
the program's state is freed, the reference follows the same steps from
the same weights and rows.
"""
from __future__ import annotations

import gc
import time

import torch

from bench import arith, checks, faults, reference, trace, weights
from bench.runners import program


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _flash_spans():
    """Install ``bench.flash_moba`` / ``bench.flash_moba_bwd`` spans around
    the program's FlashMoBA forward and backward; returns the undo."""
    from repro_torch.kernels import ops

    fwd, bwd = ops.flash_moba, ops.FlashMoBA.backward

    def flash_moba(*a, **k):
        with trace.span("flash_moba"):
            return fwd(*a, **k)

    def backward(ctx, *g):
        with trace.span("flash_moba_bwd"):
            return bwd(ctx, *g)

    ops.flash_moba = flash_moba
    ops.FlashMoBA.backward = staticmethod(backward)

    def undo():
        ops.flash_moba = fwd
        ops.FlashMoBA.backward = staticmethod(bwd)
    return undo


def run(r) -> dict:
    from repro_torch.launch import steps
    from repro_torch.optim import adamw

    cfg, tr, dev = r.config, r.traffic, r.device
    rows, seq, checked = tr["rows"], tr["seq_len"], tr["checked_steps"]
    params = weights.make_params(cfg, r.seed, dev)
    p0 = {k: v.detach().to("cpu", copy=True)
          for k, v in reference.flatten(params).items()}
    batches = weights.train_batches(cfg, r.seed, tr["batches"], rows, seq,
                                    dev)
    opt = adamw.adamw_init(params)
    step = faults.train_step(
        steps.make_train_step(program.model_config(cfg),
                              program.train_config(cfg, rows, seq,
                                                   tr["microbatch"]),
                              backend=tr["backend"], remat=tr["remat"]),
        r.fault, rows, seq)

    got = {"loss": [], "grad_norm": []}
    b1 = cfg["train"]["beta1"]
    for i in range(checked):
        params, opt, out = step(params, opt, {"tokens": batches[i]})
        got["loss"].append(float(out["loss"]))
        got["grad_norm"].append(float(out["grad_norm"]))
        if i == 0:
            got["first_grad"] = {
                k: float(m.norm()) / (1 - b1)
                for k, m in reference.flatten(opt.mu).items()}
    with torch.no_grad():
        got["change"] = {k: float((p - p0[k].to(dev)).norm())
                         for k, p in reference.flatten(params).items()}
    _sync(dev)
    rec = {"setup_s": time.perf_counter() - r.t_start}
    peak_setup = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    # the window: steps started before its end, each to its loss
    n, prof_steps, prof = 0, tr["profile_steps"], None
    t0 = time.perf_counter()
    while r.seconds > 0:      # no window: the first steps' readings only
        batch = {"tokens": batches[checked + n % (len(batches) - checked)]}
        if r.trace and n == 1:
            undo = _flash_spans()
            with trace.profiled() as prof:
                with trace.span("window"):
                    for _ in range(prof_steps):
                        params, opt, out = step(params, opt, batch)
                        float(out["loss"])
                        n += 1
            undo()
        else:
            params, opt, out = step(params, opt, batch)
            float(out["loss"])
            n += 1
        if time.perf_counter() - t0 >= r.seconds \
                and (prof is not None or not r.trace):
            break
    _sync(dev)
    rec["window_s"] = time.perf_counter() - t0
    rec.update(steps=n, tokens=n * rows * seq, attempted=n, failed=0,
               trace=trace.reduce(prof),
               profiled_steps=prof_steps)
    if dev.type == "cuda":
        rec["peak_window_bytes"] = torch.cuda.max_memory_allocated(dev)
        rec["memory_peak_bytes"] = max(peak_setup, rec["peak_window_bytes"])
    rec["moba_least_s"] = arith.moba_train_work(cfg, rows, seq)["least_s"]

    # free the program's state, then follow the checked steps
    del params, opt, step
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = reference.train_steps(p0, [batches[i] for i in range(checked)],
                                cfg, dev, chunk=tr["ref_chunk"])
    rec["reference_s"] = time.perf_counter() - t
    rec["numbers"] = checks.train_numbers(got, ref)
    return rec
