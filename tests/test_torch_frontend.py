"""The serve CLI's front ends in the PyTorch port against the JAX package:
``serving/frontend.py`` (the open-loop trace driver and the asyncio
streaming front end) and ``launch/serve.py``'s stream, open-loop and
HTTP modes, on the smoke moba-340m config with converted weights.

* open-loop traces: tokens equal the port's legacy ``run()`` and JAX's
  ``run_open_loop`` on the same trace, under ``reference``, ``xla`` and
  ``flash`` with dispatch-ahead 0..2; preemption replay on a starved
  pool is exact; the metric keys are JAX's;
* ``AsyncFrontend`` streams equal the legacy tokens;
* ``serve_stream`` and ``serve_openloop`` with ``realtime=False``: JAX's
  metric keys, request counts, generated-token counts and decode steps;
* the CLI: ``--mode stream`` by default, the stream-mode warning, the
  open-loop and fixed modes, and ``--http`` in a subprocess (three
  concurrent clients, ``/stats``, a clean SIGINT exit).
"""
import asyncio
import dataclasses
import http.client
import json
import pathlib
import signal
import socket
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch import serve as JS
from repro.models import transformer as JT
from repro.serving import frontend as JFE
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import EngineConfig as JEngineConfig
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax
from repro_torch.launch import serve as TS
from repro_torch.models import transformer as T
from repro_torch.serving import frontend as FE
from repro_torch.serving.engine import Engine, EngineConfig
from torch_threads import one_thread_env, one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def model():
    jcfg = jax_smoke_config("moba-340m")
    cfg = get_smoke_config("moba-340m")
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    params = from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


def _prompts(lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n, dtype=np.int32) for n in lens]


def _legacy(cfg, params, ecfg, prompts, gen):
    eng = Engine(cfg, params, dataclasses.replace(ecfg, dispatch_ahead=0),
                 device="cpu")
    reqs = [eng.submit(p, max_new_tokens=gen) for p in prompts]
    eng.run()
    return [list(r.out) for r in reqs]


def _trace(mod, prompts, gen, every):
    return [mod.TraceItem(prompt=p, max_new_tokens=gen, arrival_step=every * i)
            for i, p in enumerate(prompts)]


# --------------------------------------------------------- open-loop traces
@pytest.mark.parametrize("backend,dispatch_ahead", [
    ("reference", 0), ("xla", 1), ("flash", 2)])
def test_open_loop_equals_run_and_jax(model, backend, dispatch_ahead):
    jcfg, jparams, cfg, params = model
    prompts = _prompts((40, 33, 21, 28), seed=6)
    kw = dict(max_seqs=2, max_seq_len=64, attn_backend=backend,
              dispatch_ahead=dispatch_ahead)
    jeng = JEngine(jcfg, jparams, JEngineConfig(**kw))
    want = [list(r.out) for r in JFE.run_open_loop(
        jeng, _trace(JFE, prompts, 8, 1))]
    ecfg = EngineConfig(**kw)
    eng = Engine(cfg, params, ecfg, device="cpu")
    m = FE.time_open_loop(eng, _trace(FE, prompts, 8, 1))
    reqs = m.pop("_requests")
    assert [list(r.out) for r in reqs] == want
    assert want == _legacy(cfg, params, ecfg, prompts, 8)
    jm = JFE.open_loop_metrics(jeng.finished, 1.0, jeng.stats)
    assert set(m) == set(jm)
    assert m["requests"] == 4 and m["generated_tokens"] == 32
    assert m["decode_steps"] == jeng.stats["decode_steps"]
    assert m["dispatch_depth_peak"] >= dispatch_ahead


def test_open_loop_preemption_replay_exact(model):
    """``tests/test_staged_engine.py``'s starved-pool trace: preemption
    drains the pipeline mid-flight, victims replay through ``prefill()``
    first, and every stream equals the legacy loop's and JAX's."""
    jcfg, jparams, cfg, params = model
    prompts = _prompts((40, 38, 35, 33, 30), seed=3)
    kw = dict(max_seqs=2, max_seq_len=64, num_pages=6, dispatch_ahead=2)
    want = _legacy(cfg, params, EngineConfig(**kw), prompts, 10)
    jeng = JEngine(jcfg, jparams, JEngineConfig(**kw))
    jreqs = JFE.run_open_loop(jeng, _trace(JFE, prompts, 10, 2))
    assert [list(r.out) for r in jreqs] == want
    eng = Engine(cfg, params, EngineConfig(**kw), device="cpu")
    m = FE.time_open_loop(eng, _trace(FE, prompts, 10, 2))
    reqs = m.pop("_requests")
    assert [list(r.out) for r in reqs] == want
    assert eng.stats["preemptions"] == jeng.stats["preemptions"] > 0
    assert eng.stats["pipeline_drains"] > 0
    assert m["dispatch_depth_peak"] >= 2
    assert m["generated_tokens"] == sum(len(t) for t in want)
    assert m["sustained_tokens_per_s"] > 0
    for key in ("ttft_p50_ms", "ttft_p99_ms", "tpot_p50_ms",
                "tpot_p99_ms"):
        assert m[key] >= 0
    assert m["ttft_p99_ms"] >= m["ttft_p50_ms"]


# ------------------------------------------------------ asyncio front end
@pytest.mark.parametrize("backend", ["reference", "flash"])
def test_async_frontend_streams_match_legacy(model, backend):
    """The first token comes from prefill, the rest from pipelined
    ``generate_step`` calls run on the executor's threads."""
    _, _, cfg, params = model
    prompts = _prompts((40, 33, 21, 28), seed=5)
    ecfg = EngineConfig(max_seqs=4, max_seq_len=96, dispatch_ahead=1,
                        attn_backend=backend)
    want = _legacy(cfg, params, ecfg, prompts, 10)

    async def main():
        fe = FE.AsyncFrontend(Engine(cfg, params, ecfg, device="cpu"))
        await fe.start()
        reqs = [fe.submit(p, 10) for p in prompts]
        outs = []
        for r in reqs:
            outs.append([t async for t in fe.stream(r)])
        await fe.close()
        with pytest.raises(RuntimeError, match="closed"):
            fe.submit(prompts[0], 2)
        return outs, reqs

    outs, reqs = asyncio.run(main())
    assert outs == want
    assert [list(r.out) for r in reqs] == want
    assert all(r.t_first >= r.arrival for r in reqs)


# ------------------------------------------------ serve_stream / openloop
SCENARIO = dict(n_requests=6, prompt_range=(16, 48), gen_range=(4, 12),
                max_seqs=4, smoke=True, seed=2)


def test_serve_stream_counts_equal_jax():
    want = JS.serve_stream("moba-340m", realtime=False, **SCENARIO)
    got = TS.serve_stream("moba-340m", realtime=False, device="cpu",
                          **SCENARIO)
    assert set(got) == set(want)
    for key in ("requests", "generated_tokens", "decode_steps",
                "preemptions"):
        assert got[key] == want[key], key
    assert got["requests"] == 6
    assert got["latency_p99_ms"] >= got["ttft_p50_ms"] >= 0


def test_serve_openloop_counts_equal_jax():
    kw = dict(SCENARIO, every=2)
    want = JS.serve_openloop("moba-340m", **kw)
    got = TS.serve_openloop("moba-340m", device="cpu", **kw)
    assert set(got) == set(want)
    for key in ("requests", "generated_tokens", "decode_steps",
                "preemptions", "dispatch_depth_peak"):
        assert got[key] == want[key], key


# ----------------------------------------------------------------- the CLI
def _cli(*args, timeout=240):
    env = one_thread_env(PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("args,expect", [
    (("--requests", "3", "--gen", "4"), "stream: 3 requests"),
    (("--mode", "openloop", "--requests", "3"), "open-loop: 3 requests"),
    (("--mode", "fixed", "--batch", "2", "--gen", "4"), "prefill: 2×64"),
], ids=["stream-default", "openloop", "fixed"])
def test_serve_cli_modes(args, expect):
    res = _cli(*args)
    assert res.returncode == 0, res.stderr
    assert expect in res.stdout
    if args[0] == "--requests":       # stream mode ignores --gen, loudly
        assert "--gen only apply to --mode batch/fixed" in res.stderr


def test_serve_cli_fixed_refuses_shards():
    """``--mode fixed --shards 2`` exits 2 naming the option, as in batch
    mode, instead of serving from dense caches."""
    res = _cli("--mode", "fixed", "--shards", "2", "--gen", "2")
    assert res.returncode == 2, res.stderr
    assert "unsupported feature 'shards'" in res.stderr


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _request(port, method, path, body=None):
    """One request to the local server (``Connection: close`` framing);
    returns the body's JSON lines."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path, body=body)
        return [json.loads(line) for line in
                conn.getresponse().read().splitlines()]
    finally:
        conn.close()


def test_serve_http_subprocess():
    """``--http``: three concurrent clients stream their tokens, each
    equal to its final record and to a legacy engine's run on the same
    weights (seed 0); ``/stats`` counts the decode steps; SIGINT ends
    the server with exit code 0."""
    port = _free_port()
    env = one_thread_env(PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--http", str(port), "--max-seqs", "4"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = proc.stdout.readline()
        assert f"127.0.0.1:{port}" in line, (line, proc.stderr.read()
                                             if proc.poll() is not None
                                             else "")
        prompts = _prompts((40, 33, 21), seed=9)
        records = [None] * 3

        def client(i):
            records[i] = _request(port, "POST", "/generate", json.dumps(
                {"prompt": prompts[i].tolist(), "max_new_tokens": 6}))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        assert not any(t.is_alive() for t in threads)
        stats = _request(port, "GET", "/stats")[0]
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert rc == 0, proc.stderr.read()
    cfg = get_smoke_config("moba-340m")
    params = T.init_lm(torch.Generator().manual_seed(0), cfg)
    want = _legacy(cfg, params, EngineConfig(max_seqs=4, max_seq_len=512),
                   prompts, 6)
    for rec, w in zip(records, want):
        toks, final = [r["token"] for r in rec[:-1]], rec[-1]
        assert final["done"] and final["ttft_ms"] >= 0
        assert toks == final["tokens"] == w
    assert stats["decode_steps"] > 0 and stats["decode_tokens"] == 15
