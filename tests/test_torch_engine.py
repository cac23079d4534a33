"""The PyTorch port's serving engine against the JAX engine, its
out-of-scope gates, device handling, import hygiene and CLI.

Greedy tokens must be exactly equal to the JAX engine's on the smoke
moba-340m config with converted weights, under ``reference``, ``xla``
and ``flash`` (on CPU tensors ``flash`` runs the decode kernel's plain
version), through preemption by recompute and by host swap, and through
the staged prefill/insert/generate_step API with decode dispatched
ahead.
"""
import collections
import dataclasses
import pathlib
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import transformer as JT
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import EngineConfig as JEngineConfig
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax
from repro_torch.core import backends as B
from repro_torch.device import resolve_device
from repro_torch.launch.serve import (_make_engine, serve, serve_fixed,
                                      serve_openloop, serve_stream)
from repro_torch.launch.train import train
from repro_torch.models import transformer as T
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.scheduler import (ServingError,
                                           UnsupportedFeatureError)
from repro_torch.serving.sharded import ShardedEngine
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


def _run(engine_cls, ecfg_cls, cfg, params, prompts, gen, **ecfg):
    kw = {"device": "cpu"} if engine_cls is Engine else {}
    eng = engine_cls(cfg, params, ecfg_cls(**ecfg), **kw)
    reqs = [eng.submit(p, max_new_tokens=gen) for p in prompts]
    eng.run()
    return [list(r.out) for r in reqs], eng


# ------------------------------------------ token equality with JAX engine
@pytest.mark.parametrize("backend", ["reference", "xla", "flash"])
def test_engine_tokens_equal_jax(model, backend):
    """The settings of tests/test_backends.py's cross-backend sweep."""
    jcfg, jparams, cfg, params = model
    prompts = _prompts((40, 33, 21), seed=5)
    ecfg = dict(max_seqs=3, max_seq_len=64, attn_backend=backend)
    want, _ = _run(JEngine, JEngineConfig, jcfg, jparams, prompts, 10,
                   **ecfg)
    got, _ = _run(Engine, EngineConfig, cfg, params, prompts, 10, **ecfg)
    assert got == want


@pytest.mark.parametrize("swap_bytes", [0, 64 << 20],
                         ids=["recompute", "swap"])
def test_preemption_replay_equals_jax(model, swap_bytes):
    """A starved pool (tests/test_serving.py) preempts; the port's
    streams equal the JAX engine's and each request's solo stream."""
    jcfg, jparams, cfg, params = model
    prompts = _prompts((40, 35, 30), seed=4)
    ecfg = dict(max_seqs=3, max_seq_len=64, num_pages=8,
                swap_bytes=swap_bytes, attn_backend="flash")
    got, eng = _run(Engine, EngineConfig, cfg, params, prompts, 14, **ecfg)
    assert eng.stats["preemptions"] > 0, "test should exercise preemption"
    if swap_bytes:
        assert eng.stats["swap_saves"] > 0
        assert eng.stats["swap_restores"] > 0
    else:
        assert eng.stats["swap_saves"] == 0
    want, _ = _run(JEngine, JEngineConfig, jcfg, jparams, prompts, 14,
                   **ecfg)
    assert got == want
    for p, out in zip(prompts, got):
        solo, _ = _run(Engine, EngineConfig, cfg, params, [p], 14,
                       max_seqs=1, max_seq_len=64, attn_backend="flash")
        assert solo[0] == out


# ------------------------------------------------------- staged == legacy
def _staged_tokens(cfg, params, ecfg, prompts, gen):
    """Drive the three stages by hand: admit everything that fits, one
    generate_step per iteration, replay preemption victims first."""
    eng = Engine(cfg, params, ecfg, device="cpu")
    reqs = [eng.make_request(p, gen) for p in prompts]
    pending = collections.deque(reqs)
    while pending or eng.has_work():
        for r in list(eng.preempted_waiting):
            p = eng.prefill(r)
            if p is None:
                break
            assert eng.insert(p)
        while pending:
            p = eng.prefill(pending[0])
            if p is None:
                break
            assert eng.insert(p)
            pending.popleft()
        eng.generate_step()
    return [list(r.out) for r in reqs], eng


@pytest.mark.parametrize("kw", [
    dict(dispatch_ahead=0),
    dict(attn_backend="xla", prefill_chunk=16, dispatch_ahead=1),
    dict(attn_backend="flash", dispatch_ahead=2),
    dict(attn_backend="flash", max_seqs=2, num_pages=6, dispatch_ahead=2),
], ids=["ref-sync", "xla-chunked-da1", "flash-da2", "flash-preempt-da2"])
def test_staged_matches_legacy(model, kw):
    """tests/test_staged_engine.py's acceptance matrix on the port:
    stages driven by hand, with the decode pipeline as deep as
    configured, reproduce the legacy run() loop token for token."""
    _, _, cfg, params = model
    prompts = _prompts((40, 33, 21), seed=1)
    ecfg = dataclasses.replace(EngineConfig(max_seqs=4, max_seq_len=96),
                               **kw)
    want, _ = _run(Engine, EngineConfig, cfg, params, prompts, 10,
                   **dataclasses.asdict(dataclasses.replace(
                       ecfg, dispatch_ahead=0)))
    got, eng = _staged_tokens(cfg, params, ecfg, prompts, 10)
    assert got == want
    if ecfg.dispatch_ahead:      # the pipeline must actually have been deep
        assert eng.stats["dispatch_depth_peak"] >= ecfg.dispatch_ahead
    else:
        assert eng.stats["dispatch_depth_peak"] <= 1
    if ecfg.num_pages:
        assert eng.stats["preemptions"] > 0


# ------------------------------------------------------- out-of-scope gates
@pytest.mark.parametrize("field,ecfg", [
    ("route_policy", dict(route_policy="snr:pfail=0.9")),
])
def test_out_of_scope_engine_config_raises(model, field, ecfg):
    """A malformed routing policy fails construction under its own
    field."""
    _, _, cfg, params = model
    with pytest.raises(UnsupportedFeatureError) as ei:
        Engine(cfg, params, EngineConfig(**ecfg), device="cpu")
    assert ei.value.feature == field
    assert "pfail must be in" in str(ei.value)


def test_out_of_scope_model_and_fleet_raise(model):
    _, _, cfg, params = model
    kconv = get_smoke_config("moba-340m", key_conv_width=3)
    kparams = T.init_lm(torch.Generator().manual_seed(0), kconv)
    eng = Engine(kconv, kparams, EngineConfig(attn_backend="flash"),
                 device="cpu")
    assert "key_conv_state" in eng.caches["slot_1"]
    with pytest.raises(UnsupportedFeatureError) as ei:
        Engine(kconv, kparams, EngineConfig(attn_backend="nope"),
               device="cpu")
    assert ei.value.feature == "attn_backend"
    # the fleet is ported: shards on the CPU build, and more shards than
    # visible cards raise rather than share one
    fleet = _make_engine(cfg, params, EngineConfig(), shards=2, device="cpu")
    assert isinstance(fleet, ShardedEngine) and fleet.n_shards == 2
    assert fleet.devices == [torch.device("cpu")] * 2
    with pytest.raises(ServingError, match="exceeds the"):
        _make_engine(cfg, params, EngineConfig(),
                     shards=torch.cuda.device_count() + 1, device="cuda")
    with pytest.raises(ServingError, match="kv_dtype"):
        Engine(cfg, params, EngineConfig(kv_dtype="int4"), device="cpu")
    with pytest.raises(UnsupportedFeatureError) as ei:
        Engine(cfg, params, EngineConfig(attn_backend="flash:typo"),
               device="cpu")
    assert ei.value.feature == "attn_backend"


def test_backend_registry_and_specs(monkeypatch):
    flash = B.get("flash")
    monkeypatch.setattr(flash, "decode_grid", "grouped")
    monkeypatch.setattr(flash, "train_grid", "grouped")
    monkeypatch.setattr(flash, "kb_tile", 0)
    assert B.get("sparse") is B.get("xla")
    assert B.get("kernel") is flash
    assert B.resolve_backend_spec("flash:flat,kb_tile=64") == "flash"
    assert (flash.decode_grid, flash.train_grid, flash.kb_tile) == \
        ("flat", "flat", 64)
    with pytest.raises(B.BackendCapabilityError, match="option"):
        B.parse_backend_spec("flash:compiled")
    with pytest.raises(B.BackendCapabilityError, match="decode-grid"):
        B.parse_backend_spec("xla:flat")
    with pytest.raises(B.BackendCapabilityError, match="kb_tile"):
        B.parse_backend_spec("xla:kb_tile=64")
    with pytest.raises(B.BackendCapabilityError, match="integer"):
        B.parse_backend_spec("flash:kb_tile=x")
    # every backend runs cache-free (training) MoBA, dense-cache MoBA
    # decode (the fixed loop) and paged MoBA
    for name in ("reference", "xla", "flash"):
        assert B.resolve(name, kind="moba", phase="prefill",
                         cache="dense").name == name
        assert B.resolve(name, kind="moba", phase="decode",
                         cache="dense").name == name
        for phase in ("prefill", "decode"):
            assert B.resolve(name, kind="moba", phase=phase,
                             cache="paged").name == name


# ------------------------------------------------------------------ devices
def test_device_defaults_to_cuda(model):
    """Every entry point defaults to the card and raises on a host
    without one, instead of silently running the plain path."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the no-card error is not "
                    "reachable here")
    _, jparams, cfg, params = model
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        Engine(cfg, params, EngineConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        serve("moba-340m", batch=1, prompt_len=8, gen=2)
    with pytest.raises(RuntimeError, match="cuda"):
        serve_fixed("moba-340m", batch=1, prompt_len=8, gen=2)
    with pytest.raises(RuntimeError, match="cuda"):
        serve_stream("moba-340m", n_requests=1)
    with pytest.raises(RuntimeError, match="cuda"):
        serve_openloop("moba-340m", n_requests=1)
    with pytest.raises(RuntimeError, match="cuda"):
        from_jax(jax.tree.map(np.asarray, jparams), cfg)
    assert resolve_device("cpu") == torch.device("cpu")


# ---------------------------------------------------------- import hygiene
_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)(?:\.|\s|$)"
    r"|import_module\(\s*f?['\"](?:jax|repro)\.", re.M)


def test_port_imports_neither_jax_nor_reference_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    files += sorted((ROOT / "examples_torch").glob("*.py"))
    assert len(files) > 20                  # the scan sees the package
    names = {p.relative_to(ROOT).as_posix() for p in files}
    assert {"src/repro_torch/core/key_conv.py",
            "src/repro_torch/models/api.py",
            "examples_torch/quickstart.py",
            "examples_torch/train_lm.py",
            "examples_torch/serve_decode.py",
            "examples_torch/longcontext_niah.py",
            "src/repro_torch/checkpoint/manager.py",
            "src/repro_torch/data/niah.py",
            "src/repro_torch/configs/qwen3_0_6b.py",
            "src/repro_torch/serving/frontend.py",
            "src/repro_torch/serving/sharded.py",
            "src/repro_torch/distributed/moba_sp.py"} <= names
    for path in files:
        hits = _FORBIDDEN.findall(path.read_text())
        assert not hits, (str(path), hits)


def test_serve_cli_smoke_on_cpu():
    env = one_thread_env(PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--mode", "batch", "--device", "cpu", "--attn-backend", "flash",
         "--batch", "2", "--gen", "4"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    assert "decode tokens" in res.stdout


# ----------------------------------------------- the removed moba_impl
def test_moba_impl_removed_everywhere():
    """``tests/test_staged_engine.py``'s surfaces on the port: the removed
    alias fails with a shaped error naming ``attn_backend``."""
    with pytest.raises(ValueError, match="attn_backend='xla'"):
        train("moba-340m", moba_impl="xla", device="cpu")
    with pytest.raises(UnsupportedFeatureError, match="attn_backend") as ei:
        EngineConfig(moba_impl="sparse")
    assert ei.value.feature == "moba_impl"
    # the InitVar leaves replace() and asdict() as they were
    ecfg = dataclasses.replace(EngineConfig(), max_seqs=2)
    assert "moba_impl" not in dataclasses.asdict(ecfg)


@pytest.mark.parametrize("module", ["repro_torch.launch.train",
                                    "repro_torch.launch.serve"])
def test_moba_impl_cli_flag_rejected(module):
    """Both CLIs exit 2 on --moba-impl, naming the --attn-backend
    replacement (no silent precedence)."""
    env = one_thread_env(PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", module, "--moba-impl", "xla", "--smoke",
         "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 2, (res.stdout, res.stderr)
    err = res.stderr + res.stdout
    assert "--moba-impl was removed" in err
    assert "--attn-backend xla" in err
