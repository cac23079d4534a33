"""The port's examples (``examples_torch/``) against the JAX package.

quickstart's function gives the reference, gather-and-densify and
FlashMoBA outputs of JAX's ``moba_attention_reference`` and
``moba_sparse_xla`` on the same numpy inputs within fp32 2e-4, query
300's blocks bit-equal to JAX's ``moba_selection``, and the SNR rule's
values equal.  The NIAH example's router selects the blocks JAX's does
on its planted inputs, with and without key convolution.  Each script
runs as a subprocess on the CPU at a small setting, and without
``--device`` exits non-zero with the "cuda" error: the subprocesses
start together when the module starts and run beside the in-process
tests.
"""
import importlib.util
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import MoBAConfig as JMoBAConfig
from repro.core import moba as JM
from repro.core import snr as JSNR
from repro.core.key_conv import apply_key_conv as j_apply_key_conv
from repro.kernels import ref as JREF
from torch_threads import one_thread_env, one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples_torch"
SCRIPTS = ("quickstart.py", "train_lm.py", "serve_decode.py",
           "longcontext_niah.py")
TOL = 2e-4
TIMEOUT = 240


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _start(script: str, *args: str) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, str(EXAMPLES / script), *args], cwd=ROOT,
        env=one_thread_env(PYTHONPATH=str(ROOT / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module", autouse=True)
def runs(tmp_path_factory):
    """Every subprocess run, started together: ``result(name)`` waits
    for one and returns (returncode, stdout, stderr)."""
    ckpt = tmp_path_factory.mktemp("train_lm")
    procs = {
        "quickstart": _start("quickstart.py", "--device", "cpu"),
        "serve_decode": _start("serve_decode.py", "--device", "cpu",
                               "--batch", "2", "--gen", "4"),
        "niah": _start("longcontext_niah.py", "--device", "cpu"),
        "train_lm": _start("train_lm.py", "--device", "cpu", "--steps",
                           "3", "--ckpt-dir", str(ckpt)),
        **{f"no_device:{s}": _start(s) for s in SCRIPTS}}
    done = {}

    def result(name: str):
        if name not in done:
            out, err = procs[name].communicate(timeout=TIMEOUT)
            done[name] = (procs[name].returncode, out, err)
        return done[name]

    yield result, ckpt
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


# ------------------------------------------------------------ quickstart
def test_quickstart_equals_jax():
    qs = _example("quickstart")
    q, k, v = qs.inputs()
    assert q.shape == (1, 4, 512, 64) and k.shape == (1, 2, 512, 64)
    assert q.dtype == k.dtype == v.dtype == np.float32
    out = qs.run(q, k, v, device="cpu")
    cfg = JMoBAConfig(block_size=64, top_k=2)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    want_ref = np.asarray(jax.jit(JM.moba_attention_reference,
                                  static_argnums=3)(jq, jk, jv, cfg))
    want_xla = np.asarray(jax.jit(JREF.moba_sparse_xla,
                                  static_argnums=3)(jq, jk, jv, cfg))
    for name, want in (("reference", want_ref), ("sparse", want_xla),
                       ("kernel", want_ref)):
        np.testing.assert_allclose(out[name], want, atol=TOL, rtol=TOL,
                                   err_msg=name)
    assert out["err_sparse"] <= TOL and out["err_kernel"] <= TOL
    sel = np.asarray(JM.moba_selection(jq, jk, cfg))[0, 0, qs.QUERY]
    np.testing.assert_array_equal(out["selection"], sel)
    assert qs.QUERY // 64 in out["selection"]       # own block forced
    assert out["snr"] == [(bs, JSNR.snr(64, bs, 0.5),
                           JSNR.p_fail(64, bs, 0.5))
                          for bs in (512, 256, 128)]


def test_quickstart_cli(runs):
    rc, out, err = runs[0]("quickstart")
    assert rc == 0, err
    errs = [float(ln.rsplit(":", 1)[1]) for ln in out.splitlines()
            if " max err:" in ln]
    assert len(errs) == 2 and max(errs) <= TOL
    assert "query 300 (block 4) selects blocks:" in out
    assert out.count("SNR=") == 3


# ------------------------------------------------------------------ NIAH
@pytest.fixture(scope="module")
def niah():
    return _example("longcontext_niah")


@pytest.mark.parametrize("config", ["B256,k2", "B128,k4", "B64,k8",
                                    "B64,k8+kconv3"])
def test_niah_selections_equal_jax(niah, config):
    """The example's needles at N 1024 (its own draws, as ``run`` makes
    them): the port's selections equal JAX's ``moba_selection`` (after
    JAX's ``apply_key_conv`` on the same numpy weights for kconv3), so
    the table's 1024 column is JAX's count on these needles."""
    (_, bs, k, conv_w), = [c for c in niah.CONFIGS if c[0] == config]
    n, d, trials = 1024, 64, 40
    conv = niah.conv_weights(conv_w, d) if conv_w else None
    j_select = jax.jit(JM.moba_selection, static_argnums=2)
    j_conv = jax.jit(j_apply_key_conv)
    rng = np.random.default_rng(0)
    hits = 0
    for _ in range(trials):
        q, keys, pos = niah.planted_qkv(rng, n, d)
        assert q.dtype == keys.dtype == np.float32
        got = niah.select(q, keys, conv, bs, k, "cpu")
        kk = jnp.asarray(keys)[None, None]
        if conv is not None:
            kk = j_conv(jnp.asarray(conv), kk)
        want = j_select(jnp.asarray(q)[None, None, None], kk,
                        JMoBAConfig(block_size=bs, top_k=k),
                        q_positions=jnp.array([n - 1]))
        np.testing.assert_array_equal(got, np.asarray(want)[0, 0, 0])
        hits += int((got == pos // bs).any())
    assert niah.run(lengths=(n,), trials=trials, d=d,
                    device="cpu")[config] == [hits / trials]


def test_niah_planted_needle(niah):
    """The needle's first key sits at cosine 0.5 to the unit query, the
    next three at 0.35; every key has unit norm."""
    q, keys, pos = niah.planted_qkv(np.random.default_rng(5), 512, 64)
    np.testing.assert_allclose(np.linalg.norm(keys, axis=-1), 1.0,
                               atol=1e-5)
    np.testing.assert_allclose(keys[pos:pos + 4] @ q,
                               [0.5, 0.35, 0.35, 0.35], atol=1e-5)
    assert np.linalg.norm(q) == pytest.approx(1.0, abs=1e-6)


def test_niah_cli(runs):
    rc, out, err = runs[0]("niah")
    assert rc == 0, err
    assert out.count("predicted per-pair p_fail") == 3
    rows = [ln.split() for ln in out.splitlines()
            if ln.startswith(("B256", "B128", "B64"))]
    assert [r[0] for r in rows] == ["B256,k2", "B128,k4", "B64,k8",
                                    "B64,k8+kconv3"]
    assert all(len(r) == 4 and all(0 <= float(a) <= 1 for a in r[1:])
               for r in rows)


# ------------------------------------------------------ serve and train
def test_serve_decode_cli(runs):
    rc, out, err = runs[0]("serve_decode")
    assert rc == 0, err
    tail = out.split("generated token ids (greedy):")[1]
    rows = [r.split() for r in tail.replace("[", " ").split("]")
            if r.strip()]
    assert len(rows) == 2 and all(len(r) == 4 for r in rows)


def test_train_lm_cli_resumes(runs, capsys):
    result, ckpt = runs
    rc, out, err = result("train_lm")
    assert rc == 0, err
    assert "final loss:" in out and "[resume]" not in out
    again = _start("train_lm.py", "--device", "cpu", "--steps", "5",
                   "--ckpt-dir", str(ckpt))
    out2, err2 = again.communicate(timeout=TIMEOUT)
    assert again.returncode == 0, err2
    assert f"[resume] restored step 3 from {ckpt}" in out2
    assert "step     4 loss" in out2 and "final loss:" in out2
    # every step done: the reference raises IndexError here (ROADMAP §C);
    # the port reports the restored step
    losses = _example("train_lm").main(["--device", "cpu", "--steps", "5",
                                        "--ckpt-dir", str(ckpt)])
    assert losses == []
    assert f"nothing to train: {ckpt} holds step 5 of 5" in \
        capsys.readouterr().out


def test_nothing_done_without_a_device(runs):
    for script in SCRIPTS:
        rc, out, err = runs[0](f"no_device:{script}")
        assert rc != 0, script
        assert "device 'cuda' requested" in err, (script, err)
        assert "max err" not in out and "loss" not in out, script
