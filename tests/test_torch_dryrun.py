"""The port's dry run (``repro_torch.launch.dryrun``, ``roofline``,
``diagnose``, ``hillclimb``) against the JAX package's, on the CPU.

* The accounting pass's FLOPs on meta tensors equal ``FlopCounterMode``
  over the same step run for real on the CPU (train, prefill, decode;
  smoke configs of every family): the same aten ops.
* Tracing one to four periods of the layer pattern and extending them
  (``_extrapolate``) equals the whole trace at smoke size, exactly:
  FLOPs and op bytes from three points, the activation peak from two.
* ``LiveBytes``' peak and ``BytesCounter``'s total equal hand counts on
  small known graphs.
* The port's collective schedule against XLA's partitioner: ONE JAX
  subprocess on 8 simulated devices (started by an autouse fixture, so
  it runs beside the in-process tests) compiles the reference's train
  step (``xla_unrolled``, remat, AdamW) under ``use_mesh`` and
  ``param_specs`` for qwen3-0.6b's and qwen2-moe-a2.7b's smoke configs
  on an 8 × 1 and a 2 × 4 mesh, and ``repro.launch.roofline.
  collective_bytes`` reads its HLO.  On the CPU XLA lowers every FSDP
  gradient reduction as an all-reduce of the gradient gathered over the
  data axes (it forms no reduce-scatter), so the schedule's
  reduce-scatters are compared in that form (2·n× their result bytes).
  Tolerance: on the pure-FSDP dense cell (qwen3-0.6b, 8 × 1) the weight
  all-gathers are equal exactly and the gradient all-reduce within 0.1%
  (72 B of scalar partials).  What XLA's partitioner adds beyond the
  schedule is held to ``DIVERGENCE``, per kind, exactly: ROADMAP §C
  records each entry.
* The CLI on the reference test's cell (qwen3-0.6b × decode_32k,
  single) exits 0 and writes its JSON; ``Roofline``'s terms equal the
  reference's under the same constants; ``diagnose`` and ``hillclimb``.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.launch import roofline as JRL
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShardingConfig
from repro_torch.distributed import sharding as SH
from repro_torch.launch import diagnose, dryrun as DR, hillclimb
from repro_torch.launch import roofline as RL
from repro_torch.models import transformer as TT
from repro_torch.optim.adamw import tree_leaves
from torch_threads import one_thread_env, one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
KINDS = ("train", "prefill", "decode")
SMOKE = (64, 4)                       # seq, batch of the smoke cells
COLL_BATCH, COLL_SEQ = 8, 64
COLL_CELLS = [(a, m) for a in ("qwen3-0.6b", "qwen2-moe-a2.7b")
              for m in ((8, 1), (2, 4))]
# XLA's per-device collective bytes beyond the schedule, by kind (the
# schedule's reduce-scatters in the CPU's all-reduce form); ROADMAP §C
DIVERGENCE = {
    ("qwen3-0.6b", (8, 1)): {"all-gather": 133120, "all-reduce": 72,
                             "all-to-all": 32768},
    ("qwen3-0.6b", (2, 4)): {"all-gather": 1759744,
                             "all-reduce": 3653768, "all-to-all": 118784,
                             "collective-permute": 434224},
    ("qwen2-moe-a2.7b", (8, 1)): {"all-gather": 869376,
                                  "all-reduce": 3641736,
                                  "all-to-all": 32768},
    ("qwen2-moe-a2.7b", (2, 4)): {"all-gather": 2682368,
                                  "all-reduce": 6351848,
                                  "all-to-all": -352256,
                                  "collective-permute": 437296},
}

_JAX_CODE = """
import json, re, sys
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import configs
from repro.configs.base import ShardingConfig, TrainConfig
from repro.distributed import sharding as shmod
from repro.launch import roofline as RL, steps as S
from repro.models import transformer as T
from repro.optim import adamw

BATCH, SEQ = int(sys.argv[2]), int(sys.argv[3])
out = {}
for arch in ("qwen3-0.6b", "qwen2-moe-a2.7b"):
    cfg = configs.get_smoke_config(arch)
    for shape in ((8, 1), (2, 4)):
        mesh = shmod.make_compat_mesh(shape, ("data", "model"))
        scfg = ShardingConfig()
        ps = jax.eval_shape(lambda k: T.init_lm(k, cfg),
                            jax.random.PRNGKey(0))
        sds = lambda s, sh: jax.ShapeDtypeStruct(s.shape, s.dtype,
                                                 sharding=sh)
        pin = jax.tree.map(sds, ps, shmod.param_specs(ps, mesh, scfg))
        st = jax.eval_shape(adamw.adamw_init, ps)
        osp = shmod.param_specs(st.mu, mesh, scfg)
        oin = adamw.AdamWState(
            jax.ShapeDtypeStruct((), jnp.int32,
                                 sharding=NamedSharding(mesh, P())),
            jax.tree.map(sds, st.mu, osp), jax.tree.map(sds, st.nu, osp))
        bsh = S.batch_shardings(cfg, mesh, BATCH)
        bin_ = {"tokens": jax.ShapeDtypeStruct(
            (BATCH, SEQ + 1), jnp.int32, sharding=bsh["tokens"])}
        tcfg = TrainConfig(global_batch_size=BATCH, seq_len=SEQ)
        with shmod.use_mesh(mesh, scfg):
            step = S.make_train_step(cfg, tcfg, backend="xla_unrolled",
                                     remat=True, unroll=True)
            text = jax.jit(step, donate_argnums=(0, 1)).lower(
                pin, oin, bin_).compile().as_text()
        gathers = []
        for line in text.splitlines():
            m = RL._COLL_RE.search(line)
            if m and m.group(1) == "all-gather":
                ty = line.split("=", 1)[1].split(m.group(1))[0]
                gathers.append([[int(d) for d in dims.split(",") if d]
                                for _, dims in RL._SHAPE_RE.findall(ty)]
                               + [RL._shape_bytes(ty)])
        out[f"{arch}|{shape[0]}x{shape[1]}"] = {
            "total": RL.collective_bytes(text), "gathers": gathers}
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module", autouse=True)
def jax_proc(tmp_path_factory):
    """The reference's train steps compiled on 8 simulated devices, in
    one subprocess started before this file's first test."""
    tmp = tmp_path_factory.mktemp("jax_dryrun")
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX_CODE),
         str(tmp / "out.json"), str(COLL_BATCH), str(COLL_SEQ)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    yield proc, tmp / "out.json"
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def jax_run(jax_proc):
    proc, path = jax_proc
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    with open(path) as f:
        return json.load(f)


# ------------------------------------------------------------- accounting
FLOP_ARCHS = ("qwen3-0.6b", "qwen2-moe-a2.7b", "mamba2-780m",
              "zamba2-1.2b", "seamless-m4t-medium", "llama-3.2-vision-90b")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", FLOP_ARCHS)
def test_meta_flops_equal_a_real_cpu_step(arch, kind):
    cfg = get_smoke_config(arch)
    shape = (*SMOKE, kind)
    counted = DR.count_step(cfg, shape)
    with FlopCounterMode(display=False) as fc:
        DR.run_step(cfg, shape, device="cpu")
    assert counted["flops"] == fc.get_total_flops() > 0
    assert counted["bytes"] > 0


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ("qwen3-0.6b", "qwen2-moe-a2.7b",
                                  "zamba2-1.2b", "llama-3.2-vision-90b"))
def test_extrapolation_equals_the_whole_trace(arch, kind):
    """Five periods traced whole against three (counts) and two (peak)
    traced periods extended."""
    cfg = DR._with_groups(get_smoke_config(arch), 5)
    shape = (*SMOKE, kind)

    def counts(c):
        return DR.count_step(c, shape)

    def peak(c):
        return DR.activation_peak(c, shape)

    assert (DR._extrapolate(counts, cfg, DR.COUNT_POINTS)
            == DR._extrapolate(counts, cfg, DR.COUNT_POINTS, whole=True))
    assert (DR._extrapolate(peak, cfg, DR.PEAK_POINTS)
            == DR._extrapolate(peak, cfg, DR.PEAK_POINTS, whole=True))


def test_live_bytes_hand_count():
    """4,000-byte storages: views share their storage, a storage lives
    while any view does, a tensor freed before the next op still counts,
    a tensor marked as soon as it is made never does."""
    with DR.LiveBytes() as t:
        a = torch.ones(1000)                       # 4,000
        b = a * 2                                  # 8,000
        view = b[:10]                              # a view: no new bytes
        del a                                      # 4,000
        d = torch.empty(500, dtype=torch.float64)  # 8,000
        e = b + 1                                  # 12,000: the peak
        del b, e                                   # b lives in view
        assert t.live == 8000 and t.peak == 12000
        g = torch.zeros(2000)                      # 8,000 + 8,000 marked
        t.mark(g)
        h = torch.zeros(1000)                      # 12,000 unmarked
        assert t.excluded == 8000
        del d, g, h
    assert t.peak == 12000 and t.live == 4000 and t.excluded == 0
    del view
    assert t.live == 0


def test_bytes_counter_hand_count():
    """An add reads two inputs and writes one; a view moves nothing; an
    expanded input counts its storage once."""
    a, b = torch.ones(1000), torch.ones(1000)
    with DR.BytesCounter() as bc:
        a + b
    assert bc.total == 12000
    with DR.BytesCounter() as bc:
        a.view(10, 100).t()
    assert bc.total == 0
    with DR.BytesCounter() as bc:
        a[None].expand(4, 1000) * 2
    assert bc.total == 4000 + 16000


def test_train_step_state_on_one_device():
    """On a 1 × 1 layout: no collective, the state is params + grads +
    mu + nu, the FLOPs those of the whole step, and the peak the state
    plus the traced activations."""
    cfg = get_smoke_config("moba-340m")
    one = SH.Layout((1, 1), ("data", "model"))
    rl = DR.cost_cell("moba-340m", (64, 2, "train"), one, cfg=cfg,
                      verbose=False)
    n = sum(np.prod(s) for _, s in tree_leaves(TT.param_shapes(cfg)))
    assert rl.chips == 1 and rl.coll_bytes_per_device == 0
    assert rl.detail["state_bytes"] == {k: 4.0 * n for k in (
        "params", "grads", "adam_mu", "adam_nu")}
    assert rl.flops_per_device == DR.count_step(cfg, (64, 2, "train"))[
        "flops"]
    assert rl.peak_memory_bytes == 16 * n + DR.activation_peak(
        cfg, (64, 2, "train"))
    assert rl.detail["rows"] == 2


def test_device_rows_follow_batch_specs():
    single = SH.Layout((16, 16), ("data", "model"))
    assert DR.device_rows("llama-3.2-vision-90b", "train_4k", single) == 1
    assert DR.device_rows("qwen3-0.6b", "train_4k", single) == 16
    assert DR.device_rows("qwen3-14b", "train_4k", single, 4) == 4
    assert DR.device_rows("qwen3-0.6b", "long_500k", single) == 1
    assert DR.device_rows("qwen3-0.6b", "prefill_32k", single) == 2


# ------------------------------------------------------------ collectives
def _weight_gathers(cfg, layout) -> set:
    """Per-group shapes of every weight gathered over the data axes."""
    specs = dict(tree_leaves(SH.param_specs(TT.param_shapes(cfg), layout,
                                            ShardingConfig())))
    out = set()
    for path, shape in tree_leaves(TT.param_shapes(cfg)):
        g = SH.local_shape(shape, SH.without_axes(specs[path], ("data",)),
                           layout)
        out.add(g[1:] if path.startswith("blocks/") else g)
    return out


def _cpu_form(coll: dict, n_data: int) -> dict:
    """Per-kind totals with each reduce-scatter as the all-reduce of the
    gathered gradient that XLA's CPU pipeline emits (2·n× its result)."""
    out = {}
    for kind, entries in coll.items():
        b = sum(entries.values())
        if kind == "reduce-scatter":
            kind, b = "all-reduce", 2 * n_data * b
        out[kind] = out.get(kind, 0) + b
    return out


@pytest.mark.parametrize("arch,mesh", COLL_CELLS)
def test_collectives_against_xla(arch, mesh, jax_run):
    cfg = get_smoke_config(arch)
    layout = SH.Layout(mesh, ("data", "model"))
    coll = DR.collectives(cfg, (COLL_SEQ, COLL_BATCH, "train"), layout,
                          ShardingConfig())
    xla = jax_run[f"{arch}|{mesh[0]}x{mesh[1]}"]
    ours = _cpu_form(coll, mesh[0])
    extra = {k: int(xla["total"].get(k, 0) - ours.get(k, 0))
             for k in set(xla["total"]) | set(ours)}
    assert {k: v for k, v in extra.items() if v} == DIVERGENCE[(arch,
                                                                mesh)]
    if (arch, mesh) == ("qwen3-0.6b", (8, 1)):
        shapes = _weight_gathers(cfg, layout)
        weights = sum(g[-1] for g in xla["gathers"]
                      if len(g) == 2 and tuple(g[0]) in shapes)
        assert weights == sum(coll["all-gather"].values())
        assert abs(xla["total"]["all-reduce"] - ours["all-reduce"]) <= (
            1e-3 * ours["all-reduce"])


def test_collectives_by_kind_and_path():
    """The schedule on 16 × 16 for an MoE train cell: each kind the
    specs imply is there, a weight gathered twice under remat."""
    cfg = get_smoke_config("qwen2-moe-a2.7b")
    layout = SH.Layout((2, 4), ("data", "model"))
    shape = (COLL_SEQ, COLL_BATCH, "train")
    coll = DR.collectives(cfg, shape, layout, ShardingConfig())
    assert set(coll) == {"all-gather", "reduce-scatter", "all-reduce",
                         "all-to-all"}
    no_remat = DR.collectives(cfg, shape, layout, ShardingConfig(),
                              remat=False)
    wq = "blocks/slot_0/attn/wq"
    assert coll["all-gather"][wq] == 2 * no_remat["all-gather"][wq]
    assert "blocks/slot_0/attn/wo out" in coll["all-reduce"]
    no_tp = DR.collectives(cfg, shape, layout,
                           ShardingConfig(tensor_parallel=False))
    assert set(no_tp) == {"all-gather", "reduce-scatter", "all-reduce"}
    decode = DR.collectives(cfg, (COLL_SEQ, COLL_BATCH, "decode"), layout,
                            ShardingConfig())
    assert "reduce-scatter" not in decode
    assert "slot_0 partial attention" in decode["all-reduce"]
    assert diagnose.collective_breakdown(
        "qwen2-moe-a2.7b", "decode_32k", top=3) == DR.collectives(
        DR._config("qwen2-moe-a2.7b", 128, 8, 0), "decode_32k",
        SH.Layout((16, 16), ("data", "model")), ShardingConfig())


# -------------------------------------------------------------- roofline
def test_roofline_terms_equal_the_reference(monkeypatch):
    """Under the reference's constants the port's terms, bottleneck and
    shares and its table equal ``repro.launch.roofline``'s."""
    kw = dict(arch="a", shape="train_4k", mesh="16x16", chips=256,
              flops_per_device=3.2e15, bytes_per_device=4.1e12,
              coll_bytes_per_device=7.7e10,
              coll_breakdown={"all-reduce": 7.7e10}, model_flops=5.0e17,
              peak_memory_bytes=4.2e10)
    for peak, hbm, link in ((JRL.PEAK_FLOPS, JRL.HBM_BW, JRL.ICI_BW),
                            (RL.PEAK_FLOPS, RL.HBM_BW, RL.LINK_BW)):
        monkeypatch.setattr(JRL, "PEAK_FLOPS", peak)
        monkeypatch.setattr(JRL, "HBM_BW", hbm)
        monkeypatch.setattr(JRL, "ICI_BW", link)
        want, got = JRL.Roofline(**kw), RL.Roofline(**kw)
        monkeypatch.setattr(RL, "PEAK_FLOPS", peak)
        monkeypatch.setattr(RL, "HBM_BW", hbm)
        monkeypatch.setattr(RL, "LINK_BW", link)
        for p in ("t_compute", "t_memory", "t_collective", "bottleneck",
                  "useful_flops_ratio", "roofline_fraction"):
            assert getattr(got, p) == getattr(want, p), p
        assert RL.format_table([got]) == JRL.format_table([want])
        d = got.to_dict()
        assert {k: d[k] for k in want.to_dict()} == want.to_dict()
    assert RL._MULT == JRL._MULT
    assert (RL.PEAK_FLOPS, RL.HBM_BW, RL.LINK_BW) == (989e12, 3.35e12,
                                                      50e9)


# ------------------------------------------------------------ entry points
def test_cli_costs_the_reference_test_cell(tmp_path):
    """The JAX test's cell through the port's CLI."""
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--archs",
         "qwen3-0.6b", "--shapes", "decode_32k", "--mesh", "single",
         "--out", str(tmp_path)], capture_output=True, text=True,
        env=one_thread_env(PYTHONPATH=os.path.join(ROOT, "src")),
        timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "all 1 cells costed OK" in r.stdout
    with open(tmp_path / "qwen3-0.6b__decode_32k__single.json") as f:
        rec = json.load(f)
    assert rec["mesh"] == "16x16" and rec["chips"] == 256
    assert rec["flops_per_device"] > 0 and rec["bottleneck"] in (
        "compute", "memory", "collective")
    assert rec["constants"]["source"] == RL.SOURCE


def test_hillclimb_measure_writes_its_record(tmp_path, capsys):
    cfg = get_smoke_config("qwen3-0.6b")
    rl = hillclimb.measure("qwen3-0.6b", (64, 32, "train"), "smoke",
                           microbatch=2, cfg=cfg, out=str(tmp_path))
    with open(tmp_path / "smoke.json") as f:
        assert json.load(f)["peak_memory_bytes"] == rl.peak_memory_bytes
    assert rl.detail["rows"] == 1 and "smoke: t_comp=" in (
        capsys.readouterr().out)
    assert [c[:3] for c in hillclimb.CELLS] == [
        ("qwen3-14b", "prefill_32k", "qwen3-14b__prefill_32k__opt"),
        ("qwen2-moe-a2.7b", "train_4k", "qwen2-moe__train_4k__opt"),
        ("llama-3.2-vision-90b", "train_4k", "llama-90b__train_4k__opt")]
