"""The three hill-climbed cells of the reference's
``launch/hillclimb.py``, costed on the single production layout:

  A. qwen2-moe-a2.7b × train_4k (worst roofline)
  B. llama-3.2-vision-90b × train_4k at microbatch 8 (most
     collective-bound)
  C. qwen3-14b × prefill_32k with sequence parallelism and no tensor
     parallelism (paper-representative)

  PYTHONPATH=src python -m repro_torch.launch.hillclimb

Each record is written to ``experiments/hillclimb_torch/<tag>.json``.
"""
from __future__ import annotations

import json
import os

from repro_torch.configs.base import ShardingConfig
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import production_layout

OUT = "experiments/hillclimb_torch"


def measure(arch, shape, tag, scfg=None, microbatch=None, out=OUT, **kw):
    """Cost one cell (both passes) on the 16 × 16 layout with ``scfg``
    and ``microbatch`` (the arch's ``MICROBATCH`` when None), write its
    record and print its terms."""
    rl = DR.cost_cell(arch, shape, production_layout(), scfg=scfg,
                      microbatch=microbatch, verbose=False, **kw)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"{tag}.json"), "w") as f:
        json.dump(rl.to_dict(), f, indent=1)
    print(f"{tag}: t_comp={rl.t_compute:.3e} t_mem={rl.t_memory:.3e} "
          f"t_coll={rl.t_collective:.3e} bound={rl.bottleneck} "
          f"roofline={100 * rl.roofline_fraction:.1f}% "
          f"mem={rl.peak_memory_bytes / 1e9:.1f}GB")
    return rl


CELLS = (
    ("qwen3-14b", "prefill_32k", "qwen3-14b__prefill_32k__opt",
     dict(scfg=ShardingConfig(tensor_parallel=False,
                              sequence_parallel=True))),
    ("qwen2-moe-a2.7b", "train_4k", "qwen2-moe__train_4k__opt", {}),
    ("llama-3.2-vision-90b", "train_4k", "llama-90b__train_4k__opt",
     dict(microbatch=8)),
)


if __name__ == "__main__":
    for arch, shape, tag, kw in CELLS:
        measure(arch, shape, tag, **kw)
