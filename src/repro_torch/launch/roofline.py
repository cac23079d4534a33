"""Roofline terms of one dry-run cell on NVIDIA H100s.

Constants per GPU, from the NVIDIA H100 SXM5 80GB datasheet, 700 W
(dense rates, no sparsity): 989 TFLOP/s bf16, 3.35 TB/s HBM3, and one
link rate, 50 GB/s a GPU (InfiniBand NDR, 400 Gb/s).  One link rate
suffices because every group of both production layouts (16 × 16 and
2 × 16 × 16) spans more than the 8 GPUs of one NVLink node.  The three
terms are per device:

  compute    = flops_per_device / PEAK_FLOPS
  memory     = bytes_per_device / HBM_BW
  collective = collective_bytes_per_device / LINK_BW

Collective bytes count each collective's result bytes on one device,
with the ring multipliers of the reference (an all-reduce moves ~2× its
payload a device; the others ~1×).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

PEAK_FLOPS = 989e12       # bf16 dense / GPU
HBM_BW = 3.35e12          # B/s / GPU
LINK_BW = 50e9            # B/s / GPU (InfiniBand NDR)
SOURCE = "NVIDIA H100 SXM5 80GB datasheet, 700 W"

_MULT = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
         "all-to-all": 1.0, "collective-permute": 1.0}


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_breakdown: Dict[str, float]
    model_flops: float              # 6·N·D (train) / 2·N·D (fwd), global
    peak_memory_bytes: float        # per device: state + activation peak
    # the port's breakdown (state by part, collectives by tensor, ...)
    detail: dict = dataclasses.field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_device / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        traced = self.flops_per_device * self.chips
        return self.model_flops / traced if traced else 0.0

    @property
    def roofline_fraction(self) -> float:
        """useful-FLOPs time / bound time: MODEL_FLOPS/(chips·peak) over
        the dominant term — the MFU-analogue computable without the
        hardware."""
        ideal = self.model_flops / (self.chips * PEAK_FLOPS)
        bound = max(self.t_compute, self.t_memory, self.t_collective)
        return ideal / bound if bound else 0.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(t_compute=self.t_compute, t_memory=self.t_memory,
                 t_collective=self.t_collective, bottleneck=self.bottleneck,
                 useful_flops_ratio=self.useful_flops_ratio,
                 roofline_fraction=self.roofline_fraction,
                 constants={"peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW,
                            "link_bw": LINK_BW, "source": SOURCE})
        return d


def format_table(rows) -> str:
    hdr = (f"{'arch':<22}{'shape':<13}{'mesh':<10}{'t_comp(s)':>11}"
           f"{'t_mem(s)':>11}{'t_coll(s)':>11}{'bound':>11}"
           f"{'useful':>8}{'roofl%':>8}{'GB/dev':>8}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r.arch:<22}{r.shape:<13}{r.mesh:<10}"
            f"{r.t_compute:>11.3e}{r.t_memory:>11.3e}"
            f"{r.t_collective:>11.3e}{r.bottleneck:>11}"
            f"{r.useful_flops_ratio:>8.2f}"
            f"{100 * r.roofline_fraction:>7.1f}%"
            f"{r.peak_memory_bytes / 1e9:>8.2f}")
    return "\n".join(lines)
