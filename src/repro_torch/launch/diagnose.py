"""Collective breakdown of one dry-run cell: each kind's payload by
tensor and by parameter path, the largest first, with its time at the
link rate (the reference's ``launch/diagnose.py``).

  PYTHONPATH=src python -m repro_torch.launch.diagnose --arch qwen3-14b \\
      --shape prefill_32k
"""
from __future__ import annotations

import argparse

from repro_torch.configs.base import ShardingConfig
from repro_torch.launch import dryrun as DR
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import production_layout


def collective_breakdown(arch, shape, multi_pod=False, top=14,
                         scfg=None, block_size=128, top_k=8,
                         key_conv_width=0, remat=True):
    """Print the cell's per-device collectives, kind by kind, each
    kind's ``top`` largest entries; return them, by kind then entry."""
    layout = production_layout(multi_pod=multi_pod)
    cfg = DR._config(arch, block_size, top_k, key_conv_width)
    coll = DR.collectives(cfg, shape, layout, scfg or ShardingConfig(),
                          remat)
    total = sum(sum(v.values()) for v in coll.values())
    print(f"[{arch} × {DR.shape_name(shape)} × {layout.name}] total "
          f"collective payload {total / 1e9:.2f} GB/dev "
          f"(t={total / RL.LINK_BW:.3f}s at {RL.LINK_BW / 1e9:.0f} GB/s)")
    for kind in sorted(coll, key=lambda k: -sum(coll[k].values())):
        entries = coll[kind]
        nb = sum(entries.values())
        print(f"  {kind:<15} {nb / 1e9:8.3f} GB  t={nb / RL.LINK_BW:.3e}s"
              f"  ({len(entries)} tensors)")
        for name, b in sorted(entries.items(), key=lambda e: -e[1])[:top]:
            print(f"    {b / 1e9:8.3f} GB  t={b / RL.LINK_BW:.3e}s  {name}")
    return coll


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi", action="store_true")
    args = ap.parse_args()
    collective_breakdown(args.arch, args.shape, args.multi)
