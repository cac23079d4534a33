"""Quickstart: MoBA attention in three flavors + the SNR design rule.

    PYTHONPATH=src python examples_torch/quickstart.py               # card
    PYTHONPATH=src python examples_torch/quickstart.py --device cpu

On the card ``flash_moba`` launches the centroids, Flash TopK and
FlashMoBA forward kernels; on the CPU it runs their plain versions.
"""
import argparse
import os
import sys

_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_root, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.base import MoBAConfig  # noqa: E402
from repro_torch.core import moba, snr  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

B, H, HKV, N, D = 1, 4, 2, 512, 64
CFG = MoBAConfig(block_size=64, top_k=2)
QUERY = 300
SNR_BLOCKS = (512, 256, 128)


def inputs():
    """fp32 numpy q (B, H, N, D), k and v (B, HKV, N, D), seed 0."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, H, N, D), np.float32) * 0.5
    k = rng.standard_normal((B, HKV, N, D), np.float32) * 0.5
    v = rng.standard_normal((B, HKV, N, D), np.float32)
    return q, k, v


def run(q, k, v, device="cuda") -> dict:
    """The three flavors on numpy q, k, v: the outputs (numpy), their
    errors against the reference, query ``QUERY``'s selected blocks
    (head 0) and the SNR rule's (block size, SNR, p_fail) rows."""
    dev = resolve_device(device)
    q, k, v = (torch.as_tensor(x, device=dev) for x in (q, k, v))
    with torch.no_grad():
        # 1) reference (O(N^2) oracle)
        o_ref = moba.moba_attention_reference(q, k, v, CFG)
        # 2) gather-and-densify in plain PyTorch (the xla backend's path)
        o_xla = ref.moba_sparse_xla(q, k, v, CFG)
        # 3) FlashMoBA: the Hopper kernels on the card
        o_ker = ops.flash_moba(q, k, v, CFG)
        sel = moba.moba_selection(q, k, CFG)
    return {"reference": o_ref.cpu().numpy(), "sparse": o_xla.cpu().numpy(),
            "kernel": o_ker.cpu().numpy(),
            "err_sparse": float((o_ref - o_xla).abs().max()),
            "err_kernel": float((o_ref - o_ker).abs().max()),
            "selection": sel[0, 0, QUERY].cpu().numpy(),
            "snr": [(bs, snr.snr(D, bs, 0.5), snr.p_fail(D, bs, 0.5))
                    for bs in SNR_BLOCKS]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    out = run(*inputs(), device=args.device)
    print("reference vs sparse-XLA max err:", out["err_sparse"])
    print("reference vs FlashMoBA kernel max err:", out["err_kernel"])
    # routing: which blocks does query 300 attend to?
    print(f"query {QUERY} (block {QUERY // CFG.block_size}) selects blocks:",
          out["selection"])
    # the paper's design rule: SNR = Δμ_eff · sqrt(d / 2B)
    for bs, s, p in out["snr"]:
        print(f"B={bs:4d}: SNR={s:.3f}  p_fail={p:.3f}")
    print("halving B buys sqrt(2) SNR — hence FlashMoBA for small blocks.")
    return out


if __name__ == "__main__":
    main()
