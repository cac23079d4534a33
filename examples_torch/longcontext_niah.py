"""Long-context retrieval: watch the MoBA router find a planted needle,
and see block size + key convolution change retrieval accuracy exactly as
the SNR theory predicts.

    PYTHONPATH=src python examples_torch/longcontext_niah.py --device cpu

The router sweep is the paper's Tables 3/4 protocol at the router level
(RULER S-NIAH): a needle block counts as retrieved when it is in the
query's top-k.  Needles and the key-conv weights are drawn with numpy,
so the accuracies may differ from the JAX example's in the second
decimal; the selections on the same inputs are the same.
"""
import argparse
import os
import sys

_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_root, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.base import MoBAConfig  # noqa: E402
from repro_torch.core import moba as M  # noqa: E402
from repro_torch.core import snr  # noqa: E402
from repro_torch.core.key_conv import apply_key_conv  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402

# (name, block size, top_k, key-conv width)
CONFIGS = [("B256,k2", 256, 2, 0), ("B128,k4", 128, 4, 0),
           ("B64,k8", 64, 8, 0), ("B64,k8+kconv3", 64, 8, 3)]


def planted_qkv(rng: np.random.Generator, n: int, d: int, delta=0.5,
                m_cluster=4, mu_c=0.35):
    """Query + keys with an m-token clustered needle at a random block:
    fp32 q (d,), keys (n, d) and the needle's position."""
    q = rng.standard_normal(d)
    q = q / np.linalg.norm(q)
    keys = rng.standard_normal((n, d))
    keys = keys / np.linalg.norm(keys, axis=-1, keepdims=True)
    pos = int(rng.integers(0, n - m_cluster - 1))
    for i in range(m_cluster):
        mu = delta if i == 0 else mu_c
        vec = keys[pos + i]
        orth = vec - (vec @ q) * q
        orth = orth / np.linalg.norm(orth)
        keys[pos + i] = mu * q + np.sqrt(1 - mu * mu) * orth
    return q.astype(np.float32), keys.astype(np.float32), pos


def conv_weights(width: int, d: int, seed: int = 1) -> np.ndarray:
    """Key-conv weights (width, 1, d): the init's N(0, 1) · 0.02 / W,
    times 8 so the clustering shows at the router."""
    w = np.random.default_rng(seed).standard_normal((width, 1, d))
    return (w * (0.02 / width) * 8).astype(np.float32)


def select(q, keys, conv, block_size: int, top_k: int, device) -> np.ndarray:
    """The last position's selected blocks (top_k,) for numpy q (d,) and
    keys (n, d), the keys convolved first when ``conv`` is given."""
    dev = torch.device(device)
    n = keys.shape[0]
    kk = torch.as_tensor(keys, device=dev)[None, None]
    if conv is not None:
        kk = apply_key_conv(torch.as_tensor(conv, device=dev), kk)
    cfg = MoBAConfig(block_size=block_size, top_k=top_k)
    sel = M.moba_selection(torch.as_tensor(q, device=dev)[None, None, None],
                           kk, cfg,
                           q_positions=torch.tensor([n - 1], device=dev))
    return sel[0, 0, 0].cpu().numpy()


def run(lengths=(1024, 2048, 4096, 8192), trials: int = 60, d: int = 64,
        seed: int = 0, device="cuda"):
    """Router retrieval accuracy of each of :data:`CONFIGS` at each
    length; every (config, length) draws the same ``trials`` needles
    from ``default_rng(seed)``."""
    dev = resolve_device(device)
    print("# router retrieval accuracy (needle block in top-k)")
    header = f"{'config':<16}" + "".join(f"{n:>8}" for n in lengths)
    print(header)
    out = {}
    for name, bs, k, conv_w in CONFIGS:
        conv = conv_weights(conv_w, d) if conv_w else None
        accs = []
        for n in lengths:
            rng = np.random.default_rng(seed)
            hit = 0
            for _ in range(trials):
                q, keys, pos = planted_qkv(rng, n, d)
                sel = select(q, keys, conv, bs, k, dev)
                hit += int((sel == pos // bs).any())
            accs.append(hit / trials)
        out[name] = accs
        print(f"{name:<16}" + "".join(f"{a:>8.2f}" for a in accs))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    print("theory: p_fail = Φ(−Δμ_eff·sqrt(d/2B))  → smaller B retrieves "
          "better;\nclustering (kconv) raises Δμ_eff.\n")
    for bs in (256, 128, 64):
        print(f"  B={bs:4d}: predicted per-pair p_fail ="
              f" {snr.p_fail(64, bs, 0.5):.4f}")
    print()
    return run(lengths=(1024, 2048, 4096), trials=40, device=args.device)


if __name__ == "__main__":
    main()
