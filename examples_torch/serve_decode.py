"""Serving example: batched prefill + greedy decode with MoBA KV routing.

    PYTHONPATH=src python examples_torch/serve_decode.py --device cpu

Pick the attention implementation end-to-end with --attn-backend
(reference | xla | flash, see repro_torch.core.backends).  On the card
``flash`` decodes through the paged MoBA decode kernel, which takes head
dims 64 and 128, so run it at the config's full width:

    PYTHONPATH=src python examples_torch/serve_decode.py \\
        --attn-backend flash --full
"""
import argparse
import os
import sys

_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_root, "src"))

from repro_torch.launch.serve import serve  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--attn-backend", default="reference",
                    help="registered attention backend (core.backends); "
                         "flash takes an option suffix, e.g. "
                         "flash:grouped, flash:flat or flash:kb_tile=64")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill token budget per engine step "
                         "(0 = whole-prompt prefill)")
    ap.add_argument("--full", action="store_true",
                    help="the arch's full-width config instead of its "
                         "smoke config (random seed-0 weights)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    toks = serve(args.arch, batch=args.batch, prompt_len=args.prompt_len,
                 gen=args.gen, smoke=not args.full,
                 attn_backend=args.attn_backend,
                 prefill_chunk=args.prefill_chunk, device=args.device)
    print("generated token ids (greedy):")
    print(toks)
    return toks


if __name__ == "__main__":
    main()
