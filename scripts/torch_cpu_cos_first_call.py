"""Reproduce torch's first-call CPU `cos` discrepancy, with torch alone.

Each run is a fresh process that takes `cos` of a [4, 64, 64] float32
rotary table (positions 0-63, head_dim 64) twice and prints how far each
result is from numpy's float64 cos. The first call is split over the
intra-op threads (16384 elements); in a few fresh processes out of every
fifty it is up to ~1.5e-4 off while the second is exact. With one intra-op
thread (`--threads 1`), or after a one-element call (`--settle`), every
first call is exact. The effect shows more often with several processes
at once, so run it that way:

    seq 48 | xargs -P 8 -I{} python3 scripts/torch_cpu_cos_first_call.py
    seq 48 | xargs -P 8 -I{} python3 scripts/torch_cpu_cos_first_call.py \\
        --threads 1
"""

import argparse

import numpy as np
import torch


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--threads", type=int, default=None,
                        help="torch intra-op threads (default: torch's)")
    parser.add_argument("--settle", action="store_true",
                        help="call cos on one element first")
    args = parser.parse_args()
    if args.threads:
        torch.set_num_threads(args.threads)
    if args.settle:
        torch.cos(torch.zeros(1))
    pos = torch.arange(64)[None].expand(4, 64)
    inv = 1.0 / (10000.0 ** (torch.arange(0, 64, 2, dtype=torch.float32) / 64))
    freqs = pos.float()[..., None] * inv
    emb = torch.cat([freqs, freqs], -1)
    ref = np.cos(emb.double().numpy())
    first, second = emb.cos(), emb.cos()
    print(f"first {np.abs(first.numpy() - ref).max():.6g} "
          f"second {np.abs(second.numpy() - ref).max():.6g}")


if __name__ == "__main__":
    main()
