"""Sweep of ``mxu_expand``'s sparse-path threshold on one card.

Run from the root of a checkout on a machine with a card::

    python3 -m bfs_tpu_torch.tools.mxu_sparse_sweep [--tiles 524288]

``csrc/relay_mxu_kernels.cu`` sends a live tile down its sparse path when
it holds at most ``kSparseMaxBits`` reachable (frontier row, destination)
bits, else through the tensor cores.  This script builds two more copies
of that source into the git-ignored build directory, one with the constant
at 0 (every tile with a reachable bit takes the tensor cores) and one at
2^20 (every tile takes the sparse path), and times them beside the
committed build on layouts of ``--tiles`` tiles that each hold exactly k
bits (1 to 16384), spread over the tile's rows or packed into the rows of
one lane, under an all-ones frontier: one launch after an L2 flush and a
device sleep (``utils.timing.cold_ms``), mean of 10.  Every output is
held against the plain version.  One line per k, the card's name and power limit, and one
JSON line; the threshold is the k where the two paths' times cross.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..ops import relay_cuda as K
from ..ops import relay_mxu as RM
from ..utils import cuda_build
from ..utils.timing import card_line, cold_ms

KS = tuple(1 << i for i in range(15))  # 1 .. 16384 bits: up to a full tile
ROWS = 1 << 22  # rows = cols: 32,768 row and column blocks
HBM_BYTES_PER_S = 3.35e12


def variants() -> dict:
    """name -> loaded library: the committed build and the all-dense and
    all-sparse copies."""
    libs = cuda_build.build_variants(
        "relay_mxu_kernels", K.SOURCES["relay_mxu_kernels"],
        {"dense": {"kSparseMaxBits": 0}, "sparse": {"kSparseMaxBits": 1 << 20}},
        K._register_mxu)
    return {"committed": K.mxu_kernels(), **libs}


def launch(lib, fw, ops, vtp: int, cols: int) -> torch.Tensor:
    """One ``mxu_expand`` launch of ``lib``, as ``relay_cuda.expand_frontier_mxu``
    launches it."""
    tiles, row_idx, col_id, keys2d = ops
    ntp = tiles.shape[0]
    out = torch.full((vtp,), -1, dtype=torch.int32, device=fw.device)
    sms = torch.cuda.get_device_properties(fw.device).multi_processor_count
    blocks = min(-(-ntp // (32 * K.MXU_WARPS)), sms * K.MXU_BLOCKS_PER_SM)
    rc = lib.mxu_expand(
        K._ptr(tiles), K._ptr(row_idx), K._ptr(col_id), K._ptr(keys2d), K._ptr(fw),
        fw.numel(), K._ptr(out), ntp, vtp // 128, 1, fw.numel(), vtp, blocks, K._ctl(None),
        K._stream(),
    )
    if rc:
        raise RuntimeError(f"mxu_expand: CUDA error {rc} at launch")
    return out[:cols]


#: Rows in the order that fills one lane's rows first: the kernel's lane L
#: holds rows L, L + 32, L + 64 and L + 96.
LANE_ROWS = [u + 32 * i for u in range(32) for i in range(4)]


def layout(n: int, k: int, spread: bool, gen: torch.Generator):
    """``n`` tiles of exactly ``k`` bits each, random row blocks, column
    blocks in ascending order as the builder sorts them, random keys with
    the sentinel pad block.  ``spread``: bit i at i * s plus a random offset
    below s = 16384 / k (the bits spread over the rows, so over the lanes);
    else the first k bits of whole rows in ``LANE_ROWS`` order (up to 512
    bits on one lane, the sparse path's worst case)."""
    dev = "cuda"
    blocks = ROWS // 128
    words = torch.empty((n, 512), dtype=torch.int32, device=dev)
    step = max(1, (1 << 26) // k)  # tiles per chunk of positions
    order = torch.tensor(LANE_ROWS, device=dev)
    base = torch.arange(k, device=dev)
    for lo in range(0, n, step):
        m = min(step, n - lo)
        if spread:
            s = 16384 // k
            pos = base * s + torch.randint(0, s, (m, k), device=dev, generator=gen)
        else:
            pos = (order[base // 128] * 128 + base % 128).expand(m, k)
        acc = torch.zeros((m, 512), dtype=torch.int64, device=dev)
        acc.scatter_add_(1, pos >> 5, torch.ones_like(pos) << (pos & 31))  # distinct bits: sum = OR
        words[lo : lo + m] = (acc - (acc >> 31 << 32)).to(torch.int32)
    row_idx = torch.randint(0, blocks, (n,), device=dev, generator=gen).to(torch.int32)
    col_id = (torch.arange(n, device=dev) * blocks // n).to(torch.int32)
    keys = torch.randint(0, 1 << 30, (blocks + 1, 128), device=dev, generator=gen).to(torch.int32)
    keys[-1] = -1
    return (words.reshape(n, 128, 4), row_idx, col_id, keys)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiles", type=int, default=1 << 19)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mxu_sparse_sweep: no CUDA device")
    card = card_line()
    libs = variants()
    committed = cuda_build.constant(K.SOURCES["relay_mxu_kernels"], "kSparseMaxBits")
    gen = torch.Generator(device="cuda").manual_seed(0)
    fw = torch.full((ROWS // 32,), -1, dtype=torch.int32, device="cuda")
    kw = dict(rows=ROWS, cols=ROWS, rtp=ROWS, vtp=ROWS)
    bound_ms = (2064 * args.tiles + 8 * ROWS) / HBM_BYTES_PER_S * 1e3
    rows = []
    for spread in (True, False):
        for k in KS:
            ops = layout(args.tiles, k, spread, gen)
            want = RM.expand_frontier_mxu_plain(fw, ops, **kw)
            ms = {}
            for name, lib in libs.items():
                if not torch.equal(launch(lib, fw, ops, ROWS, ROWS), want):
                    raise AssertionError(f"k={k}: the {name} build differs from the plain version")
                ms[name] = cold_ms(lambda: launch(lib, fw, ops, ROWS, ROWS), 10, warm=1)
            kind = "spread" if spread else "one lane"
            rows.append(dict(k=k, layout=kind, **ms))
            print(f"k={k} ({kind}): dense {ms['dense']:.4f} ms, sparse {ms['sparse']:.4f} ms, "
                  f"committed (kSparseMaxBits={committed}) {ms['committed']:.4f} ms; bound "
                  f"{bound_ms:.4f} ms; {args.tiles} tiles, bit-exact", flush=True)
            del ops, want
            torch.cuda.empty_cache()
    print(card)
    print(json.dumps({"tiles": args.tiles, "bound_ms": bound_ms, "committed": committed,
                      "card": card, "sweep": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
