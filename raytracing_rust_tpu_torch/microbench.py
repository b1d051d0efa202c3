"""D1 and D2 timed alone: the winner-row read and the member tests and votes.

    python -m raytracing_rust_tpu_torch.microbench [--device cuda|cpu]
        [--threads N] [--full-wave]

The counterpart of tools/microbench.py, on its seeded inputs
(`ops/microbench.py`). On the card (the default) it prints, for 4 and then
2 bands, the winner-row read's µs per call with the table read through the
read-only cache (`global`) and staged in shared memory (`shared`), then
the ns per call of one sphere member test, one merged-box slab test, a
warp's `any` vote and a warp's 31-bit OR-reduce, each from CUDA events at
the JAX tool's two trip counts (D1 2 and 22, D2 64 and 1064). --threads
sets the thread count (default 8,192, the TPU tile's lanes, as the JAX tool
measures); --full-wave launches each kernel with one full wave of its own
threads instead (SMs × the blocks of it an SM holds at once). With
--device cpu it runs the plain versions at the low trip counts and prints
their checks, with no rates.
"""

from __future__ import annotations

import argparse
import sys

import torch

from .ops import microbench as mb


def _check_cpu(threads: int) -> bool:
    """The plain versions' checks at the low trip counts: D1's accumulator
    equals the exact sum of its words (integer multiples of 2⁻¹⁴⁹ below
    2²⁴ · 2⁻¹⁴⁹, so the f32 sum is their integer sum) and its checksum the
    words' xor; D2's votes are those of each warp's lanes."""
    ok = True
    col = mb.attr_cols(threads)
    for n_bands in mb.BANDS:
        table = mb.attr_table(n_bands)
        k = mb.D1_K[0]
        acc, ck = mb.attr_read(table, col, k)
        words = torch.stack([mb.attr_rows_plain(table, col, i)
                             for i in range(k)])
        exact = bool(torch.equal(acc.view(torch.int32),
                                 words[..., 0].sum(dim=0).to(torch.int32)))
        want = torch.zeros_like(ck)
        for w in words.permute(0, 2, 1).reshape(-1, col.numel()):
            want = want ^ w
        fold = bool(torch.equal(ck, want))
        ok &= exact and fold
        print(f"attr_read[{n_bands} bands] plain k={k}: accumulator exact "
              f"{exact}, checksum {fold}")
    rec, x = mb.member_rec(), mb.member_x(threads)
    k = mb.D2_K[0]
    for kind in mb.KINDS:
        out, fold = mb.member(rec, x, k, kind)
        if kind in ("sphere", "box"):
            hit = float((out < 3e38).double().mean())
            good = bool(torch.isfinite(out).all()) and bool((fold == 0).all())
            print(f"{kind:16s} plain k={k}: {100 * hit:.1f}% of lanes hit")
        elif kind == "any":
            # q ≥ 1 votes true for every lane; q = 0 where a lane's x > 500
            want = k - 1 + (x.view(-1, 32) > 500).any(dim=1).to(torch.int32)
            good = bool(torch.equal(fold.view(-1, 32)[:, 0], want))
            print(f"{kind:16s} plain k={k}: votes {good}")
        else:
            lit = (x.view(-1, 32) > 0).any(dim=1)
            want = torch.zeros_like(lit, dtype=torch.int32)
            for q in range(k):
                want = want ^ (lit.to(torch.int32) << (q % 31))
            good = bool(torch.equal(fold.view(-1, 32)[:, 0], want))
            print(f"{kind:16s} plain k={k}: words {good}")
        ok &= good
    return ok


def run_card(threads: int | None) -> dict:
    """The rates on the card → dict of µs per D1 call by "bands_variant",
    ns per D2 call by kind, and each one's thread count: `threads` threads,
    or (None) each kernel's own full wave (`ops.microbench.full_wave`)."""
    dev = torch.device("cuda")
    out = dict(d1_us={}, d2_ns={}, d1_threads={}, d2_threads={})
    at = "" if threads else " at {} threads"
    for n_bands in mb.BANDS:
        table = mb.attr_table(n_bands).to(dev)
        line = f"attr_read[{n_bands} bands]"
        for variant in ("global", "shared"):
            shared = variant == "shared"
            n = threads or mb.full_wave("attr_read", n_bands, shared)
            col = mb.attr_cols(n).to(dev)
            us = mb.per_call(lambda k: mb.attr_read(table, col, k,
                                                    shared=shared),
                             mb.D1_K) * 1e6
            key = f"{n_bands}_{variant}"
            out["d1_us"][key], out["d1_threads"][key] = us, n
            line += f" {variant} {us:8.3f} µs/call{at.format(n)} "
        print(line.rstrip(), flush=True)
    rec = mb.member_rec().to(dev)
    for kind in mb.KINDS:
        n = threads or mb.full_wave(kind)
        x = mb.member_x(n).to(dev)
        ns = mb.per_call(lambda k: mb.member(rec, x, k, kind), mb.D2_K) * 1e9
        out["d2_ns"][kind], out["d2_threads"][kind] = ns, n
        print(f"{kind:16s} {ns:8.3f} ns/call{at.format(n)}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="raytracing_rust_tpu_torch.microbench")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--threads", type=int, default=mb.TILE,
                    help="threads a launch (a multiple of 32; default the "
                         "TPU tile's 8,192 lanes)")
    ap.add_argument("--full-wave", action="store_true",
                    help="on the card, launch each kernel with one full "
                         "wave of its threads instead of --threads")
    args = ap.parse_args(argv)
    if args.threads <= 0 or args.threads % 32:
        print(f"--threads {args.threads}: a positive multiple of 32",
              file=sys.stderr)
        return 2
    if args.device == "cpu":
        return 0 if _check_cpu(args.threads) else 1
    if not torch.cuda.is_available():
        print("microbench: device cuda requested, but "
              "torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    print(f"{torch.cuda.get_device_name(0)}; " + (
        "one full wave of each kernel" if args.full_wave
        else f"{args.threads} threads"), flush=True)
    run_card(None if args.full_wave else args.threads)
    return 0


if __name__ == "__main__":
    sys.exit(main())
