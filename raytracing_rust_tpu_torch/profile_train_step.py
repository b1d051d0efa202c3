"""Where one training step of the default inverse render spends its time.

Counterpart of `tools/profile_train_step.py`: the step of
`inverse_render.train` (200×200, a block of 4,096 pixels × 64 spp a step,
depth 6: the path-matched loss, then Adam with its cosine decay and
clamps) split into its parts, on both differentiable tiers. The parts
come from split steps: the trainer's own step (`inverse_render.update` on
`default_run`'s step) with a `mark` hook that the step calls where each
part ends, which synchronizes the device and reads the host clock. Whole
steps (the same call without the hook), each timed from a synchronized
device to a synchronized device, alternate with the split ones, N of
each in each of 5 rounds after one warm step; each figure is its median
over the rounds, per step, and each part is also given as a share of the
whole step. The split steps' syncs take away what the card overlaps with
the host inside a whole step, so the parts' sum exceeds the step by that
overlap.

The fused tier (K2/K3, their plain torch twin on the CPU):
  step_inputs   the gradients zeroed and `step_inputs`: the randperm,
                the camera rays, the Philox `fast_draws`;
  fwd_bwd       the loss and its backward on those inputs
                (`path_matched_loss` + `backward`), of which
    records     `fast_grad_record` of the target and of the candidate
                (the candidate's through `with_params`), a loop of its
                own in the rounds,
    kernels     K2 ×2 (the target without a tape, the candidate with one)
                and K3, by CUDA events over bare launches on the step's
                operands (`grad.bare_launches`); on the CPU the plain
                twin's `grad_fwd` ×2 and `grad_bwd` on the host clock,
    glue        fwd_bwd − records − kernels: the loss, autograd's
                bookkeeping, the launches' host side;
  adam          the optimizer's step, the schedule's and the clamps;
  step          the whole step.
The general tier (`--no-fast`: autograd through checkpointed bounces):
  pixels        the gradients zeroed and `step_pixels`;
  target        the step's `fast_draws` and the target block through
                `render_block_sharded` without gradient;
  fwd_bwd       `train_step_sharded` of the candidate with the chain back
                onto the parameters;
  fwd           the candidate's differentiable forward and loss alone,
                a loop of its own in the rounds;
  adam, step    as above.
The parts that partition a step (fused: step_inputs, fwd_bwd, adam;
general: pixels, target, fwd_bwd, adam) add up to `parts_sum`, which is
held beside the whole step (`parts_over_step`).

    python -m raytracing_rust_tpu_torch.profile_train_step [--steps 8]
        [--block 4096] [--spp 64] [--depth 6] [--nx 200 --ny 200]
        [--device cuda|cpu] [--tier both|fused|general] [--trace DIR]

--trace DIR also writes a torch.profiler Chrome trace of 3 whole steps of
the tier, DIR/train_step_<tier>.trace.json; it takes one tier (--tier
fused or general), since torch.profiler has recorded the card's activity
in a process's first profiler session alone. Prints a table a tier, then
one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

from .benchlib import sync

WINDOWS = 5
FUSED_PARTS = ("step_inputs", "fwd_bwd", "adam")
GENERAL_PARTS = ("pixels", "target", "fwd_bwd", "adam")


def timed(loops: dict, whole, split, n: int, device) -> tuple[dict, dict]:
    """The loops {name: fn(i)}, the whole step whole(i) and the split step
    split(i) → {part: seconds} in WINDOWS rounds after one warm call of
    each: in a round each loop runs n calls from a synchronized device to a
    synchronized device, then n steps alternate a whole step, timed from a
    synchronized device to a synchronized device, and a split one. →
    ({name: seconds a call, "step": seconds a whole step}, {part: seconds
    a step}), each the median over the rounds. Loops and steps take turns,
    so a drift of the machine's speed reaches all alike."""
    for fn in (*loops.values(), whole, split):
        fn(0)
    walls = {name: [] for name in (*loops, "step")}
    split_walls: dict = {}
    for w in range(WINDOWS):
        for name, fn in loops.items():
            sync(device)
            t0 = time.perf_counter()
            for i in range(n):
                fn(1 + w * n + i)
            sync(device)
            walls[name].append((time.perf_counter() - t0) / n)
        acc: dict = {"step": 0.0}
        for i in range(1 + w * n, 1 + (w + 1) * n):
            sync(device)
            t0 = time.perf_counter()
            whole(i)
            sync(device)
            acc["step"] += time.perf_counter() - t0
            for part, sec in split(i).items():
                acc[part] = acc.get(part, 0.0) + sec
        walls["step"].append(acc.pop("step") / n)
        for part, sec in acc.items():
            split_walls.setdefault(part, []).append(sec / n)
    return ({name: statistics.median(v) for name, v in walls.items()},
            {part: statistics.median(v) for part, v in split_walls.items()})


class Marks:
    """A step's `mark` hook: mark(part) synchronizes the device and adds
    the host seconds since the last mark (or since it was made) to
    parts[part]."""

    def __init__(self, device):
        self.device = device
        self.parts: dict = {}
        sync(device)
        self.t = time.perf_counter()

    def __call__(self, part: str) -> None:
        sync(self.device)
        now = time.perf_counter()
        self.parts[part] = self.parts.get(part, 0.0) + now - self.t
        self.t = now


def kernel_seconds(rec_t, rec_c, o, d, u, cfg, max_depth: int, n: int,
                   device) -> float:
    """Seconds a step of K2 ×2 (the target's, the candidate's with its
    tape) and K3: by CUDA events over n rounds of bare launches on the
    card (after one warm round), on the CPU the plain twin over n rounds
    on the host clock (after one warm round)."""
    from .ops import grad

    rec_t, rec_c = rec_t.detach().contiguous(), rec_c.detach().contiguous()
    ct = torch.full_like(o, 1.0 / o.numel())
    if device.type != "cuda":
        def twin(i):
            grad.grad_fwd(rec_t, o, d, u, cfg, max_depth)
            _, tape = grad.grad_fwd(rec_c, o, d, u, cfg, max_depth,
                                    tape=True)
            grad.grad_bwd(rec_c, o, d, u, ct, cfg, max_depth, tape=tape)
        twin(0)
        t0 = time.perf_counter()
        for i in range(n):
            twin(i)
        return (time.perf_counter() - t0) / n
    fwd_t, _, _ = grad.bare_launches(rec_t, o, d, u, ct, cfg, max_depth)
    _, fwd_tape, bwd = grad.bare_launches(rec_c, o, d, u, ct, cfg,
                                          max_depth)

    def launches():
        fwd_t()
        fwd_tape()
        bwd()

    launches()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        launches()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) * 1e-3 / n


def profile(tier: str = "fused", *, steps: int = 8, nx: int = 200,
            ny: int = 200, block: int = 4096, spp: int = 64,
            max_depth: int = 6, device="cuda") -> dict:
    """One tier's parts → {tier, tier_line, parts: {name: seconds a step},
    step, parts_sum, parts_over_step, shares: {name: part / step}} (see
    the module's docstring)."""
    from . import inverse_render as ir
    from .ops import grad
    from .render import lane_radiance

    device = ir._check_device(device)
    run = ir.default_run(nx=nx, ny=ny, spp=spp, block=block,
                         max_depth=max_depth, device=device,
                         fast=tier == "fused")
    if run.tier != tier:
        raise ValueError(f"the {tier} tier does not take the step: "
                         f"{run.tier_line}")
    opt, sched = ir.optimizer(run.groups, 1000)
    kw = dict(nx=nx, ny=ny, spp=spp, max_depth=max_depth)

    def whole(i):
        ir.update(opt, sched, run.groups, run.step, i)

    def split(i):
        marks = Marks(device)
        ir.update(opt, sched, run.groups, run.step, i, mark=marks)
        return marks.parts

    def candidate():
        return ir.with_params(run.scene, run.light_tex, run.box_tex,
                              run.albedo, run.emit)

    if tier == "fused":
        def records(i):
            grad.fast_grad_record(run.target_scene)
            grad.fast_grad_record(candidate())

        loops = {"records": records}
        o, d, u = ir.step_inputs(run.cam, 0, block=block, device=device,
                                 **kw)
        kernels = kernel_seconds(
            grad.fast_grad_record(run.target_scene),
            grad.fast_grad_record(candidate()), o, d, u, run.cfg, max_depth,
            steps, device)
        summed = FUSED_PARTS
    else:
        pix = ir.step_pixels(0, nx=nx, ny=ny, block=block, device=device)
        u = grad.fast_draws(0, block * spp, max_depth + 1, device)
        with torch.no_grad():
            tgt = lane_radiance(run.target_scene, run.cam, pix, 0, nx, ny,
                                spp, max_depth, u=u) / spp

        def fwd(i):
            with torch.enable_grad():
                img = lane_radiance(candidate(), run.cam, pix, 0, nx, ny,
                                    spp, max_depth, differentiable=True,
                                    u=u) / spp
                torch.mean((img - tgt) ** 2)

        loops = {"fwd": fwd}
        summed = GENERAL_PARTS
    alone, parts = timed(loops, whole, split, steps, device)
    step = alone.pop("step")
    if tier == "fused":
        parts["records"] = alone["records"]
        parts["kernels"] = kernels
        parts["glue"] = parts["fwd_bwd"] - parts["records"] - kernels
    else:
        parts["fwd"] = alone["fwd"]
    parts_sum = sum(parts[k] for k in summed)
    return dict(tier=tier, tier_line=run.tier_line, steps=steps,
                parts=parts, summed=list(summed), step=step,
                parts_sum=parts_sum, parts_over_step=parts_sum / step,
                shares={k: v / step for k, v in parts.items()})


def trace_steps(tier: str, trace_dir: str, *, steps: int = 3, device,
                **kw) -> str:
    """A torch.profiler Chrome trace of `steps` whole steps of tier (after
    one warm step) → its path, trace_dir/train_step_<tier>.trace.json."""
    from . import inverse_render as ir
    from .cli import profiled

    run = ir.default_run(device=device, fast=tier == "fused", **kw)
    opt, sched = ir.optimizer(run.groups, 1000)
    ir.update(opt, sched, run.groups, run.step, 0)
    name = f"train_step_{tier}"
    with profiled(trace_dir, name, device):
        for i in range(steps):
            ir.update(opt, sched, run.groups, run.step, 1 + i)
        sync(torch.device(device))
    return os.path.join(trace_dir, f"{name}.trace.json")


def table(res: dict) -> str:
    lines = [f"{res['tier']} tier ({res['tier_line']}), "
             f"{res['steps']} steps a loop:"]
    for k, v in res["parts"].items():
        mark = "" if k in res["summed"] else "  (within fwd_bwd)" \
            if k in ("records", "kernels", "glue") else "  (not summed)"
        lines.append(f"  {k:<14s} {v * 1e3:10.3f} ms/step "
                     f"{100 * res['shares'][k]:6.1f}%{mark}")
    lines.append(f"  {'step':<14s} {res['step'] * 1e3:10.3f} ms/step "
                 f"(parts summed {res['parts_sum'] * 1e3:.3f}: "
                 f"{res['parts_over_step']:.3f}× the step)")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m raytracing_rust_tpu_torch.profile_train_step",
        description="split the inverse render's training step into its "
                    "parts on both tiers")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--block", type=int, default=4096)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--nx", type=int, default=200)
    ap.add_argument("--ny", type=int, default=200)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--tier", choices=["both", "fused", "general"],
                    default="both")
    ap.add_argument("--trace", default=None, metavar="DIR")
    args = ap.parse_args(argv)
    if args.trace and args.tier == "both":
        ap.error("--trace takes one tier (--tier fused or --tier general): "
                 "torch.profiler has recorded the card's activity in a "
                 "process's first profiler session alone")
    kw = dict(nx=args.nx, ny=args.ny, block=args.block, spp=args.spp,
              max_depth=args.depth, device=args.device)
    tiers = ["fused", "general"] if args.tier == "both" else [args.tier]
    out = {"device": args.device, "tiers": {}}
    for tier in tiers:
        res = profile(tier, steps=args.steps, **kw)
        print(table(res), flush=True)
        if args.trace:
            res["trace"] = trace_steps(tier, args.trace, **kw)
        out["tiers"][tier] = res
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
