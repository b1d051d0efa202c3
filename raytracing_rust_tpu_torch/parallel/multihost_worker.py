"""A sharded training step in several processes: its worker, a launcher of
ranks, and a dry run on the CPU.

Counterpart of `tools/multihost_worker.py` (the worker) and
`__graft_entry__.dryrun_multichip` (`dryrun`). Each rank is one process of a
torch.distributed group (`sharding.init`, from the variables torchrun sets,
which `launch` sets the same way); the worker runs one `train_step_sharded`
on the JAX worker's problem (two_spheres 32×18, 64 pixels × 4 spp, depth 4,
a zero target, seed 3) over a (dp, sp) mesh and rank 0 writes the loss and
the gradient norms as JSON:

    python -m raytracing_rust_tpu_torch.parallel.multihost_worker OUT.json \\
        [--device cpu|cuda] [--dp N] [--sp N]

under `torchrun --nproc-per-node N`, or under `launch`. A rank ends through
`finish`.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

# the JAX worker's problem (tools/multihost_worker.py)
STEP_SCENE = "two_spheres"
STEP_NX, STEP_NY, STEP_SPP, STEP_DEPTH = 32, 18, 4, 4
STEP_PIXELS = 64
STEP_SEED = 3


def step_result(mesh, device) -> dict:
    """One `train_step_sharded` of the JAX worker's problem over mesh →
    dict(world, mesh, loss, g_tex, g_geom): the loss and the norms of the
    tex_color and prim_data gradients, the same on every rank."""
    from ..models.builders import PRESETS
    from .sharding import train_step_sharded

    preset = PRESETS[STEP_SCENE]
    scene, cam = preset.build(device=device), preset.camera(device=device)
    pix = torch.arange(STEP_PIXELS, dtype=torch.int64, device=device)
    target = torch.zeros((STEP_PIXELS, 3), dtype=torch.float32,
                         device=device)
    loss, g = train_step_sharded(scene, cam, pix, STEP_SEED, target,
                                 nx=STEP_NX, ny=STEP_NY, spp=STEP_SPP,
                                 max_depth=STEP_DEPTH, mesh=mesh,
                                 wrt=("tex_color", "prim_data"))
    return dict(world=mesh.dp * mesh.sp, mesh=[mesh.dp, mesh.sp],
                loss=loss.item(), g_tex=torch.linalg.norm(g["tex_color"])
                .item(), g_geom=torch.linalg.norm(g["prim_data"]).item())


def launch(n: int, argv: list[str], *, one_device: bool = False,
           timeout: float = 300.0) -> list[tuple[int, str]]:
    """Run `python argv…` as n ranks of one group on this host, with the
    variables torchrun sets (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
    MASTER_PORT; OMP_NUM_THREADS 1 unless set), and the package importable
    → [(exit code, output)] by rank. one_device: LOCAL_RANK 0 on every rank
    (ranks that share card 0 under gloo). Every rank is killed, and
    TimeoutError raised, when they have not all ended within timeout
    seconds.

    As torchrun's agent does, this process holds the group's TCPStore on a
    port the system picks, and the ranks join it as clients
    (TORCHELASTIC_USE_AGENT_STORE): the port is bound before any rank
    starts, so no other process can take it in between."""
    import torch.distributed as dist

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                          wait_for_workers=False)
    deadline = time.monotonic() + timeout
    with contextlib.ExitStack() as stack:
        # each rank writes to a file of its own: a rank blocked on a full
        # pipe while another waits for it in a collective would hang both
        logs = [stack.enter_context(tempfile.TemporaryFile("w+"))
                for _ in range(n)]
        procs = []
        for r in range(n):
            env = {"OMP_NUM_THREADS": "1",  # torchrun's default too
                   **os.environ, "RANK": str(r), "WORLD_SIZE": str(n),
                   "LOCAL_RANK": "0" if one_device else str(r),
                   "MASTER_ADDR": "127.0.0.1",
                   "MASTER_PORT": str(store.port),
                   "TORCHELASTIC_USE_AGENT_STORE": "True",
                   "TORCHELASTIC_RESTART_COUNT": "0",
                   "PYTHONPATH": os.pathsep.join(
                       [root] + [p for p in [os.environ.get("PYTHONPATH")]
                                 if p])}
            procs.append(subprocess.Popen([sys.executable, *argv], env=env,
                                          stdout=logs[r],
                                          stderr=subprocess.STDOUT))
        try:
            for p in procs:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            for p in procs:
                p.wait()
            raise TimeoutError(f"{n} ranks of {argv} ran past {timeout} s")
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read())
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def finish(rc: int):
    """End this process with exit code rc: `sys.exit`, but in a rank of a
    launched group (RANK set, as `launch` and torchrun set it) `os._exit`
    once Python's streams are flushed, which skips the interpreter's and
    libtorch's teardown. On a loaded CPU that teardown aborted a gloo rank
    now and then (SIGABRT, "terminate called without an active exception"
    from a static destructor, no Python frame on the stack), after the rank
    had destroyed its group and written its results: a failed run of work
    that had succeeded. A rank's files are closed before it returns."""
    if "RANK" not in os.environ:
        sys.exit(rc)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)


def dryrun(n: int, timeout: float = 300.0) -> dict:
    """One sharded training step in n gloo ranks on the CPU, on JAX's
    dryrun mesh (sp = 2 when n is even) → rank 0's `step_result`. Raises
    if a rank fails or the loss or a gradient norm is not finite."""
    sp = 2 if n % 2 == 0 else 1
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "result.json")
        runs = launch(n, ["-m", __name__, out, "--device", "cpu",
                          "--dp", str(n // sp), "--sp", str(sp)],
                      timeout=timeout)
        for r, (rc, text) in enumerate(runs):
            if rc != 0:
                raise RuntimeError(f"rank {r} exited {rc}:\n{text[-3000:]}")
        with open(out) as fh:
            res = json.load(fh)
    if not all(math.isfinite(res[k]) for k in ("loss", "g_tex", "g_geom")):
        raise RuntimeError(f"dryrun({n}): a value is not finite: {res}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m raytracing_rust_tpu_torch.parallel.multihost_worker",
        description="one sharded training step as a rank of torchrun's "
                    "group; rank 0 writes the loss and gradient norms")
    ap.add_argument("out", help="JSON path that rank 0 writes")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--dp", type=int, default=None)
    ap.add_argument("--sp", type=int, default=None)
    args = ap.parse_args(argv)

    from . import sharding
    with sharding.process_group(args.device) as dev:
        res = step_result(sharding.make_mesh(args.dp, args.sp), dev)
        if torch.distributed.get_rank() == 0:
            res["device"] = (torch.cuda.get_device_name(dev)
                             if dev.type == "cuda" else "cpu")
            with open(args.out, "w") as fh:
                json.dump(res, fh)
    return 0


if __name__ == "__main__":
    finish(main())
