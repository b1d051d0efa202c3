"""The port's sharding (`raytracing_rust_tpu_torch/parallel/`) on gloo on
the CPU.

The sharded port is held against the one-rank port on the same seed and
draws: `render_sharded` against `render.render` (held to the JAX XLA tier
by tests/test_torch_general.py) and `train_step_sharded` against
`render.train_step` with u (held to jax.grad by
tests/test_torch_autograd.py:160). Those comparisons tie the sharded port
to JAX; `make_mesh`'s layouts are held to JAX's `make_mesh` directly.

In this process a one-rank gloo group on a FileStore: every result bit for
bit the one-process function's. Two ranks run once, as subprocesses of
this file (`launch`, the twin of tests/test_multihost.py's workers), on
meshes (2, 1) and (1, 2): a split of pixels is bit-equal to one rank; a
split of samples adds each pixel's two partial sums, so its f64 sums are
held within 1e-12 relative and its image within 1 f32 ulp; the sharded
step's loss within 1e-6 relative and each table's gradient within 1e-5 of
its largest |gradient| (a gradient scaled by the world size, or lanes
keyed by their position in a shard, misses both by far). Then two steps of
the trainer's multi-rank mode: the parameters equal on both ranks and to
the one-rank general tier's on the same draws.
"""

import os
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from raytracing_rust_tpu_torch import cli
from raytracing_rust_tpu_torch import inverse_render as ir
from raytracing_rust_tpu_torch import render
from raytracing_rust_tpu_torch.models.builders import PRESETS
from raytracing_rust_tpu_torch.ops.grad import fast_draws
from raytracing_rust_tpu_torch.parallel import multihost_worker, sharding
import torch_threads  # noqa: F401  (one torch thread a process)

# the render: two_spheres 32×18×8, depth 6
NX, NY, SPP, DEPTH = 32, 18, 8, 6
# the step: 64 pixels × 4 spp, depth 4, seed 3, two tables
STEP = dict(nx=NX, ny=NY, spp=4, max_depth=4, wrt=("tex_color", "prim_data"))
STEP_PIX, STEP_SEED = 64, 3
# the trainer: 2 steps of a 64-pixel block × 4 spp on a 24×24 image
TRAIN = dict(steps=2, nx=24, ny=24, spp=4, block=64, device="cpu")
MESHES = ((2, 1), (1, 2))


def _scene():
    p = PRESETS["two_spheres"]
    return p.build(device="cpu"), p.camera(device="cpu")


def _step_inputs(with_u: bool):
    pix = torch.arange(STEP_PIX, dtype=torch.int64)
    target = torch.full((STEP_PIX, 3), 0.1)
    u = (fast_draws(STEP_SEED, STEP_PIX * STEP["spp"], STEP["max_depth"] + 1)
         if with_u else None)
    return pix, target, u


def _cli_argv(out, *extra):
    return ["render", "--scene", "two_spheres", "--nx", str(NX), "--ny",
            str(NY), "--spp", str(SPP), "--max-depth", str(DEPTH), "--device",
            "cpu", "--out", str(out), *extra]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """A one-rank gloo group on a FileStore, for this module's in-process
    tests."""
    store = dist.FileStore(str(tmp_path_factory.mktemp("pg") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("n,dp,sp", [(1, None, None), (2, None, None),
                                     (8, None, None), (8, 2, 4), (8, None, 2),
                                     (8, 4, None), (4, 1, None), (6, 3, 2),
                                     (8, 3, None)])
def test_mesh_layout_is_jax_make_mesh(n, dp, sp):
    """mesh_shape's defaults and assert, and each rank's (dp, sp)
    coordinates, are those of JAX's make_mesh over the first n devices."""
    import jax
    from raytracing_rust_tpu.parallel.sharding import make_mesh as jax_mesh

    devs = jax.devices()[:n]
    try:
        want = jax_mesh(devs, dp=dp, sp=sp)
    except AssertionError as e:
        with pytest.raises(AssertionError, match=str(e)):
            sharding.mesh_shape(n, dp, sp)
        return
    got = sharding.mesh_shape(n, dp, sp)
    assert got == (want.shape["dp"], want.shape["sp"])
    for r in range(n):
        m = sharding.Mesh(*got, rank=r, dp_group=None, sp_group=None)
        assert want.devices[m.coords] == devs[r]


def test_make_mesh_over_one_rank(group):
    mesh = sharding.make_mesh()
    assert (mesh.shape, mesh.coords) == ({"dp": 1, "sp": 1}, (0, 0))
    # a layout's groups are made once in a process group
    again = sharding.make_mesh(dp=1)
    assert (again.dp_group, again.sp_group) == (mesh.dp_group, mesh.sp_group)
    assert (mesh.rows(10), mesh.samples(8)) == ((0, 10), (0, 8))
    with pytest.raises(AssertionError, match="mesh 2x0 != 1 devices"):
        sharding.make_mesh(dp=2)


@pytest.mark.parametrize("case", ["render", "train_step", "train_step_u",
                                  "train_step_local", "train_step_u_local"])
def test_one_rank_is_the_one_process_function(group, case):
    """One rank: render_sharded (and its sums) is render, train_step_sharded
    is train_step (with and without u), bit for bit; so is
    train_step_sharded with no mesh (`LOCAL`, no collective)."""
    scene, cam = _scene()
    mesh = None if case.endswith("local") else sharding.make_mesh()
    if case == "render":
        kw = dict(device="cpu", max_depth=DEPTH)
        assert torch.equal(
            sharding.render_sums_sharded(scene, cam, NX, NY, SPP, mesh, **kw),
            render.render_sums(scene, cam, NX, NY, SPP, **kw))
        np.testing.assert_array_equal(
            sharding.render_sharded(scene, cam, NX, NY, SPP, mesh, **kw),
            render.render(scene, cam, NX, NY, SPP, **kw))
        return
    pix, target, u = _step_inputs(case.startswith("train_step_u"))
    loss, g = sharding.train_step_sharded(scene, cam, pix, STEP_SEED, target,
                                          mesh=mesh, u=u, **STEP)
    want_loss, want = render.train_step(scene, cam, pix, STEP_SEED, target,
                                        u=u, **STEP)
    assert torch.equal(loss, want_loss)
    for k in STEP["wrt"]:
        assert torch.equal(g[k], want[k]), k
        assert g[k].abs().max() > 0, k


@pytest.mark.parametrize("local", [False, True], ids=["one_rank", "local"])
def test_render_block_one_rank_is_lane_radiance(group, local):
    """render_block_sharded over a one-rank mesh, or with no mesh, is
    lane_radiance of the block bit for bit."""
    scene, cam = _scene()
    pix, _, u = _step_inputs(True)
    kw = dict(nx=NX, ny=NY, spp=STEP["spp"], max_depth=STEP["max_depth"],
              u=u)
    got = sharding.render_block_sharded(
        scene, cam, pix, STEP_SEED, mesh=None if local else
        sharding.make_mesh(), **kw)
    assert torch.equal(got, render.lane_radiance(scene, cam, pix, STEP_SEED,
                                                 **kw))


def test_cli_sharded_one_rank_is_the_general_tier(group, tmp_path, capsys):
    assert cli.main(_cli_argv(tmp_path / "s.ppm", "--sharded")) == 0
    assert "sharded over dp=1 sp=1" in capsys.readouterr().out
    assert cli.main(_cli_argv(tmp_path / "g.ppm", "--engine", "xla")) == 0
    assert (tmp_path / "s.ppm").read_bytes() == (tmp_path / "g.ppm").read_bytes()


@pytest.mark.parametrize("extra", [["--checkpoint", "ck.npz"],
                                   ["--engine", "kernel"]])
def test_cli_sharded_refuses(tmp_path, capsys, extra):
    """--sharded is the general tier's path: it refuses a checkpoint and
    the kernel engine with one line and exit 2, as JAX's CLI does."""
    assert cli.main(_cli_argv(tmp_path / "x.ppm", "--sharded", *extra)) == 2
    err = capsys.readouterr().err.strip()
    assert len(err.splitlines()) == 1 and "--sharded" in err


def test_cli_sharded_cuda_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: this checks the refusal without it")
    argv = _cli_argv(tmp_path / "x.ppm", "--sharded")
    argv[argv.index("cpu")] = "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(argv)
    with pytest.raises(RuntimeError, match="cuda"):
        sharding.init("cuda")


def _ranks(out: str) -> None:
    """One rank of `two_ranks`: every sharded result on both meshes, the
    CLI (every rank on dp), and the trainer's multi-rank mode, saved to
    out/rank<r>.pt."""
    torch.set_num_threads(2)
    scene, cam = _scene()
    res = {}
    with sharding.process_group("cpu"):
        rank = dist.get_rank()
        for dp, sp in MESHES:
            mesh = sharding.make_mesh(dp, sp)
            tag = f"{dp}x{sp}"
            res[f"sums {tag}"] = sharding.render_sums_sharded(
                scene, cam, NX, NY, SPP, mesh, device="cpu", max_depth=DEPTH)
            img = sharding.render_sharded(scene, cam, NX, NY, SPP, mesh,
                                          device="cpu", max_depth=DEPTH)
            res[f"image {tag}"] = torch.from_numpy(
                np.zeros(0, np.float32) if img is None else img)
            for with_u in (False, True):
                pix, target, u = _step_inputs(with_u)
                loss, g = sharding.train_step_sharded(
                    scene, cam, pix, STEP_SEED, target, mesh=mesh, u=u,
                    **STEP)
                res[f"loss {tag} {with_u}"] = loss
                res.update({f"{k} {tag} {with_u}": v for k, v in g.items()})
        # empty shards: rank 1 holds no sample of a 1-spp render on (1, 2)
        # and no pixel of a 1-pixel step on (2, 1), and still reduces
        res["sums empty"] = sharding.render_sums_sharded(
            scene, cam, NX, NY, 1, sharding.make_mesh(1, 2), device="cpu",
            max_depth=DEPTH)
        pix, target, u = _step_inputs(True)
        loss, g = sharding.train_step_sharded(
            scene, cam, pix[:1], STEP_SEED, target[:1],
            mesh=sharding.make_mesh(2, 1), u=u[:, :, :STEP["spp"]], **STEP)
        res["loss empty"] = loss
        res.update({f"{k} empty": v for k, v in g.items()})
        assert cli.main(_cli_argv(os.path.join(out, "cli.ppm"),
                                  "--sharded")) == 0
        # the trainer's main in its multi-rank mode, then its train on the
        # mesh main makes (sp = 2 on two ranks), for the parameters
        assert ir.main(["--device", "cpu", "--steps", "2", "--nx", "24",
                        "--ny", "24", "--block", "64", "--spp", "4"]) in (0, 1)
        r = ir.train(mesh=sharding.make_mesh(1, 2), log=lambda *a: None,
                     **TRAIN)
        res["albedo"] = torch.from_numpy(r["albedo"])
        res["emit"] = torch.tensor(r["emit"])
        res["tier"] = r["tier"]
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """`_ranks` in two gloo ranks on the CPU → (each rank's results, the
    outputs, the directory)."""
    out = tmp_path_factory.mktemp("ranks")
    runs = multihost_worker.launch(2, [os.path.abspath(__file__), str(out)],
                                   timeout=240)
    for r, (rc, text) in enumerate(runs):
        assert rc == 0, f"rank {r} exited {rc}:\n{text[-3000:]}"
    return ([torch.load(out / f"rank{r}.pt") for r in range(2)],
            [text for _, text in runs], out)


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_two_ranks_render(two_ranks, mesh):
    """render_sums_sharded on both ranks against one rank's render_sums;
    rank 0's image against render's."""
    res, _, _ = two_ranks
    tag = f"{mesh[0]}x{mesh[1]}"
    scene, cam = _scene()
    want = render.render_sums(scene, cam, NX, NY, SPP, device="cpu",
                              max_depth=DEPTH)
    img = render.finalize_image(want.T.numpy(), SPP, NX, NY)
    assert torch.equal(res[0][f"sums {tag}"], res[1][f"sums {tag}"])
    got = res[0][f"sums {tag}"]
    got_img = res[0][f"image {tag}"].numpy()
    if mesh[1] == 1:
        assert torch.equal(got, want)
        np.testing.assert_array_equal(got_img, img)
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                                   atol=0.0)
        assert _ulps(got_img, img) <= 1
    assert res[1][f"image {tag}"].numel() == 0


@pytest.mark.parametrize("with_u", [False, True], ids=["lane_draws", "u"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_two_ranks_train_step(two_ranks, mesh, with_u):
    """train_step_sharded on both ranks (equal) against one rank's
    train_step on the same seed and draws."""
    res, _, _ = two_ranks
    tag = f"{mesh[0]}x{mesh[1]} {with_u}"
    scene, cam = _scene()
    pix, target, u = _step_inputs(with_u)
    want_loss, want = render.train_step(scene, cam, pix, STEP_SEED, target,
                                        u=u, **STEP)
    assert torch.equal(res[0][f"loss {tag}"], res[1][f"loss {tag}"])
    np.testing.assert_allclose(res[0][f"loss {tag}"].item(), want_loss.item(),
                               rtol=1e-6)
    for k in STEP["wrt"]:
        assert torch.equal(res[0][f"{k} {tag}"], res[1][f"{k} {tag}"]), k
        scale = want[k].abs().max().item()
        assert scale > 0, k
        err = (res[0][f"{k} {tag}"] - want[k]).abs().max().item()
        assert err <= 1e-5 * scale, (k, err, scale)


def test_two_ranks_empty_shards(two_ranks):
    """A rank with no samples (1 spp over sp = 2) or no pixels (1 pixel
    over dp = 2) calls the same collectives: its zeros leave one rank's
    sums and step bit for bit."""
    res, _, _ = two_ranks
    scene, cam = _scene()
    assert torch.equal(res[0]["sums empty"], render.render_sums(
        scene, cam, NX, NY, 1, device="cpu", max_depth=DEPTH))
    pix, target, u = _step_inputs(True)
    want_loss, want = render.train_step(scene, cam, pix[:1], STEP_SEED,
                                        target[:1], u=u[:, :, :STEP["spp"]],
                                        **STEP)
    assert torch.equal(res[0]["loss empty"], want_loss)
    for k in STEP["wrt"]:
        assert torch.equal(res[0][f"{k} empty"], want[k]), k
        assert torch.equal(res[1][f"{k} empty"], want[k]), k


def test_two_ranks_cli(two_ranks, tmp_path):
    """`render --sharded` in two ranks (dp = 2): rank 0's image is the
    general tier's, byte for byte, and rank 0 alone prints."""
    _, texts, out = two_ranks
    assert cli.main(_cli_argv(tmp_path / "g.ppm", "--engine", "xla")) == 0
    assert (out / "cli.ppm").read_bytes() == (tmp_path / "g.ppm").read_bytes()
    assert "sharded over dp=2 sp=1" in texts[0]
    assert "primary rays/s" not in texts[1]


def test_two_ranks_trainer(two_ranks):
    """The trainer's multi-rank mode: main printed the sharded tier on rank
    0 alone; two steps of train on the (1, 2) mesh leave the parameters
    equal on both ranks and within 1e-6 of one rank's general tier on the
    same draws (`--no-fast`)."""
    res, texts, _ = two_ranks
    assert "sharded over dp=1 sp=2 ranks" in texts[0]
    assert "recovered albedo" in texts[0] and "recovered" not in texts[1]
    assert res[0]["tier"] == res[1]["tier"] == "general"
    for k in ("albedo", "emit"):
        assert torch.equal(res[0][k], res[1][k]), k
    want = ir.train(fast=False, log=lambda *a: None, **TRAIN)
    np.testing.assert_allclose(res[0]["albedo"].numpy(), want["albedo"],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(res[0]["emit"].item(), want["emit"], rtol=0,
                               atol=1e-6)
    assert not np.allclose(want["albedo"], ir.START_ALBEDO)


@pytest.mark.parametrize("rank", [None, "1"], ids=["alone", "rank"])
def test_finish_ends_with_the_code(rank):
    """`multihost_worker.finish` ends a process with the code it is given:
    in a rank of a launched group (RANK set) by os._exit, its output
    flushed first, which skips the interpreter's teardown (an atexit hook
    does not run); elsewhere by sys.exit, which runs it."""
    import subprocess
    env = {k: v for k, v in os.environ.items() if k != "RANK"}
    if rank is not None:
        env["RANK"] = rank
    code = ("import atexit, sys\n"
            "from raytracing_rust_tpu_torch.parallel import multihost_worker\n"
            "atexit.register(lambda: print('teardown', flush=True))\n"
            "sys.stdout.write('done')\n"
            "multihost_worker.finish(3)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 3, res.stderr
    assert res.stdout.startswith("done")
    assert ("teardown" in res.stdout) == (rank is None)


def test_dryrun_matches_one_rank(group):
    """dryrun(2): the port's multihost worker in two gloo ranks (mesh (1,
    2), as JAX's dryrun lays two devices) against the same step on one
    rank."""
    got = multihost_worker.dryrun(2, timeout=240)
    want = multihost_worker.step_result(sharding.make_mesh(), "cpu")
    assert (got["world"], got["mesh"], got["device"]) == (2, [1, 2], "cpu")
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
    np.testing.assert_allclose(got["g_tex"], want["g_tex"], rtol=1e-5)
    np.testing.assert_allclose(got["g_geom"], want["g_geom"], rtol=1e-5)


if __name__ == "__main__":
    _ranks(sys.argv[1])
    multihost_worker.finish(0)
