"""The parity sweep (`raytracing_rust_tpu_torch.parity`) on the CPU, where K1
runs as its plain version: a run through `main` on cut-down configs, the
BVH one among them, writes tools/tpu_parity.py's record layout (with the
card's name) and passes; a general tier whose image is off by a factor, or
whose pixels are moved about with their mean kept, fails its check and
makes the process exit 1.

The configs are cut to 16×9 pixels × 16 spp at depth 4 so the file stays
within seconds; each config keeps its own tolerance (doubled by
`--quick`), and at this size the two seeds' means differ by an eighth
(random_spheres_bvh, 0.0073 of 0.06) and a tenth (two_spheres, 0.0038 of
0.04) of it. The sweep's real sizes run on the card (chip_smoke.py phase
54, `python -m raytracing_rust_tpu_torch.parity`).
"""

import json

import pytest

from raytracing_rust_tpu_torch import parity
from raytracing_rust_tpu_torch import render as trender
import torch_threads  # noqa: F401  (one torch thread a process)

SMALL = {
    "random_spheres_bvh": ("random_spheres", 16, 9, 16, 4, 0.03,
                           {"use_bvh": True}),
    "two_spheres": ("two_spheres", 16, 9, 16, 4, 0.02, {}),
}


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(parity, "CONFIGS", SMALL)


def test_sweep_writes_jax_record_layout(small, tmp_path):
    """`main` on both configs exits 0 and writes the JAX sweep's record: its
    top-level keys, one row per check in CONFIGS order with the JAX row's
    keys (pallas = K1, xla = the general tier) and the per-pixel gate's."""
    path = tmp_path / "parity.json"
    rc = parity.main(["--device", "cpu", "--quick", "--json", str(path),
                      "--only", *SMALL])
    art = json.loads(path.read_text())
    assert rc == 0, art
    assert {"pass", "failures", "quick", "spp_mult", "device", "card",
            "checks"} <= set(art)
    assert art["pass"] is True and art["failures"] == 0
    assert art["quick"] is True and art["device"] == "cpu"
    assert [c["check"] for c in art["checks"]] == list(SMALL)
    for row in art["checks"]:
        assert {"pass", "pallas_mean", "xla_mean", "rel", "tol", "nx", "ny",
                "spp", "depth", "pallas_s", "xla_s", "opts", "same_seed_mad",
                "mad_noise", "pixels_within", "pixels_ok"} <= set(row)
        assert row["pass"] is True and row["pixels_ok"] is True
        assert isinstance(row["spp"], float)  # JAX's rows hold floats
        assert row["same_seed_mad"] < parity.PIXEL_NOISE_SHARE * row[
            "mad_noise"]
    bvh = art["checks"][0]
    assert bvh["opts"] == {"use_bvh": True}
    assert bvh["tol"] == pytest.approx(0.06)  # --quick doubles it


@pytest.mark.parametrize("breakage", ["scaled", "shuffled"])
def test_broken_general_tier_fails(small, monkeypatch, capsys, breakage):
    """A general tier 10% dark fails the mean check; one whose pixels are
    flipped top to bottom (the same mean) fails the per-pixel check."""
    render = trender.render

    def broken(*a, **kw):
        img = render(*a, **kw)
        return 0.9 * img if breakage == "scaled" else img[::-1].copy()
    monkeypatch.setattr(trender, "render", broken)
    assert parity.main(["--device", "cpu", "--quick", "--only",
                        "two_spheres"]) == 1
    out = capsys.readouterr().out
    assert "two_spheres:" in out and "FAIL" in out and "PARITY FAIL (1)" in out
    row = parity.RESULTS[0]
    assert row["pass"] is False
    if breakage == "scaled":
        assert row["rel"] > row["tol"]
    else:
        assert row["rel"] < row["tol"] and row["pixels_ok"] is False


def test_cuda_without_cuda_raises():
    """The sweep runs on the card unless the CPU is asked for."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        parity.run(device="cuda", only=["two_spheres"])
