"""D1 and D2's plain versions (the port's `ops/microbench.py`) against the
JAX package's building blocks, on the CPU, on the JAX tool's seeded inputs.

The kernels themselves run only on a CUDA card (tests/test_torch_kernel.py
and chip_smoke.py hold them against these plain versions there). Here:

* D1: the words the port's winner-row read takes at each lane equal what
  `pallas_tracer._attr_gather` gathers (interpret mode) at the same
  columns, bitcast back to int32, exactly; the port's f32 accumulator is
  the exact sum of those words (denormals, whose partial sums are integer
  multiples of 2⁻¹⁴⁹), and a test records that JAX's own accumulator is
  0.0 on the CPU because XLA flushes denormals, so the port must not be
  "fixed" toward it.
* D2: the sphere and box outputs equal the JAX tool's bodies, copied into
  a test-local interpret-mode `pallas_call` (tools/microbench.py keeps its
  factories inside `main`), bit for bit; the OR over a tile's warps of the
  port's per-warp words and votes equals `pallas_tracer._or_reduce` and
  `jnp.any` of the tile, exactly.

Every comparison is exact (bit-equal): the same f32 operations in the
same order, no reduction whose order could differ. The one stated
tolerance is XLA's own: compiled, it contracts a·b + c into fused
multiply-adds, so the D2 bodies are held bit for bit run op by op, and
within 1 ulp in the tool's interpret-mode `pallas_call`
(`test_d2_member_tests_match_jax`).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
from raytracing_rust_tpu.ops import pallas_tracer as pt
from raytracing_rust_tpu_torch import microbench
from raytracing_rust_tpu_torch.ops import microbench as mb
import torch_threads  # noqa: F401  (one torch thread a process)

S, L = mb.SUB, mb.LANES
f = jnp.float32


def _tool_attr():
    """tools/microbench.py:52-55: the table, seed 0."""
    return np.random.default_rng(0).integers(
        0, 2 ** 20, (pt.ATTR_ROWS, 1408 + (-1408) % 128), dtype=np.int32)


def test_seeded_inputs_are_the_tools():
    attr = _tool_attr()
    for n_bands in mb.BANDS:
        assert np.array_equal(mb.attr_table(n_bands).numpy(),
                              attr[:8 * n_bands].T)
    col = np.random.default_rng(1).integers(0, 1400, (S, L), dtype=np.int32)
    assert np.array_equal(mb.attr_cols().numpy(), col.ravel())
    assert np.array_equal(mb.attr_cols(3 * mb.TILE).numpy(),
                          np.tile(col.ravel(), 3))
    assert mb.REC == pt.REC
    assert np.array_equal(mb.member_rec().numpy(), _tool_rec())
    x = np.random.default_rng(3).integers(0, 997, (S, L), dtype=np.int32)
    assert np.array_equal(mb.member_x().numpy(), x.ravel())


def test_d1_words_match_jax_attr_gather():
    """The words iteration i reads, row (col + i) mod 1400, equal the fields
    `_attr_gather` gathers at those columns (4 bands, col (8, 256): its
    widths follow col's shape), bitcast back to int32, exactly."""
    i, n_bands, width = 7, 4, 256
    attr = _tool_attr()
    col = np.random.default_rng(1).integers(
        0, 1400, (S, L), dtype=np.int32)[:, :width]

    def kernel(a_ref, c_ref, w_ref):
        fields = pt._attr_gather(a_ref, (c_ref[...] + i) % 1400, n_bands)
        for j, x in enumerate(fields):
            w_ref[j] = jax.lax.bitcast_convert_type(x, jnp.int32)

    words = np.asarray(pl.pallas_call(
        kernel, in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((8 * n_bands, S, width), jnp.int32),
        interpret=True)(attr, col))
    got = mb.attr_rows_plain(mb.attr_table(n_bands),
                             torch.from_numpy(col.ravel()), i)
    assert np.array_equal(got.numpy().T.reshape(8 * n_bands, S, width),
                          words)


@pytest.mark.parametrize("n_bands", mb.BANDS)
@pytest.mark.parametrize("k", [2, 16])
def test_d1_accumulator_is_the_exact_sum(n_bands, k):
    """attr_read_plain's f32 accumulator is exact: every word is below 2²⁰,
    so as an f32 it is the denormal word · 2⁻¹⁴⁹, and k ≤ 16 partial sums
    stay below 2²⁴ · 2⁻¹⁴⁹, where an f32's bit pattern is the integer sum
    of the words itself. The checksum is the xor of every word read."""
    table = mb.attr_table(n_bands)
    col = mb.attr_cols(1024)
    acc, ck = mb.attr_read(table, col, k)
    assert acc.dtype == torch.float32 and ck.dtype == torch.int32
    t, c = table.numpy().astype(np.int64), col.numpy().astype(np.int64)
    rows = [(c + i) % 1400 for i in range(k)]
    want = sum(t[r, 0] for r in rows)
    assert want.max() < 2 ** 24
    assert np.array_equal(acc.view(torch.int32).numpy(), want)
    assert (acc > 0).all()
    xor = np.zeros(c.shape, np.int64)
    for r in rows:
        xor ^= np.bitwise_xor.reduce(t[r], axis=1)
    assert np.array_equal(ck.numpy(), xor.astype(np.int32))


def test_jax_d1_output_is_zero_because_xla_flushes_denormals():
    """The JAX tool's D1 output on this CPU: its accumulation, `acc + fl[0]`
    over a fori loop from zeros, of the same words bitcast to f32 gives 0.0
    in every lane, because XLA on a CPU flushes f32 denormals (the TPU has
    none). torch keeps them, as the card does, so the port's accumulator is
    the exact nonzero sum and is never held against JAX's."""
    k = 2
    table, col = mb.attr_table(4), mb.attr_cols(1024)
    words = np.stack([mb.attr_rows_plain(table, col, i)[:, 0].numpy()
                      for i in range(k)])

    @jax.jit
    def jax_acc(w):
        return jax.lax.fori_loop(
            0, k, lambda i, acc: acc + jax.lax.bitcast_convert_type(
                w[i], jnp.float32), jnp.zeros(w.shape[1], f))

    assert not np.asarray(jax_acc(words)).any()
    acc, _ = mb.attr_read(table, col, k)
    assert (acc > 0).all()


def _member_body(kind, k, x, r):
    """The JAX tool's member kernel body (tools/microbench.py:94-151) for
    sphere or box on the (8, 1024) lanes x, record cell (p, i) read by
    r(p, i) → t_b + wi."""
    xf = x.astype(f) * f(1e-3)
    ox = oy = oz = xf
    dx, dy, dz = xf + f(0.1), xf + f(0.2), xf + f(0.3)
    a_dd = dx * dx + dy * dy + dz * dz
    inv_a = f(1.0) / a_dd

    def body(p, st):
        t_b, wi = st
        if kind == "sphere":
            ocx, ocy, ocz = ox - r(p, 0), oy - r(p, 1), oz - r(p, 2)
            bq = ocx * dx + ocy * dy + ocz * dz
            cq = (ocx * ocx + ocy * ocy + ocz * ocz - r(p, 3))
            disc = bq * bq - a_dd * cq
            pos = disc > f(0.0)
            sq = jnp.sqrt(jnp.where(pos, disc, f(1.0)))
            t_near = (-bq - sq) * inv_a
            t_far = (-bq + sq) * inv_a
            t_sel = jnp.where(t_near > f(1e-3), t_near, t_far)
            ok = pos & (t_sel > f(1e-3)) & (t_sel < t_b)
        else:
            def si(dc):
                return jnp.where(jnp.abs(dc) < f(1e-30), f(1e30),
                                 f(1.0) / dc)

            ix, iy, iz = si(dx), si(dy), si(dz)
            t0 = (r(p, 0) - ox) * ix
            t1 = (r(p, 3) - ox) * ix
            tmn = jnp.minimum(t0, t1)
            tmx = jnp.maximum(t0, t1)
            t0 = (r(p, 1) - oy) * iy
            t1 = (r(p, 4) - oy) * iy
            tmn = jnp.maximum(tmn, jnp.minimum(t0, t1))
            tmx = jnp.minimum(tmx, jnp.maximum(t0, t1))
            t0 = (r(p, 2) - oz) * iz
            t1 = (r(p, 5) - oz) * iz
            tmn = jnp.maximum(tmn, jnp.minimum(t0, t1))
            tmx = jnp.minimum(tmx, jnp.maximum(t0, t1))
            t_sel = jnp.where(tmn > f(1e-3), tmn, tmx)
            ok = (tmx > tmn) & (t_sel > f(1e-3)) & (t_sel < t_b)
        return (jnp.where(ok, t_sel, t_b),
                jnp.where(ok, jnp.asarray(p).astype(f), wi))

    t_b = jnp.full((S, L), f(3e38))
    wi = jnp.zeros((S, L), f)
    t_b, wi = jax.lax.fori_loop(0, k, body, (t_b, wi))
    return t_b + wi


def _tool_rec():
    """tools/microbench.py:82-83: the records, seed 2."""
    return np.random.default_rng(2).uniform(-1, 1, (64, pt.REC)) \
        .astype(np.float32)


def _member_pallas(kind, k, x):
    """The body in the tool's `pallas_call` (records in SMEM), interpret
    mode."""
    def kernel(rec_ref, x_ref, out_ref):
        out_ref[...] = _member_body(kind, k, x_ref[...],
                                    lambda p, i: rec_ref[p % 64, i])

    return np.asarray(pl.pallas_call(
        kernel, in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                          pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((S, L), jnp.float32),
        interpret=True)(_tool_rec(), x))


def _member_op_by_op(kind, k, x):
    """The body run op by op (`jax.disable_jit`): each JAX operation is its
    own computation and rounds on its own."""
    rec = jnp.asarray(_tool_rec())
    with jax.disable_jit():
        return np.asarray(_member_body(kind, k, jnp.asarray(x),
                                       lambda p, i: rec[p % 64, i]))


def _signed_x():
    return np.random.default_rng(5).integers(-3000, 1000, (S, L),
                                             dtype=np.int32)


def _sparse_x():
    """Every lane far below zero but a few, in a few warps."""
    x = np.full((S, L), -2000, np.int32)
    x.ravel()[[40, 45, 1000, 5000, 8191]] = [600, 3, 900, 1, 400]
    return x


INPUTS = {"tool": lambda: mb.member_x().numpy().reshape(S, L),
          "signed": _signed_x, "sparse": _sparse_x}


@pytest.mark.parametrize("kind", ["sphere", "box"])
@pytest.mark.parametrize("x_name", ["tool", "signed"])
def test_d2_member_tests_match_jax(kind, x_name):
    """member_plain's t_b + wi equals the JAX tool's body on the same
    records and lanes, k = 70 (past the 64 records, so rows repeat), bit
    for bit with the body run op by op; the fold is 0 for the member tests.

    Op by op, every JAX operation rounds on its own, as the port's and the
    card's (built with -fmad=false) do. Compiled, as the tool's
    interpret-mode `pallas_call` is, XLA:CPU fuses the body's elementwise
    loops and LLVM contracts a·b + c into one fused multiply-add (x·10⁻³ +
    0.1, o − r, the sphere's dot products and discriminant): that moves up
    to 2% of the lanes by 1 ulp here, the stated tolerance of that
    comparison."""
    k, x = 70, INPUTS[x_name]()
    want = _member_op_by_op(kind, k, x)
    got, fold = mb.member(mb.member_rec(), torch.from_numpy(x.ravel()), k,
                          kind)
    got = got.numpy().reshape(S, L)
    assert np.array_equal(got, want)
    assert (want < 3e38).any() and (want == 3e38).sum() < want.size
    assert not fold.any()
    fused = _member_pallas(kind, k, x)
    ulp = np.abs(got.view(np.int32).astype(np.int64) - fused.view(np.int32))
    assert ulp.max() <= 1 and (ulp > 0).mean() < 0.02


def _votes_jax(x, k):
    """Per iteration q < k: jnp.any of the tool's `any` mask and
    `_or_reduce` of its `or_tree` mask over the (8, 1024) tile, in
    interpret mode → (int32[k], int32[k])."""
    def kernel(x_ref, any_ref, or_ref):
        xf = x_ref[...].astype(f) * f(1e-3)
        for q in range(k):
            any_ref[q] = jnp.any((xf + f(q)) > f(0.5)).astype(jnp.int32)
            or_ref[q] = pt._or_reduce(
                (xf > f(0.0)).astype(jnp.int32) << (q % 31))

    out = pl.pallas_call(
        kernel, in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)] * 2,
        out_shape=[jax.ShapeDtypeStruct((k,), jnp.int32)] * 2,
        interpret=True)(x)
    return [np.asarray(a) for a in out]


@pytest.mark.parametrize("x_name", ["tool", "signed", "sparse"])
def test_d2_warp_votes_match_jax_tile_reduces(x_name):
    """The port's votes are per warp; a tile's answer is the OR of its
    warps'. Iteration by iteration (the fold of k + 1 iterations less that
    of k for `any`; bit q of the fold, k ≤ 31, for `or_tree`), the OR over
    the tile's warps equals jnp.any and `_or_reduce` of the tile, and each
    warp's answer equals numpy's over its 32 lanes, exactly."""
    k = 5
    x = INPUTS[x_name]()
    any_j, or_j = _votes_jax(x, k)
    xt, rec = torch.from_numpy(x.ravel()), mb.member_rec()
    xf = (x.ravel().astype(np.float32) * np.float32(1e-3)).reshape(-1, 32)
    counts = [mb.member(rec, xt, q, "any")[1].numpy() for q in range(k + 1)]
    words = mb.member(rec, xt, k, "or_tree")[1].numpy()
    out, _ = mb.member(rec, xt, k, "any")
    assert (out == np.float32(3e38)).all()
    for q in range(k):
        vote = counts[q + 1] - counts[q]
        assert np.array_equal(vote.reshape(-1, 32)[:, 0],
                              (xf + np.float32(q) > 0.5).any(axis=1))
        assert int(np.bitwise_or.reduce(vote)) == any_j[q]
        word = words & (1 << q)
        assert np.array_equal(
            word.reshape(-1, 32)[:, 0],
            np.bitwise_or.reduce(((xf > 0) << q).astype(np.int32), axis=1))
        assert int(np.bitwise_or.reduce(word)) == or_j[q]
    if x_name == "sparse":
        assert any_j[0] == 1 and or_j[0] == 1
        assert (counts[1].reshape(-1, 32)[:, 0] == 0).mean() > 0.9


def test_wrappers_raise_on_bad_arguments():
    table, col = mb.attr_table(2), mb.attr_cols(64)
    for bad in (dict(table=table.float()), dict(table=table[:1400]),
                dict(table=torch.zeros((1536, 24), dtype=torch.int32)),
                dict(table=table.t()), dict(col=col.long()),
                dict(col=col[:0]), dict(k=-1), dict(k=1 << 24),
                dict(table=table.to("meta"), col=col.to("meta"))):
        args = dict(table=table, col=col, k=2) | bad
        with pytest.raises(ValueError):
            mb.attr_read(**args)
    rec, x = mb.member_rec(), mb.member_x(64)
    for bad in (dict(kind="cone"), dict(rec=rec[:32]), dict(rec=rec.double()),
                dict(x=x[:40]), dict(x=x.float()), dict(k=-2),
                dict(rec=rec.to("meta"), x=x.to("meta"))):
        args = dict(rec=rec, x=x, k=4, kind="box") | bad
        with pytest.raises(ValueError):
            mb.member(**args)
    with pytest.raises(ValueError):
        mb.attr_table(3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            mb.per_call(lambda k: None, mb.D2_K)


def test_attr_bytes_counts_each_warps_distinct_rows():
    """D1's bytes a call (its bound's numerator): every word of each
    distinct row a warp reads, the same in every iteration of the tool's
    trip counts; a warp whose lanes share one row needs that row once."""
    col = mb.attr_cols(1000)
    for n_bands in mb.BANDS:
        row_bytes = 8 * n_bands * 4
        for i in range(mb.D1_K[1]):
            rows = mb.attr_rows_plain(torch.arange(1408, dtype=torch.int32)
                                      .unsqueeze(1), col, i).ravel().numpy()
            want = sum(len(set(rows[w:w + 32].tolist()))
                       for w in range(0, rows.size, 32))
            assert mb.attr_bytes(col, n_bands) == want * row_bytes
    same = torch.full((64,), 1399, dtype=torch.int32)
    assert mb.attr_bytes(same, 4) == 2 * 128
    assert mb.attr_bytes(torch.arange(64, dtype=torch.int32), 2) == 64 * 64


def test_full_wave_raises_on_bad_kernels():
    """`full_wave` names D1 as attr_read at 2 or 4 bands, or a D2 kind."""
    for args in (("cone",), ("attr_read", 3), ("sphere_box",)):
        with pytest.raises(ValueError):
            mb.full_wave(*args)


def test_microbench_runs_on_the_plain_versions(capsys):
    """`python -m raytracing_rust_tpu_torch.microbench --device cpu` runs the
    plain versions' checks and exits 0; a thread count that is not whole
    warps exits 2."""
    assert microbench.main(["--device", "cpu", "--threads", "2048"]) == 0
    out = capsys.readouterr().out
    assert "attr_read[4 bands]" in out and "or_tree" in out
    assert "False" not in out
    assert microbench.main(["--device", "cpu", "--threads", "100"]) == 2
