"""D1 and D2 (`csrc/microbench.cu`): the megakernel's building blocks timed
alone, and their plain versions.

Counterparts of tools/microbench.py's two Pallas kernels, on the tool's own
seeded inputs:

* D1, the winner-row read (`attr_read`): k iterations, each reading all W =
  8 · bands words of row (col + i) mod 1400 of an int32 table [1408, W] (the
  tool's [32, 1408] attribute table transposed into rows), adding word 0
  read as an f32 to an accumulator and xor-folding every word into a
  checksum → (f32[n], int32[n]). The words are below 2²⁰, so as f32 they
  are denormals; the partial sums stay exact multiples of 2⁻¹⁴⁹, and the
  card and torch keep them, where XLA on a CPU flushes them (the tool's own
  output is 0.0 there).
* D2, the member tests and the votes (`member`): k iterations over 64
  records f32[64, 46] of one kind: the sphere member test, the merged-box
  slab test, a warp's `any` of (x·10⁻³ + q > 0.5), a warp's OR of
  (x·10⁻³ > 0) << (q mod 31) → (t_b + wi as f32[n], the votes' int32 fold:
  the count of true votes for `any`, the xor of the words for `or_tree`, 0
  for the tests).

The wrappers launch the kernel on CUDA tensors (building it at first use)
or raise; on CPU tensors they run `attr_read_plain` and `member_plain`, the
same arithmetic in the kernel's order. `per_call` times one iteration on
the card at the tool's two trip counts.
"""

from __future__ import annotations

import numpy as np
import torch

SUB, LANES = 8, 1024
TILE = SUB * LANES          # the TPU tile's lanes: the default thread count
ATTR_ROWS = 32              # the tool's table: pallas_tracer.py ATTR_ROWS
TABLE_ROWS = 1408           # the tool's primitives (a multiple of 128)
ROWS_READ = 1400            # rows (col + i) mod ROWS_READ are read
REC, N_REC = 46, 64         # D2's records
BANDS = (4, 2)
KINDS = ("sphere", "box", "any", "or_tree")
# the tool's trip counts: D1 at 2 and 22 (µs per call), D2 at 64 and 1064
# (ns per call)
D1_K = (2, 22)
D2_K = (64, 1064)
# bytes an SM's load path delivers to its threads a clock from L1 or shared
# memory (32 banks of 4 bytes): D1's table stays on chip, so this rate, not
# device memory's, is the floor of its reads
SM_LOAD_BYTES_PER_CLK = 128
# f32 and integer operations per thread and iteration of each D2 kind,
# counted from csrc/microbench.cu (the loop's own counter not counted; the
# box's reciprocals are taken once, before the loop, as K1 takes them):
# sphere 10 mul, 11 add/sub, a negation, a sqrt, 4 compares, 4 selects, an
# int→f32 convert; box 6 sub, 6 mul, 10 min/max, 4 compares, 3 selects, a
# convert; any a convert, an add, a compare, the vote, a convert, an add,
# an int add; or_tree a compare, a modulo, a shift, the vote, a convert, an
# add, an xor
D2_OPS = {"sphere": 32, "box": 30, "any": 7, "or_tree": 7}

# launches of each kernel, counted by its wrapper after a launch succeeds
D1_LAUNCHES = 0
D2_LAUNCHES = 0


def attr_table(n_bands: int = 4) -> torch.Tensor:
    """The tool's seeded attribute table (seed 0: int32 in [0, 2²⁰),
    [32, 1408]) as rows: int32[1408, 8·n_bands], row r holding fields
    0 .. 8·n_bands − 1 of primitive r."""
    if n_bands not in BANDS:
        raise ValueError(f"n_bands {n_bands} not in {BANDS}")
    attr = np.random.default_rng(0).integers(
        0, 2 ** 20, (ATTR_ROWS, TABLE_ROWS), dtype=np.int32)
    return torch.from_numpy(np.ascontiguousarray(attr[:8 * n_bands].T))


def _tiled(a: np.ndarray, n: int) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.resize(a.ravel(), n)))


def attr_cols(n: int = TILE) -> torch.Tensor:
    """The tool's seeded column indices (seed 1: int32 in [0, 1400), one per
    lane of the (8, 1024) tile, row-major), repeated to n threads."""
    return _tiled(np.random.default_rng(1).integers(
        0, ROWS_READ, (SUB, LANES), dtype=np.int32), n)


def member_rec() -> torch.Tensor:
    """The tool's seeded records (seed 2: uniform in [−1, 1), f32[64, 46])."""
    return torch.from_numpy(np.random.default_rng(2).uniform(
        -1, 1, (N_REC, REC)).astype(np.float32))


def member_x(n: int = TILE) -> torch.Tensor:
    """The tool's seeded lane values (seed 3: int32 in [0, 997), one per lane
    of the tile, row-major), repeated to n threads."""
    return _tiled(np.random.default_rng(3).integers(
        0, 997, (SUB, LANES), dtype=np.int32), n)


def _check_attr(table, col, k) -> None:
    if table.dtype != torch.int32 or table.dim() != 2 \
            or table.shape[0] < TABLE_ROWS or table.shape[1] not in (16, 32) \
            or not table.is_contiguous():
        raise ValueError(f"table must be a contiguous int32[≥ {TABLE_ROWS}, "
                         f"16 or 32], got {table.dtype} {tuple(table.shape)}")
    if col.dtype != torch.int32 or col.dim() != 1 or col.numel() == 0 \
            or not col.is_contiguous() or col.device != table.device:
        raise ValueError("col must be a contiguous int32 vector on the "
                         "table's device")
    if not 0 <= k < 1 << 24:
        raise ValueError(f"k {k} out of range")


def _check_member(rec, x, k, kind) -> None:
    if kind not in KINDS:
        raise ValueError(f"kind {kind!r} not in {KINDS}")
    if rec.dtype != torch.float32 or tuple(rec.shape) != (N_REC, REC) \
            or not rec.is_contiguous():
        raise ValueError(f"rec must be a contiguous f32[{N_REC}, {REC}]")
    if x.dtype != torch.int32 or x.dim() != 1 or x.numel() == 0 \
            or x.numel() % 32 or not x.is_contiguous() \
            or x.device != rec.device:
        raise ValueError("x must be a contiguous int32 vector of whole warps "
                         "(a multiple of 32) on rec's device")
    if not 0 <= k < 1 << 24:
        raise ValueError(f"k {k} out of range")


def attr_rows_plain(table: torch.Tensor, col: torch.Tensor,
                    i: int) -> torch.Tensor:
    """The words iteration i reads: row (col + i) mod 1400 of the table for
    each thread, col taken as unsigned 32-bit as the kernel takes it →
    int32[n, W]."""
    row = ((col.to(torch.int64) + i) & 0xFFFFFFFF) % ROWS_READ
    return table[row]


def attr_bytes(col: torch.Tensor, n_bands: int) -> int:
    """The bytes one D1 call (one iteration) must deliver to its threads:
    all W = 8 · n_bands words of each distinct row a warp of 32 threads
    reads (lanes of a warp that share a row are served once). Counted on
    iteration 0's rows; on columns below 1400, as the tool's are, the shift
    (col + i) mod 1400 keeps every warp's count in every iteration."""
    rows = (col.cpu().numpy().astype(np.int64) & 0xFFFFFFFF) % ROWS_READ
    distinct = sum(np.unique(rows[w:w + 32]).size
                   for w in range(0, rows.size, 32))
    return distinct * 8 * n_bands * 4


def attr_read_plain(table: torch.Tensor, col: torch.Tensor,
                    k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """D1 in plain torch → (acc f32[n], checksum int32[n]): over k iterations
    in order, acc + word 0 read as an f32, and the xor of every word."""
    n = col.numel()
    acc = torch.zeros(n, dtype=torch.float32, device=col.device)
    ck = torch.zeros(n, dtype=torch.int32, device=col.device)
    for i in range(k):
        words = attr_rows_plain(table, col, i)
        for j in range(words.shape[1]):
            ck = ck ^ words[:, j]
        acc = acc + words[:, 0].view(torch.float32)
    return acc, ck


def attr_read(table: torch.Tensor, col: torch.Tensor, k: int,
              shared: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """D1's (acc, checksum) for one thread per entry of col. On CUDA it
    launches `csrc/microbench.cu` on the current stream, the table read
    through the read-only cache or (shared) staged in shared memory, or
    raises; on the CPU it runs `attr_read_plain`."""
    global D1_LAUNCHES
    _check_attr(table, col, k)
    if table.device.type == "cpu":
        return attr_read_plain(table, col, k)
    if table.device.type != "cuda":
        raise ValueError(f"no kernel for device {table.device}")
    if table.data_ptr() % 16:
        raise ValueError("the table must be 16-byte aligned")
    from ._build import load
    lib = load()
    n = col.numel()
    acc = torch.empty(n, dtype=torch.float32, device=table.device)
    ck = torch.empty(n, dtype=torch.int32, device=table.device)
    with torch.cuda.device(table.device):
        err = lib.rt_attr_read(
            table.data_ptr(), table.shape[0], table.shape[1], col.data_ptr(),
            n, k, int(shared), acc.data_ptr(), ck.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"D1 launch failed: cudaError {err}")
    D1_LAUNCHES += 1
    return acc, ck


def _warp_any(m: torch.Tensor) -> torch.Tensor:
    return m.view(-1, 32).any(dim=1).repeat_interleave(32)


def _warp_or(m: torch.Tensor) -> torch.Tensor:
    words = m.view(-1, 32)
    out = words[:, 0]
    for j in range(1, 32):
        out = out | words[:, j]
    return out.repeat_interleave(32)


def member_plain(rec: torch.Tensor, x: torch.Tensor, k: int,
                 kind: str) -> tuple[torch.Tensor, torch.Tensor]:
    """D2 in plain torch → (t_b + wi f32[n], fold int32[n]): the JAX tool's
    body for `kind`, iteration q on record q mod 64, every f32 operation in
    its order; `any` and `or_tree` reduce over each warp of 32 threads."""
    dev = x.device
    f32 = torch.float32
    table = rec.cpu().tolist()   # each cell an f32 value, as a Python float
    xf = x.to(f32) * 1e-3
    ox = oy = oz = xf
    dx, dy, dz = xf + 0.1, xf + 0.2, xf + 0.3
    a_dd = dx * dx + dy * dy + dz * dz
    inv_a = 1.0 / a_dd

    def si(dc):
        return torch.where(dc.abs() < 1e-30, 1e30, 1.0 / dc)

    ix, iy, iz = si(dx), si(dy), si(dz)
    t_b = torch.full_like(xf, 3e38)
    wi = torch.zeros_like(xf)
    fold = torch.zeros(x.shape, dtype=torch.int32, device=dev)
    for q in range(k):
        r = table[q % N_REC]
        if kind == "sphere":
            ocx, ocy, ocz = ox - r[0], oy - r[1], oz - r[2]
            bq = ocx * dx + ocy * dy + ocz * dz
            cq = ocx * ocx + ocy * ocy + ocz * ocz - r[3]
            disc = bq * bq - a_dd * cq
            pos = disc > 0.0
            # sqrt in f64, rounded once to f32: correctly rounded, as the
            # card's sqrtf (torch's f32 sqrt on a CPU's AVX-512 path is not)
            sq = torch.sqrt(torch.where(pos, disc, 1.0).double()).float()
            t_near = (-bq - sq) * inv_a
            t_far = (-bq + sq) * inv_a
            t_sel = torch.where(t_near > 1e-3, t_near, t_far)
            ok = pos & (t_sel > 1e-3) & (t_sel < t_b)
        elif kind == "box":
            t0, t1 = (r[0] - ox) * ix, (r[3] - ox) * ix
            tmn, tmx = torch.minimum(t0, t1), torch.maximum(t0, t1)
            t0, t1 = (r[1] - oy) * iy, (r[4] - oy) * iy
            tmn = torch.maximum(tmn, torch.minimum(t0, t1))
            tmx = torch.minimum(tmx, torch.maximum(t0, t1))
            t0, t1 = (r[2] - oz) * iz, (r[5] - oz) * iz
            tmn = torch.maximum(tmn, torch.minimum(t0, t1))
            tmx = torch.minimum(tmx, torch.maximum(t0, t1))
            t_sel = torch.where(tmn > 1e-3, tmn, tmx)
            ok = (tmx > tmn) & (t_sel > 1e-3) & (t_sel < t_b)
        elif kind == "any":
            vote = _warp_any(xf + float(q) > 0.5).to(torch.int32)
            t_b = t_b + vote.to(f32)
            fold = fold + vote
            continue
        else:
            word = _warp_or((xf > 0.0).to(torch.int32) << (q % 31))
            t_b = t_b + word.to(f32)
            fold = fold ^ word
            continue
        t_b = torch.where(ok, t_sel, t_b)
        wi = torch.where(ok, float(q), wi)
    return t_b + wi, fold


def member(rec: torch.Tensor, x: torch.Tensor, k: int,
           kind: str) -> tuple[torch.Tensor, torch.Tensor]:
    """D2's (t_b + wi, fold) for one thread per entry of x (whole warps). On
    CUDA it launches `csrc/microbench.cu` on the current stream or raises;
    on the CPU it runs `member_plain`."""
    global D2_LAUNCHES
    _check_member(rec, x, k, kind)
    if x.device.type == "cpu":
        return member_plain(rec, x, k, kind)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    from ._build import load
    lib = load()
    n = x.numel()
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    fold = torch.empty(n, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.rt_member(rec.data_ptr(), x.data_ptr(), n, k,
                            KINDS.index(kind), out.data_ptr(),
                            fold.data_ptr(),
                            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"D2 launch failed: cudaError {err}")
    D2_LAUNCHES += 1
    return out, fold


def full_wave(kernel: str, n_bands: int = 4, shared: bool = False) -> int:
    """Threads of one full wave of a kernel on the card: SMs × the blocks
    of 256 threads of it an SM holds at once (the runtime's occupancy
    query, which sees its registers and shared memory) × 256. kernel is
    "attr_read" (D1 at n_bands, the table staged in shared memory if
    shared) or one of KINDS (D2)."""
    import ctypes
    if kernel == "attr_read":
        if n_bands not in BANDS:
            raise ValueError(f"n_bands {n_bands} not in {BANDS}")
        args = (0, 8 * n_bands, int(shared))
    elif kernel in KINDS:
        args = (1, KINDS.index(kernel), 0)
    else:
        raise ValueError(f"kernel {kernel!r} not attr_read or in {KINDS}")
    from ._build import load
    blocks = ctypes.c_int(0)
    err = load().rt_mb_blocks_per_sm(*args, ctypes.addressof(blocks))
    if err != 0 or blocks.value <= 0:
        raise RuntimeError(f"occupancy of {kernel}: cudaError {err}, "
                           f"{blocks.value} blocks an SM")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * blocks.value * 256


def per_call(launch, ks: tuple[int, int]) -> float:
    """Seconds of one iteration on the card: launch(k) timed by CUDA events
    at the two trip counts ks (the best of three each, after a warm-up),
    the difference over ks[1] − ks[0]; raises without CUDA. Each timed
    launch is queued behind a ~0.5 ms spin of the card, so the events
    bracket the kernel alone and not the host's time to launch it, which
    is longer than a short kernel."""
    if not torch.cuda.is_available():
        raise RuntimeError("per_call measures the card: "
                           "torch.cuda.is_available() is false")

    def best_ms(k: int) -> float:
        times = []
        for _ in range(3):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda._sleep(1 << 20)
            a.record()
            launch(k)
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return min(times)

    launch(ks[0])   # warm-up (and the build)
    torch.cuda.synchronize()
    t1, t2 = best_ms(ks[0]), best_ms(ks[1])
    return (t2 - t1) * 1e-3 / (ks[1] - ks[0])
