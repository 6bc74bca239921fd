"""The calibration statistics kernels: wrappers and plain versions.

Two CUDA C++ kernels for Hopper (calib/csrc/) replace the JAX package's two
Pallas kernels (calib/kernels.py of the JAX package):

  * ``octav_many(xs, dynamic_sym)``: per tensor and sample row, the OCTAV
    MSE-optimal clip with the row's min and max, in one launch per size
    class (``octav_plan``) for a whole list of tensors (csrc/octav.cu);
    ``octav(x, dynamic_sym)`` is the same for one tensor;
  * ``bin_count_many(xs, valid, scales, bins, out)``: the |x| binning
    fused into an exact histogram count per tensor, in one launch per dtype
    and 64 tensors (``bin_count_plan``) for a whole list of tensors
    (csrc/histogram.cu); ``bin_count(x, valid, scales, t, bins, out)`` is the
    same for one tensor.

Each wrapper dispatches on the tensor's device only: a CPU tensor goes to
the plain PyTorch version beside it (``octav_reference``,
``bin_count_reference``), a CUDA tensor to the kernel, or the wrapper
raises.  There is no fallback from the kernel to the plain version.  Each
wrapper adds one to ``LAUNCHES`` where it launches its kernel, and nowhere
else."""
from __future__ import annotations

import ctypes
import functools
import struct
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

LAUNCHES = {"octav": 0, "bin_count": 0}
OCTAV_MAX_ITER = 20
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# Hopper's (sm_90) shared memory, for both planners
SMEM_PER_BLOCK = 232_448      # the most shared memory one block may have
SMEM_PER_SM = 233_472         # one SM's shared memory (228 KB)
SMEM_RESERVED = 1024          # what the runtime reserves for each resident block


class KernelLaunchError(RuntimeError):
    pass


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_rows(x: torch.Tensor, what: str):
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: x must be float32 or bfloat16, got {x.dtype}")
    if x.ndim != 2 or x.shape[1] < 1:
        raise ValueError(f"{what}: x must be (B, n) with n >= 1, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous")


def _same_device(what: str, x: torch.Tensor, **others):
    for name, t in others.items():
        if t.device != x.device:
            raise ValueError(f"{what}: {name} is on {t.device}, x on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(err: int, what: str):
    if err != 0:
        raise KernelLaunchError(f"{what} kernel launch failed with CUDA error {err}")


# -- OCTAV -------------------------------------------------------------------
# The shared memory arithmetic of csrc/octav.cu.
OCTAV_STATIC_SMEM = 512       # kStaticSmem: the kernel's static shared memory, at most
OCTAV_ALIGN = 16              # kAlign: slack that keeps a block's copy 16-byte aligned
OCTAV_CLUSTERS = (1, 2, 4, 8)  # portable thread-block cluster sizes
OCTAV_MAX_ENTRIES = 64        # kMaxEntries: tensors in one launch's table
_SLICE_STEP = 8               # a block's slice starts on a multiple of 8 elements
_MAX_N = 2 ** 31 - _SLICE_STEP  # the kernel counts elements in 32 bits
_ELEM = {torch.float32: 4, torch.bfloat16: 2}


@dataclass(frozen=True)
class OctavLaunch:
    """One launch of the OCTAV kernel: the tensors (``entries``, indices into
    the caller's list) of one dtype whose rows take ``cluster`` blocks each,
    every block keeping up to ``held`` elements of its slice (``chunks[j]``
    elements of entry j's row) in ``smem_bytes`` of shared memory; one SM
    holds ``per_sm`` such blocks."""
    dtype: torch.dtype
    cluster: int
    per_sm: int
    held: int
    smem_bytes: int
    entries: Tuple[int, ...]
    chunks: Tuple[int, ...]


def _octav_capacity(elem: int) -> int:
    """Elements of a slice one block can keep in shared memory."""
    room = SMEM_PER_BLOCK - OCTAV_STATIC_SMEM - OCTAV_ALIGN
    return room // elem // _SLICE_STEP * _SLICE_STEP


def octav_chunk(n: int, cluster: int) -> int:
    """Elements of a row that each block of a ``cluster`` takes."""
    per_block = -(-n // cluster)
    return -(-per_block // _SLICE_STEP) * _SLICE_STEP


def octav_plan(sizes: Sequence[Tuple[int, torch.dtype]]) -> Tuple[OctavLaunch, ...]:
    """The launches ``octav_many`` makes for tensors of these (n, dtype).

    A row goes to the smallest cluster whose blocks each hold their slice;
    a row too large for 8 blocks keeps what fits and re-reads the rest.  The
    rows of one dtype and cluster size form one class, split in two where
    two blocks fit on one SM, so that small rows do not take a whole SM's
    shared memory.  A class makes one launch per ``OCTAV_MAX_ENTRIES``
    tensors, with the shared memory its largest slice needs.  A statistics
    pass asks for the same sizes every batch, so the plans are cached."""
    return _octav_plan(tuple(sizes))


@functools.lru_cache(maxsize=32)
def _octav_plan(sizes: Tuple[Tuple[int, torch.dtype], ...]) -> Tuple[OctavLaunch, ...]:
    classes: Dict[Tuple[torch.dtype, int, int], list] = {}
    for i, (n, dtype) in enumerate(sizes):
        elem = _ELEM[dtype]
        capacity = _octav_capacity(elem)
        cluster = next((c for c in OCTAV_CLUSTERS if octav_chunk(n, c) <= capacity),
                       OCTAV_CLUSTERS[-1])
        chunk = octav_chunk(n, cluster)
        held = min(chunk, capacity)
        block_smem = held * elem + OCTAV_ALIGN + OCTAV_STATIC_SMEM + SMEM_RESERVED
        per_sm = 2 if 2 * block_smem <= SMEM_PER_SM else 1
        classes.setdefault((dtype, cluster, per_sm), []).append((i, chunk, held))
    launches = []
    for (dtype, cluster, per_sm), members in sorted(
            classes.items(), key=lambda kv: (_DTYPE_CODE[kv[0][0]], -kv[0][1], kv[0][2])):
        for j in range(0, len(members), OCTAV_MAX_ENTRIES):
            part = members[j:j + OCTAV_MAX_ENTRIES]
            held = max(h for _, _, h in part)
            launches.append(OctavLaunch(dtype, cluster, per_sm, held,
                                        held * _ELEM[dtype] + OCTAV_ALIGN,
                                        tuple(i for i, _, _ in part),
                                        tuple(c for _, c, _ in part)))
    return tuple(launches)


def octav_many(xs: Sequence[torch.Tensor], dynamic_sym: bool) -> torch.Tensor:
    """A list of T (B, n_t) f32/bf16 tensors -> (T, B, 3) f32 of (optimal s,
    min, max) per tensor and row, in ``len(octav_plan(...))`` launches."""
    xs = list(xs)
    if not xs:
        raise ValueError("octav_many: no tensors")
    for x in xs:
        _check_rows(x, "octav_many")
        _same_device("octav_many", xs[0], tensor=x)
        if x.shape[0] != xs[0].shape[0] or x.shape[0] < 1:
            raise ValueError(f"octav_many: every tensor needs the same B >= 1 rows, got "
                             f"{[tuple(t.shape) for t in xs]}")
        if x.shape[1] > _MAX_N:
            raise ValueError(f"octav_many: at most {_MAX_N} elements per row, got {x.shape[1]}")
    if xs[0].device.type == "cpu":
        return torch.stack([octav_reference(x, dynamic_sym) for x in xs])
    from .build import OctavEntry, library
    lib = library()
    device, batch = xs[0].device, xs[0].shape[0]
    out = torch.empty((len(xs), batch, 3), dtype=torch.float32, device=device)
    # The classes run side by side on streams forked from the caller's and
    # joined back into it, so one class's last wave of blocks shares the
    # card with the next class instead of leaving SMs idle.
    caller = torch.cuda.current_stream(device)
    fork = torch.cuda.Event()
    fork.record(caller)
    for launch in octav_plan([(x.shape[1], x.dtype) for x in xs]):
        side = torch.cuda.Stream(device)
        side.wait_event(fork)
        table = (OctavEntry * len(launch.entries))(
            *(OctavEntry(xs[i].data_ptr(), xs[i].shape[1], chunk, i)
              for i, chunk in zip(launch.entries, launch.chunks)))
        _raise_on(lib.octav_launch(table, len(launch.entries), _DTYPE_CODE[launch.dtype],
                                   launch.cluster, batch, launch.held, launch.smem_bytes,
                                   int(bool(dynamic_sym)), out.data_ptr(), side.cuda_stream,
                                   device.index), "octav")
        LAUNCHES["octav"] += 1
        join = torch.cuda.Event()
        join.record(side)
        caller.wait_event(join)
    return out


def octav(x: torch.Tensor, dynamic_sym: bool) -> torch.Tensor:
    """(B, n) f32/bf16 rows -> (B, 3) f32 of (optimal s, min, max) per row."""
    return octav_many([x], dynamic_sym)[0]


def octav_reference(x: torch.Tensor, dynamic_sym: bool, return_iterations: bool = False):
    """Plain version of ``octav``, vectorised over the rows: once a row has
    converged, an ``active`` mask freezes its s, which reproduces the
    per-row while-loop of the JAX package's XLA fallback
    (calib/stats.py:45-70).  With ``return_iterations`` it also returns
    the fixed-point iterations each row took (B,) int64."""
    xf = x.float()
    absx = xf.abs()
    mn = xf.amin(1)
    mx = xf.amax(1)
    n = xf.shape[1]
    nnz = (absx > 0).sum(1).clamp(min=1)
    s = absx.sum(1) / nnz
    if dynamic_sym:
        unsigned = torch.where(mn.abs() < 1e-6, 4.0, 1.0)
    else:
        unsigned = torch.ones_like(mn)
    coef = (1.0 / (4.0 ** 8) / 3.0) / unsigned
    prev = s + 1.0
    iterations = torch.zeros_like(nnz)
    for _ in range(OCTAV_MAX_ITER):
        active = (s - prev).abs() >= 1e-6
        iterations += active
        gt = absx > s[:, None]
        num = torch.where(gt, absx, 0.0).sum(1)
        gt_count = gt.sum(1)
        den = coef * (n - gt_count) + gt_count
        s_next = num / den.clamp(min=1e-30)
        prev = torch.where(active, s, prev)
        s = torch.where(active, s_next, s)
    out = torch.stack([s, mn, mx], dim=1)
    return (out, iterations) if return_iterations else out


# -- histogram -------------------------------------------------------------------
# The launch arithmetic of csrc/histogram.cu.
BIN_COUNT_THREADS = 512        # kThreads
BIN_COUNT_BLOCKS_PER_SM = 2    # kBlocksPerSm: __launch_bounds__'s minimum resident blocks
BIN_COUNT_MAX_ENTRIES = 64     # kMaxEntries: tensors in one launch's table
BIN_COUNT_DEPTH = 8            # kRingDepth: 16-byte words per thread in the load ring
BIN_COUNT_RING_BYTES = BIN_COUNT_DEPTH * BIN_COUNT_THREADS * 16
BIN_COUNT_WORK_PER_COUNTER = 16  # a block counts at least 16 elements per shared counter
HOPPER_SMS = 132               # an H100 SXM's SMs; the wrappers pass the card's own count
_MAX_PER_BLOCK = 2 ** 31 - 1   # a block's shared counts are int32


@dataclass(frozen=True)
class BinCountLaunch:
    """One launch of the histogram kernel: the tensors (``entries``, indices
    into the caller's list) of one dtype laid end to end in a flat range of
    ``total`` elements (entry j, of ``ns[j]`` elements per row, starting at
    ``firsts[j]``), counted by ``grid`` blocks of ``per_block`` elements
    each, with ``smem_bytes`` of shared memory per block (the load ring of
    ``depth`` words per thread and the histogram).  ``flushes`` is the
    number of (block, entry) pairs whose ranges meet: each flushes its
    shared histogram once, with at most ``bins`` global atomics."""
    dtype: torch.dtype
    depth: int
    entries: Tuple[int, ...]
    ns: Tuple[int, ...]
    firsts: Tuple[int, ...]
    total: int
    per_block: int
    grid: int
    smem_bytes: int
    flushes: int


def bin_count_plan(sizes: Sequence[Tuple[int, torch.dtype]], batch: int, bins: int,
                   sms: int = HOPPER_SMS, per_block: Optional[int] = None
                   ) -> Tuple[BinCountLaunch, ...]:
    """The launches ``bin_count_many`` makes for tensors of these (n, dtype)
    with ``batch`` rows each, on a card of ``sms`` SMs.

    One launch per dtype and per ``BIN_COUNT_MAX_ENTRIES`` tensors.  The grid
    is sized to the card: SMs x the blocks that fit on one SM (by threads
    and shared memory), each block taking an equal run of the flat range,
    but no fewer than ``BIN_COUNT_WORK_PER_COUNTER`` elements per shared
    counter, so that zeroing and flushing stay a small share of a block's
    work.  The cost model: a block flushes once per entry its range meets,
    so a launch makes ``flushes`` <= grid + entries - 1 flushes and at most
    ``flushes * bins`` global atomics.  A block keeps the load ring beside
    the histogram where both fit its shared memory, else it loads without
    one (``depth`` 0).  ``per_block`` fixes a block's elements instead of
    sizing the grid to the card (``chip_smoke.py`` times such a grid).  A
    statistics pass asks for the same sizes every batch, so the plans are
    cached."""
    return _bin_count_plan(tuple(sizes), int(batch), int(bins), int(sms), per_block)


@functools.lru_cache(maxsize=32)
def _bin_count_plan(sizes: Tuple[Tuple[int, torch.dtype], ...], batch: int, bins: int,
                    sms: int, fixed_per_block: Optional[int]) -> Tuple[BinCountLaunch, ...]:
    if bins * 4 > SMEM_PER_BLOCK:
        raise ValueError(f"bin_count: {bins} bins need {bins * 4} bytes of shared memory per "
                         f"block, more than the {SMEM_PER_BLOCK} a block may have")
    depth = BIN_COUNT_DEPTH if BIN_COUNT_RING_BYTES + bins * 4 <= SMEM_PER_BLOCK else 0
    smem = depth * BIN_COUNT_THREADS * 16 + bins * 4
    per_sm = min(BIN_COUNT_BLOCKS_PER_SM, SMEM_PER_SM // (smem + SMEM_RESERVED))
    by_dtype: Dict[torch.dtype, list] = {}
    for i, (n, dtype) in enumerate(sizes):
        by_dtype.setdefault(dtype, []).append(i)
    launches = []
    for dtype in sorted(by_dtype, key=_DTYPE_CODE.get):
        members = by_dtype[dtype]
        for j in range(0, len(members), BIN_COUNT_MAX_ENTRIES):
            part = tuple(members[j:j + BIN_COUNT_MAX_ENTRIES])
            firsts, total = [], 0
            for i in part:
                firsts.append(total)
                total += batch * sizes[i][0]
            per_block = fixed_per_block or max(-(-total // (sms * per_sm)),
                                               BIN_COUNT_WORK_PER_COUNTER * bins)
            per_block = min(per_block, _MAX_PER_BLOCK)
            flushes = sum((f + batch * sizes[i][0] - 1) // per_block - f // per_block + 1
                          for i, f in zip(part, firsts))
            launches.append(BinCountLaunch(dtype, depth, part, tuple(sizes[i][0] for i in part),
                                           tuple(firsts), total, per_block,
                                           -(-total // per_block), smem, flushes))
    return tuple(launches)


def _bin_count_sizes(what: str, xs, valid, scales, bins, out):
    """Checks the inputs of ``bin_count`` / ``bin_count_many`` and returns
    each tensor's (n, dtype).  One pass over the tensors, reading each
    attribute once: the main path checks 50 tensors per batch."""
    if not xs:
        raise ValueError(f"{what}: no tensors")
    device = valid.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {device}")
    if scales.device != device or out.device != device:
        raise ValueError(f"{what}: valid is on {device}, scales on {scales.device}, "
                         f"out on {out.device}")
    if valid.dtype != torch.float32 or valid.ndim != 1 or not valid.is_contiguous():
        raise ValueError(f"{what}: valid must be a contiguous (B,) float32 tensor")
    if scales.dtype != torch.float32 or scales.ndim != 1 or not scales.is_contiguous():
        raise ValueError(f"{what}: scales must be a contiguous (T,) float32 tensor")
    if bins < 1 or out.dtype != torch.int64 or not out.is_contiguous():
        raise ValueError(f"{what}: out must be a contiguous int64 tensor and bins >= 1")
    batch = valid.shape[0]
    sizes = []
    for x in xs:
        dtype, shape = x.dtype, x.shape
        if dtype not in _DTYPE_CODE:
            raise TypeError(f"{what}: x must be float32 or bfloat16, got {dtype}")
        if len(shape) != 2 or shape[1] < 1 or shape[0] != batch:
            raise ValueError(f"{what}: x must be (B, n) with n >= 1 and B = {batch} rows of "
                             f"valid, got {tuple(shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: x must be contiguous")
        if x.device != device:
            raise ValueError(f"{what}: x is on {x.device}, valid on {device}")
        sizes.append((shape[1], dtype))
    return sizes


def bin_count_many(xs: Sequence[torch.Tensor], valid: torch.Tensor, scales: torch.Tensor,
                   bins: int, out: torch.Tensor) -> torch.Tensor:
    """Add, for each of T tensors x_i (B, n_i), the histogram of
    ``min(int(|x_i| * scales[i]), bins - 1)`` over the rows with
    ``valid > 0`` into ``out[i]`` ((T, bins) int64), in
    ``len(bin_count_plan(...))`` launches."""
    xs = list(xs)
    sizes = _bin_count_sizes("bin_count_many", xs, valid, scales, bins, out)
    if scales.shape != (len(xs),) or out.shape != (len(xs), bins):
        raise ValueError(f"bin_count_many: scales must be ({len(xs)},) and out "
                         f"({len(xs)}, {bins}), got {tuple(scales.shape)} and {tuple(out.shape)}")
    if valid.device.type == "cpu":
        for i, x in enumerate(xs):
            bin_count_reference(x, valid, scales, i, bins, out[i])
        return out
    base, row = out.data_ptr(), bins * out.element_size()
    _bin_count_cuda(sizes, xs, range(len(xs)), range(base, base + len(xs) * row, row), valid,
                    scales, bins)
    return out


def bin_count(x: torch.Tensor, valid: torch.Tensor, scales: torch.Tensor, t: int,
              bins: int, out: torch.Tensor) -> torch.Tensor:
    """Add the histogram of ``min(int(|x| * scales[t]), bins - 1)`` over the
    rows of x (B, n) with ``valid > 0`` into ``out`` (bins,) int64: one
    launch with one entry."""
    sizes = _bin_count_sizes("bin_count", [x], valid, scales, bins, out)
    if not 0 <= t < scales.shape[0] or out.shape != (bins,):
        raise ValueError(f"bin_count: need 0 <= t < {scales.shape[0]} (t={t}) and out "
                         f"({bins},), got {tuple(out.shape)}")
    if x.device.type == "cpu":
        return bin_count_reference(x, valid, scales, t, bins, out)
    _bin_count_cuda(sizes, [x], [t], [out.data_ptr()], valid, scales, bins)
    return out


@functools.lru_cache(maxsize=8)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _bin_count_cuda(sizes, xs, ts, outs, valid, scales, bins):
    """Every launch of the plan for xs on the card; entry i counts with
    scales[ts[i]] into the int64 row at address outs[i]."""
    plan = bin_count_plan(sizes, valid.shape[0], bins, _sms(valid.device.index))
    for launch in plan:
        launch_bin_count(launch, xs, ts, outs, valid, scales, bins)


@functools.lru_cache(maxsize=BIN_COUNT_MAX_ENTRIES)
def _table_format(count: int) -> struct.Struct:
    """The layout of ``count`` BinCountEntry structures (x, out, n, first, t
    and 4 bytes of padding), packed in one call."""
    from .build import BinCountEntry
    fmt = struct.Struct("<" + "QQqqi4x" * count)
    assert fmt.size == count * ctypes.sizeof(BinCountEntry)
    return fmt


def launch_bin_count(launch: BinCountLaunch, xs, ts, outs, valid, scales, bins):
    """One planned launch on the caller's stream (``chip_smoke.py`` also
    calls it with a plan of another grid)."""
    from .build import BinCountEntry, library
    count = len(launch.entries)
    fields = []
    for i, n, first in zip(launch.entries, launch.ns, launch.firsts):
        fields += (xs[i].data_ptr(), outs[i], n, first, ts[i])
    table = (BinCountEntry * count).from_buffer_copy(_table_format(count).pack(*fields))
    _raise_on(library().bin_count_launch(
        table, count, _DTYPE_CODE[launch.dtype], launch.depth,
        valid.shape[0], launch.total, launch.per_block, launch.grid, bins, valid.data_ptr(),
        scales.data_ptr(), _stream(valid), valid.device.index), "bin_count")
    LAUNCHES["bin_count"] += 1


def bin_count_reference(x: torch.Tensor, valid: torch.Tensor, scales: torch.Tensor,
                        t: int, bins: int, out: torch.Tensor) -> torch.Tensor:
    """Plain version of ``bin_count``: binning, then ``torch.bincount`` over
    the valid rows, in int64.  NaN counts in bucket 0 and +inf in bucket
    bins-1, as the kernel's saturating conversion does."""
    v = x[valid > 0].float().abs() * scales[t]
    v = torch.nan_to_num(v, nan=0.0).clamp(0, bins - 1)
    out += torch.bincount(v.to(torch.int64).reshape(-1), minlength=bins)
    return out
