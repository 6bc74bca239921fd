"""The calibration statistics kernels: wrappers and plain versions.

Two CUDA C++ kernels for Hopper (calib/csrc/) replace the JAX package's two
Pallas kernels (calib/kernels.py of the JAX package):

  * ``octav_many(xs, dynamic_sym)``: per tensor and sample row, the OCTAV
    MSE-optimal clip with the row's min and max, in one launch per size
    class (``octav_plan``) for a whole list of tensors (csrc/octav.cu);
    ``octav(x, dynamic_sym)`` is the same for one tensor;
  * ``bin_count(x, valid, scales, t, bins, out)``: the |x| binning fused
    into an exact histogram count (csrc/histogram.cu).

Each wrapper dispatches on the tensor's device only: a CPU tensor goes to
the plain PyTorch version beside it (``octav_reference``,
``bin_count_reference``), a CUDA tensor to the kernel, or the wrapper
raises.  There is no fallback from the kernel to the plain version.  Each
wrapper adds one to ``LAUNCHES`` where it launches its kernel, and nowhere
else."""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import torch

LAUNCHES = {"octav": 0, "bin_count": 0}
OCTAV_MAX_ITER = 20
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_DEFAULT_SMEM = 48 * 1024  # a block's shared memory without opt-in (kDefaultSmem)


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
# The shared memory arithmetic of csrc/octav.cu, for Hopper (sm_90).
SMEM_PER_BLOCK = 232_448      # the most shared memory one block may have
SMEM_PER_SM = 233_472         # one SM's shared memory (228 KB)
SMEM_RESERVED = 1024          # what the runtime reserves for each resident block
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
def _check_bin_count(x, valid, scales, t, bins, out):
    _check_rows(x, "bin_count")
    _same_device("bin_count", x, valid=valid, scales=scales, out=out)
    if valid.dtype != torch.float32 or valid.shape != (x.shape[0],):
        raise ValueError(f"bin_count: valid must be ({x.shape[0]},) float32")
    if scales.dtype != torch.float32 or scales.ndim != 1 or not 0 <= t < scales.shape[0]:
        raise ValueError(f"bin_count: scales must be (T,) float32 with 0 <= t < T (t={t})")
    if bins < 1 or out.dtype != torch.int64 or out.shape != (bins,) or not out.is_contiguous():
        raise ValueError(f"bin_count: out must be a contiguous ({bins},) int64 tensor")
    if not (valid.is_contiguous() and scales.is_contiguous()):
        raise ValueError("bin_count: valid and scales must be contiguous")


def bin_count(x: torch.Tensor, valid: torch.Tensor, scales: torch.Tensor, t: int,
              bins: int, out: torch.Tensor) -> torch.Tensor:
    """Add the histogram of ``min(int(|x| * scales[t]), bins - 1)`` over the
    rows of x (B, n) with ``valid > 0`` into ``out`` (bins,) int64."""
    _check_bin_count(x, valid, scales, t, bins, out)
    if x.device.type == "cpu":
        return bin_count_reference(x, valid, scales, t, bins, out)
    from .build import library
    lib = library()
    if x.shape[0] > 65535:
        raise ValueError(f"bin_count: at most 65535 rows per launch, got {x.shape[0]}")
    err = lib.bin_count_launch(x.data_ptr(), _DTYPE_CODE[x.dtype], valid.data_ptr(),
                               scales.data_ptr(), int(t), x.shape[0], x.shape[1], int(bins),
                               out.data_ptr(), _stream(x), x.device.index)
    if err != 0 and 4 * bins > _DEFAULT_SMEM:
        # beyond 48 KB the kernel asks for more shared memory, which the card refused
        raise ValueError(f"bin_count: {bins} bins need {4 * bins} bytes of shared memory, "
                         f"more than a block on this card may have (CUDA error {err})")
    _raise_on(err, "bin_count")
    LAUNCHES["bin_count"] += 1
    return out


def bin_count_reference(x: torch.Tensor, valid: torch.Tensor, scales: torch.Tensor,
                        t: int, bins: int, out: torch.Tensor) -> torch.Tensor:
    """Plain version of ``bin_count``: binning, then ``torch.bincount`` over
    the valid rows, in int64.  NaN counts in bucket 0 and +inf in bucket
    bins-1, as the kernel's saturating conversion does."""
    v = x[valid > 0].float().abs() * scales[t]
    v = torch.nan_to_num(v, nan=0.0).clamp(0, bins - 1)
    out += torch.bincount(v.to(torch.int64).reshape(-1), minlength=bins)
    return out
