"""The port's statistics kernels against the JAX package's Pallas kernels.

On the CPU the wrappers take the kernels' plain PyTorch versions, which are
held here against the Pallas kernels (interpret mode, as
tests/test_pallas_kernels.py runs them), the XLA fallback and numpy.  The
CUDA kernels themselves run only on the card: tests/test_torch_cuda.py and
chip_smoke.py hold them against the plain versions there.

Tolerances: OCTAV's s to rtol 1e-4 (f32 sums in another order; the fixed
point carries the rounding), min and max exact; histogram counts bit-exact
(the binning is one f32 multiply and a truncation in every version)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from dipoorlet_torch.calib import kernels as K

torch.set_num_threads(2)


def octav_numpy(x, dynamic_sym=False):
    abs_x = np.abs(x).ravel()
    data_min, data_max = x.min(), x.max()
    unsigned = 4 if (dynamic_sym and abs(data_min) < 1e-6) else 1
    s_n = abs_x.sum() / max((abs_x > 0).sum(), 1)
    for _ in range(20):
        gt = abs_x > s_n
        s_next = abs_x[gt].sum() / (1 / 4**8 / 3 / unsigned * (~gt).sum() + gt.sum())
        if abs(s_next - s_n) < 1e-6:
            s_n = s_next
            break
        s_n = s_next
    return s_n, data_min, data_max


def _rows(rng, b, n, relu):
    x = (rng.randn(b, n) * 2).astype(np.float32)
    if relu:
        x = np.maximum(x, 0)
        x[:, 0] = 0.0
    return x


@pytest.mark.parametrize("dynamic_sym", [False, True])
@pytest.mark.parametrize("n,relu", [(100, False), (1024, True), (5000, False), (3000, True)])
def test_octav_reference_matches_pallas_xla_and_numpy(n, relu, dynamic_sym):
    from dipoorlet_tpu.calib.kernels import octav_pallas
    from dipoorlet_tpu.calib.stats import make_octav_transform
    rng = np.random.RandomState(n + relu)
    x = _rows(rng, 3, n, relu)
    got = K.octav(torch.from_numpy(x), dynamic_sym).numpy()  # CPU -> plain version
    np.testing.assert_array_equal(got, K.octav_reference(torch.from_numpy(x), dynamic_sym))
    xla = make_octav_transform(dynamic_sym, allow_pallas=False)
    for r in range(x.shape[0]):
        with pltpu.force_tpu_interpret_mode():
            pallas = [float(v) for v in octav_pallas(jnp.asarray(x[r]), dynamic_sym)]
        fallback = [float(v) for v in xla("t", jnp.asarray(x[r]))]
        for ref in (pallas, fallback, octav_numpy(x[r], dynamic_sym)):
            np.testing.assert_allclose(got[r, 0], ref[0], rtol=1e-4)
            assert got[r, 1] == ref[1] and got[r, 2] == ref[2]


def test_octav_reference_bf16_rows_match_f32_of_the_same_values():
    rng = np.random.RandomState(3)
    x = torch.from_numpy(_rows(rng, 4, 2000, False)).to(torch.bfloat16)
    np.testing.assert_array_equal(K.octav_reference(x, False),
                                  K.octav_reference(x.float(), False))


def test_octav_reference_reports_iterations_and_freezes_converged_rows():
    rng = np.random.RandomState(4)
    x = torch.from_numpy(_rows(rng, 5, 777, True))
    out, iters = K.octav_reference(x, True, return_iterations=True)
    assert iters.dtype == torch.int64 and (iters >= 1).all() and (iters <= 20).all()
    for r in range(5):  # each row alone gives the same s: no cross-row coupling
        np.testing.assert_array_equal(out[r], K.octav_reference(x[r:r + 1], True)[0])


@pytest.mark.parametrize("dynamic_sym", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_octav_many_matches_per_tensor_reference_and_the_jax_package(dtype, dynamic_sym):
    """A ragged list in one call: on the CPU each tensor's rows equal
    ``octav_reference`` on that tensor bit for bit, and the JAX package's
    Pallas kernel and XLA fallback on the same (f32) values within rtol 1e-4."""
    from dipoorlet_tpu.calib.kernels import octav_pallas
    from dipoorlet_tpu.calib.stats import make_octav_transform
    rng = np.random.RandomState(11 + dynamic_sym)
    xs = [torch.from_numpy(_rows(rng, 2, n, relu=bool(i % 2))).to(dtype)
          for i, n in enumerate((1, 3, 512, 1000, 4099))]
    got = K.octav_many(xs, dynamic_sym)
    assert got.shape == (len(xs), 2, 3) and got.dtype == torch.float32
    np.testing.assert_array_equal(got, torch.stack([K.octav_reference(x, dynamic_sym)
                                                    for x in xs]))
    xla = make_octav_transform(dynamic_sym, allow_pallas=False)
    for x, g in zip(xs, got.numpy()):
        for r, row in enumerate(x.float().numpy()):
            with pltpu.force_tpu_interpret_mode():
                pallas = [float(v) for v in octav_pallas(jnp.asarray(row), dynamic_sym)]
            fallback = [float(v) for v in xla("t", jnp.asarray(row))]
            for ref in (pallas, fallback):
                np.testing.assert_allclose(g[r, 0], ref[0], rtol=1e-4)
                assert g[r, 1] == ref[1] and g[r, 2] == ref[2]


# ResNet-18@224's 50 tapped tensors (elements per sample, count), as
# chip_smoke.py's model phase finds them
RESNET18_224 = {802816: 2, 200704: 11, 150528: 1, 100352: 11, 50176: 11, 25088: 11, 1000: 1,
                512: 2}


def _resnet18_sizes(dtype):
    return [(n, dtype) for n, count in RESNET18_224.items() for _ in range(count)]


def _block_split(n, chunk, cluster, held):
    """(elements kept in shared memory, elements re-read each iteration) for
    each block of a cluster, as csrc/octav.cu splits a row."""
    split = []
    for rank in range(cluster):
        lo = min(rank * chunk, n)
        length = min(chunk, n - lo)
        split.append((min(length, held), length - min(length, held)))
    return split


def _random_sizes():
    rng = np.random.RandomState(5)
    ns = np.exp(rng.uniform(0, np.log(5e6), 150)).astype(int) + 1
    return [(int(n), (torch.float32, torch.bfloat16)[rng.randint(2)]) for n in ns]


@pytest.mark.parametrize("sizes", [_resnet18_sizes(torch.bfloat16),
                                   _resnet18_sizes(torch.float32), _random_sizes()],
                         ids=["resnet18-bf16", "resnet18-f32", "random"])
def test_octav_plan_invariants(sizes):
    plan = K.octav_plan(sizes)
    placed = sorted(i for launch in plan for i in launch.entries)
    assert placed == list(range(len(sizes)))  # every entry in exactly one launch
    for launch in plan:
        assert launch.cluster in K.OCTAV_CLUSTERS and launch.cluster <= 8
        assert 1 <= len(launch.entries) <= K.OCTAV_MAX_ENTRIES
        assert launch.smem_bytes + K.OCTAV_STATIC_SMEM <= 232_448
        block = launch.smem_bytes + K.OCTAV_STATIC_SMEM + K.SMEM_RESERVED
        assert launch.per_sm * block <= K.SMEM_PER_SM
        elem = torch.tensor([], dtype=launch.dtype).element_size()
        assert launch.held * elem + K.OCTAV_ALIGN <= launch.smem_bytes
        for i, chunk in zip(launch.entries, launch.chunks):
            n, dtype = sizes[i]
            assert dtype == launch.dtype
            split = _block_split(n, chunk, launch.cluster, launch.held)
            assert sum(on + reread for on, reread in split) == n
            assert all(on <= launch.held for on, _ in split)
            # a row re-reads only when 8 blocks cannot hold it
            assert not any(r for _, r in split) or launch.cluster == 8
            if launch.cluster > 1:  # the smallest cluster that holds the row
                half = K.octav_chunk(n, launch.cluster // 2)
                assert half * elem + K.OCTAV_ALIGN + K.OCTAV_STATIC_SMEM > 232_448


def test_octav_plan_classes_at_resnet18():
    """bf16: 802,816 elements on clusters of 8, 200,704 and 150,528 on 2,
    100,352 on one block alone on its SM, the 25 smaller rows two blocks to
    an SM; f32 re-reads only the 802,816-element rows."""
    bf16 = [(launch.cluster, launch.per_sm, len(launch.entries))
            for launch in K.octav_plan(_resnet18_sizes(torch.bfloat16))]
    assert bf16 == [(8, 1, 2), (2, 1, 12), (1, 1, 11), (1, 2, 25)]
    sizes = _resnet18_sizes(torch.float32)
    reread = {sizes[i][0] for launch in K.octav_plan(sizes)
              for i, chunk in zip(launch.entries, launch.chunks)
              if any(r for _, r in _block_split(sizes[i][0], chunk, launch.cluster,
                                                       launch.held))}
    assert reread == {802816}


def _binned(x, scale, bins):
    """The JAX package's binning (stats.py:435-442) in numpy f32."""
    v = np.abs(x.astype(np.float32)) * np.float32(scale)
    return np.clip(v.astype(np.int32), 0, bins - 1)


@pytest.mark.parametrize("n,bins", [(500, 128), (4096, 2048), (9000, 2048), (64, 7)])
def test_bin_count_reference_matches_pallas_and_bincount(n, bins):
    from dipoorlet_tpu.calib.kernels import histogram_pallas
    rng = np.random.RandomState(n + bins)
    b = 4
    x = _rows(rng, b, n, relu=bool(n % 2))
    valid = np.ones(b, np.float32)
    valid[2] = 0.0  # a masked (padded) sample
    amax = np.abs(x[valid > 0]).max()
    scales = np.array([0.5, bins / amax], np.float32)
    idx = _binned(x, scales[1], bins)
    idx_masked = np.where(valid[:, None] > 0, idx, -1).ravel()
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(histogram_pallas(jnp.asarray(idx_masked), bins))
    numpy_ref = np.bincount(idx_masked[idx_masked >= 0], minlength=bins)
    out = torch.zeros(bins, dtype=torch.int64)
    got = K.bin_count(torch.from_numpy(x), torch.from_numpy(valid), torch.from_numpy(scales),
                      1, bins, out)
    assert got is out  # accumulates in place
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(got.numpy(), numpy_ref)
    # a second call adds, in int64
    K.bin_count(torch.from_numpy(x), torch.from_numpy(valid), torch.from_numpy(scales),
                1, bins, out)
    np.testing.assert_array_equal(out.numpy(), 2 * numpy_ref)


def test_bin_count_reference_bf16_and_non_finite_values():
    """bf16 rows bin as their f32 values; NaN counts in bucket 0 and +-inf in
    bucket bins-1, as the kernel's saturating conversion and XLA's
    clip(int32(.)) do."""
    bins = 16
    x = torch.tensor([[0.0, 1.0, 2.5, float("nan"), float("inf"), -float("inf"), 100.0]])
    valid = torch.ones(1)
    scales = torch.tensor([2.0])
    got = K.bin_count_reference(x, valid, scales, 0, bins, torch.zeros(bins, dtype=torch.int64))
    want = np.zeros(bins, np.int64)
    for v in (0, 2, 5, 0, bins - 1, bins - 1, bins - 1):
        want[v] += 1
    np.testing.assert_array_equal(got.numpy(), want)
    xla = np.asarray(jnp.clip((jnp.abs(jnp.asarray(x.numpy()[0])) * 2.0).astype(jnp.int32),
                              0, bins - 1))
    np.testing.assert_array_equal(np.bincount(xla, minlength=bins), want)
    xb = torch.randn(3, 300).to(torch.bfloat16)
    a = K.bin_count_reference(xb, torch.ones(3), scales, 0, bins, torch.zeros(bins, dtype=torch.int64))
    b = K.bin_count_reference(xb.float(), torch.ones(3), scales, 0, bins,
                              torch.zeros(bins, dtype=torch.int64))
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def _ragged_hist_inputs(rng, dtype, b=3):
    """A ragged list of (b, n) tensors with post-ReLU and signed rows, NaN
    and +-inf in some rows, one masked row, and one scale per tensor."""
    xs = []
    for i, n in enumerate((1, 3, 512, 1000, 4099, 9000)):
        x = _rows(rng, b, n, relu=bool(i % 2))
        x[0, rng.randint(n)] = np.nan
        x[b - 1, rng.randint(n)] = np.inf
        x[b - 1, rng.randint(n)] = -np.inf
        xs.append(torch.from_numpy(x).to(dtype))
    valid = np.ones(b, np.float32)
    valid[1] = 0.0
    amax = [np.nanmax(np.where(np.isinf(x.float().numpy()), 0, np.abs(x.float().numpy())))
            for x in xs]
    scales = np.array([257 / a if a > 0 else 0.0 for a in amax], np.float32)
    return xs, torch.from_numpy(valid), torch.from_numpy(scales)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bin_count_many_matches_per_tensor_reference_and_the_jax_package(dtype):
    """A ragged list in one call: on the CPU each tensor's counts equal
    ``bin_count_reference`` on that tensor bit for bit, and the JAX
    package's Pallas histogram (interpret mode) and ``np.bincount`` over the
    indices XLA's binning gives for the same (f32) values."""
    from dipoorlet_tpu.calib.kernels import histogram_pallas
    bins = 300
    xs, valid, scales = _ragged_hist_inputs(np.random.RandomState(21), dtype)
    out = torch.full((len(xs), bins), 5, dtype=torch.int64)  # added into
    got = K.bin_count_many(xs, valid, scales, bins, out)
    assert got is out
    for i, x in enumerate(xs):
        want = K.bin_count_reference(x, valid, scales, i, bins,
                                     torch.full((bins,), 5, dtype=torch.int64))
        np.testing.assert_array_equal(got[i].numpy(), want.numpy())
        v = jnp.asarray(x.float().numpy())
        idx = np.asarray(jnp.clip((jnp.abs(v) * scales[i].item()).astype(jnp.int32), 0, bins - 1))
        idx = np.where(valid.numpy()[:, None] > 0, idx, -1).ravel().astype(np.int32)
        with pltpu.force_tpu_interpret_mode():
            pallas = np.asarray(histogram_pallas(jnp.asarray(idx), bins))
        np.testing.assert_array_equal(got[i].numpy() - 5, pallas)
        np.testing.assert_array_equal(got[i].numpy() - 5,
                                      np.bincount(idx[idx >= 0], minlength=bins))
        assert int(got[i].sum()) - 5 * bins == 2 * x.shape[1]  # two valid rows counted


def _plan_tiles(launch, sizes, batch):
    """The tiles each block of a launch counts, as csrc/histogram.cu walks
    them: (block, entry, row, first element, end) for every part of a row
    of an entry that falls in the block's range."""
    tiles = []
    for block in range(launch.grid):
        lo = block * launch.per_block
        hi = min(lo + launch.per_block, launch.total)
        for i, first in zip(launch.entries, launch.firsts):
            n = sizes[i][0]
            a, z = max(lo - first, 0), min(hi - first, batch * n)
            row = a // n if a < z else batch
            while row * n < z:
                tiles.append((block, i, row, max(a, row * n) - row * n,
                              min(z, (row + 1) * n) - row * n))
                row += 1
    return tiles


def _random_hist_sizes():
    rng = np.random.RandomState(8)
    ns = np.exp(rng.uniform(0, np.log(3e6), 140)).astype(int) + 1
    return [(int(n), (torch.float32, torch.bfloat16)[rng.randint(2)]) for n in ns]


@pytest.mark.parametrize("sms", [132, 114, 8])  # H100 SXM, H100 PCIe, a small card
@pytest.mark.parametrize("sizes,batch,bins", [
    (_resnet18_sizes(torch.bfloat16), 16, 2048), (_resnet18_sizes(torch.float32), 16, 2048),
    (_random_hist_sizes(), 16, 2048), (_random_hist_sizes()[:90], 3, 7),
    ([(1, torch.float32), (3, torch.bfloat16), (4099, torch.bfloat16)], 1, 8192),
    (_random_hist_sizes()[:20], 2, 58112)],
    ids=["resnet18-bf16", "resnet18-f32", "random", "random-7-bins", "tiny-8192-bins",
         "random-58112-bins"])
def test_bin_count_plan_invariants(sizes, batch, bins, sms):
    plan = K.bin_count_plan(sizes, batch, bins, sms)
    placed = sorted(i for launch in plan for i in launch.entries)
    assert placed == list(range(len(sizes)))  # every entry in exactly one launch
    dtypes = {dtype for _, dtype in sizes}
    assert len(plan) == sum(-(-sum(d == dtype for _, d in sizes) // K.BIN_COUNT_MAX_ENTRIES)
                            for dtype in dtypes)
    # the load ring where it fits beside the histogram
    depth = K.BIN_COUNT_DEPTH if K.BIN_COUNT_RING_BYTES + bins * 4 <= 232_448 else 0
    for launch in plan:
        assert 1 <= len(launch.entries) <= K.BIN_COUNT_MAX_ENTRIES
        assert {sizes[i][1] for i in launch.entries} == {launch.dtype}
        assert launch.depth == depth
        assert launch.smem_bytes == depth * K.BIN_COUNT_THREADS * 16 + bins * 4 <= 232_448
        assert launch.total == sum(batch * sizes[i][0] for i in launch.entries)
        assert 1 <= launch.per_block < 2 ** 31  # the kernel's int32 shared counts
        assert launch.grid * launch.per_block >= launch.total > (launch.grid - 1) * launch.per_block
        # every (entry, row, element) in exactly one tile
        tiles = _plan_tiles(launch, sizes, batch)
        covered = {}
        for _, i, row, c0, c1 in tiles:
            assert 0 <= c0 < c1 <= sizes[i][0]
            covered.setdefault((i, row), []).append((c0, c1))
        assert set(covered) == {(i, r) for i in launch.entries for r in range(batch)}
        for (i, _), parts in covered.items():
            parts.sort()
            assert parts[0][0] == 0 and parts[-1][1] == sizes[i][0]
            assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
        # the cost model: one flush per (block, entry) pair whose ranges meet
        flushes = len({(block, i) for block, i, *_ in tiles})
        assert launch.flushes == flushes <= launch.grid + len(launch.entries) - 1
        # the grid fills the card unless a block would count fewer than 16
        # elements per shared counter
        per_sm = min(K.BIN_COUNT_BLOCKS_PER_SM, K.SMEM_PER_SM // (launch.smem_bytes + 1024))
        assert launch.grid <= sms * per_sm or launch.per_block == 2 ** 31 - 1
        assert (launch.grid >= sms * per_sm
                or launch.per_block == K.BIN_COUNT_WORK_PER_COUNTER * bins)


def test_bin_count_plan_at_resnet18():
    """bf16 at 2048 bins: one launch of 264 blocks (2 per SM) for all 50
    tensors, 313 flushes, so at most 641,024 global atomics per batch.  A
    grid of 64K-element blocks takes 1,440 blocks and, with the tensors in
    this order, 1,472 flushes.  A
    block's shared memory holds the 64 KB load ring and up to 41,728 bins,
    and without the ring up to 58,112."""
    sizes = _resnet18_sizes(torch.bfloat16)
    (launch,) = K.bin_count_plan(sizes, 16, 2048)
    assert (len(launch.entries), launch.grid, launch.flushes) == (50, 264, 313)
    assert launch.flushes * 2048 <= 1_000_000
    assert launch.depth == K.BIN_COUNT_DEPTH
    (fixed,) = K.bin_count_plan(sizes, 16, 2048, per_block=1 << 16)
    assert (fixed.per_block, fixed.grid, fixed.flushes) == (1 << 16, 1440, 1472)
    assert fixed.flushes == len({(block, i) for block, i, *_ in _plan_tiles(fixed, sizes, 16)})
    ring = K.bin_count_plan([(10, torch.float32)], 1, 41728)[0]
    assert (ring.depth, ring.smem_bytes) == (K.BIN_COUNT_DEPTH, 232_448)
    no_ring = K.bin_count_plan([(10, torch.float32)], 1, 41729)[0]
    assert (no_ring.depth, no_ring.smem_bytes) == (0, 41729 * 4)
    assert K.bin_count_plan([(10, torch.float32)], 1, 58112)[0].smem_bytes == 232_448
    with pytest.raises(ValueError, match="58113 bins"):
        K.bin_count_plan([(10, torch.float32)], 1, 58113)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int32])
def test_wrappers_refuse_unsupported_dtypes(dtype):
    x = torch.ones(2, 8, dtype=dtype)
    with pytest.raises(TypeError):
        K.octav(x, False)
    with pytest.raises(TypeError):
        K.octav_many([torch.ones(2, 8), x], False)
    with pytest.raises(TypeError):
        K.bin_count(x, torch.ones(2), torch.ones(1), 0, 4, torch.zeros(4, dtype=torch.int64))
    with pytest.raises(TypeError):
        K.bin_count_many([torch.ones(2, 8), x], torch.ones(2), torch.ones(2), 4,
                         torch.zeros(2, 4, dtype=torch.int64))


def test_wrappers_refuse_bad_shapes_and_layouts():
    x = torch.ones(4, 8)
    with pytest.raises(ValueError):
        K.octav(x.t(), False)  # not contiguous
    with pytest.raises(ValueError):
        K.octav(torch.ones(8), False)  # not (B, n)
    with pytest.raises(ValueError):
        K.octav(torch.ones(0, 8), False)  # no rows
    with pytest.raises(ValueError):
        K.octav_many([], False)
    with pytest.raises(ValueError):
        K.octav_many([x, torch.ones(3, 8)], False)  # B differs
    out = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError):
        K.bin_count(x, torch.ones(3), torch.ones(1), 0, 4, out)  # valid length
    with pytest.raises(ValueError):
        K.bin_count(x, torch.ones(4), torch.ones(1), 1, 4, out)  # t out of range
    with pytest.raises(ValueError):
        K.bin_count(x, torch.ones(4), torch.ones(1), 0, 4, torch.zeros(4))  # out not int64


def test_bin_count_many_refuses_bad_shapes():
    xs = [torch.ones(4, 8), torch.ones(4, 3)]
    out = torch.zeros(2, 4, dtype=torch.int64)
    with pytest.raises(ValueError):
        K.bin_count_many([], torch.ones(4), torch.ones(0), 4, out)
    with pytest.raises(ValueError):
        K.bin_count_many([xs[0], torch.ones(3, 3)], torch.ones(4), torch.ones(2), 4, out)  # B
    with pytest.raises(ValueError):
        K.bin_count_many(xs, torch.ones(4), torch.ones(3), 4, out)  # one scale per tensor
    with pytest.raises(ValueError):
        K.bin_count_many(xs, torch.ones(4), torch.ones(2), 4, torch.zeros(3, 4, dtype=torch.int64))
    with pytest.raises(ValueError):
        K.bin_count_many(xs, torch.ones(4), torch.ones(2), 4, torch.zeros(4, 2, dtype=torch.int64).t())
    with pytest.raises(ValueError):
        K.bin_count_many([xs[0].t()], torch.ones(8), torch.ones(1), 4, out[:1])  # not contiguous


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    K.reset_launches()
    x = torch.rand(2, 50)
    K.octav(x, False)
    K.octav_many([x, torch.rand(2, 7).to(torch.bfloat16)], True)
    K.bin_count(x, torch.ones(2), torch.ones(1), 0, 8, torch.zeros(8, dtype=torch.int64))
    K.bin_count_many([x, x.to(torch.bfloat16)], torch.ones(2), torch.ones(2), 8,
                     torch.zeros(2, 8, dtype=torch.int64))
    assert K.LAUNCHES == {"octav": 0, "bin_count": 0}
