"""dipoorlet_torch on the card: the CUDA kernels against their plain
versions, the statistics on the card against the CPU, and the CLI without
--cpu.  Every test is marked ``cuda`` and skips where no CUDA device is
visible.  This file imports no JAX, so it also runs on a GPU host without
it, where the repo's conftest (which imports JAX) is left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: the histogram bit-exact; OCTAV's s to rtol 1e-4 with min/max
exact (f32 sums in another order); minmax clip values on the card against
the CPU to rtol 1e-4 (cuDNN and CPU convolutions round differently)."""
import json
import math
import os

import numpy as np
import pytest
import torch

from dipoorlet_torch import onnx_ir as oir
from dipoorlet_torch.calib import kernels as K

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run this file on the card)")
    from dipoorlet_torch.device import full_fp32_math
    full_fp32_math()
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [512, 50176, 802816])
def test_kernels_match_plain_versions(cuda_device, dtype, n):
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    x = torch.relu(torch.randn(16, n, generator=gen, device=cuda_device)).to(dtype)
    K.reset_launches()
    for dyn in (False, True):
        got, want = K.octav(x, dyn), K.octav_reference(x, dyn)
        torch.testing.assert_close(got[:, 0], want[:, 0], rtol=1e-4, atol=0)
        assert torch.equal(got[:, 1:], want[:, 1:])
    valid = torch.ones(16, device=cuda_device)
    valid[7] = 0
    scales = torch.stack([torch.ones((), device=cuda_device),
                          2048 / x.float().abs().amax()])
    zeros = torch.zeros(2048, dtype=torch.int64, device=cuda_device)
    a = K.bin_count(x, valid, scales, 1, 2048, zeros.clone())
    b = K.bin_count_reference(x, valid, scales, 1, 2048, zeros.clone())
    assert torch.equal(a, b) and int(a.sum()) == 15 * n
    assert K.LAUNCHES == {"octav": 2 * len(K.octav_plan([(n, dtype)])), "bin_count": 1}


# (n, dtype) that reach every class of the planner and the re-read path: an
# f32 row of 802,816 elements (more than 8 blocks hold), n that is not a
# multiple of the cluster's slices, n = 1 and n = 3
OCTAV_RAGGED = [(802816, torch.float32), (802817, torch.float32), (802816, torch.bfloat16),
                (200704, torch.float32), (200704, torch.bfloat16), (150531, torch.bfloat16),
                (100352, torch.float32), (100352, torch.bfloat16), (50176, torch.float32),
                (25088, torch.bfloat16), (4099, torch.float32), (1000, torch.bfloat16),
                (3, torch.float32), (1, torch.bfloat16), (1, torch.float32)]


@pytest.mark.parametrize("dynamic_sym", [False, True])
@pytest.mark.parametrize("relu", [False, True])
def test_octav_many_matches_plain_version_in_every_class(cuda_device, relu, dynamic_sym):
    plan = K.octav_plan(OCTAV_RAGGED)
    assert {launch.cluster for launch in plan} == {1, 2, 4, 8}
    assert {launch.per_sm for launch in plan} == {1, 2}
    assert any(max(launch.chunks) > launch.held for launch in plan)  # a row re-reads
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    xs = []
    for n, dtype in OCTAV_RAGGED:
        x = torch.randn(16, n, generator=gen, device=cuda_device) * 3.0
        x = torch.relu(x) if relu else x
        x[3] = 0.0  # an all-zero row
        xs.append(x.to(dtype))
    K.reset_launches()
    got = K.octav_many(xs, dynamic_sym)
    assert K.LAUNCHES["octav"] == len(plan)
    for x, g in zip(xs, got):
        want = K.octav_reference(x, dynamic_sym)
        torch.testing.assert_close(g[:, 0], want[:, 0], rtol=1e-4, atol=0)
        assert torch.equal(g[:, 1:], want[:, 1:])
        assert g[3].tolist() == [0.0, 0.0, 0.0]


def test_octav_many_runs_in_the_order_of_the_callers_stream(cuda_device):
    """The classes run on side streams: they start after the work already
    queued on the caller's stream and finish before the work queued next."""
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        x = torch.randn(16, 802816, device=cuda_device).to(torch.bfloat16)
        xs = [x, x[:, :200704].contiguous(), x[:, :1000].contiguous()]
        assert len(K.octav_plan([(t.shape[1], t.dtype) for t in xs])) == 3
        got = K.octav_many(xs, True).clone()
    stream.synchronize()
    for t, g in zip(xs, got):
        want = K.octav_reference(t, True)
        torch.testing.assert_close(g[:, 0], want[:, 0], rtol=1e-4, atol=0)
        assert torch.equal(g[:, 1:], want[:, 1:])


# Row lengths that start rows at every alignment (4,099, 3, 7, 1,000), n = 1,
# and few enough elements beside the large rows that, at 7 or 128 bins, a
# block's range crosses rows and entries
HIST_RAGGED = [4099, 3, 1, 512, 1000, 25088, 802816, 7, 9000, 1, 200704]


# 41,729 and 58,112 bins leave no room for the load ring: the kernel loads
# without it
@pytest.mark.parametrize("bins", [7, 128, 2048, 8192, 41729, 58112])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bin_count_many_matches_plain_version(cuda_device, dtype, bins):
    """Bit for bit against bin_count_reference per tensor, with NaN and +-inf
    values, one masked sample, and a batch with every sample masked."""
    gen = torch.Generator(device=cuda_device).manual_seed(bins)
    xs = []
    for i, n in enumerate(HIST_RAGGED):
        x = torch.randn(16, n, generator=gen, device=cuda_device) * 3.0
        x = torch.relu(x) if i % 2 else x
        x[2, n // 2] = float("nan")
        x[9, n - 1] = float("inf")
        x[11, 0] = -float("inf")
        xs.append(x.to(dtype))
    scales = torch.rand(len(xs), generator=gen, device=cuda_device) * bins / 4
    plan = K.bin_count_plan([(x.shape[1], x.dtype) for x in xs], 16, bins,
                            torch.cuda.get_device_properties(0).multi_processor_count)
    assert plan[0].depth == (K.BIN_COUNT_DEPTH if bins <= 41728 else 0)
    if bins <= 128:  # some block counts parts of several entries
        assert plan[0].flushes > plan[0].grid
    for masked in (list(range(16)), [7]):
        valid = torch.ones(16, device=cuda_device)
        valid[masked] = 0
        out = torch.full((len(xs), bins), 3, dtype=torch.int64, device=cuda_device)
        K.reset_launches()
        K.bin_count_many(xs, valid, scales, bins, out)
        assert K.LAUNCHES["bin_count"] == len(plan) == 1
        for i, x in enumerate(xs):
            want = K.bin_count_reference(x, valid, scales, i, bins,
                                         torch.full((bins,), 3, dtype=torch.int64,
                                                    device=cuda_device))
            assert torch.equal(out[i], want), (i, x.shape[1])
            assert int(out[i].sum()) - 3 * bins == (16 - len(masked)) * x.shape[1]


def test_bin_count_many_runs_in_the_order_of_the_callers_stream(cuda_device):
    """The launch goes on the caller's stream: it starts after the work
    already queued there and finishes before the work queued next."""
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        x = torch.relu(torch.randn(16, 802816, device=cuda_device)).to(torch.bfloat16)
        xs = [x, x[:, :200704].contiguous(), x[:, :1000].contiguous()]
        valid = torch.ones(16, device=cuda_device)
        valid[5] = 0
        scales = torch.full((3,), 400.0, device=cuda_device)
        out = torch.zeros(3, 2048, dtype=torch.int64, device=cuda_device)
        K.bin_count_many(xs, valid, scales, 2048, out)
        got = out.clone()
    stream.synchronize()
    for i, t in enumerate(xs):
        want = K.bin_count_reference(t, valid, scales, i, 2048,
                                     torch.zeros(2048, dtype=torch.int64, device=cuda_device))
        assert torch.equal(got[i], want)


def test_kernels_raise_instead_of_falling_back(cuda_device):
    x = torch.rand(4, 100, device=cuda_device)
    with pytest.raises(ValueError):  # mixed devices
        K.bin_count(x, torch.ones(4), torch.ones(1, device=cuda_device), 0, 8,
                    torch.zeros(8, dtype=torch.int64, device=cuda_device))
    with pytest.raises(ValueError, match="58113 bins"):  # more than a block's shared memory
        K.bin_count(x, torch.ones(4, device=cuda_device), torch.ones(1, device=cuda_device), 0,
                    58113, torch.zeros(58113, dtype=torch.int64, device=cuda_device))


def _two_conv_model(path):
    rng = np.random.RandomState(1)
    w1 = oir.array_to_tensor((rng.randn(8, 3, 3, 3) * 0.3).astype(np.float32), "w1")
    w2 = oir.array_to_tensor((rng.randn(4, 8, 3, 3) * 0.3).astype(np.float32), "w2")
    nodes = [oir.make_node("Conv", ["x", "w1"], ["c1"], name="conv1", kernel_shape=[3, 3],
                           pads=[1, 1, 1, 1]),
             oir.make_node("Relu", ["c1"], ["r1"], name="relu1"),
             oir.make_node("Conv", ["r1", "w2"], ["y"], name="conv2", kernel_shape=[3, 3],
                           pads=[1, 1, 1, 1])]
    graph = oir.make_graph(
        nodes, "g", [oir.make_tensor_value_info("x", oir.DataType.FLOAT, [1, 3, 16, 16])],
        [oir.make_tensor_value_info("y", oir.DataType.FLOAT, [1, 4, 16, 16])])
    graph.initializer = [w1, w2]
    oir.save_model(oir.make_model(graph), path)


@pytest.fixture
def workspace(cuda_device, tmp_path):
    from dipoorlet_torch.runtime.data import make_synthetic_dataset
    _two_conv_model(str(tmp_path / "m.onnx"))
    make_synthetic_dataset(str(tmp_path / "data"), {"x": [1, 3, 16, 16]}, 10, seed=2)
    return tmp_path


def test_statistics_on_the_card_match_the_cpu(workspace):
    from dipoorlet_torch.calib.stats import StatsRunner
    from dipoorlet_torch.graph import GraphIR
    from dipoorlet_torch.runtime import Executor
    from dipoorlet_torch.runtime.data import CalibDataset
    ex = Executor(GraphIR.load(str(workspace / "m.onnx")))
    ds = CalibDataset(str(workspace / "data"), ex.input_shapes(), 10)
    params = ex.init_params()
    card, cpu = StatsRunner(ex, device="cuda"), StatsRunner(ex, device="cpu")
    K.reset_launches()
    mm_g = card.run_minmax(params, ds, batch_size=4)
    mm_c = cpu.run_minmax(params, ds, batch_size=4)
    for name in mm_c:
        np.testing.assert_allclose([mm_g[name]["min"], mm_g[name]["max"]],
                                   [mm_c[name]["min"], mm_c[name]["max"]], rtol=1e-4)
    h_g = card.run_hist(params, ds, mm_c, 256, batch_size=4)
    h_c = cpu.run_hist(params, ds, mm_c, 256, batch_size=4)
    np.testing.assert_array_equal(h_g["x"], h_c["x"])  # the input itself: identical data
    for name in h_c:
        assert h_g[name].sum() == h_c[name].sum()
    o_g = card.run_octav(params, ds, True, batch_size=4)
    o_c = cpu.run_octav(params, ds, True, batch_size=4)
    for name in o_c:
        np.testing.assert_allclose(o_g[name]["s_sum"], o_c[name]["s_sum"], rtol=1e-3)
    batches = 3  # 10 samples in batches of 4
    octav_per_batch = len(K.octav_plan([(math.prod(ex.graph.get_tensor_shape(n)), torch.float32)
                                        for n in card.tensor_names]))
    hist_per_batch = len(K.bin_count_plan([(math.prod(ex.graph.get_tensor_shape(n)),
                                             torch.float32) for n in card.tensor_names], 4, 256))
    assert K.LAUNCHES == {"octav": octav_per_batch * batches,
                          "bin_count": hist_per_batch * batches}


def test_cli_runs_on_the_card_by_default(workspace):
    from dipoorlet_torch.__main__ import main
    from dipoorlet_torch.graph import GraphIR
    K.reset_launches()
    out = workspace / "out"
    main(["-M", str(workspace / "m.onnx"), "-I", str(workspace / "data"), "-O", str(out),
          "-N", "10", "--batch_size", "4", "-A", "mse", "-D", "trt"])
    graph = GraphIR.load(str(workspace / "m.onnx"))
    sizes = [(math.prod(graph.get_tensor_shape(n)), torch.bfloat16)  # bf16 statistics forwards
             for n in ("x", "c1", "r1", "y")]
    assert K.LAUNCHES["octav"] == 3 * len(K.octav_plan(sizes))
    blob = json.load(open(os.path.join(out, "trt_clip_val.json")))["blob_range"]
    assert set(blob) == {"x", "c1", "r1", "y"}
    cos = json.load(open(os.path.join(out, "model_res.json.rank0")))["y"][0]
    assert cos > 0.99
