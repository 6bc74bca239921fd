"""The port's StatsRunner against dipoorlet_tpu's, in f32 on the CPU, on
ResNet-18 at 32x32 with 10 classes: 10 samples in batches of 4, so the last
batch is partial and its padded samples are masked.

The port's weights are the JAX executor's own ``init_params()``, carried
across by ``params_from_numpy``.  Tolerances: min/max to rtol 1e-5 (XLA and
PyTorch CPU convolutions round differently, ~1e-6 relative); OCTAV's s sum
to rtol 1e-4 (its fixed point carries that rounding); histogram counts
exact for the network input (identical data) and, for computed tensors,
equal in total with at most 0.1% of the counts moved to a neighbouring bin
(a value within rounding of a bin edge, ROADMAP queue 3)."""
import os
from argparse import Namespace

import numpy as np
import pytest
import torch

from dipoorlet_torch.calib.stats import StatsRunner
from dipoorlet_torch.graph import GraphIR
from dipoorlet_torch.runtime import Executor, params_from_numpy
from dipoorlet_torch.runtime.data import CalibDataset, make_synthetic_dataset
from dipoorlet_torch.utils.export import export

torch.set_num_threads(2)
N, BATCH, BINS = 10, 4, 256


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from torch_export import MODEL_ZOO
    from dipoorlet_tpu.calib.stats import StatsRunner as JaxStatsRunner
    from dipoorlet_tpu.graph import GraphIR as JaxGraphIR
    from dipoorlet_tpu.runtime import Executor as JaxExecutor
    ws = tmp_path_factory.mktemp("stats")
    torch.manual_seed(0)
    export(MODEL_ZOO["resnet18"](num_classes=10), torch.randn(1, 3, 32, 32), str(ws / "m.onnx"))
    make_synthetic_dataset(str(ws / "data"), {"input": [1, 3, 32, 32]}, N, seed=1)
    jex = JaxExecutor(JaxGraphIR.load(str(ws / "m.onnx")))
    jparams = jex.init_params()
    ex = Executor(GraphIR.load(str(ws / "m.onnx")))
    assert ex.param_names == jex.param_names
    ds = CalibDataset(str(ws / "data"), ex.input_shapes(), N)
    return dict(ex=ex, params=params_from_numpy(jparams, "cpu"), ds=ds,
                jax=JaxStatsRunner(jex), jparams=jparams)


def _assert_hists_close(got, ref):
    assert set(got) == set(ref)
    for name in ref:
        g, r = np.asarray(got[name]), np.asarray(ref[name])
        assert g.dtype == np.int64 and g.shape == (BINS,)
        assert g.sum() == r.sum(), name
        if name == "input":
            np.testing.assert_array_equal(g, r)
        else:
            assert np.abs(g - r).sum() <= 2 * max(1, int(1e-3 * r.sum())), name


def _assert_minmax_close(got, ref):
    assert list(got) == list(ref)
    for name in ref:
        np.testing.assert_allclose([got[name]["min"], got[name]["max"]],
                                   [ref[name]["min"], ref[name]["max"]], rtol=1e-5, atol=1e-7)


def test_minmax_matches_jax(setup):
    runner = StatsRunner(setup["ex"], device="cpu")
    got = runner.run_minmax(setup["params"], setup["ds"], batch_size=BATCH)
    ref = setup["jax"].run_minmax(setup["jparams"], setup["ds"], batch_size=BATCH)
    assert len(got) == 50
    _assert_minmax_close(got, ref)
    # a sub-range and numpy weights give the same as the JAX package too
    got = runner.run_minmax(setup["ex"].init_params(), setup["ds"], batch_size=3, start=2, end=9)
    ref = setup["jax"].run_minmax(setup["jparams"], setup["ds"], batch_size=3, start=2, end=9)
    _assert_minmax_close(got, ref)


def test_hist_and_fused_minmax_hist_match_jax(setup):
    runner = StatsRunner(setup["ex"], device="cpu")
    mm = setup["jax"].run_minmax(setup["jparams"], setup["ds"], batch_size=BATCH)
    got = runner.run_hist(setup["params"], setup["ds"], mm, BINS, batch_size=BATCH)
    ref = setup["jax"].run_hist(setup["jparams"], setup["ds"], mm, BINS, batch_size=BATCH)
    _assert_hists_close(got, ref)
    for name, h in got.items():  # 10 samples counted, padded ones masked
        assert h.sum() == N * int(np.prod(setup["ex"].graph.get_tensor_shape(name)))
    stats, hists = runner.run_minmax_hist(setup["params"], setup["ds"], BINS, batch_size=BATCH)
    jstats, jhists = setup["jax"].run_minmax_hist(setup["jparams"], setup["ds"], BINS,
                                                  batch_size=BATCH)
    _assert_minmax_close(stats, jstats)
    _assert_hists_close(hists, jhists)
    # the fused pass bins exactly as the two-pass API does on the CPU
    two_pass = runner.run_hist(setup["params"], setup["ds"], stats, BINS, batch_size=BATCH)
    for name in hists:
        np.testing.assert_array_equal(hists[name], two_pass[name])


@pytest.mark.parametrize("dynamic_sym", [False, True])
def test_octav_matches_jax(setup, dynamic_sym):
    runner = StatsRunner(setup["ex"], device="cpu")
    got = runner.run_octav(setup["params"], setup["ds"], dynamic_sym, batch_size=BATCH)
    ref = setup["jax"].run_octav(setup["jparams"], setup["ds"], dynamic_sym, batch_size=BATCH)
    assert list(got) == list(ref)
    for name in ref:
        assert got[name]["count"] == ref[name]["count"] == N
        np.testing.assert_allclose(got[name]["s_sum"], ref[name]["s_sum"], rtol=1e-4)
        np.testing.assert_allclose([got[name]["min"], got[name]["max"]],
                                   [ref[name]["min"], ref[name]["max"]], rtol=1e-5, atol=1e-7)


def test_tap_chunks_give_the_same_statistics(setup):
    whole = StatsRunner(setup["ex"], device="cpu")
    chunked = StatsRunner(setup["ex"], device="cpu", tap_chunk=7)
    assert len(chunked._sub_runners()) == 8
    a = whole.run_octav(setup["params"], setup["ds"], False, batch_size=BATCH)
    b = chunked.run_octav(setup["params"], setup["ds"], False, batch_size=BATCH)
    assert a == b
    sa, ha = whole.run_minmax_hist(setup["params"], setup["ds"], BINS, batch_size=BATCH)
    sb, hb = chunked.run_minmax_hist(setup["params"], setup["ds"], BINS, batch_size=BATCH)
    assert sa == sb
    for name in ha:
        np.testing.assert_array_equal(ha[name], hb[name])


@pytest.mark.parametrize("tap_chunk,calls,most", [(None, 3, 50), (7, 8 * 3, 7)])
def test_run_octav_makes_one_octav_many_call_per_batch(setup, monkeypatch, tap_chunk, calls,
                                                       most):
    """One call per batch over all the runner's tensors: 3 batches of the
    50 tensors, or 3 for each of the 8 tap chunks (at most 7 tensors)."""
    from dipoorlet_torch.calib import stats
    octav_many, seen = stats.octav_many, []

    def counting(xs, dynamic_sym):
        seen.append(len(xs))
        return octav_many(xs, dynamic_sym)
    monkeypatch.setattr(stats, "octav_many", counting)
    runner = StatsRunner(setup["ex"], device="cpu", tap_chunk=tap_chunk)
    got = runner.run_octav(setup["params"], setup["ds"], True, batch_size=BATCH)
    assert len(seen) == calls and max(seen) == most and sum(seen) == 50 * 3
    assert len(got) == 50


@pytest.mark.parametrize("tap_chunk,calls,most", [(None, 3, 50), (7, 8 * 3, 7)])
def test_hist_pass_makes_one_bin_count_many_call_per_batch(setup, monkeypatch, tap_chunk, calls,
                                                           most):
    """The fused minmax->hist pass counts every tensor of a batch in one call:
    3 batches of the 50 tensors, or 3 for each of the 8 tap chunks."""
    from dipoorlet_torch.calib import stats
    bin_count_many, seen = stats.bin_count_many, []

    def counting(xs, valid, scales, bins, out):
        assert out.shape == (len(xs), bins) and scales.shape == (len(xs),)
        seen.append(len(xs))
        return bin_count_many(xs, valid, scales, bins, out)
    monkeypatch.setattr(stats, "bin_count_many", counting)
    runner = StatsRunner(setup["ex"], device="cpu", tap_chunk=tap_chunk)
    _, hists = runner.run_minmax_hist(setup["params"], setup["ds"], BINS, batch_size=BATCH)
    assert len(seen) == calls and max(seen) == most and sum(seen) == 50 * 3
    assert len(hists) == 50


def test_bf16_statistics_stay_close_to_f32(setup):
    """bf16 forwards round activations to 8 mantissa bits; the ranges move by
    well under 2% (the JAX package documents <1% on ResNet-18)."""
    f32 = StatsRunner(setup["ex"], device="cpu").run_minmax(setup["params"], setup["ds"],
                                                            batch_size=BATCH)
    bf16 = StatsRunner(setup["ex"], device="cpu", compute_dtype=torch.bfloat16).run_minmax(
        setup["params"], setup["ds"], batch_size=BATCH)
    for name in f32:
        amax = max(-f32[name]["min"], f32[name]["max"])
        for key in ("min", "max"):
            assert abs(bf16[name][key] - f32[name][key]) <= 0.02 * amax, (name, key)


def test_runner_defaults_to_the_card(setup, monkeypatch):
    from dipoorlet_torch.device import NoCudaDevice
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDevice):
        StatsRunner(setup["ex"])


@pytest.mark.parametrize("algo", ["hist", "kl"])
def test_hist_and_kl_clip_values_match_jax(setup, algo):
    """The algorithm layer over the fused minmax->hist pass: the percentile
    walk and the KL search pick a bin, and a count moved across a bin edge
    may move that pick by one bin, so clip values agree to one bin width
    (data_max / bins), plus rtol 1e-5 for the range itself."""
    from dipoorlet_torch.calib.algorithms import tensor_cali_dispatcher
    from dipoorlet_tpu.calib.algorithms import tensor_cali_dispatcher as jax_dispatcher
    from dipoorlet_tpu.graph import GraphIR as JaxGraphIR
    ds = setup["ds"]
    args = Namespace(input_dir=ds.input_dir, data_num=N, batch_size=BATCH, bins=BINS,
                     threshold=0.999, deploy="trt", bf16_calib=False, stats_chunk=0,
                     act_quant=algo, device=torch.device("cpu"), mesh=None)
    got = tensor_cali_dispatcher(algo, setup["ex"].graph, args)
    model = os.path.join(setup["ex"].graph.base_dir, "m.onnx")
    ref = jax_dispatcher(algo, JaxGraphIR.load(model), args)
    assert set(got) == set(ref)
    for name, (lo, hi) in ref.items():
        width = max(-lo, hi) / BINS
        np.testing.assert_allclose(got[name], [lo, hi], rtol=1e-5, atol=width * 1.0001,
                                   err_msg=name)
