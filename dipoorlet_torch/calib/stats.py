"""Activation statistics (the calibration hot path), on the device.

Counterpart of the JAX package's calib/stats.py.  Each pass runs the
batched forward (``torch.func.vmap`` over samples) with every tensor of
interest tapped; the taps leave the forward as (B, *shape) and the
statistics run on them outside the vmap:

  * minmax -> (min, max) per tensor, reduced on the device;
  * hist   -> a (bins,) int64 |x| histogram per tensor, counted straight
              from the activations by one ``bin_count_many`` call per batch
              over all the tapped tensors;
  * octav  -> the OCTAV fixed point per sample and tensor, by one
              ``octav_many`` call per batch over all the tapped tensors.

Cross-batch combination stays on the device (min/max/sum carries); a pass
syncs with the host once, when it returns.  Padded samples of a partial
last batch are masked with ``valid`` (``_pad_batch``), as in the JAX
package.  Histogram counts accumulate in int64 directly: the (hi, lo) int32
carry of the JAX package existed only because TPU jit has no int64."""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..device import select_device
from ..runtime.executor import Executor
from .kernels import bin_count_many, octav_many

_BIG = float(np.finfo(np.float32).max)


class StatsRunner:
    """Batched statistics forward over a GraphIR on one device.

    ``device`` defaults to the card (``select_device``); the CPU runs only
    when asked for.  ``compute_dtype`` (e.g. ``torch.bfloat16``) casts the
    float inputs and weights of the statistics forwards; the statistics
    themselves stay f32.  ``tap_chunk`` bounds the tensors tapped per pass
    (``--stats_chunk``)."""

    def __init__(self, executor: Executor, tensor_names: Optional[Sequence[str]] = None,
                 device=None, compute_dtype: Optional[torch.dtype] = None,
                 tap_chunk: Optional[int] = None):
        self.ex = executor
        self.tensor_names = list(tensor_names) if tensor_names is not None \
            else self.ex.all_tensor_names()
        self.device = torch.device(device) if device is not None else select_device()
        self.compute_dtype = compute_dtype
        self.tap_chunk = tap_chunk
        self._subrunners = None
        self._forward = self.ex.make_batched(taps=self.tensor_names, outputs=())

    def _sub_runners(self):
        if not self.tap_chunk or len(self.tensor_names) <= self.tap_chunk:
            return None
        if self._subrunners is None:
            c = int(self.tap_chunk)
            self._subrunners = [
                StatsRunner(self.ex, self.tensor_names[i:i + c], device=self.device,
                            compute_dtype=self.compute_dtype)
                for i in range(0, len(self.tensor_names), c)]
        return self._subrunners

    def _device_params(self, params) -> Dict[str, torch.Tensor]:
        """Weights (numpy arrays or tensors) on the runner's device, floating
        ones in the compute dtype."""
        out = {}
        for name, v in params.items():
            t = torch.tensor(v) if isinstance(v, np.ndarray) else v
            t = t.to(self.device)
            if self.compute_dtype is not None and t.is_floating_point():
                t = t.to(self.compute_dtype)
            out[name] = t
        return out

    @staticmethod
    def _pad_batch(batch, batch_size):
        """Pad to batch_size with repeats of the last sample; returns
        (padded_batch, valid_mask)."""
        n = next(iter(batch.values())).shape[0]
        valid = np.zeros(batch_size, np.float32)
        valid[:n] = 1.0
        if n == batch_size:
            return batch, valid
        out = {}
        for k, v in batch.items():
            pad = np.repeat(v[-1:], batch_size - n, axis=0)
            out[k] = np.concatenate([v, pad], axis=0)
        return out, valid

    def _batches(self, dataset, batch_size, start, end):
        """Yields (inputs on the device, valid (B,) f32 on the device, n_valid)."""
        for idx in dataset.iter_batches(batch_size, start, end):
            batch, valid = self._pad_batch(dataset.load_batch(idx), batch_size)
            inputs = {}
            for name, arr in batch.items():
                t = torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)
                # inputs DECLARED integer (token ids) keep their raw-f32
                # values: bf16 would round ids >= 256
                if self.compute_dtype is not None and name not in self.ex.integer_inputs:
                    t = t.to(self.compute_dtype)
                inputs[name] = t
            yield inputs, torch.from_numpy(valid).to(self.device), len(idx)

    def _taps(self, params, inputs):
        """{name: (B, n) contiguous} for every tapped tensor."""
        _, taps = self._forward(params, inputs)
        return {n: taps[n].reshape(taps[n].shape[0], -1).contiguous()
                for n in self.tensor_names}

    # -- minmax ------------------------------------------------------------
    @torch.no_grad()
    def _minmax_pass(self, params, dataset, batch_size, start, end):
        """Device (lo, hi) (T,) f32 carries, no host sync."""
        params = self._device_params(params)
        t = len(self.tensor_names)
        lo = torch.full((t,), _BIG, device=self.device)
        hi = torch.full((t,), -_BIG, device=self.device)
        for inputs, valid, _ in self._batches(dataset, batch_size, start, end):
            taps = self._taps(params, inputs)
            mins, maxs = zip(*(torch.aminmax(taps[n], dim=1) for n in self.tensor_names))
            keep = valid > 0
            lo = torch.minimum(lo, torch.where(keep, torch.stack(mins).float(), _BIG).amin(1))
            hi = torch.maximum(hi, torch.where(keep, torch.stack(maxs).float(), -_BIG).amax(1))
        return lo, hi

    def run_minmax(self, params, dataset, batch_size=32, start=0, end=None):
        """Returns {name: {'min': scalar, 'max': scalar}} reduced over samples."""
        subs = self._sub_runners()
        if subs:
            out = {}
            for r in subs:
                out.update(r.run_minmax(params, dataset, batch_size, start, end))
            return out
        lo, hi = self._minmax_pass(params, dataset, batch_size, start, end)
        lo, hi = lo.cpu().numpy(), hi.cpu().numpy()
        return {n: {"min": float(lo[i]), "max": float(hi[i])}
                for i, n in enumerate(self.tensor_names)}

    # -- histogram ---------------------------------------------------------
    @torch.no_grad()
    def _hist_pass(self, params, dataset, bins, scales, batch_size, start, end):
        """Device (T, bins) int64 counts of |x| binned by the device scales."""
        params = self._device_params(params)
        acc = torch.zeros((len(self.tensor_names), bins), dtype=torch.int64,
                          device=self.device)
        for inputs, valid, _ in self._batches(dataset, batch_size, start, end):
            taps = self._taps(params, inputs)
            bin_count_many([taps[n] for n in self.tensor_names], valid, scales, bins, acc)
        return acc

    def _hist_result(self, acc):
        acc = acc.cpu().numpy()
        return {n: acc[i] for i, n in enumerate(self.tensor_names)}

    def run_hist(self, params, dataset, stats_min_max, bins, batch_size=32, start=0, end=None):
        """Returns {name: (bins,) int64 summed histogram}."""
        subs = self._sub_runners()
        if subs:
            out = {}
            for r in subs:
                out.update(r.run_hist(params, dataset, stats_min_max, bins,
                                      batch_size, start, end))
            return out
        amax = np.array([max(stats_min_max[n]["max"], -stats_min_max[n]["min"])
                         for n in self.tensor_names], np.float32)
        scales = np.where(amax > 0, bins / amax, 0.0).astype(np.float32)
        acc = self._hist_pass(params, dataset, bins, torch.from_numpy(scales).to(self.device),
                              batch_size, start, end)
        return self._hist_result(acc)

    def run_minmax_hist(self, params, dataset, bins, batch_size=32, start=0, end=None):
        """Fused two-phase calibration: the minmax pass and the |x|-histogram
        pass with one host sync at the very end.  The binning scales are
        derived from the device minmax carry on the device, in f32, as
        ``where(amax > 0, bins / amax, 0)``.

        Returns (stats_min_max_dict, hists_dict)."""
        subs = self._sub_runners()
        if subs:
            stats, hists = {}, {}
            for r in subs:
                s, h = r.run_minmax_hist(params, dataset, bins, batch_size, start, end)
                stats.update(s)
                hists.update(h)
            return stats, hists
        lo, hi = self._minmax_pass(params, dataset, batch_size, start, end)
        amax = torch.maximum(hi, -lo)
        scales = torch.where(amax > 0, bins / amax, 0.0).to(torch.float32)
        acc = self._hist_pass(params, dataset, bins, scales, batch_size, start, end)
        ranges = torch.stack([lo, hi]).cpu().numpy()  # the pass's one sync
        stats = {n: {"min": float(ranges[0, i]), "max": float(ranges[1, i])}
                 for i, n in enumerate(self.tensor_names)}
        return stats, self._hist_result(acc)

    # -- OCTAV -------------------------------------------------------------
    @torch.no_grad()
    def run_octav(self, params, dataset, dynamic_sym, batch_size=32, start=0, end=None):
        """Returns {name: {'s_sum':, 'count':, 'min':, 'max':}} per tensor."""
        subs = self._sub_runners()
        if subs:
            out = {}
            for r in subs:
                out.update(r.run_octav(params, dataset, dynamic_sym,
                                       batch_size, start, end))
            return out
        params = self._device_params(params)
        t = len(self.tensor_names)
        s_sum = torch.zeros((t,), device=self.device)
        lo = torch.full((t,), _BIG, device=self.device)
        hi = torch.full((t,), -_BIG, device=self.device)
        count = 0
        for inputs, valid, n_valid in self._batches(dataset, batch_size, start, end):
            taps = self._taps(params, inputs)
            res = octav_many([taps[n] for n in self.tensor_names], dynamic_sym)
            keep = valid > 0
            s_sum = s_sum + (res[..., 0] * valid).sum(1)
            lo = torch.minimum(lo, torch.where(keep, res[..., 1], _BIG).amin(1))
            hi = torch.maximum(hi, torch.where(keep, res[..., 2], -_BIG).amax(1))
            count += n_valid
        out = torch.stack([s_sum, lo, hi]).cpu().numpy()
        return {n: {"s_sum": float(out[0, i]), "count": count,
                    "min": float(out[1, i]), "max": float(out[2, i])}
                for i, n in enumerate(self.tensor_names)}
