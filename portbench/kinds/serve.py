"""The ``serve`` kind of run: requests due at a fixed rate, each copied from
host memory to the card, ``predict_batch(batch, verbose=True)`` and its
fields and residuals copied back; latency from the request's due time to its
outputs in host memory.

A mix of this kind gives ``pool`` (cases held in host memory),
``n_internal``, ``n_boundary``, ``min_cases``, ``max_cases``, ``rate_rps``,
``check_requests`` (the sample the reference recomputes, the largest
request among them) and ``profile_requests`` (the traced stretch). Below the
system's capacity every request due in the window is served, late ones
after its close. With ``stop_at_close`` (a rate above capacity, where the
backlog grows all through the window) no request starts after the close:
the window's work is what the system finished in it.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import drive, flops, inputs, trace, traffic
from portbench.reference import model as ref


class Cell:
    def __init__(self, spec, mix, seed, device, seconds, t_start, spans: trace.Spans):
        self.spec, self.cfg, self.mix, self.seed, self.device = spec, spec.cfg, mix, seed, device
        self.spans = spans
        data, domain = spec.dataset.make_batch(mix["pool"], mix["n_internal"],
                                               mix["n_boundary"], 0,
                                               inputs.rng(seed, inputs.DATA))
        pool = torch.from_numpy(data)
        self.pool = pool.pin_memory() if device.type == "cuda" else pool
        self.buf = torch.empty((mix["max_cases"], *pool.shape[1:]), dtype=pool.dtype,
                               pin_memory=device.type == "cuda")
        keys = ("internal", "boundary", *spec.dataset.PATCHES)
        one = {k: v[:1] for k, v in domain.items() if k in keys}
        self.dom = {k: v.expand(mix["max_cases"], -1)
                    for k, v in drive.domain_tensors(one, device).items()}
        self.model, _ = drive.program_model(spec, device)
        self.model.module.eval()
        self.init = inputs.draw_weights(self.model.module.named_parameters(), seed, device)
        from porous_cfd_tpu_torch.train.engine import make_predict_functions
        self.predict = make_predict_functions(self.model).predict_batch
        self.schedule = traffic.requests(mix, seed, seconds)
        self.sample_rng = inputs.rng(seed, inputs.SAMPLE)
        self.slots, self.largest, self.kept, self.n_seen = [], None, {}, 0
        self.run = drive.Run("serve")
        self.run.flops_per_case = flops.forward_flops(spec, 1, mix["n_internal"],
                                                      mix["n_boundary"])
        sizes = {len(ids) for _, ids in self.schedule}
        for size in sorted(sizes):          # each shape the traffic sends, once
            self._serve(np.arange(size))
        drive.sync(device)
        self.run.setup_s = time.perf_counter() - t_start

    def _serve(self, ids):
        n = len(ids)
        with self.spans("h2d"):
            idx = torch.from_numpy(np.asarray(ids, dtype=np.int64))
            x = torch.index_select(self.pool, 0, idx, out=self.buf[:n])
            batch = drive.foam_data(self.spec, x.to(self.device, non_blocking=True),
                                    {k: v[:n] for k, v in self.dom.items()})
        with self.spans("predict"):
            pred, extra = self.predict(self.model.attach_neighbors(batch), True)
        t_enq = time.perf_counter()
        with self.spans("d2h"):
            out = pred.data.cpu(), extra.data.cpu()
        return out, t_enq

    def _keep(self, i, ids, out):
        """The check's sample of the finished requests, drawn from the seed
        as they finish (a reservoir of ``check_requests - 1``), and the
        largest finished request beside it."""
        k, n = self.mix["check_requests"] - 1, self.n_seen
        self.n_seen += 1
        if n < k:
            self.slots.append(i)
        else:
            j = int(self.sample_rng.integers(0, n + 1))
            if j < k:
                self.slots[j] = i
        if self.largest is None or len(ids) > len(self.kept[self.largest][0]):
            self.largest = i
        keep = set(self.slots) | {self.largest}
        if i in keep:
            self.kept[i] = (ids, out)
        self.kept = {j: v for j, v in self.kept.items() if j in keep}

    def _loop(self, schedule, run=None, close=None):
        t0 = time.perf_counter()
        for i, (due, ids) in enumerate(schedule):
            if close is not None and time.perf_counter() - t0 >= close:
                break
            with self.spans("wait"):
                while True:
                    ahead = t0 + due - time.perf_counter()
                    if ahead <= 0:
                        break
                    if ahead > 2e-3:
                        time.sleep(ahead - 1e-3)
            start = time.perf_counter()
            out, t_enq = self._serve(ids)
            done = time.perf_counter()
            if run is not None:
                run.latency_s.append(done - (t0 + due))
                run.service_s.append(done - start)
                run.host_call_s.append(t_enq - start)
                run.cases += len(ids)
                run.failed += not drive.finite(*out)
                self._keep(i, ids, out)
        return time.perf_counter() - t0

    def window(self, seconds):
        run = self.run
        close = seconds if self.mix.get("stop_at_close") else None
        run.wall_s = self._loop(self.schedule, run, close)
        run.attempted = len(run.latency_s)

    def traced(self):
        schedule = traffic.requests(self.mix, self.seed,
                                    self.mix["profile_requests"] / self.mix["rate_rps"], 1)
        self.run.traced = trace.traced(lambda: self._loop(schedule), self.spans, self.device)
        cases = sum(len(ids) for _, ids in schedule)
        self.run.traced_units = cases
        calls = flops.kernel_calls(self.spec, 1, self.mix["n_internal"],
                                   self.mix["n_boundary"], {}, train=False)
        self.run.kernel_bounds = {n: flops.bound_s(f, b) for n, f, b in calls}
        # the work is linear in the cases, so the bounds add up by case
        self.run.traced_bound_s = sum(flops.bound_s(f * cases, b * cases) for _, f, b in calls)

    def program_result(self):
        return [self.kept[i][1] for i in sorted(self.kept)]

    def release(self):
        prog = self.program_result()
        del self.model, self.predict
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return prog

    def reference(self, mode="f32", chunk=13):
        outs = []
        with drive.precision(mode, self.device):
            for i in sorted(self.kept):
                ids = self.kept[i][0]
                data = self.pool[torch.from_numpy(np.asarray(ids))].to(self.device)
                parts = [ref.predict(self.spec, self.init, data[c:c + chunk],
                                     {k: v[:len(data[c:c + chunk])] for k, v in self.dom.items()})
                         for c in range(0, len(ids), chunk)]
                outs.append(tuple(torch.cat(p, 0).cpu() for p in zip(*parts)))
        return outs

    def readings(self, prog, refs):
        return {"field_err": max(drive.field_error(p, r) for p, r in zip(prog, refs))}
