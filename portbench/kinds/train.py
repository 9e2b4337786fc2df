"""The ``train`` kind of run: ``train_step`` over seeded permutations, steps
queued with no host sync, the window ending in a device sync.

A mix of this kind gives ``cases`` (the pool), ``batch``, ``n_internal``,
``n_boundary``, ``n_obs``, ``warmup_epochs`` and ``profile_epochs`` (the
traced stretch).
"""
from __future__ import annotations

import math
import time

import torch

from portbench import drive, flops, inputs, trace, traffic
from portbench.reference import model as ref

# the most training steps a second the window is sized for; past it the
# epochs' permutations repeat
MAX_STEPS_PER_S = 400


class Cell:
    """Set-up builds one training state, drives it from the seed through
    its first ``check_steps`` steps (the window's own call and feed, on rows
    that all differ; the reference follows them after the window), ends the
    first epoch and warms up, then hands the same state to the window."""

    def __init__(self, spec, mix, seed, device, seconds, t_start, spans: trace.Spans,
                 check_steps=3):
        self.spec, self.cfg, self.mix, self.seed, self.device = spec, spec.cfg, mix, seed, device
        self.spans = spans
        data, domain = spec.dataset.make_batch(mix["cases"], mix["n_internal"],
                                               mix["n_boundary"], mix["n_obs"],
                                               inputs.rng(seed, inputs.DATA))
        self.data = torch.from_numpy(data).to(device)
        self.domain = drive.domain_tensors(domain, device)
        self.model, scaler = drive.program_model(spec, device)
        self.init = inputs.draw_weights(self.model.module.named_parameters(), seed, device)
        from porous_cfd_tpu_torch.train.engine import (gather_cases, make_optimizer,
                                                       make_train_functions)
        self.gather = gather_cases
        self.dataset = self.model.attach_neighbors(drive.foam_data(spec, self.data,
                                                                   self.domain))
        self.steps = mix["cases"] // mix["batch"]
        fns = make_train_functions(self.model, make_optimizer(self.model, self.steps), scaler)
        self.train_step = fns.train_step
        self.state = fns.init_state(seed=seed)
        n_epochs = (mix["warmup_epochs"] + mix["profile_epochs"]
                    + math.ceil(seconds * MAX_STEPS_PER_S / self.steps) + 1)
        self.perms = torch.as_tensor(traffic.epochs(mix, seed, n_epochs)).to(device)
        self.epoch = 0
        self.n_steps = 0
        self.run = drive.Run("train")
        self.losses = []
        names = [n for n, _ in self.model.module.named_parameters()]
        params = dict(self.model.module.named_parameters())
        beta1 = self.cfg["adam_betas"][0]
        for s in range(check_steps):
            self.losses.append(self._step(0, s)[0])
            if s == 0:
                # Adam's first moment after one step is (1 - beta1) g; a
                # parameter the optimizer never stepped has no state
                opt = self.state.optimizer.state
                self.grad1 = {n: opt[params[n]]["exp_avg"].detach() / (1 - beta1)
                              if "exp_avg" in opt.get(params[n], {})
                              else torch.zeros_like(params[n]) for n in names}
        self.change = {n: params[n].detach() - self.init[n] for n in names}
        self.check_batches = [self.perms[0, s] for s in range(check_steps)]
        self.run.failed = sum(not drive.finite(m) for m in self.losses)
        for s in range(check_steps, self.steps):
            self._step(0, s)
        self.epoch = 1
        while self.epoch < mix["warmup_epochs"]:
            self._epoch()
        drive.sync(device)
        self.run.setup_s = time.perf_counter() - t_start

    def _step(self, e, s, host=None):
        with self.spans("feed"):
            batch = self.gather(self.dataset, self.perms[e % len(self.perms), s])
        with self.spans("train_step"):
            t0 = time.perf_counter()
            self.state, m = self.train_step(self.state, batch)
            if host is not None:
                host.append(time.perf_counter() - t0)
        self.n_steps += 1
        return m

    def _epoch(self, host=None):
        out = [self._step(self.epoch, s, host) for s in range(self.steps)]
        self.epoch += 1
        return out

    def window(self, seconds):
        run, mets = self.run, []
        t0 = time.perf_counter()
        while True:
            mets += self._epoch(run.host_call_s)
            run.timeline.append((time.perf_counter() - t0, len(mets)))
            if run.timeline[-1][0] >= seconds:
                break
        drive.sync(self.device)
        run.wall_s = time.perf_counter() - t0
        run.attempted = len(mets)
        run.cases = len(mets) * self.mix["batch"]
        run.failed += sum(not drive.finite(m[0]) for m in mets)
        run.flops_per_case = flops.step_flops(self.spec, 1, self.mix["n_internal"],
                                              self.mix["n_boundary"])

    def traced(self):
        n_ep = self.mix["profile_epochs"]
        last = []

        def stretch():
            for _ in range(n_ep):
                self._epoch()
                last[:] = [self.perms[(self.epoch - 1) % len(self.perms), -1]]

        self.run.traced = trace.traced(stretch, self.spans, self.device)
        self.run.traced_units = n_ep * self.steps
        params = {n: p.detach() for n, p in self.model.module.named_parameters()}
        idx = last[0]
        winners = drive.pool_winners(self.spec, params, self.data[idx],
                                     {k: v[idx] for k, v in self.domain.items()})
        calls = flops.kernel_calls(self.spec, self.mix["batch"], self.mix["n_internal"],
                                   self.mix["n_boundary"], winners, train=True)
        self.run.kernel_bounds = {n: flops.bound_s(f, b) for n, f, b in calls}
        self.run.traced_bound_s = sum(self.run.kernel_bounds.values()) * self.run.traced_units

    def program_result(self):
        lrs = [float(g["lr"]) for g in self.state.optimizer.param_groups]
        return ([float(m) for m in self.losses], self.grad1, self.change, lrs)

    def release(self):
        """Free the program's state before the reference runs."""
        prog = self.program_result()
        del self.model, self.state, self.train_step, self.dataset
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return prog

    def reference(self, mode="f32"):
        """The reference's first steps from the harness's weights, and the
        learning rate the run's last step should have applied."""
        with drive.precision(mode, self.device):
            out = ref.train(self.spec, self.init, self.data, self.domain, self.check_batches,
                            self.seed, self.steps)
        return (*out, [ref.lr_at(self.cfg, self.n_steps - 1, self.steps)])

    def readings(self, prog, refs):
        return drive.train_readings(self.cfg, prog, refs)
