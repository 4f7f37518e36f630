"""Inverse rendering's gradient step, back to back, as the inverse CLI
takes it: `grad.inverse.make_train_step` with Adam over the trained fields,
each step ending with its loss read on the host.

The mix's file sets: `render` (overrides of the configuration's render
settings), `fields` (the trained fields of `TrainableParams.from_scene`),
`lr`, `perturb_scale` and `start_seed` (the start: each field
x(1 + u) + 0.1u, at least 0, u uniform in [-scale, scale) drawn from
`start_seed`, the same for every run, so that every seed fits the same
problem; a base colour's alpha kept), `target_spp` (the target: the true
scene rendered at that spp in set-up), `check_units` (the first steps, run
in set-up through the window's own step and followed by the reference)
and `profile` ({"first", "units"}: the window's steps a traced run
profiles).  Step k's key is a hash of (seed, k).

Besides the first steps, one step of the window, drawn from the seed by
reservoir (in a traced run, from the traced stretch), is checked: the
trained leaves, Adam's state and the gradient Adam took are copied on the
card before and after it, and the reference takes that step again from
the copy.
"""

from __future__ import annotations

import contextlib
import dataclasses
import statistics
import importlib
import time

from harness import compare, inputs, port, scenes

REF = scenes.REFERENCE
BETA1 = 0.9      # torch.optim.Adam's default, the step's optimizer


class Run:
    def __init__(self, ctx):
        self.ctx = ctx
        self.config = ctx.cell.config
        self.mix = ctx.cell.traffic
        self.settings = {**self.config["render"], **self.mix.get("render", {}),
                         **ctx.scale}
        prof = self.mix["profile"]
        self.p0, self.pn = prof["first"], prof["units"]
        self.min_units = self.p0 + self.pn if ctx.tracer.on else 1
        self.losses, self.grad1, self.params0, self.params_k = [], {}, {}, {}
        self.rng = inputs.rng(ctx.seed, "check")
        self.eligible = 0
        self.kept = None    # (step, state before, state after, loss)

    def _start(self, inverse, scene):
        """The trained fields' start (the same on both sides)."""
        import torch
        sel = set(self.mix["fields"])
        true = inverse.TrainableParams.from_scene(
            scene, **{f: f in sel for f in ("base_color", "roughness",
                                            "metallic", "emissive")})
        items = true.items()
        noise = inputs.perturbation(self.mix["start_seed"],
                                    [tuple(v.shape) for _, v in items],
                                    self.mix["perturb_scale"],
                                    self.ctx.device)
        start = {}
        for (name, v), u in zip(items, noise):
            x = torch.clamp_min(v.detach() * (1.0 + u) + 0.1 * u, 0.0)
            if name == "base_color_factor":
                x[..., 3] = v[..., 3]
            start[name] = x
        return dataclasses.replace(true, **start)

    def _key(self, k):
        return inputs.key(self.ctx.seed, inputs.STEP, k, self.ctx.device)

    def _target(self, package, scene, cam, cfg):
        import torch
        path = importlib.import_module(f"{package}.integrator.path")
        with torch.no_grad():
            return path.render(scene, cam, inputs.key(
                self.ctx.seed, inputs.TARGET, 0, self.ctx.device),
                dataclasses.replace(cfg, spp=self.mix["target_spp"])).mean()

    # -- the program -------------------------------------------------------
    def setup(self):
        import torch
        ctx = self.ctx
        port.load_kernels(ctx.device)
        ctx.phase("kernel library")
        inverse = port.module("grad.inverse")
        path = port.module("integrator.path")
        cfg = path.RenderConfig(**self.settings)
        scene, cam = scenes.build(port.PACKAGE, self.config, ctx.device,
                                  ctx.spans)
        ctx.phase("scene")
        self.target = self._target(port.PACKAGE, scene, cam, cfg)
        ctx.phase("target")
        start = self._start(inverse, scene)
        self.params0 = {k: v.detach().cpu() for k, v in start.items()}
        self.params = inverse.trainable_copy(start)
        self.opt = torch.optim.Adam(self.params.leaves(), lr=self.mix["lr"])
        self.step = inverse.make_train_step(scene, cam, cfg, self.opt)
        self.opt_state = None
        for k in range(self.mix["check_units"]):
            self.losses.append(self._step(k))
            if k == 0:
                self.grad1 = {
                    name: (self.opt.state[leaf]["exp_avg"]
                           / (1.0 - BETA1)).cpu()
                    for name, leaf in self.params.items()}
        self.params_k = {k: v.detach().cpu().clone()
                         for k, v in self.params.items()}
        ctx.phase("checked steps")

    def _step(self, k) -> float:
        self.params, self.opt_state, loss = self.step(
            self.params, self.opt_state, self._key(k), self.target)
        return float(loss)

    def _state(self):
        """{field: (leaf, Adam's state of it, the gradient Adam took)},
        copied on the card."""
        return {name: (leaf.detach().clone(),
                       {k: v.detach().clone()
                        for k, v in self.opt.state[leaf].items()},
                       None if leaf.grad is None
                       else leaf.grad.detach().clone())
                for name, leaf in self.params.items()}

    def unit(self, i):
        tracer = self.ctx.tracer
        traced = self.p0 <= i < self.p0 + self.pn
        keep = False
        if traced or not tracer.on:
            # Reservoir of one over the steps that may be checked.
            self.eligible += 1
            keep = self.rng.randrange(self.eligible) == 0
        before = self._state() if keep else None
        if tracer.on and i == self.p0:
            tracer.start()
        k = self.mix["check_units"] + i
        loss = self._step(k)
        if tracer.on and i == self.p0 + self.pn - 1:
            tracer.stop(self.pn)
        if keep:
            self.kept = (k, before, self._state(), loss)

    def e2e(self, window_s, lat):
        return {"step_s": window_s / len(lat)}

    def release(self):
        import gc

        import torch
        if self.ctx.tracer.on and self.ctx.tracer.stretch is None:
            raise RuntimeError(f"the window ended before the traced steps "
                               f"{self.p0}..{self.p0 + self.pn - 1}")
        k, before, after, loss = self.kept
        self.kept = (k, *({name: (leaf.cpu(), {s: v.cpu()
                                               for s, v in st.items()},
                                  None if g is None else g.cpu())
                           for name, (leaf, st, g) in x.items()}
                          for x in (before, after)), loss)
        self.params = self.step = self.opt_state = self.target = None
        self.opt = None
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the reference -----------------------------------------------------
    def check(self):
        import torch
        ctx = self.ctx
        dev = ctx.device
        inverse = importlib.import_module(f"{REF}.grad.inverse")
        path = importlib.import_module(f"{REF}.integrator.path")
        cfg = path.RenderConfig(**self.settings)
        t = time.perf_counter()
        scene, cam = scenes.build(REF, self.config, dev)
        target = self._target(REF, scene, cam, cfg)
        params = inverse.trainable_copy(self._start(inverse, scene))
        opt = torch.optim.Adam(params.leaves(), lr=self.mix["lr"])
        step = inverse.make_train_step(scene, cam, cfg, opt)
        hooks = None
        if ctx.tracer.on:
            from work import hooks as hooks_mod
            hooks = hooks_mod.Recorder(scene, cfg)
        losses, grad1, state = [], {}, None
        for k in range(self.mix["check_units"]):
            params, state, loss = step(params, state, self._key(k), target)
            losses.append(float(loss))
            if k == 0:
                grad1 = {n: leaf.grad.detach().cpu()
                         for n, leaf in params.items()}
        moved = {n: leaf.detach().cpu() - self.params0[n]
                 for n, leaf in params.items()}
        moved_prog = {n: v - self.params0[n]
                      for n, v in self.params_k.items()}
        keep = _moved_leaves(grad1)
        numbers = {
            "loss_gap": max(compare.rel_gap(a, b)
                            for a, b in zip(self.losses, losses)),
            "grad_gap": compare.norm_gap(self.grad1, grad1),
            "update_gap": compare.norm_gap(moved_prog, moved, keep)}
        notes = [f"losses: program {self.losses}, reference {losses}",
                 "gradient norms (reference): " + ", ".join(
                     f"{n} {float(g.double().norm())}"
                     for n, g in grad1.items()),
                 f"change compared on: {', '.join(sorted(keep))}"]

        # The window's checked step, taken again from the program's state
        # before it.
        k, before, after, loss_prog = self.kept
        params = inverse.trainable_copy(dataclasses.replace(
            params, **{n: leaf.to(dev) for n, (leaf, _, _) in before.items()}))
        opt = torch.optim.Adam(params.leaves(), lr=self.mix["lr"])
        for n, leaf in params.items():
            st = before[n][1]
            opt.state[leaf] = {
                "step": torch.tensor(float(st["step"])),
                "exp_avg": st["exp_avg"].to(dev).clone(),
                "exp_avg_sq": st["exp_avg_sq"].to(dev).clone()}
        step = inverse.make_train_step(scene, cam, cfg, opt)
        with (hooks.unit(0) if hooks is not None
              else contextlib.nullcontext()):
            params, _, loss = step(params, None, self._key(k), target)
        grad = {n: leaf.grad.detach().cpu() for n, leaf in params.items()}
        keep = _moved_leaves(grad)
        numbers.update({
            "window_loss_gap": compare.rel_gap(loss_prog, float(loss)),
            "window_grad_gap": compare.norm_gap(
                {n: after[n][2] for n in after}, grad),
            "window_update_gap": compare.norm_gap(
                {n: after[n][0] - before[n][0] for n in after},
                {n: leaf.detach().cpu() - before[n][0]
                 for n, leaf in params.items()}, keep)})
        notes += [f"window step {k}: loss program {loss_prog}, reference "
                  f"{float(loss)}; change compared on: "
                  f"{', '.join(sorted(keep))}",
                  f"reference: {len(losses) + 1} steps in "
                  f"{time.perf_counter() - t:.3f} s"]
        return numbers, (hooks.totals() if hooks else {}), notes


def _moved_leaves(grad: dict) -> set:
    """Leaves whose reference gradient is nought to rounding move under
    Adam by round-off alone: their change is compared on the others."""
    norms = {n: float(g.double().norm()) for n, g in grad.items()}
    med = statistics.median(norms.values())
    return {n for n, v in norms.items() if v >= 1e-3 * med}
