"""Gradient checks of the backward kernels that tell ReLU ties from faults.

A backward kernel (B4-B6) sums in another order than autograd through its
conv's plain version. A ReLU pre-activation z that lies within f32 rounding
of 0 can then be positive in one evaluation and not in the other: that
(pair, hidden unit) adds its share to the gradients in one of them only, up
to ~1e-2 of max|ref| for a pair with a large cotangent. No f32
implementation avoids such ties, and they are rare and single.

`ReluTies` runs a conv's plain version with its MLP ReLUs recorded. A
pre-activation z = x @ w1 + b1 is a tie when |z| <= 2 E, E being the
classic a-priori bound on its f32 rounding error: gamma_n (|x| @ |w1| +
|b1|) for the n-term sum, gamma_n = n u / (1 - n u), plus the error its
inputs carry times |w1| (the edge MLP's output bound, propagated the same
way, for its columns of the TP-weight MLP's input; a few units in the last
place for the distance embedding). Two evaluations each within E of the
exact value can differ in sign only there. `check` holds every gradient
tensor to tol * max|ref|. Where that fails it tries ties in the order in
which their other decision moves their MLP's bias gradient toward the
kernel's, keeps each that brings all gradients closer, and accepts only if
autograd through the plain version with those decisions flipped matches
every tensor at tol. `explain` names the positions, ties or not, that
come closest to a difference the check could not resolve. Any other fault, one hidden
unit, one bias, one node row or one pair included, fails.
"""
from __future__ import annotations

import contextlib
import weakref

import torch

from . import trunk_convs as TC

_U = 2.0 ** -24  # f32 unit roundoff
# relative error, in units of u, allowed on each input of the edge MLP (the
# Gaussian distance embedding: exp of a rounded argument up to ~10)
_INPUT_ULPS = 32


def _gamma(n: int) -> float:
    return n * _U / (1.0 - n * _U)


class _TieRelu(torch.autograd.Function):
    """ReLU whose derivative can be flipped at chosen positions and whose
    backward records the cotangent at the recorded ties."""

    @staticmethod
    def forward(ctx, z, rec, call):
        ctx.save_for_backward(z)
        # a weak reference: the recorder holds the graph, which holds ctx
        ctx.rec, ctx.call = weakref.ref(rec), call
        return torch.relu(z)

    @staticmethod
    def backward(ctx, g):
        (z,) = ctx.saved_tensors
        rec = ctx.rec()
        on = z > 0
        flip = rec._flip_masks.get(ctx.call)
        if flip is not None:
            on = on ^ flip
        if rec._recording:
            rec.calls[ctx.call]["g"] = g
        return torch.where(on, g, torch.zeros_like(g)), None, None


class ReluTies:
    """Autograd through `fn(*args)` (a trunk conv's plain version, or a
    function that runs them, such as the score net's loss on the CPU) with
    the trunk convs' ReLU ties recorded; `ref` holds the gradients of
    `leaves` for the cotangents `gs`, equal to plain autograd through `fn`."""

    def __init__(self, fn, args, leaves, gs):
        self.calls = []
        self.leaves, self.gs = list(leaves), list(gs)
        self._flip_masks, self._recording = {}, False
        self._edge = None  # (the edge MLP's output, its rounding-error bound)
        self._rows_seen, self._b, self._where = [], -1, None
        with self._patched():
            out = fn(*args)
        self.out = out if isinstance(out, tuple) else (out,)
        self._recording = True
        self.ref = self.grads([])
        self._recording = False
        self.scales = [float(r.abs().max().clamp_min(1e-30)) if r.numel() else 1.0
                       for r in self.ref]

    @property
    def n_ties(self) -> int:
        return sum(int(c["idx"].numel()) for c in self.calls)

    @property
    def n_values(self) -> int:
        """Pre-activations recorded, ties or not."""
        return sum(c["z"].numel() for c in self.calls)

    # -- recording ---------------------------------------------------------

    @contextlib.contextmanager
    def _patched(self):
        saved = TC._mlp2, TC._rows, TC._chunks
        TC._mlp2, TC._rows, TC._chunks = self._mlp2, self._rows_fn(saved[1]), \
            self._chunks_fn(saved[2])
        try:
            yield
        finally:
            TC._mlp2, TC._rows, TC._chunks = saved

    def _rows_fn(self, rows):
        def wrapped(mask_b):
            r = rows(mask_b)
            self._rows_seen.append(r)
            return r
        return wrapped

    def _chunks_fn(self, chunks):
        def wrapped(idx, width):
            # the plain versions take the source rows, then the target rows
            self._b += 1
            src = self._rows_seen[-2]
            for ch in chunks(idx, width):
                self._where = (self._b, ch, src)
                yield ch
        return wrapped

    def _mlp2(self, w1, b1, w2, b2, x):
        with torch.no_grad():
            e = self._edge
            width = 0 if e is None else e[0].shape[-1]
            is_fc = (e is not None and e[0].shape[:-1] == x.shape[:-1]
                     and width < x.shape[-1] and torch.equal(x[..., :width], e[0]))
            xw = x.abs() @ w1.abs()
            if is_fc:  # the TP-weight MLP: its leading columns are the edge MLP's output
                carried, role = e[1] @ w1[:width].abs(), self.calls[-1]["role"] + 1
            else:
                carried, role = (_INPUT_ULPS * _U) * xw, 0
            err = carried + _gamma(w1.shape[0] + 1) * (xw + b1.abs())
        z = x @ w1 + b1
        with torch.no_grad():
            bound = 2.0 * err
            idx = torch.nonzero((z.abs() <= bound).reshape(-1)).reshape(-1)
            self.calls.append(dict(
                role=role, shape=z.shape, z=z.detach(), bound=bound, idx=idx, g=None,
                bias=next((i for i, t in enumerate(self.leaves) if t is b1), None),
                where=self._where if self._where is not None else (self._edge_calls(role), None,
                                                                   None)))
        h = _TieRelu.apply(z, self, len(self.calls) - 1)
        out = h @ w2 + b2
        if role == 0:
            with torch.no_grad():
                self._edge = (out.detach(), err @ w2.abs() + _gamma(w2.shape[0] + 1)
                              * (h.abs() @ w2.abs() + b2.abs()))
        return out

    def _edge_calls(self, role):
        """Batch index of a call outside the chunked loops (the knn conv)."""
        return sum(c["role"] == 0 for c in self.calls) - (role != 0)

    # -- gradients with chosen decisions flipped ---------------------------

    def grads(self, flips):
        """Gradients of the leaves with the ReLU derivative flipped at each
        (call, flat position) of `flips` (zeros for a leaf `fn` does not
        read)."""
        masks = {}
        for call, flat in flips:
            c = self.calls[call]
            m = masks.get(call)
            if m is None:
                m = masks[call] = torch.zeros(c["z"].numel(), dtype=torch.bool,
                                              device=c["z"].device)
            m[flat] = True
        self._flip_masks = {k: m.reshape(self.calls[k]["shape"]) for k, m in masks.items()}
        try:
            grads = torch.autograd.grad(self.out, self.leaves, self.gs, retain_graph=True,
                                        allow_unused=True)
            return [torch.zeros_like(t) if g is None else g for t, g in zip(self.leaves, grads)]
        finally:
            self._flip_masks = {}

    def errors(self, got, ref=None):
        """max|got - ref| / max|ref| per tensor (ref: the plain gradients)."""
        ref = self.ref if ref is None else ref
        return [float((g - r).abs().max()) / s if r.numel() else 0.0
                for g, r, s in zip(got, ref, self.scales)]

    def _misfit(self, got, cur):
        return sum(float((((g - c) / s).double() ** 2).sum())
                   for g, c, s in zip(got, cur, self.scales))

    def _flip_deltas(self, call, flat):
        """The change of the MLP's first-bias gradient at each position's
        unit when its ReLU decision flips: -g where the unit is on, +g
        where it is off (g the cotangent at the ReLU's output)."""
        c = self.calls[call]
        g = c["g"].reshape(-1)[flat]
        return torch.where(c["z"].reshape(-1)[flat] > 0, -g, g)

    def candidates(self, got, count: int):
        """Up to `count` ties (call, flat), the most promising first: those
        whose flip moves their MLP's bias gradient toward `got` by the most
        (relative to max|ref|)."""
        gains, keys = [], []
        for i, c in enumerate(self.calls):
            if c["bias"] is None or not c["idx"].numel():
                continue
            unit = c["idx"] % c["shape"][-1]
            r = (got[c["bias"]] - self.ref[c["bias"]])[unit]
            gains.append((r.abs() - (r - self._flip_deltas(i, c["idx"])).abs())
                         / self.scales[c["bias"]])
            keys.append(torch.stack([torch.full_like(c["idx"], i), c["idx"]], 1))
        if not gains:
            return []
        gain, key = torch.cat(gains), torch.cat(keys)
        top = torch.topk(gain, min(count, gain.numel()))
        return [tuple(k) for k, v in zip(key[top.indices].tolist(), top.values.tolist()) if v > 0]

    def describe(self, call, flat):
        c = self.calls[call]
        hid, cols = c["shape"][-1], c["shape"][-2]
        row, col, unit = flat // (hid * cols) % c["shape"][-3], flat // hid % cols, flat % hid
        b, tgt, src = c["where"]
        return dict(role=c["role"], b=int(b),
                    target=int(tgt[row]) if tgt is not None else row,
                    source=int(src[col]) if src is not None else col,
                    slot=src is None, unit=unit, z=float(c["z"].reshape(-1)[flat]),
                    bound=float(c["bound"].reshape(-1)[flat]))

    def explain(self, got, count: int = 3):
        """Where a failed check's largest bias-gradient difference could come
        from: the `count` positions, ties or not, whose flip alone comes
        closest to it, described with the flip's and the difference's size
        relative to max|ref| (`delta`, `diff`)."""
        biases = {c["bias"] for c in self.calls if c["bias"] is not None}
        if not biases:
            return []
        worst = max(biases, key=lambda i: float((got[i] - self.ref[i]).abs().max())
                    / self.scales[i])
        d = got[worst] - self.ref[worst]
        unit = int(d.abs().argmax())
        miss, keys = [], []
        for i, c in enumerate(self.calls):
            if c["bias"] != worst:
                continue
            flat = torch.arange(unit, c["z"].numel(), c["shape"][-1], device=c["z"].device)
            miss.append((d[unit] - self._flip_deltas(i, flat)).abs())
            keys.append(torch.stack([torch.full_like(flat, i), flat], 1))
        miss, keys = torch.cat(miss), torch.cat(keys)
        scale = self.scales[worst]
        out = []
        for call, flat in keys[torch.topk(-miss, min(count, miss.numel())).indices].tolist():
            e = self.describe(call, flat)
            e.update(delta=float(self._flip_deltas(call, torch.tensor([flat], device=d.device))[0])
                     / scale, diff=float(d[unit]) / scale)
            out.append(e)
        return out

    def check(self, got, tol, tries: int = 48):
        """(errors before, errors after, flipped ties described): every
        tensor's max|got - ref| / max|ref| against the plain gradients, then
        against the plain gradients with the chosen ties flipped."""
        raw = self.errors(got)
        if max(raw) <= tol:
            return raw, raw, []
        cur, chosen = list(self.ref), []
        misfit = self._misfit(got, cur)
        for call, flat in self.candidates(got, tries):
            one = self.grads([(call, flat)])
            trial = [c + (o - r) for c, o, r in zip(cur, one, self.ref)]
            m = self._misfit(got, trial)
            if m < misfit:
                cur, misfit = trial, m
                chosen.append((call, flat))
                if max(self.errors(got, cur)) <= tol:
                    break
        final = self.errors(got, self.grads(chosen)) if chosen else raw
        return raw, final, [self.describe(c, f) for c, f in chosen]
