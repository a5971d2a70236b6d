"""How far KPFCNN's f32 step stands from an f64 step, on the card and on
the CPU, and where the distance comes from.

    python3 -m tdwss_torch.tools.kpconv_grads [--device cuda] [--spheres 8]
                                              [--bisect FILE]

Builds the batch of ``chip_smoke.py``'s KPConv phase (the synthetic
scenes grid-subsampled at ``first_subsampling_dl``, spheres drawn by
``PotentialSampler``, neighbour limits from ``calibrate_neighbors``) at
``KPConvConfig()``'s width, once padded as ``segmentation_inputs`` pads
it and once at the clouds' exact sizes, and runs one training forward
and backward from the same weights: in f64 on the CPU (the yardstick;
f64 all through, see ``models.layers.acc_dtype``), in f32 on the CPU,
twice in f32 and once in f64 on ``--device``.  Prints, per run and
batch, the logits' and the loss's distance from f64 and the gradients'
(per tensor: ||d|| / ||f64|| and max|d| / max|f64| over the finite
entries), then the device against the CPU in f32 and in f64.

Then two readings:

- a fault only in the backward (:func:`row0_takes_no_gradient`: the
  gathers drop every gradient bound for row 0 of their table; the
  forward is unchanged), in f64 and in f32 on ``--device``, against the
  CPU's clean step of the same dtype;
- the f32 step with the f64 step's selections (:class:`Selections`),
  on the CPU and on ``--device``, and ``--device``'s f32 step with the
  CPU's f32 selections, each with the count of entries where the step's
  own choice differs.  What is left of the distance then comes from
  rounding alone.

The basis of the KPConv phase's limits in ``chip_smoke.py``.

With ``--bisect FILE`` it runs :func:`bisect` in place of all this:
every module's output and gradient tapped (:class:`Taps`) in f32 steps
that should agree, and the first tensor where the padded batch's
distance exceeds the exact batch's tenfold.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import math
import time

import numpy as np
import torch
import torch.nn.functional as F


def kpconv_clouds(scenes, cfg):
    """The scenes grid-subsampled at ``cfg.first_subsampling_dl`` through
    the port's native binding, as KPConv clouds: points, features (a
    column of ones and the colours: ``in_features_dim`` 4) and labels."""
    from tdwss_torch import native

    clouds = []
    for sc in scenes:
        pts, cols, labels = native.grid_subsample(
            sc.points, sc.colors, sc.labels,
            cell_size=cfg.first_subsampling_dl)
        feats = np.concatenate([np.ones((pts.shape[0], 1), np.float32),
                                cols], axis=1)
        clouds.append({"points": pts, "features": feats, "labels": labels})
    return clouds


def draw_spheres(clouds, cfg, num_spheres: int, seed: int = 0):
    """``num_spheres`` spheres of ``cfg.in_radius`` drawn by
    ``PotentialSampler`` (potential grid in_radius / 10), each centred on
    its centre."""
    from tdwss_torch.models.kpconv.sampler import PotentialSampler

    sampler = PotentialSampler(clouds, in_radius=cfg.in_radius,
                               potential_dl=cfg.in_radius / 10, seed=seed)
    spheres = []
    for ci, center, idx in sampler.sample_batch(num_spheres, min_points=1):
        c = clouds[ci]
        spheres.append({"points": c["points"][idx] - center,
                        "features": c["features"][idx],
                        "labels": c["labels"][idx]})
    return spheres


def row0_takes_no_gradient(x, idx, fill):
    """A planted fault only in the backward: ``ops._take_fill`` with the
    embedding's padding index at row 0 instead of the shadow row, so the
    forward is the same and every gradient bound for row 0 is dropped."""
    n = x.shape[0]
    safe = torch.where((idx >= 0) & (idx < n), idx, n)
    return F.embedding(safe.long(), torch.cat([x, x.new_full(
        (1, x.shape[1]), fill)]), padding_idx=0)


def _tied(values, ties, reduce, dim):
    """``reduce`` (amax or amin) of ``values`` over ``dim`` restricted to
    the entries of ``ties`` (another step's tie set), with ``reduce``'s own
    backward: the gradient split equally among those entries.  On the
    step that recorded ``ties`` this is ``reduce(values, dim)`` bit for
    bit, value and gradient."""
    fill = torch.finfo(values.dtype).min if reduce is torch.amax else \
        torch.finfo(values.dtype).max
    out = reduce(torch.where(ties, values, fill), dim=dim).detach()
    w = ties.to(values.dtype)
    return out + ((values - values.detach()) * w).sum(dim) / w.sum(dim)


class Selections:
    """The selections of one step in call order: each max pool's tied
    winners, each linear influence's side of its cut at 0 (above, at, or
    below), each leaky ReLU's sign, each deformable conv's tied closest
    neighbours per kernel point (``min_d2``).  Without ``replay`` a step
    records its own and computes as it does without this; with
    ``replay`` (another step's record) it takes those of the ``kinds``
    given (all if None), computes the others as without this, and counts
    per kind the entries where its own choice differs.  A replayed tie
    splits the gradient among the recorded entries as the step's own
    ``amax`` / ``amin`` / ``maximum`` split it among its own, so a step
    that replays its own record is the step itself (a replay of one
    winner per tie moved KPFCNN's f32 step on the padded batch by 0.73%
    of a gradient's norm).  The regulariser's clamps are not replayed
    (its gradient is continuous across them)."""

    KINDS = ("max pool", "influence cut", "closest point", "leaky ReLU")

    def __init__(self, replay: "Selections | None" = None, kinds=None):
        self.seen, self.replay = [], replay
        self.kinds = set(self.KINDS if kinds is None else kinds)
        self.flips = collections.Counter()
        self.entries = collections.Counter()
        self.ties = collections.Counter()     # recorded max / min ties

    def _choose(self, kind, own, tie_dim=None):
        """The replayed choice, or None where the step computes its own.
        ``own`` is a tie set over ``tie_dim`` where one is given: a
        recording counts the reductions whose max or min ties."""
        i = len(self.seen)
        self.seen.append(own.cpu() if self.replay is None else None)
        if self.replay is None:
            if tie_dim is not None:
                self.ties[kind] += int((own.sum(tie_dim) > 1).sum())
            return None
        ref = self.replay.seen[i].to(own.device)
        self.flips[kind] += int((ref != own).sum())
        self.entries[kind] += own.numel()
        return ref if kind in self.kinds else None

    @contextlib.contextmanager
    def active(self):
        from tdwss_torch.models.kpconv import blocks
        from tdwss_torch.models.kpconv import ops as kp_ops

        max_pool, influences = blocks.max_pool, kp_ops.kp_influences
        distances, kp_aux = kp_ops._sq_distances, kp_ops.KPConvAux
        leaky = F.leaky_relu
        last = {}

        def pool(x, inds):
            g = kp_ops.gather_feats(x, inds)
            ties = self._choose("max pool",
                                g == torch.amax(g, dim=1, keepdim=True), 1)
            if ties is None:
                return torch.amax(g, dim=1)
            return _tied(g, ties, torch.amax, 1)

        def infl(sq, kp_extent, influence, aggregation):
            if influence != "linear":
                return influences(sq, kp_extent, influence, aggregation)
            lin = 1.0 - torch.sqrt(sq) / kp_extent
            side = self._choose("influence cut", torch.sign(lin))
            if side is None:
                return influences(sq, kp_extent, influence, aggregation)
            # torch.maximum(lin, 0): all of the gradient above the cut,
            # half of it at the cut, none below
            kept = torch.where(side > 0, lin, torch.where(
                side == 0, 0.5 * lin, torch.zeros_like(lin)))
            return (influences(sq, kp_extent, "constant", aggregation)
                    * kept.permute(0, 2, 1))

        def sq_distances(rel, kp):
            last["sq"] = distances(rel, kp)
            return last["sq"]

        def aux(min_d2=None, deformed_kp=None):
            if min_d2 is not None:
                sq = last["sq"]                          # (N, n, K)
                ties = self._choose("closest point",
                                    sq == torch.amin(sq, dim=1,
                                                     keepdim=True), 1)
                if ties is not None:
                    min_d2 = _tied(sq, ties, torch.amin, 1)
            return kp_aux(min_d2, deformed_kp)

        def relu(x, negative_slope=0.01, inplace=False):
            pos = self._choose("leaky ReLU", x > 0)
            if pos is None:
                return leaky(x, negative_slope)
            return torch.where(pos, x, negative_slope * x)

        blocks.max_pool, kp_ops.kp_influences = pool, infl
        kp_ops._sq_distances, kp_ops.KPConvAux = sq_distances, aux
        F.leaky_relu = relu
        try:
            yield self
        finally:
            blocks.max_pool, kp_ops.kp_influences = max_pool, influences
            kp_ops._sq_distances, kp_ops.KPConvAux = distances, kp_aux
            F.leaky_relu = leaky


class Taps:
    """Every module's output (and a KPConv layer's ``min_d2``) in call
    order, with the gradient that reaches it, kept on the CPU: the points
    at which two steps are compared tensor by tensor."""

    def __init__(self):
        self.order, self.out, self.grad = [], {}, {}

    def _keep(self, key, t):
        if not (torch.is_tensor(t) and t.is_floating_point()):
            return
        self.order.append(key)
        self.out[key] = t.detach().cpu().clone()
        if t.requires_grad:
            t.register_hook(lambda g: self.grad.__setitem__(
                key, g.detach().cpu().clone()))

    @contextlib.contextmanager
    def active(self, model):
        calls = collections.Counter()

        def hook(name, module, inputs, output):
            key = f"{name}#{calls[name]}"
            calls[name] += 1
            first = output[0] if isinstance(output, tuple) else output
            self._keep(key, first)
            if isinstance(output, tuple) and len(output) == 2 and \
                    hasattr(output[1], "min_d2"):          # a KPConvAux
                self._keep(key + ".min_d2", output[1].min_d2)

        handles = [m.register_forward_hook(
            lambda mod, i, o, n=name: hook(n, mod, i, o))
            for name, m in model.named_modules() if name]
        try:
            yield self
        finally:
            for h in handles:
                h.remove()


def step_outputs(cfg, host, device, dtype, take=None, selections=None,
                 taps=None):
    """One training forward and backward of ``KPFCNN(cfg, seed=0)`` in
    ``dtype`` on ``device``: (logits, loss, {name: gradient}) on the CPU
    in f64.  ``take`` stands in for ``ops._take_fill`` (a planted
    fault); ``selections`` records or replays the step's selections;
    ``taps`` (:class:`Taps`) keeps every module's output and gradient."""
    from tdwss_torch.models.kpconv import KPFCNN, kpfcnn_loss
    from tdwss_torch.models.kpconv import ops as kp_ops

    model = KPFCNN(cfg, seed=0, device="cpu").to(dtype).to(device)
    b = host.to(device)
    b = b._replace(points=tuple(p.to(dtype) for p in b.points),
                   features=b.features.to(dtype))
    saved = kp_ops._take_fill
    kp_ops._take_fill = take or saved
    try:
        with (selections.active() if selections is not None
              else contextlib.nullcontext()), \
                (taps.active(model) if taps is not None
                 else contextlib.nullcontext()):
            logits, auxes = model(b, train=True)
            loss = kpfcnn_loss(logits, b.labels, auxes, cfg)
            loss.backward()
    finally:
        kp_ops._take_fill = saved
    return (logits.detach().double().cpu(), float(loss.detach()),
            {n: p.grad.detach().double().cpu()
             for n, p in model.named_parameters()})


def grad_errors(got, ref):
    """(||d|| / ||ref||, max|d| / max|ref|, name) per tensor over the
    finite entries of ``ref``, largest first."""
    rows = []
    for n, b in ref.items():
        fin = torch.isfinite(b)
        if not fin.any():
            continue
        d = got[n][fin] - b[fin]
        rows.append((torch.linalg.vector_norm(d).item()
                     / max(torch.linalg.vector_norm(b[fin]).item(), 1e-300),
                     d.abs().max().item() / max(b[fin].abs().max().item(),
                                                1e-300), n))
    return sorted(rows, reverse=True)


def tensor_distance(got, ref, rows=None):
    """(||d|| / ||ref||, max|d| / max|ref|) over the entries where both
    are finite, within ``rows`` (a bool mask of the leading dim) if
    given; (nan, nan) where no entry is left."""
    got, ref = got.double(), ref.double()
    fin = torch.isfinite(got) & torch.isfinite(ref)
    if rows is not None:
        fin &= rows.reshape((-1,) + (1,) * (ref.dim() - 1))
    if not fin.any():
        return math.nan, math.nan
    d, r = got[fin] - ref[fin], ref[fin]
    return (torch.linalg.vector_norm(d).item()
            / max(torch.linalg.vector_norm(r).item(), 1e-300),
            d.abs().max().item() / max(r.abs().max().item(), 1e-300))


def compare_taps(got: Taps, ref: Taps, valids):
    """Per tapped tensor in call order: (key, shape, forward distance
    over all rows, over the valid rows, gradient distance over all rows,
    over the valid rows, non-finite entries that differ).  The valid rows
    are those of the layer whose capacity is the tensor's leading dim."""
    by_len = {}
    for v in valids:
        by_len.setdefault(v.shape[0], torch.as_tensor(v).bool())
    rows = []
    for key in ref.order:
        a, b = got.out[key], ref.out[key]
        valid = by_len.get(b.shape[0]) if b.dim() else None
        ga, gb = got.grad.get(key), ref.grad.get(key)
        nonfinite = int((torch.isfinite(a) != torch.isfinite(b)).sum())
        grads = ((math.nan,) * 2,) * 2
        if ga is not None and gb is not None:
            nonfinite += int((torch.isfinite(ga) != torch.isfinite(gb)).sum())
            grads = (tensor_distance(ga, gb),
                     tensor_distance(ga, gb, valid) if valid is not None
                     else (math.nan, math.nan))
        rows.append((key, tuple(b.shape), tensor_distance(a, b),
                     tensor_distance(a, b, valid) if valid is not None
                     else (math.nan, math.nan), *grads, nonfinite))
    return rows


def first_jump(padded, exact, index, factor=10.0):
    """The first row of ``padded`` (in the given order) whose distance at
    ``index`` (2: forward, 4: gradient, over all rows) exceeds ``factor``
    times the same key's in ``exact`` and 1e-6; None if none does."""
    base = {r[0]: r[index][0] for r in exact}
    for r in padded:
        ex = base.get(r[0], math.nan)
        got = r[index][0]
        if math.isfinite(got) and got > 1e-6 and not got <= factor * ex:
            return r, ex
    return None


def bisect(cfg, batches, dev, out_path):
    """Where the f32 steps of one batch part, tensor by tensor.  For each
    batch, from the CPU's f32 step (its selections recorded, every
    module's output and gradient tapped), against:

    - the same step on the CPU again (is the CPU's step repeatable?);
    - the CPU's step replaying one kind of its own selections at a time,
      then all of them (is the replay faithful?);
    - ``dev``'s step replaying them, also held against the CPU's
      replaying step (the card against the CPU with one set of
      selections).

    Prints each comparison's logits, loss and parameter gradients, writes
    one line per tapped tensor of the tapped comparisons to ``out_path``,
    and prints per comparison the first tensor (forward in call order,
    gradient in backward order) whose distance on the padded batch
    exceeds the exact batch's tenfold."""
    f32 = torch.float32
    found = {}

    def write(f, label, rows):
        f.write(f"## {label}: key, shape, forward (norm, max) all rows / "
                f"valid rows, gradient (norm, max) all rows / valid rows, "
                f"non-finite entries that differ\n")
        for r in rows:
            f.write(f"{r[0]} {r[1]} fwd {r[2][0]:.3g} {r[2][1]:.3g} / "
                    f"{r[3][0]:.3g} {r[3][1]:.3g} grad {r[4][0]:.3g} "
                    f"{r[4][1]:.3g} / {r[5][0]:.3g} {r[5][1]:.3g} "
                    f"nonfinite {r[6]}\n")

    def params(label, run, ref):
        _report(label, run, ref)
        errs = grad_errors(run[2], ref[2])
        print(f"{label}: parameters ||d|| / ||ref|| (max|d| / max), largest "
              f"five: " + ", ".join(f"{n} {a:.3g} ({m:.3g})"
                                    for a, m, n in errs[:5]), flush=True)

    with open(out_path, "w") as f:
        for name, host in batches.items():
            tape, own_taps = Selections(), Taps()
            own = step_outputs(cfg, host, "cpu", f32, selections=tape,
                               taps=own_taps)
            print(f"{name}: the cpu f32 step's reductions whose max or min "
                  f"ties: " + ", ".join(f"{k} {v}" for k, v in
                                        tape.ties.items()), flush=True)
            taps = Taps()
            again = step_outputs(cfg, host, "cpu", f32, taps=taps)
            label = f"{name}: cpu f32 again vs cpu f32"
            params(label, again, own)
            found[(name, "cpu again")] = rows = compare_taps(
                taps, own_taps, host.valids)
            write(f, label, rows)
            del taps
            for kind in Selections.KINDS:
                params(f"{name}: cpu f32 replaying only its own {kind} "
                       f"selections vs cpu f32", step_outputs(
                           cfg, host, "cpu", f32,
                           selections=Selections(tape, [kind])), own)
            rep_taps = Taps()
            rep = step_outputs(cfg, host, "cpu", f32,
                               selections=Selections(tape), taps=rep_taps)
            label = f"{name}: cpu f32 replaying its own selections vs cpu f32"
            params(label, rep, own)
            found[(name, "cpu replay")] = rows = compare_taps(
                rep_taps, own_taps, host.valids)
            write(f, label, rows)
            taps, sel = Taps(), Selections(replay=tape)
            run = step_outputs(cfg, host, dev, f32, selections=sel,
                               taps=taps)
            print(f"{name}: {dev} f32's own selections that differ from the "
                  f"cpu's: " + ", ".join(f"{k} {sel.flips[k]} of "
                                         f"{sel.entries[k]}"
                                         for k in sel.entries), flush=True)
            for label, ref, ref_taps in (
                    ("cpu f32", own, own_taps),
                    ("cpu f32 replaying them", rep, rep_taps)):
                label = f"{name}: {dev} f32 with the cpu f32 selections vs " \
                        f"{label}"
                params(label, run, ref)
                found[(name, label.split(": ", 1)[1])] = rows = compare_taps(
                    taps, ref_taps, host.valids)
                write(f, label, rows)
            del taps, own_taps, rep_taps
    for key in sorted({k for _, k in found}):
        if ("padded", key) not in found or ("exact", key) not in found:
            continue
        pad, ex = found[("padded", key)], found[("exact", key)]
        for what, index, order in (("forward", 2, pad),
                                   ("gradient", 4, pad[::-1])):
            hit = first_jump(order, ex, index)
            if hit is None:
                print(f"bisect ({key}): no {what} distance on the padded "
                      f"batch exceeds the exact batch's tenfold", flush=True)
                continue
            r, base = hit
            print(f"bisect ({key}): first {what} jump at {r[0]} {r[1]}: "
                  f"padded all rows {r[index][0]:.3g} ({r[index][1]:.3g}), "
                  f"valid rows {r[index + 1][0]:.3g} "
                  f"({r[index + 1][1]:.3g}); exact {base:.3g}", flush=True)


def _report(label, run, ref):
    lo, loss, g = run
    errs = grad_errors(g, ref[2])
    d_lo = ((lo - ref[0]).abs().max() / ref[0].abs().max()).item()
    print(f"{label}: logits max|d| / max {d_lo:.3g}, loss relative "
          f"{abs(loss - ref[1]) / abs(ref[1]):.3g}, gradients ||d|| / "
          f"||ref|| up to {errs[0][0]:.3g}, max|d| / max up to "
          f"{max(e[1] for e in errs):.3g}; largest: "
          + ", ".join(f"{n} {a:.3g} ({m:.3g})" for a, m, n in errs[:3]),
          flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--spheres", type=int, default=8)
    parser.add_argument("--scenes", type=int, default=5)
    parser.add_argument("--points", type=int, default=150_000)
    parser.add_argument("--bisect", metavar="PATH",
                        help="only tap every module's output and gradient "
                        "(see bisect) and write the per-tensor lines to "
                        "PATH")
    args = parser.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from tdwss_torch.data.synthetic import make_dataset
    from tdwss_torch.models.kpconv import (KPConvConfig, calibrate_neighbors,
                                           segmentation_inputs)

    cfg = KPConvConfig()
    dev = args.device
    scenes = make_dataset(args.scenes, num_points=args.points, seed=7,
                          with_text=False)
    spheres = draw_spheres(kpconv_clouds(scenes, cfg), cfg, args.spheres)
    limits = calibrate_neighbors(spheres, cfg)
    padded = segmentation_inputs(spheres, cfg, neighbor_limits=limits)
    exact = [int(v.sum()) for v in padded.valids]
    batches = {"padded": padded,
               "exact": segmentation_inputs(spheres, cfg, capacities=exact,
                                            neighbor_limits=limits)}
    if args.bisect:
        bisect(cfg, batches, dev, args.bisect)
        return 0
    f32, f64 = torch.float32, torch.float64
    for name, host in batches.items():
        t = time.perf_counter()
        tape = Selections()
        ref = step_outputs(cfg, host, "cpu", f64, selections=tape)
        print(f"{name}: layer rows {[int(v.sum()) for v in host.valids]}; "
              f"f64 on the CPU in {time.perf_counter() - t:.2f} s",
              flush=True)
        tape32 = Selections()
        runs = {"cpu f32": step_outputs(cfg, host, "cpu", f32,
                                        selections=tape32),
                f"{dev} f32": step_outputs(cfg, host, dev, f32),
                f"{dev} f32 again": step_outputs(cfg, host, dev, f32),
                f"{dev} f64": step_outputs(cfg, host, dev, f64)}
        for label, run in runs.items():
            _report(f"{name}: {label} vs cpu f64", run, ref)
        _report(f"{name}: {dev} f32 again vs {dev} f32",
                runs[f"{dev} f32 again"], runs[f"{dev} f32"])
        _report(f"{name}: {dev} f32 vs cpu f32", runs[f"{dev} f32"],
                runs["cpu f32"])
        for dtype, label, clean in ((f64, "f64", ref),
                                    (f32, "f32", runs["cpu f32"])):
            _report(f"{name}: {dev} {label} with row 0 taking no gradient "
                    f"vs cpu {label}",
                    step_outputs(cfg, host, dev, dtype,
                                 take=row0_takes_no_gradient), clean)
        for where, source, record, clean in (
                ("cpu", "cpu f64", tape, ref), (dev, "cpu f64", tape, ref),
                (dev, "cpu f32", tape32, runs["cpu f32"])):
            sel = Selections(replay=record)
            run = step_outputs(cfg, host, where, f32, selections=sel)
            _report(f"{name}: {where} f32 with the {source} step's "
                    f"selections vs {source}", run, clean)
            print(f"{name}: {where} f32's own selections that differ from "
                  f"{source}'s: " + ", ".join(
                      f"{k} {sel.flips[k]} of {sel.entries[k]}"
                      for k in sel.entries), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
