"""How far KPFCNN's f32 step stands from an f64 step, on the card and on
the CPU, and where the distance comes from.

    python3 -m tdwss_torch.tools.kpconv_grads [--device cuda] [--spheres 8]

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
"""

from __future__ import annotations

import argparse
import collections
import contextlib
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


class Selections:
    """The selections of one step in call order: each max pool's winners,
    each linear influence's cut at 0, each leaky ReLU's sign, each
    deformable conv's closest neighbour per kernel point (``min_d2``).
    Without ``replay`` a step records its own and computes as it does
    without this; with ``replay`` (another step's record) it takes
    those, and counts per kind the entries where its own choice differs.
    The regulariser's clamps are not replayed (its gradient is
    continuous across them)."""

    def __init__(self, replay: "Selections | None" = None):
        self.seen, self.replay = [], replay
        self.flips = collections.Counter()
        self.entries = collections.Counter()

    def _choose(self, kind, own):
        i = len(self.seen)
        self.seen.append(own.cpu() if self.replay is None else None)
        if self.replay is None:
            return own
        ref = self.replay.seen[i].to(own.device)
        self.flips[kind] += int((ref != own).sum())
        self.entries[kind] += own.numel()
        return ref

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
            win = self._choose("max pool", torch.argmax(g, dim=1))
            if self.replay is None:
                return torch.amax(g, dim=1)
            return torch.gather(g, 1, win[:, None]).squeeze(1)

        def infl(sq, kp_extent, influence, aggregation):
            if influence != "linear":
                return influences(sq, kp_extent, influence, aggregation)
            lin = 1.0 - torch.sqrt(sq) / kp_extent
            keep = self._choose("influence cut", lin > 0)
            if self.replay is None:
                return influences(sq, kp_extent, influence, aggregation)
            return (influences(sq, kp_extent, "constant", aggregation)
                    * torch.where(keep, lin, 0.0).permute(0, 2, 1))

        def sq_distances(rel, kp):
            last["sq"] = distances(rel, kp)
            return last["sq"]

        def aux(min_d2=None, deformed_kp=None):
            if min_d2 is not None:
                sq = last["sq"]                          # (N, n, K)
                near = self._choose("closest point",
                                    torch.argmin(sq, dim=1))
                if self.replay is not None:
                    min_d2 = torch.gather(sq, 1, near[:, None]).squeeze(1)
            return kp_aux(min_d2, deformed_kp)

        def relu(x, negative_slope=0.01, inplace=False):
            pos = self._choose("leaky ReLU", x > 0)
            if self.replay is None:
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


def step_outputs(cfg, host, device, dtype, take=None, selections=None):
    """One training forward and backward of ``KPFCNN(cfg, seed=0)`` in
    ``dtype`` on ``device``: (logits, loss, {name: gradient}) on the CPU
    in f64.  ``take`` stands in for ``ops._take_fill`` (a planted
    fault); ``selections`` records or replays the step's selections."""
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
