"""A RetinaNet run on row bands over a mesh's 'model' axis: the port of
sad_tpu's ``spatial_sharding`` (sad_tpu/parallel/mesh.py:76-84), where XLA
splits each level's rows over the devices and inserts the convolution halo
exchanges.

``spatialize(model, mesh)`` returns the same model (same parameters, same
state-dict keys, so convert.py and checkpoints are untouched) called on this
rank's band of the canvas:

    run = spatialize(model, mesh)
    out = run(images[:, r0:r1], outputs=("cls_prob",), height=H)  # bands of each level

Every level of the forward (the canvas, each stride of the body, P3..P7) is
split over the model group by ``mesh.row_band``: band m of an N-row level
holds rows [m c, min((m + 1) c, N)), c = ceil(N / n), so a band may be empty
(P7 of a 128-row canvas is 1 row). The ops that mix rows, ``F.conv2d``,
``F.max_pool2d`` and the nearest 2x ``F.interpolate``, are taken from the
model's forward by a ``TorchFunctionMode`` that is active only inside the
run (``_Routed``), so the model code knows nothing of bands; every other op
of the path is row-wise and runs on the band as it is. An op's output band
[o0, o1) needs the input rows

    kernel k, stride s, padding p, dilation d:  [o0 s - p, (o1 - 1) s - p + (k - 1) d + 1)
    nearest 2x upsample:                        [o0 // 2, (o1 - 1) // 2 + 1)

(``needed_rows``), which parallel/halo.py gathers from their owners, with
the op's vertical padding (0 for a convolution, -inf for a max pool) as the
rows outside the image; horizontal padding stays the op's own. A rank whose
output band is empty runs no op and returns a band of height 0, still tied
to the graph, so that its backward sends the gradients of the rows it lent.

REMAT_BACKBONE: a Bottleneck under ``torch.utils.checkpoint`` runs its ops
again in the backward, after the run has ended. For the banded call each
ResNetBody takes ``recompute_context`` as checkpoint's context_fn
(``_on_bands``): it notes which routed ops the block's forward took and
routes the recompute through the same ones, checked to end where the
forward ended; its halos exchange the same rows again. Every rank starts a
block's recompute at the block's last ReLU, whose saved output an empty band
keeps too, so the ranks' exchanges come in the same order. S2D_STEM is the
7x7 stem in the port (models/resnet.py); a band's height may be odd.

The level heights come from a record run: the model's forward on a strip of
the whole canvas height, one image of 2^max_level columns, with every routed
op counted in call order and its input and output heights kept, once per
(height, outputs, dtype, device). The banded run's routed ops must come in
the same order; one the record run did not see raises.

Only the RetinaNet path's modules run banded (``band_modules``): another
module on the path raises, and an R-CNN model on an n_model > 1 mesh raises,
since no sad_tpu path runs one under spatial_sharding (ROADMAP.md "Not
ported"). With n_model = 1 ``spatialize`` returns the model.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from .halo import Rows, halo
from .mesh import Mesh, row_band

def needed_rows(out_rows: Rows, k: int, s: int, p: int, d: int = 1) -> Rows:
    """Input rows [lo, hi) that output rows [o0, o1) of a window op need
    (kernel k, stride s, padding p, dilation d); (lo, lo) when the output
    is empty."""
    o0, o1 = out_rows
    lo = o0 * s - p
    if o1 <= o0:
        return lo, lo
    return lo, (o1 - 1) * s - p + (k - 1) * d + 1


def upsample_rows(out_rows: Rows) -> Rows:
    """Coarse rows that fine rows [a, b) of a nearest 2x upsample need."""
    a, b = out_rows
    if b <= a:
        return a // 2, a // 2
    return a // 2, (b - 1) // 2 + 1


def out_height(h: int, k: int, s: int, p: int, d: int = 1) -> int:
    return (h + 2 * p - d * (k - 1) - 1) // s + 1


@dataclass(frozen=True)
class Op:
    """One routed op of a forward, as the record run saw it."""

    kind: str  # 'conv', 'pool' or 'up'
    window: Tuple[int, int, int, int]  # vertical (k, s, p, d); (1, 1, 0, 1) for 'up'
    h_in: int
    h_out: int


class _Record:
    """The routed ops of a forward in call order, and each one's input
    (shape, element size, whether it takes a gradient)."""

    def __init__(self):
        self.ops: List[Op] = []
        self.inputs: List[tuple] = []

    def add(self, kind, window, x, out):
        self.ops.append(Op(kind, window, x.shape[2], out.shape[2]))
        self.inputs.append((tuple(x.shape), x.element_size(), x.requires_grad))
        return out


class _Banded:
    def __init__(self, ops: Sequence[Op], mesh: Mesh, start: int = 0):
        self.ops, self.mesh, self.i = ops, mesh, start

    def next(self, kind: str, window) -> Op:
        if self.i >= len(self.ops):
            raise RuntimeError(f"a {kind} op that the record run did not see")
        op = self.ops[self.i]
        if (op.kind, op.window) != (kind, tuple(window)):
            raise RuntimeError(f"routed op {self.i}: {kind} {window}, the record run had "
                               f"{op.kind} {op.window}")
        self.i += 1
        return op

    def extended(self, x, op: Op, rows_of, pad: float):
        """(the input rows the output band needs, exchanged; the output band)."""
        n = self.mesh.n_model
        bands = [row_band(op.h_out, n, q) for q in range(n)]
        needs = [rows_of(b) for b in bands]
        return halo(x, op.h_in, needs, pad, self.mesh), bands[self.mesh.model_index]


def _pair(v) -> Tuple[int, int]:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _empty_out(x, ext, c_out: int, w_out: int):
    """A band of 0 rows, tied to ``ext`` in the graph."""
    out = x.new_zeros((x.shape[0], c_out, 0, w_out))
    return out + ext.sum() * 0 if ext.requires_grad else out


def _conv2d(run, func, x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
    """``F.conv2d`` in the run: recorded, or on bands."""
    (k, kw), (s, sw), (p, pw), (d, dw) = (tuple(weight.shape[2:]), _pair(stride),
                                          _pair(padding), _pair(dilation))
    if isinstance(run, _Record):
        return run.add("conv", (k, s, p, d), x,
                       func(x, weight, bias, stride, padding, dilation, groups))
    op = run.next("conv", (k, s, p, d))
    ext, (o0, o1) = run.extended(x, op, lambda b: needed_rows(b, k, s, p, d), 0.0)
    if o1 <= o0:
        return _empty_out(x, ext, weight.shape[0], out_height(x.shape[3], kw, sw, pw, dw))
    return func(ext, weight, bias, (s, sw), (0, pw), (d, dw), groups)


def _max_pool2d(run, func, x, kernel_size, stride=None, padding=0, dilation=1,
                ceil_mode=False, return_indices=False):
    """``F.max_pool2d`` in the run (the rows outside the image are -inf, as
    the op pads)."""
    if _pair(dilation) != (1, 1) or ceil_mode or return_indices:
        raise NotImplementedError("a max pool with dilation, ceil_mode or indices has no "
                                  "banded form")
    (k, kw), (p, pw) = _pair(kernel_size), _pair(padding)
    s, sw = _pair(kernel_size if stride is None else stride)
    if isinstance(run, _Record):
        return run.add("pool", (k, s, p, 1), x, func(x, (k, kw), (s, sw), (p, pw)))
    op = run.next("pool", (k, s, p, 1))
    ext, (o0, o1) = run.extended(x, op, lambda b: needed_rows(b, k, s, p), float("-inf"))
    if o1 <= o0:
        return _empty_out(x, ext, x.shape[1], out_height(x.shape[3], kw, sw, pw))
    return func(ext, (k, kw), (s, sw), (0, pw))


def _interpolate(run, func, x, size=None, scale_factor=None, mode="nearest", **kwargs):
    """``F.interpolate`` in the run: the nearest 2x upsample only."""
    if size is not None or mode != "nearest" or _pair(scale_factor) != (2, 2):
        raise NotImplementedError(f"interpolate(size={size}, scale_factor={scale_factor}, "
                                  f"mode={mode!r}) has no banded form; the nearest 2x has")
    if isinstance(run, _Record):
        return run.add("up", (1, 1, 0, 1), x, func(x, scale_factor=2, mode="nearest"))
    op = run.next("up", (1, 1, 0, 1))
    ext, (a, b) = run.extended(x, op, upsample_rows, 0.0)
    if b <= a:
        return _empty_out(x, ext, x.shape[1], 2 * x.shape[3])
    c0 = upsample_rows((a, b))[0]
    up = func(ext, scale_factor=2, mode="nearest")
    return up[:, :, a - 2 * c0:b - 2 * c0]


_ROUTES = {F.conv2d: _conv2d, F.max_pool2d: _max_pool2d, F.interpolate: _interpolate}


class _Routed(TorchFunctionMode):
    """While active, the model's ``F.conv2d``, ``F.max_pool2d`` and
    ``F.interpolate`` calls go to ``run`` (a record or a banded run); every
    other op runs as it is. A mode leaves its own stack while it handles a
    call, so the op the route calls runs plainly."""

    def __init__(self, run):
        super().__init__()
        self.run = run

    def __torch_function__(self, func, types, args=(), kwargs=None):
        route = _ROUTES.get(func)
        if route is None:
            return func(*args, **(kwargs or {}))
        return route(self.run, func, *args, **(kwargs or {}))


def recompute_context(run: _Banded):
    """``torch.utils.checkpoint``'s context_fn for a block of the model
    (REMAT_BACKBONE) in the banded ``run``: a forward context that notes the
    routed ops the block takes, and a recompute context that routes the
    block's ops again through those."""
    span = [run.i, None]

    @contextlib.contextmanager
    def forward():
        yield
        span[1] = run.i

    @contextlib.contextmanager
    def recompute():
        again = _Banded(run.ops, run.mesh, span[0])
        with _Routed(again):
            yield
        if again.i != span[1]:
            raise RuntimeError(f"a recompute routed ops {span[0]}..{again.i}, its forward "
                               f"{span[0]}..{span[1]}")

    return forward(), recompute()


@contextlib.contextmanager
def _on_bands(model, run: _Banded):
    """For a call on ``run``'s bands, each ResNetBody of ``model`` recomputes
    a block through the run (REMAT_BACKBONE) and reads its input's height as
    a band's, not the canvas's (S2D_STEM's check)."""
    from ..models.resnet import ResNetBody

    bodies = [m for m in model.modules() if isinstance(m, ResNetBody)]
    for body in bodies:
        body.remat_context_fn = functools.partial(recompute_context, run)
        body.whole_rows = False
    try:
        yield
    finally:
        for body in bodies:
            del body.remat_context_fn, body.whole_rows


def band_modules():
    """The module types that run on bands: the RetinaNet path's."""
    from ..models.fpn import FPNRetinaNetBackbone
    from ..models.resnet import AffineChannel, Bottleneck, Conv2d, ResNetBody
    from ..models.retinanet import RetinaNet, RetinaNetHead

    return (RetinaNet, FPNRetinaNetBackbone, ResNetBody, Bottleneck, RetinaNetHead, Conv2d,
            AffineChannel)


def check_bandable(model) -> None:
    """Raise unless every module of ``model`` runs on bands: an R-CNN model
    names ROADMAP.md's "Not ported" entry, any other module its type."""
    from ..models import GeneralizedRCNN, SingleScaleRCNN

    if isinstance(model, (GeneralizedRCNN, SingleScaleRCNN)):
        raise NotImplementedError(
            f"{type(model).__name__} on a mesh with n_model > 1: height-sharded R-CNN "
            "models are not ported, as no sad_tpu path runs an R-CNN model under "
            "spatial_sharding (ROADMAP.md \"Not ported\", after item 7b); only the RetinaNet "
            "path runs on bands")
    allowed = band_modules()
    for name, m in model.named_modules():
        if not isinstance(m, allowed):
            raise NotImplementedError(
                f"module {name or '<root>'} ({type(m).__name__}) has no banded form; the "
                "spatial plan knows the RetinaNet path's modules only (ROADMAP.md item 7b)")


class SpatialModel:
    """``model`` on this rank's bands of a mesh's model group; every other
    attribute is the model's own (``parameters()``, ``state_dict()``)."""

    def __init__(self, model, mesh: Mesh):
        check_bandable(model)
        self.module, self.mesh = model, mesh
        self._plans: Dict[tuple, Tuple[List[Op], Dict[str, Dict[int, int]]]] = {}

    def __getattr__(self, name):
        return getattr(self.module, name)

    def plan(self, height: int, outputs: Tuple[str, ...], dtype, device):
        """(routed ops, output level heights) of a forward on a canvas of
        ``height`` rows: the record run's."""
        key = (height, outputs, dtype, str(device))
        if key not in self._plans:
            strip = torch.zeros((1, height, 2 ** self.module.arch.max_level, 3), dtype=dtype,
                                device=device)
            rec = _Record()
            with torch.no_grad(), _Routed(rec):
                out = self.module(strip, outputs=outputs)
            heights = {k: {lvl: t.shape[1] for lvl, t in v.items()} for k, v in out.items()}
            self._plans[key] = (rec.ops, heights)
        return self._plans[key]

    def level_heights(self, height: int, outputs, dtype, device) -> Dict[str, Dict[int, int]]:
        return self.plan(height, tuple(outputs), dtype, device)[1]

    def __call__(self, images: torch.Tensor, outputs=None, *, height: int):
        """The model's outputs on this rank's band ``images`` (N, rows, W, 3)
        of a canvas of ``height`` rows: each level's band of rows."""
        from ..models.retinanet import ALL_OUTPUTS

        outputs = tuple(outputs or ALL_OUTPUTS)
        r0, r1 = self.mesh.band(height)
        if images.shape[1] != r1 - r0:
            raise ValueError(f"a band of {images.shape[1]} rows; model index "
                             f"{self.mesh.model_index} holds rows [{r0}, {r1}) of {height}")
        ops, _ = self.plan(height, outputs, images.dtype, images.device)
        run = _Banded(ops, self.mesh)
        with _Routed(run), _on_bands(self.module, run):
            out = self.module(images, outputs=outputs)
        if run.i != len(ops):
            raise RuntimeError(f"the banded run routed {run.i} ops, the record run {len(ops)}")
        return out


def spatialize(model, mesh: Mesh):
    """``model`` run on bands of ``mesh``'s model axis (SpatialModel), or
    the model itself when the axis has one rank."""
    if mesh.n_model == 1:
        return model
    return SpatialModel(model, mesh)
