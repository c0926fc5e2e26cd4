"""The port of sad_tpu's 'model' mesh axis (height sharding) on the CPU:
the row arithmetic, the banded RetinaNet forward and backward, the content
mask of a band, and height-sharded serving.

- Row arithmetic, no processes: XLA's ceil split of every level
  (``mesh.row_band``); each op's needed rows (``spatial.needed_rows``,
  ``upsample_rows``) against a brute-force union of every output row's taps,
  for every routed op of the tiny ResNet-FPN and of R-50, R-101 and
  X-101-64x4d (record runs on the meta device); the halo plan's sends equal
  the receives and, with each rank's own rows, cover what it needs once,
  over n_model 2..4 and heights that leave bands empty.
- The forward (gloo ranks on the CPU, each a process that imports no jax,
  ``tools/profile_spatial.rank_forward``): the tiny student of
  tests/test_torch_train_step.py at float32 on n_model = 4 at 128x128
  (sad_tpu's own test layout: P7 is 1 row over 4 bands, three empty) and on
  a 2 x 2 mesh, and at 160x128 on n_model = 3. The gathered outputs lie
  within 2e-5 of sad_tpu's forward on the same weights (the tolerance of
  tests/test_model_and_train.py:473-478) and within 1e-5 * max of the
  port's one-process forward.
- The backward: the gradient of a scalar of the banded outputs (position
  weights, ``profile_spatial.output_scalar``) with respect to the input and
  to every parameter equals one process's within 1e-5 relative L2 at
  float32; at float64 within 1e-12 (every halo row's gradient reaches its
  owner).
- The content mask of a band: a canvas whose content ends in the second band
  normalises as one process does.
- Serving on a 1 x 2 mesh (``make_inference_fn(cfg, model, mesh)``): the
  first rank's detections equal one process's (classes and valid exactly,
  boxes and scores within 1e-5 * max), and match sad_tpu's inference at the
  tolerances of tests/test_torch_inference.py; the other rank returns none;
  each rank's halo bytes equal the prediction from the shapes.
- R-CNN models and modules without a banded form raise, naming ROADMAP.md
  item 7b.

Each world is spawned once a module and runs all its jobs (a mesh each); the
cases read their results.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import sad_tpu.config as jcfg
from sad_tpu.config.config import merge_cfg_from_dict as j_merge
from sad_tpu.eval.inference import make_inference_fn as j_make_inference_fn
from sad_tpu.models import RetinaNet as JaxRetinaNet
import sad_tpu_torch.config as tcfg
from sad_tpu_torch.config import load_cfg
from sad_tpu_torch.config.config import merge_cfg_from_dict as t_merge
from sad_tpu_torch.convert import load_params
from sad_tpu_torch.eval.inference import make_inference_fn
from sad_tpu_torch.models import RetinaNet, create_model
from sad_tpu_torch.models.arch import ModelArch
from sad_tpu_torch.models.retinanet import ALL_OUTPUTS
from sad_tpu_torch.ops.image_norm import content_mask, normalize_u8_on_device
from sad_tpu_torch.parallel.halo import plan
from sad_tpu_torch.parallel.launch import spawn
from sad_tpu_torch.parallel.mesh import Mesh, row_band
from sad_tpu_torch.parallel.spatial import (
    SpatialModel, needed_rows, spatialize, upsample_rows,
)
from sad_tpu_torch.tools import profile_ddp, profile_spatial
from test_torch_inference import CFG as SERVE_CFG
from test_torch_inference import _assert_same_detections, canvases
from test_torch_models import one_torch_thread, random_params, sad_tpu_native_loaded  # noqa: F401

TIMEOUT_S = 110.0  # the module's worlds together
CONFIGS = "sad_tpu_torch/configs"


# --------------------------------------------------------------------------- #
# Row arithmetic
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("n", [2, 3, 4])
def test_ceil_split_of_every_level(n):
    """Bands of ceil(N / n) rows in model order, the last ones shorter or
    empty; the flagship canvas's and sad_tpu's test layout's levels."""
    for h in range(1, 130):
        c = -(-h // n)
        bands = [row_band(h, n, m) for m in range(n)]
        assert bands[0][0] == 0 and bands[-1][1] == h
        assert all(a1 == b0 for (_, a1), (b0, _) in zip(bands, bands[1:]))
        assert all(b - a == c for a, b in bands[:h // c])
        assert all(0 <= b - a <= c for a, b in bands)
    assert [row_band(1, 4, m) for m in range(4)] == [(0, 1), (1, 1), (1, 1), (1, 1)]
    assert [row_band(5, 2, m) for m in range(2)] == [(0, 3), (3, 5)]
    assert [row_band(10, 2, m) for m in range(2)] == [(0, 5), (5, 10)]


def _taps(out_rows, k, s, p, d):
    rows = {o * s - p + j * d for o in range(*out_rows) for j in range(k)}
    return (min(rows), max(rows) + 1) if rows else None


def _record(model, height):
    run = SpatialModel(model, Mesh(1, 2))
    return run.plan(height, ALL_OUTPUTS, torch.float32, "meta")[0]


def _meta_model(yaml, *opts):
    return create_model(load_cfg(f"{CONFIGS}/{yaml}", list(opts)), "meta")


@pytest.mark.parametrize("which", ["tiny", "R-50", "R-50 folded", "R-101", "X-101-64x4d"])
def test_needed_rows_of_every_routed_op(which):
    """Each routed op of the forward (every Conv2d, the stem's max pool, the
    upsamples) on the canvas's levels: the needed rows of every band, n 2..4,
    equal the union of its output rows' taps."""
    if which == "tiny":
        with torch.device("meta"):
            model = RetinaNet(ModelArch(**dataclasses.asdict(graft._tiny_arch())))
        height = 160
    else:
        yaml = {"R-101": "retinanet_R-101-FPN_teacher.yaml",
                "X-101-64x4d": "retinanet_X-101-64x4d-FPN_teacher_500.yaml"}.get(
            which, "retinanet_R-50-FPN_student.yaml")
        opts = ("FOLD_AFFINE", "True") if which == "R-50 folded" else ()
        model, height = _meta_model(yaml, *opts), 640
    ops = _record(model, height)
    convs = [m for m in model.modules() if type(m).__name__ == "Conv2d"]
    n_conv = sum(op.kind == "conv" for op in ops)
    levels = len(model.arch.levels)
    head = sum(1 for name, _ in model.head.named_children())
    # every conv once, the head's once a level
    assert n_conv == len(convs) - head + head * levels
    assert [op.kind for op in ops].count("pool") == 1 + (not model.arch.extra_conv_levels)
    assert [op.kind for op in ops].count("up") == len(model.fpn.laterals) - 1
    windows = set()
    for op in ops:
        k, s, p, d = op.window
        windows.add(op.window)
        for n in (2, 3, 4):
            for m in range(n):
                band = row_band(op.h_out, n, m)
                got = upsample_rows(band) if op.kind == "up" else needed_rows(band, k, s, p, d)
                if band[1] <= band[0]:
                    assert got[1] <= got[0]
                    continue
                want = (band[0] // 2, (band[1] - 1) // 2 + 1) if op.kind == "up" else _taps(
                    band, k, s, p, d)
                assert got == want, (op, n, m)
        if op.kind != "up":
            assert op.h_out == (op.h_in + 2 * p - d * (k - 1) - 1) // s + 1
    if which != "tiny":  # the stem, 3x3/2 (or 1x1/2 with STRIDE_1X1), the extra levels
        assert {(7, 2, 3, 1), (3, 2, 1, 1), (3, 1, 1, 1), (1, 1, 0, 1)} <= windows


@pytest.mark.parametrize("n", [2, 3, 4])
def test_plan_sends_equal_receives(n):
    """Over heights that leave bands empty and every window of the path:
    rank m's send to q is q's receive from m, and each rank's own rows with
    what it receives cover its needed rows inside the image exactly once."""
    windows = [(7, 2, 3, 1), (3, 2, 1, 1), (1, 2, 0, 1), (3, 1, 1, 1), (1, 1, 0, 1),
               (3, 1, 2, 2), (3, 2, 1, 1)]
    for h_in in (1, 2, 3, 5, 7, 10, 20):
        cases = [(w, (h_in + 2 * w[2] - w[3] * (w[0] - 1) - 1) // w[1] + 1) for w in windows]
        cases.append(("up", 2 * h_in))
        for w, h_out in cases:
            if h_out < 1:
                continue
            bands = [row_band(h_out, n, q) for q in range(n)]
            needs = [upsample_rows(b) if w == "up" else needed_rows(b, *w) for b in bands]
            plans = [plan(h_in, needs, m) for m in range(n)]
            for m, p in enumerate(plans):
                for q, r0, r1 in p.sends:
                    assert (m, r0, r1) in plans[q].recvs
                for q, r0, r1 in p.recvs:
                    assert (m, r0, r1) in plans[q].sends
                lo, hi = max(p.lo, 0), min(p.hi, h_in)
                got = [r for _, r0, r1 in p.recvs for r in range(r0, r1)]
                got += list(range(max(lo, p.a), min(hi, p.b)))
                assert sorted(got) == list(range(lo, hi)) if hi > lo else not got


# --------------------------------------------------------------------------- #
# The banded forward and backward, and serving: one spawn a world
# --------------------------------------------------------------------------- #


def _port(arch, params, **over):
    a = dataclasses.replace(ModelArch(**dataclasses.asdict(arch)), **over)
    return load_params(RetinaNet(a), params)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The tiny student with random float32 weights, at FREEZE_AT 0 (every
    parameter and the input take a gradient), its images, and the saved
    (model, images) of each forward job; the serving pair of
    tests/test_torch_inference.py."""
    arch = graft._tiny_arch()
    tmp = tmp_path_factory.mktemp("spatial")
    rng = np.random.RandomState(0)
    x128 = rng.randn(2, 128, 128, 3).astype(np.float32)
    x160 = rng.randn(2, 160, 128, 3).astype(np.float32)
    params = random_params(JaxRetinaNet(arch), x128[:1], 1)
    paths = {}
    for name, x, over in (("f32_128", x128, {}), ("f32_160", x160, {}),
                          ("f64_160", x160, {"compute_dtype": "float64"})):
        model = _port(arch, params, freeze_at=0, **over)
        dt = torch.float64 if over else torch.float32
        paths[name] = str(tmp / f"{name}.pt")
        torch.save({"model": model.to(dt), "images": torch.from_numpy(x).to(dt)}, paths[name])
    jc, tc = j_merge(jcfg.Config(), SERVE_CFG), t_merge(tcfg.Config(), SERVE_CFG)
    data, im_hw, scale, content = canvases(0)
    sparams = random_params(JaxRetinaNet(arch), data.astype(np.float32), seed=3)
    sport = _port(arch, sparams).eval()
    serve = tuple(torch.from_numpy(a) for a in (data, im_hw, scale, content))
    paths["serve"] = str(tmp / "serve.pt")
    torch.save((tc, sport, *serve), paths["serve"])
    return {"arch": arch, "params": params, "x128": x128, "x160": x160, "paths": paths,
            "serve": (jc, tc, sparams, sport, serve)}


def _world(world, jobs):
    return spawn(profile_spatial.rank_jobs, world, (jobs,), device="cpu", timeout_s=TIMEOUT_S,
                 threads=1)


def _jax_forward(arch, params, x):
    out = jax.jit(lambda p, im: JaxRetinaNet(arch).apply({"params": p}, im))(params,
                                                                              jnp.asarray(x))
    return {k: {lvl: np.asarray(v) for lvl, v in d.items()} for k, d in out.items()}


@pytest.fixture(scope="module")
def worlds(setup):
    """The worlds' results (spawned at once) and sad_tpu's forwards, which
    this process jits meanwhile."""
    p = setup["paths"]
    fwd = "forward"
    jobs = {
        4: [(fwd, dict(path=p["f32_128"], n_data=1, n_model=4)),
            (fwd, dict(path=p["f32_128"], n_data=2, n_model=2))],
        3: [(fwd, dict(path=p["f32_160"], n_data=1, n_model=3)),
            (fwd, dict(path=p["f64_160"], n_data=1, n_model=3))],
        2: [("infer", dict(build=profile_ddp.load_run, build_kwargs={"path": p["serve"]},
                           n_data=1, n_model=2, keep_outputs=True))],
    }
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {w: pool.submit(_world, w, j) for w, j in jobs.items()}
        ref = {h: _jax_forward(setup["arch"], setup["params"], setup[f"x{h}"])
               for h in (128, 160)}
        return {w: f.result() for w, f in futures.items()}, ref


def _one_process(path):
    """The saved model's whole forward, and the gradients of the scalar."""
    saved = torch.load(path, weights_only=False)
    model, x = saved["model"], saved["images"].clone().requires_grad_(True)
    out = model(x)
    shapes = {k: {lvl: tuple(v.shape) for lvl, v in d.items()} for k, d in out.items()}
    scalar = profile_spatial.output_scalar(out, shapes)
    named = [(n, q) for n, q in model.named_parameters() if q.requires_grad]
    got = torch.autograd.grad(scalar, [x] + [q for _, q in named])
    return ({k: {lvl: v.detach().numpy() for lvl, v in d.items()} for k, d in out.items()},
            got[0].numpy(), {n: g.numpy() for (n, _), g in zip(named, got[1:])})


def _joined(ranks, n_data, n_model, get):
    """The ranks' pieces joined: bands by rows within a data index, then the
    data blocks."""
    blocks = []
    for d in range(n_data):
        bands = [get(r) for r in ranks[d * n_model:(d + 1) * n_model]]
        blocks.append(np.concatenate(bands, axis=1))
    return np.concatenate(blocks, axis=0)


FORWARD_CASES = [(4, 0, "f32_128", 1, 4), (4, 1, "f32_128", 2, 2), (3, 0, "f32_160", 1, 3)]


@pytest.mark.parametrize("world,job,name,n_data,n_model", FORWARD_CASES)
def test_banded_forward_matches_one_process_and_sad_tpu(setup, worlds, world, job, name,
                                                        n_data, n_model):
    results, ref = worlds
    ranks = [r[job] for r in results[world]]
    one, _, _ = _one_process(setup["paths"][name])
    jref = ref[int(name[-3:])]
    empty = 0
    for key in ALL_OUTPUTS:
        for lvl, want in one[key].items():
            got = _joined(ranks, n_data, n_model, lambda r: r["out"][key][lvl])
            assert got.shape == want.shape, (key, lvl)
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), (key, lvl)
            assert np.abs(got - jref[key][lvl]).max() <= 2e-5, (key, lvl)
            empty += sum(r["out"][key][lvl].shape[1] == 0 for r in ranks)
    if name == "f32_128" and n_model == 4:  # P7 is 1 row, P6 2: 3 + 2 bands of each output empty
        assert empty == 5 * len(ALL_OUTPUTS)


def _rel_l2(got, want):
    return float(np.linalg.norm((got - want).ravel()) / max(np.linalg.norm(want.ravel()), 1e-300))


@pytest.mark.parametrize("world,job,name,n_data,n_model,tol", [
    (4, 0, "f32_128", 1, 4, 1e-5), (4, 1, "f32_128", 2, 2, 1e-5), (3, 1, "f64_160", 1, 3, 1e-12)])
def test_banded_backward_matches_one_process(setup, worlds, world, job, name, n_data, n_model,
                                             tol):
    results, _ = worlds
    ranks = [r[job] for r in results[world]]
    _, gx, grads = _one_process(setup["paths"][name])
    got_x = _joined(ranks, n_data, n_model, lambda r: r["grad_x"])
    assert _rel_l2(got_x, gx) <= tol
    worst = max((_rel_l2(sum(r["grads"][k] for r in ranks), g), k) for k, g in grads.items())
    assert worst[0] <= tol, worst
    assert len(grads) == len(ranks[0]["grads"]) > 30


def test_content_mask_of_a_band():
    """Bands of a canvas whose contents end in the second band (rows 64..127
    of 128 over 2, or inside band 2 of 3) normalise as the whole canvas."""
    rng = np.random.RandomState(5)
    u8 = torch.from_numpy(rng.randint(0, 256, (3, 128, 96, 3)).astype(np.uint8))
    hw = torch.tensor([[100.0, 96.0], [70.0, 50.0], [128.0, 20.0]])
    args = ((102.98, 115.95, 122.77), 1.0, (57.375, 57.12, 58.395))
    whole = normalize_u8_on_device(u8, *args, content_hw=hw)
    for n in (2, 3):
        parts = []
        for m in range(n):
            r0, r1 = row_band(128, n, m)
            parts.append(normalize_u8_on_device(u8[:, r0:r1], *args, content_hw=hw, row0=r0))
            assert torch.equal(content_mask(u8[:, r0:r1].shape, hw, r0),
                               content_mask(u8.shape, hw)[:, r0:r1])
        assert torch.equal(torch.cat(parts, dim=1), whole)
    # the mask of a band without its offset would differ
    assert not torch.equal(content_mask(u8[:, 64:].shape, hw), content_mask(u8.shape, hw)[:, 64:])


def test_height_sharded_serving_matches_one_process_and_sad_tpu(worlds, setup):
    results, _ = worlds
    first, other = (r[0] for r in results[2])
    assert "dets" not in other and first["transport"] == other["transport"] == "gloo"
    jc, tc, sparams, sport, serve = setup["serve"]
    assert first["band_rows"] == [0, 64] and other["band_rows"] == [64, 128]
    assert serve[3][:, 0].min() > 64  # every content ends in the second band
    one = make_inference_fn(tc, sport)(*serve)
    got = first["dets"]
    for key in ("classes", "valid"):
        np.testing.assert_array_equal(got[key], one[key].numpy())
    for key in ("boxes", "scores"):
        want = one[key].numpy()
        assert np.abs(got[key] - want).max() <= 1e-5 * np.abs(want).max(), key
    ref = j_make_inference_fn(jc, JaxRetinaNet(setup["arch"]))(
        sparams, *(jnp.asarray(t.numpy()) for t in serve))
    _assert_same_detections(ref, got, 2)
    # the gathered level maps are whole: P7 of a 128-row canvas is 1 row
    assert first["raw"]["cls_prob"][7].shape[1] == 1
    with torch.device("meta"):
        meta = RetinaNet(ModelArch(**dataclasses.asdict(setup["arch"])))
    assert [first["halo_bytes_per_batch"], other["halo_bytes_per_batch"]] == (
        profile_spatial.predicted_halo_bytes(meta, (128, 256), 2, 2, ("cls_prob", "bbox_pred")))
    assert first["launches"]["nms"] == other["launches"]["nms"] == 0  # the plain NMS here


# --------------------------------------------------------------------------- #
# Refusals
# --------------------------------------------------------------------------- #


def test_rcnn_models_and_unknown_modules_do_not_run_banded():
    rcnn = create_model(load_cfg(f"{CONFIGS}/e2e_mask_rcnn_R-50-FPN.yaml"), "meta")
    with pytest.raises(NotImplementedError, match="item 7b"):
        spatialize(rcnn, Mesh(1, 2))
    assert spatialize(rcnn, Mesh(2, 1)) is rcnn  # the data axis alone bands nothing
    tiny = RetinaNet(ModelArch(**dataclasses.asdict(graft._tiny_arch())))
    tiny.head.extra = torch.nn.BatchNorm2d(4)
    with pytest.raises(NotImplementedError, match="BatchNorm2d.*item 7b"):
        spatialize(tiny, Mesh(1, 2))
