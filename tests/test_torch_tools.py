"""The port's weight and result tools and small utils on the CPU, each against
sad_tpu's counterpart on the same seeded inputs:

- convert_selective_search, reval (COCO and VOC07), generate_testdev_from_test
  and pickle_caffe_blobs: outputs equal to sad_tpu's;
- convert_weights: blobs -> checkpoint -> blobs round trips exactly, and the
  blobs equal sad_tpu's flax_to_reference_blobs of the same weights (a tiny
  Mask R-CNN, so fc6 and the flattening-FC column order are covered);
- visualize_results writes an image a detected image;
- net_drawer: the module table and the dot text equal to sad_tpu's on the
  port's own YAMLs (no reference YAML is read), the model built on the meta
  device;
- dashboard: the HTML equal to sad_tpu's for the same run directory;
- utils/io, utils/env, AttrDict, the dummy COCO classes and the image list.
"""

import hashlib
import json
import os
import pickle

import numpy as np
import pytest
import scipy.io
import torch

import sad_tpu.config as jcfg
from sad_tpu.data import dummy_datasets as j_dummy
from sad_tpu.data import image_list_dataset as j_image_list
from sad_tpu.tools import convert_selective_search as j_ss
from sad_tpu.tools import dashboard as j_dashboard
from sad_tpu.tools import generate_testdev_from_test as j_testdev
from sad_tpu.tools import net_drawer as j_net_drawer
from sad_tpu.tools import pickle_caffe_blobs as j_caffe
from sad_tpu.tools import reval as j_reval
from sad_tpu.train import checkpoint as j_ck
from sad_tpu.utils import io as j_io
import sad_tpu_torch.config as tcfg
from sad_tpu_torch.config.config import cfg_to_yaml
from sad_tpu_torch.config.config import merge_cfg_from_dict as t_merge
from sad_tpu_torch.data import dummy_datasets, image_list_dataset
from sad_tpu_torch.data.synth_coco import generate_synthetic_coco
from sad_tpu_torch.models import create_model
from sad_tpu_torch.tools import (convert_selective_search, convert_weights, dashboard,
                                 generate_testdev_from_test, net_drawer, pickle_caffe_blobs,
                                 reval, visualize_results)
from sad_tpu_torch.train import checkpoint
from sad_tpu_torch.utils import collections_util, env
from sad_tpu_torch.utils import io as t_io
from test_caffe_convert import _blob, _ld, _layer, _write_caffemodel
from test_torch_models import one_torch_thread, sad_tpu_native_loaded  # noqa: F401  (autouse)
from test_torch_rcnn import TINY

SPLIT = "torch_tools_val"
YAMLS = ("retinanet_R-50-FPN_student", "e2e_mask_rcnn_R-50-FPN", "faster_rcnn_VGG16_voc07",
         "e2e_mask_rcnn_R-50-C4", "e2e_mask_rcnn_R-50-FPN_cityscapes")


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """A 4-image synthetic COCO split in both catalogs, and seeded
    detections of its images (COCO-format results)."""
    root = str(tmp_path_factory.mktemp("tools_data"))
    img_dir, js = generate_synthetic_coco(root, "val", 4, seed=1, size_range=(60, 100),
                                          objects_per_image=(1, 3))
    jcfg.register_dataset(SPLIT, img_dir, js, allow_override=True)
    tcfg.register_dataset(SPLIT, img_dir, js, allow_override=True)
    doc = json.load(open(js))
    rng = np.random.RandomState(0)
    dets = []
    for a in doc["annotations"]:
        x, y, w, h = a["bbox"]
        for _ in range(2):
            j = rng.normal(0, 2, 4)
            dets.append({"image_id": a["image_id"], "category_id": a["category_id"],
                         "bbox": [x + j[0], y + j[1], max(w + j[2], 1), max(h + j[3], 1)],
                         "score": float(rng.uniform(0.5, 1.0))})
    res = os.path.join(root, "results.json")
    with open(res, "w") as f:
        json.dump(dets, f)
    return root, doc, res


def test_selective_search_equals_sad_tpus(tmp_path, split):
    _, doc, _ = split
    rng = np.random.RandomState(2)
    names = [im["file_name"].rsplit(".", 1)[0] for im in doc["images"]]
    cells = np.empty((len(names),), dtype=object)
    for i in range(len(names)):
        b = rng.randint(1, 60, (rng.randint(0, 6), 4)).astype(np.float64)
        cells[i] = np.concatenate([b[:, :2], b[:, :2] + b[:, 2:]], axis=1)
    mat = str(tmp_path / "ss.mat")
    scipy.io.savemat(mat, {"boxes": cells, "images": np.array(names, dtype=object)})
    ann = str(tmp_path / "ann.json")
    with open(ann, "w") as f:
        json.dump(doc, f)
    for extra in ([], ["--id-map", ann]):
        j_ss.main(["--mat", mat, "--output", str(tmp_path / "j.pkl"), *extra])
        convert_selective_search.main(["--mat", mat, "--output", str(tmp_path / "t.pkl"), *extra])
        ref, got = (pickle.load(open(tmp_path / f, "rb")) for f in ("j.pkl", "t.pkl"))
        assert got["ids"] == ref["ids"] and len(got["boxes"]) == len(names)
        for key in ("boxes", "scores"):
            for a, b in zip(ref[key], got[key]):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
    assert got["ids"] == [im["id"] for im in doc["images"]]


@pytest.mark.parametrize("extra", [[], ["--voc"], ["--voc", "--voc-07"]])
def test_reval_equals_sad_tpus(split, extra):
    _, _, res = split
    argv = ["--dataset", SPLIT, "--results", res, *extra]
    ref, got = j_reval.main(argv), reval.main(argv)
    assert got == ref and ("mAP" in got) == bool(extra)


def test_testdev_filter_equals_sad_tpus(split, tmp_path):
    _, doc, res = split
    ann = str(tmp_path / "testdev.json")
    with open(ann, "w") as f:
        json.dump({"images": doc["images"][1:3]}, f)
    for mod, out in ((j_testdev, "j.json"), (generate_testdev_from_test, "t.json")):
        mod.main(["--results", res, "--testdev-ann", ann, "--output", str(tmp_path / out)])
    got = (tmp_path / "t.json").read_bytes()
    assert got == (tmp_path / "j.json").read_bytes()
    assert {d["image_id"] for d in json.loads(got)} == {im["id"] for im in doc["images"][1:3]}


def test_pickle_caffe_blobs_equals_sad_tpus(tmp_path):
    rng = np.random.RandomState(4)
    f32 = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    var = np.abs(f32(8)) + 0.5
    p = str(tmp_path / "net.caffemodel")
    _write_caffemodel(p, [
        _layer("conv1", "Convolution", [f32(8, 3, 7, 7)]),
        _layer("bn_conv1", "BatchNorm", [f32(8), var, np.ones(1, np.float32)]),
        _layer("scale_conv1", "Scale", [f32(8), f32(8)]),
        _layer("res4b11_branch2c", "Convolution", [f32(16, 8, 1, 1), f32(16)]),
        _layer("bn4b11_branch2c", "BatchNorm", [f32(16), np.abs(f32(16)) + 0.5,
                                                np.ones(1, np.float32)]),
        _layer("scale4b11_branch2c", "Scale", [f32(16), f32(16)]),
        _layer("fc1000", "InnerProduct", [f32(10, 16), f32(10)]),
        _layer("relu1", "ReLU", []),
        _ld(100, _ld(1, b"ip2") + _ld(2, b"InnerProduct") + _ld(7, _blob(f32(3, 4), False))),
    ])
    ref, got = j_caffe.parse_caffemodel(p), pickle_caffe_blobs.parse_caffemodel(p)
    assert [(l["name"], l["type"]) for l in got] == [(l["name"], l["type"]) for l in ref]
    for a, b in zip(ref, got):
        for x, y in zip(a["blobs"], b["blobs"], strict=True):
            np.testing.assert_array_equal(x, y)
    for mod, out in ((j_caffe, "j.pkl"), (pickle_caffe_blobs, "t.pkl")):
        mod.main(["--caffemodel", p, "--output", str(tmp_path / out)])
    r, g = (pickle.load(open(tmp_path / f, "rb"))["blobs"] for f in ("j.pkl", "t.pkl"))
    assert sorted(g) == sorted(r) and "res4_11_branch2c_bn_s" in g and "conv1_b" in g
    for k in r:
        assert g[k].dtype == r[k].dtype
        np.testing.assert_array_equal(g[k], r[k])
    for name in ("res4b11_branch2c", "res2a_branch1", "res3d_branch2b", "conv1", "res_conv1"):
        assert pickle_caffe_blobs.normalize_resnet_name(name) == j_caffe.normalize_resnet_name(name)


def test_convert_weights_round_trips_and_equals_sad_tpus_blobs(tmp_path):
    over = dict(TINY, MODEL=dict(TINY["MODEL"], MASK_ON=True))
    cfg = t_merge(tcfg.Config(), over)
    yml = str(tmp_path / "cfg.yaml")
    with open(yml, "w") as f:
        f.write(cfg_to_yaml(cfg))
    model = create_model(cfg, "cpu", torch.Generator().manual_seed(7))
    ck = str(tmp_path / "model.pkl")
    checkpoint.save_checkpoint(ck, model)
    convert_weights.main(["--cfg", yml, "--to-blobs", "--input", ck,
                          "--output", str(tmp_path / "blobs.pkl")])
    blobs = pickle.load(open(tmp_path / "blobs.pkl", "rb"))["blobs"]
    res = checkpoint.fc_flatten_resolutions(cfg)
    ref = j_ck.flax_to_reference_blobs(j_ck.load_checkpoint(ck)["params"], fc_resolutions=res)
    assert sorted(blobs) == sorted(ref) and "fc6_w" in blobs
    for k in ref:
        np.testing.assert_array_equal(blobs[k], ref[k])
    convert_weights.main(["--cfg", yml, "--input", str(tmp_path / "blobs.pkl"),
                          "--output", str(tmp_path / "back.pkl")])
    back = checkpoint.load_checkpoint(str(tmp_path / "back.pkl"))["params"]
    again = create_model(cfg, "cpu", torch.Generator().manual_seed(8))
    checkpoint.load_params(again, back)
    for (k, a), b in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k


def test_visualize_results_writes_images(split, tmp_path):
    _, doc, res = split
    out = str(tmp_path / "vis")
    visualize_results.main(["--dataset", SPLIT, "--results", res, "--output-dir", out,
                            "--thresh", "0.0", "--first", "3"])
    files = sorted(os.listdir(out))
    assert files == sorted(im["file_name"].rsplit(".", 1)[0] + "_det.png"
                           for im in doc["images"][:3])


@pytest.mark.parametrize("yaml", YAMLS)
def test_net_drawer_equals_sad_tpus(yaml, tmp_path):
    import jax

    from sad_tpu.config import load_cfg as j_load
    from sad_tpu.models import create_model as j_create
    from sad_tpu.models.model_builder import init_model_params

    path = os.path.join("sad_tpu_torch", "configs", yaml + ".yaml")
    opts = ["RESNETS.CHANNEL_RATIO", "0.0625"]
    jc = j_load(path, opts)
    jmodel = j_create(jc)
    params = jax.eval_shape(lambda: init_model_params(jmodel, jax.random.PRNGKey(0),
                                                      (1, 128, 128, 3)))
    sd = create_model(tcfg.load_cfg(path, opts), "meta").state_dict()
    assert net_drawer.module_table(sd) == j_net_drawer.module_table(params)
    dot = net_drawer.to_dot(tcfg.load_cfg(path, opts), sd)
    assert dot == j_net_drawer.to_dot(jc, params) and "->" in dot
    out = str(tmp_path / "m.dot")
    net_drawer.main(["--cfg", path, "--out", out, *opts])
    assert open(out).read().startswith("digraph")


def test_dashboard_html_equals_sad_tpus(tmp_path):
    run = tmp_path / "run"
    run.mkdir()
    rng = np.random.RandomState(5)
    with open(run / "stats.jsonl", "w") as f:
        for it in range(0, 200, 20):
            f.write(json.dumps({"iter": it, "loss": float(rng.uniform(0.1, 2)),
                                "lr": 0.01, "time": float(rng.uniform()), "eta": "0:01"}) + "\n")
        f.write(json.dumps({"iter": 200, "loss": float("nan"), "lr": 0.01}) + "\n")
    (run / "model_iter19.pkl").write_bytes(b"\0" * 1000)
    (run / "cfg.yaml").write_text("MODEL:\n  TYPE: retinanet\n")
    html = dashboard.render_report(str(run))
    assert html == j_dashboard.render_report(str(run))
    assert "<svg" in html and "model_iter19.pkl" in html
    out = dashboard.main(["--dir", str(run)])
    assert open(out).read() == html


def test_io_env_and_small_counterparts(tmp_path):
    obj = {"a": np.arange(3), "b": [1, "x"]}
    t_io.save_object(obj, str(tmp_path / "o" / "obj.pkl"))
    back = j_io.load_object(str(tmp_path / "o" / "obj.pkl"))
    np.testing.assert_array_equal(back["a"], obj["a"])
    assert back["b"] == obj["b"]
    assert t_io.load_object(str(tmp_path / "o" / "obj.pkl"))["b"] == obj["b"]
    # the cache-hit path only: the file is placed first, nothing is fetched
    url = "https://example.invalid/weights/R-50.pkl"
    cache = str(tmp_path / "cache")
    os.makedirs(cache)
    # sad_tpu's name for the cached file: 12 hex digits of the URL's md5
    placed = os.path.join(cache, hashlib.md5(url.encode()).hexdigest()[:12] + "_R-50.pkl")
    with open(placed, "wb") as f:
        f.write(b"w")
    assert t_io.cache_url(url, cache) == j_io.cache_url(url, cache) == placed
    assert t_io.cache_url("/local/file.pkl", cache) == "/local/file.pkl"
    assert t_io.is_url(url) and not t_io.is_url("/x")

    info = env.get_runtime_info()
    assert info["torch_version"] == torch.__version__
    assert info["device_count"] == str(torch.cuda.device_count())
    libs = env.get_native_kernels_lib()
    assert os.path.exists(libs["host"])
    if not torch.cuda.is_available():
        assert libs["cuda"].startswith("(not built")

    d = collections_util.AttrDict(a=1)
    d.b = 2
    assert d.a == 1 and d["b"] == 2
    with pytest.raises(AttributeError):
        d.c  # noqa: B018
    assert dummy_datasets.get_coco_dataset().classes == j_dummy.get_coco_dataset().classes
    lst = tmp_path / "list.txt"
    lst.write_text("a/1.jpg 3\nb/2.jpg\n\nc/3.jpg 0\n")
    ref = j_image_list.ImageListDataset(str(lst), "/imgs")
    got = image_list_dataset.ImageListDataset(str(lst), "/imgs")
    assert got.get_roidb() == ref.get_roidb() and len(got) == 3
