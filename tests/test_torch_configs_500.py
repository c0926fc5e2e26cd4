"""The paper's second experiment, R-101 student <- X-101-64x4d teacher at
input scale 500 (sad_tpu_torch/configs/retinanet_{R-101-FPN_student,
X-101-64x4d-FPN_teacher}_500.yaml): the YAMLs load with the stated archs in
both packages; a training batch of the pair lands on the 512x896 canvas,
which the teacher shares; a tiny-depth joint step of the pair (the
student's body, a ResNeXt teacher of 4 groups of width 4 with the stride on
the 3x3 conv, both FOLD_AFFINE as the YAMLs) matches sad_tpu's over two
steps at float32: metrics within 1e-4 relative, every parameter and
velocity leaf within 1e-4 * max|ref| (the bounds and batches of
tests/test_torch_train_step.py); and the workflow runs through its entry
points on the CPU at a quarter of the width: test_net --pseudo-out serves the
64-group teacher over the unlabeled split into the coco_2017_unlabel_X101_500
set, and train_net trains the student with it as the unlabeled stream."""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sad_tpu.config as jcfg
from sad_tpu.models import RetinaNet as JaxRetinaNet
from sad_tpu.models import arch as jarch
from sad_tpu.train import TrainState as JaxTrainState
from sad_tpu.train import make_train_step as j_make_train_step
import sad_tpu_torch.config as tcfg
from sad_tpu_torch.config import catalog
from sad_tpu_torch.config.config import cfg_to_yaml
from sad_tpu_torch.convert import load_params, params_to_state_dict
from sad_tpu_torch.data.minibatch import RetinaNetMinibatchBuilder
from sad_tpu_torch.data.synth_coco import generate_synthetic_coco
from sad_tpu_torch.data.synthetic import random_train_entries
from sad_tpu_torch.models import RetinaNet, arch as tarch
from sad_tpu_torch.train import TrainState, batch_to_torch, make_train_step
from test_torch_models import one_torch_thread, random_params  # noqa: F401
from test_torch_train_step import G, LR, _batch, _check_tree

REPO = Path(__file__).resolve().parent.parent
STUDENT = str(REPO / "sad_tpu_torch/configs/retinanet_R-101-FPN_student_500.yaml")
TEACHER = str(REPO / "sad_tpu_torch/configs/retinanet_X-101-64x4d-FPN_teacher_500.yaml")
OPTS = ["NUM_GPUS", str(G), "COMPUTE_DTYPE", "float32", "PIXEL_STD", "(57.375,57.12,58.395)"]


def test_yamls_load_with_the_stated_archs():
    for path, depth, groups, width, stride_1x1 in ((STUDENT, 101, 1, 64, True),
                                                   (TEACHER, 101, 64, 4, False)):
        j, t = jcfg.load_cfg(path), tcfg.load_cfg(path)
        a, b = jarch.arch_from_config(j), tarch.arch_from_config(t)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert (b.depth, b.block_counts, b.num_groups, b.width_per_group, b.stride_1x1) == (
            depth, (3, 4, 23, 3), groups, width, stride_1x1)
        assert b.fold_affine and b.fpn_dim == 256 and b.levels == (3, 4, 5, 6, 7)
        assert (t.TRAIN.SCALES, t.TRAIN.MAX_SIZE, t.TEST.SCALES, t.TEST.MAX_SIZE) == (
            (500,), 833, (500,), 833)
    s = tcfg.load_cfg(STUDENT)
    assert s.MODEL.TYPE == "distillation" and s.DISTILLATION.UNLABEL_DISTILLATION
    assert s.DISTILLATION.UNLABEL_DATASETS == ("coco_2017_unlabel_X101_500",)
    assert tcfg.load_cfg(TEACHER).MODEL.TYPE == "retinanet"


def test_profile_train_takes_the_pair_and_refuses_a_half():
    """profile_train --cfg <student> --teacher_cfg <teacher> profiles the
    pair's joint step; a student without its teacher, or a teacher beside an
    R-CNN config, is refused before anything touches the card."""
    from sad_tpu_torch.tools import profile_train

    faster = str(REPO / "sad_tpu_torch/configs/e2e_faster_rcnn_R-50-FPN.yaml")
    for argv in (["--cfg", STUDENT], ["--teacher_cfg", TEACHER],
                 ["--cfg", faster, "--teacher_cfg", TEACHER]):
        with pytest.raises(SystemExit) as info:
            profile_train.main(argv)
        assert info.value.code == 2


def test_pair_batch_on_the_512x896_canvas():
    """The builder of the pair puts both models on the student's canvas: one
    uint8 canvas a landscape image, labels on the canvas's anchor grid."""
    s, t = tcfg.load_cfg(STUDENT, OPTS), tcfg.load_cfg(TEACHER, OPTS)
    entries, images = random_train_entries(np.random.RandomState(0), 4, max_side=833,
                                           num_classes=81)
    builder = RetinaNetMinibatchBuilder(s, t, device_normalize=True)
    assert builder.landscape == (512, 896) and builder.portrait == (896, 512)
    built = builder.build(entries, images, seed=0)
    assert built.data_u8.shape == (4, 512, 896, 3)
    for lvl in s.fpn_levels():
        assert built.labels[lvl].shape == (4, -(-512 // 2 ** lvl), -(-896 // 2 ** lvl), 9)
    assert built.fg_num.shape == (G,) and float(built.fg_num.sum()) > 0


@pytest.fixture(scope="module")
def pair():
    """Both packages' configs from the YAMLs, and tiny-depth archs of the pair."""
    jc, tc = jcfg.load_cfg(STUDENT, OPTS), tcfg.load_cfg(STUDENT, OPTS)
    jtc, ttc = jcfg.load_cfg(TEACHER, OPTS), tcfg.load_cfg(TEACHER, OPTS)
    small = dict(block_counts=(1, 1, 1, 1), channel_ratio=1.0, fpn_dim=16, num_convs=1)
    s_arch = dataclasses.replace(jarch.arch_from_config(jc), width_per_group=8, **small)
    t_arch = dataclasses.replace(jarch.arch_from_config(jtc), num_groups=4, width_per_group=4,
                                 **dict(small, block_counts=(1, 1, 2, 1)))
    assert s_arch.fold_affine and t_arch.fold_affine and not t_arch.stride_1x1
    return jc, tc, jtc, ttc, s_arch, t_arch


def test_tiny_grouped_teacher_joint_step_matches_sad_tpu(pair):
    jc, tc, jtc, ttc, s_arch, t_arch = pair
    x = np.zeros((1, 128, 128, 3), np.float32)
    sp = random_params(JaxRetinaNet(s_arch), x, 11)
    tp = random_params(JaxRetinaNet(t_arch), x, 12)
    rng = np.random.RandomState(13)
    vel = jax.tree_util.tree_map(lambda a: (rng.randn(*a.shape) * 1e-3).astype(np.float32), sp)

    jstep = jax.jit(j_make_train_step(jc, JaxRetinaNet(s_arch), JaxRetinaNet(t_arch),
                                      n_groups=G, teacher_cfg=jtc))
    student = load_params(RetinaNet(tarch.ModelArch(**dataclasses.asdict(s_arch))), sp)
    teacher = load_params(RetinaNet(tarch.ModelArch(**dataclasses.asdict(t_arch))), tp)
    conv2b = teacher.fpn.body.Bottleneck_0.res2_0_branch2b
    assert conv2b.groups == 4 and conv2b.weight.shape[1] == 4  # 4 channels a group
    step = make_train_step(tc, student, teacher, n_groups=G, teacher_cfg=ttc)
    state = TrainState({k: v.clone() for k, v in params_to_state_dict(vel).items()})
    jstate = JaxTrainState(sp, vel)
    t_before = [p.detach().clone() for p in teacher.parameters()]
    for seed in (0, 1):
        batch = _batch(seed)
        jstate, jm = jstep(jstate, tp, jax.tree_util.tree_map(jnp.asarray, batch),
                           jnp.float32(LR))
        m = step(state, batch_to_torch(batch, "cpu"), LR)
        assert sorted(m) == sorted(jm) and "fl_distill_fpn7" in m
        for k in jm:
            ref = float(jm[k])
            assert abs(float(m[k]) - ref) <= 1e-4 * abs(ref), (k, float(m[k]), ref)
        _check_tree(student.state_dict(), jstate.params, "params")
        _check_tree(state.velocity, jstate.velocity, "velocity")
    assert all(torch.equal(p, q) for p, q in zip(teacher.parameters(), t_before))


def test_pseudo_labels_and_train_net_on_the_pair(tmp_path, monkeypatch):
    from sad_tpu_torch.tools import test_net, train_net

    def register(name, img_dir, js, pseudo=False):
        """Register a split under the YAMLs' dataset name for this test; its
        json lists COCO's 80 category ids, as the 81-class models predict."""
        with open(js) as f:
            doc = json.load(f)
        named = {c["id"]: c["name"] for c in doc["categories"]}
        doc["categories"] = [{"id": i, "name": named.get(i, f"c{i}")} for i in range(1, 81)]
        with open(js, "w") as f:
            json.dump(doc, f)
        monkeypatch.setitem(catalog.DATASET_CATALOG, name,
                            catalog.DatasetSpec(name, img_dir, js, pseudo))

    small = dict(size_range=(64, 96), objects_per_image=(1, 3), small_frac=0.0, crowd_frac=0.0,
                 ignore_frac=0.0)
    register("coco_2017_train", *generate_synthetic_coco(str(tmp_path), "train", 6, seed=1,
                                                         **small))
    unl_dir, unl_js = generate_synthetic_coco(str(tmp_path), "unl", 4, seed=2, labeled=False,
                                              size_range=(64, 96))
    register("coco_2017_unlabel", unl_dir, unl_js)
    shrink = ["RESNETS.CHANNEL_RATIO", "0.25", "TRAIN.SCALES", "(64,)", "TRAIN.MAX_SIZE", "128",
              "TEST.SCALES", "(64,)", "TEST.MAX_SIZE", "128", "COMPUTE_DTYPE", "float32",
              "PIXEL_STD", "(57.375,57.12,58.395)"]

    # the teacher's pseudo-labels over its TEST.DATASETS, coco_2017_unlabel
    pl = str(tmp_path / "pseudo_unlabeled2017_X101_500.json")
    test_net.main(["--cfg", TEACHER, "--device", "cpu", "--batch-size", "4", "--pseudo-out", pl,
                   "--pseudo-score-thresh", "0.0"] + shrink)
    with open(pl) as f:
        doc = json.load(f)
    assert len(doc["images"]) == 4 and doc["annotations"]
    register("coco_2017_unlabel_X101_500", unl_dir, pl, pseudo=True)

    teacher_yaml = tmp_path / "teacher.yaml"
    teacher_yaml.write_text(cfg_to_yaml(tcfg.load_cfg(TEACHER, shrink)))
    out = tmp_path / "out"
    result = train_net.main(["--cfg", STUDENT, "--teacher_cfg", str(teacher_yaml), "--skip-test",
                             "--device", "cpu", "OUTPUT_DIR", str(out), "SOLVER.MAX_ITER", "2",
                             "SOLVER.BASE_LR", "1e-4", "NUM_GPUS", "1",
                             "DATA_LOADER.NUM_THREADS", "1"] + shrink)
    assert result.feed_summary()["served"] == ["labeled", "unlabeled"]
    run = out / "train" / "coco_2017_train"
    assert (run / "model_final.pkl").exists()
    with open(run / "stats.jsonl") as f:
        stats = [json.loads(line) for line in f]
    assert stats and all(np.isfinite(r["loss"]) and "fl_distill_fpn3" in r for r in stats)
