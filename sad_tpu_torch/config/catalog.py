"""Dataset catalog: logical dataset name -> on-disk image dir + annotation file.

A copy of sad_tpu/config/catalog.py, but for the default data root: without
SAD_TPU_DATA_DIR the port looks under data/ in its own checkout.

Replaces ``detectron/lib/datasets/dataset_catalog.py:39-219``. The reference
had a duplicate-key bug where 'coco_2017_unlabel_R101_600' was registered twice
(dataset_catalog.py:207/:213) and the second (X101) entry silently won; here the
two teachers' pseudo-label sets get distinct names and re-registration of an
existing name raises unless explicitly allowed.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class DatasetSpec:
    name: str
    image_directory: str
    annotation_file: str
    # Pseudo-labeled datasets are generated by a teacher (semi-supervised loop)
    # and behave exactly like GT datasets during training (SURVEY.md §3.4).
    is_pseudo_labeled: bool = False
    # RAW_DIR (cityscapes entries, dataset_catalog.py:46) — the gtFine tree,
    # used by the official-format result exporter; DEVKIT_DIR (voc entries,
    # dataset_catalog.py:181) — the VOCdevkit root for the VOC evaluator.
    raw_dir: str = ""
    devkit_dir: str = ""


# the data root: $SAD_TPU_DATA_DIR, else data/ in the repository checkout
_DATA_DIR = os.environ.get(
    "SAD_TPU_DATA_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                 "data"))


def _coco(split_dir: str, ann: str, name: str, pseudo: bool = False) -> DatasetSpec:
    return DatasetSpec(
        name=name,
        image_directory=os.path.join(_DATA_DIR, "coco", split_dir),
        annotation_file=os.path.join(_DATA_DIR, "coco", "annotations", ann),
        is_pseudo_labeled=pseudo,
    )


def _cityscapes(split: str) -> DatasetSpec:
    """Cityscapes instance-seg splits as COCO jsons (dataset_catalog.py:40-64;
    produce the json with tools/convert_cityscapes_to_coco.py)."""
    root = os.path.join(_DATA_DIR, "cityscapes")
    ann = (
        "instancesonly_filtered_gtFine_val.json"
        if split == "val"
        else f"instancesonly_gtFine_{split}.json"
    )
    return DatasetSpec(
        name=f"cityscapes_fine_instanceonly_seg_{split}",
        image_directory=os.path.join(root, "images"),
        annotation_file=os.path.join(root, "annotations", ann),
        raw_dir=os.path.join(root, "raw"),
    )


def _voc(year: str, split: str) -> DatasetSpec:
    root = os.path.join(_DATA_DIR, f"VOC{year}")
    return DatasetSpec(
        name=f"voc_{year}_{split}",
        image_directory=os.path.join(root, "JPEGImages"),
        annotation_file=os.path.join(root, "annotations", f"voc_{year}_{split}.json"),
        devkit_dir=os.path.join(root, f"VOCdevkit{year}"),
    )




DATASET_CATALOG: Dict[str, DatasetSpec] = {
    s.name: s
    for s in [
        _coco("train2017", "instances_train2017.json", "coco_2017_train"),
        _coco("val2017", "instances_val2017.json", "coco_2017_val"),
        _coco("test2017", "image_info_test2017.json", "coco_2017_test"),
        _coco("test2017", "image_info_test-dev2017.json", "coco_2017_test-dev"),
        _coco("unlabeled2017", "image_info_unlabeled2017.json", "coco_2017_unlabel"),
        # Teacher-generated pseudo-label annotation sets (distinct names per
        # teacher — fixing the reference's duplicate-key bug).
        _coco(
            "unlabeled2017",
            "pseudo_unlabeled2017_R101_600.json",
            "coco_2017_unlabel_R101_600",
            pseudo=True,
        ),
        _coco(
            "unlabeled2017",
            "pseudo_unlabeled2017_X101_500.json",
            "coco_2017_unlabel_X101_500",
            pseudo=True,
        ),
        # COCO 2014 family (dataset_catalog.py:65-100). minival -> val2017 is
        # the reference fork's mapping and is CONTENT-identical
        # (minival2014 == val2017). The fork also maps valminusminival ->
        # train2017, but that is a strict superset (train2017 = train2014 +
        # valminusminival): an upstream trainval config naming
        # ('coco_2014_train','coco_2014_valminusminival') would silently
        # duplicate all of train2014. We keep the true split instead
        # (val2014 images + the valminusminival json, as upstream Detectron).
        _coco("train2014", "instances_train2014.json", "coco_2014_train"),
        _coco("val2014", "instances_val2014.json", "coco_2014_val"),
        _coco("val2017", "instances_val2017.json", "coco_2014_minival"),
        _coco(
            "val2014", "instances_valminusminival2014.json",
            "coco_2014_valminusminival",
        ),
        _coco("test2015", "image_info_test2015.json", "coco_2015_test"),
        _coco("test2015", "image_info_test-dev2015.json", "coco_2015_test-dev"),
        # person-keypoints splits (dataset_catalog.py:141-176)
        _coco(
            "train2014", "person_keypoints_train2014.json",
            "keypoints_coco_2014_train",
        ),
        _coco("val2014", "person_keypoints_val2014.json", "keypoints_coco_2014_val"),
        _coco(
            "val2014", "person_keypoints_minival2014.json",
            "keypoints_coco_2014_minival",
        ),
        _coco(
            "val2014", "person_keypoints_valminusminival2014.json",
            "keypoints_coco_2014_valminusminival",
        ),
        _coco(
            "test2015", "image_info_test2015.json", "keypoints_coco_2015_test"
        ),
        _coco(
            "test2015", "image_info_test-dev2015.json",
            "keypoints_coco_2015_test-dev",
        ),
        _cityscapes("train"),
        _cityscapes("val"),
        _cityscapes("test"),
        _voc("2007", "trainval"),
        _voc("2007", "test"),
        _voc("2012", "trainval"),
    ]
}


def get_dataset_spec(name: str) -> DatasetSpec:
    if name not in DATASET_CATALOG:
        raise KeyError(
            f"Unknown dataset: {name!r}. Known: {sorted(DATASET_CATALOG)}. "
            "Register custom datasets with sad_tpu_torch.config.register_dataset."
        )
    return DATASET_CATALOG[name]


def register_dataset(
    name: str,
    image_directory: str,
    annotation_file: str,
    is_pseudo_labeled: bool = False,
    allow_override: bool = False,
) -> DatasetSpec:
    """Register (or explicitly override) a dataset entry."""
    if name in DATASET_CATALOG and not allow_override:
        raise ValueError(
            f"Dataset {name!r} already registered; pass allow_override=True "
            "to replace it (silent duplicate keys were a reference bug)."
        )
    spec = DatasetSpec(name, image_directory, annotation_file, is_pseudo_labeled)
    DATASET_CATALOG[name] = spec
    return spec
