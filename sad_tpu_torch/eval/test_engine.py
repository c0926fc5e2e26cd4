"""Dataset inference, COCO evaluation and pseudo-label generation (ref:
sad_tpu/eval/test_engine.py; detectron/lib/core/test_engine.py).

Images are batched onto the static test canvases as uint8 with their
content extents, normalised and decoded on the device, and the (N, 100)
results come back as COCO-format detection dicts: for RetinaNet, and for
Faster / Mask R-CNN (generalized_rcnn with FPN). Mask R-CNN's kept masks are
gathered to each detection's own class on the card, pasted into the image
frame and RLE-encoded on the host. ``test_net_on_dataset`` scores them with
the COCO evaluator (bbox, and segm under MODEL.MASK_ON), writes
bbox_results.json, results.json and timing.json (the host split of the
loop), and with cfg.VIS renders each image with its boxes and masks.

Over the torchrun world (``multi_gpu``, test_net --multi-gpu-testing) each
rank serves a contiguous shard of the roidb, the counterpart of the
reference's --range subprocesses (test_engine.py:115-153) and of sad_tpu's
mesh batch sharding (sad_tpu/eval/test_engine.py:195-212); rank 0 merges
the detections in the one-process order (the landscape images in roidb
order, then the portrait ones), evaluates and writes the files.

Not ported yet, and raising NotImplementedError naming their ROADMAP.md
item when a config asks for them: test-time augmentation, soft-NMS, box
voting and proposals from files (Queue 1 item 8; sad_tpu's RetinaNet branch
ignores TEST.BBOX_AUG, TEST.SOFT_NMS and TEST.BBOX_VOTE,
sad_tpu/eval/test_engine.py:160, and so does the port's), keypoints (item
8), and the VOC, Cityscapes-mask and VID evaluators (item 9).

Dataset I/O is the port's copy of sad_tpu's host modules (sad_tpu_torch.data).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config.config import get_output_dir
from ..data.dataset import CocoDataset
from ..data.minibatch import compute_im_scale, load_image_bgr, resize_bgr_u8
from ..parallel.distributed import (
    barrier, broadcast_object, current, gather_objects, world_size,
)
from ..utils.segms import mask_to_rle, paste_mask_into_image
from .coco_eval import COCOEvaluator
from .inference import make_inference_fn
from .rcnn_inference import make_rcnn_inference_fn

logger = logging.getLogger(__name__)

# the host split of run_inference_on_roidb, in the order of a batch
SPLIT_KEYS = ("load_resize", "device", "mask_gather", "paste", "rle", "dicts", "vis")


def _test_canvas_shapes(cfg):
    """(landscape, portrait) canvases: short side from max(TEST.SCALES),
    long side from TEST.MAX_SIZE, both rounded up to COARSEST_STRIDE."""
    cs = cfg.FPN.COARSEST_STRIDE
    short = int(cs * np.ceil(max(cfg.TEST.SCALES) / float(cs)))
    long = int(cs * np.ceil(cfg.TEST.MAX_SIZE / float(cs)))
    long = max(long, short)
    return (short, long), (long, short)


def prepare_test_batch(cfg, entries: List[dict], canvas) -> Dict[str, np.ndarray]:
    """uint8 BGR canvases plus per-image content extents ('content_hw'),
    original sizes ('im_hw') and scales ('im_scale')."""
    ch, cw = canvas
    n = len(entries)
    data = np.zeros((n, ch, cw, 3), np.uint8)
    im_hw = np.zeros((n, 2), np.float32)
    content_hw = np.zeros((n, 2), np.float32)
    scales = np.zeros((n,), np.float32)
    for i, e in enumerate(entries):
        im_bgr = load_image_bgr(e["image"], False)
        scale = compute_im_scale(e["height"], e["width"], cfg.TEST.SCALES[0],
                                 cfg.TEST.MAX_SIZE)
        scale = min(scale, ch / float(e["height"]), cw / float(e["width"]))
        im = resize_bgr_u8(im_bgr, scale)
        h, w = im.shape[:2]
        data[i, :h, :w] = im
        im_hw[i] = (e["height"], e["width"])
        content_hw[i] = (h, w)
        scales[i] = scale
    return {"data": data, "im_hw": im_hw, "im_scale": scales, "content_hw": content_hw}


def _refuse_unported_inference(cfg) -> None:
    """Raise for what run_inference_on_roidb does not port, before any work
    (dispatch by model type, sad_tpu/eval/test_engine.py:109-124; ref:
    im_detect_all branching, test.py:52-58)."""
    if cfg.MODEL.TYPE in ("retinanet", "distillation"):
        return
    if cfg.MODEL.TYPE != "generalized_rcnn":
        raise NotImplementedError(f"MODEL.TYPE={cfg.MODEL.TYPE!r} inference is not ported")
    unported = [name for name, on in (
        ("TEST.BBOX_AUG", cfg.TEST.BBOX_AUG.ENABLED),
        ("TEST.MASK_AUG", cfg.MODEL.MASK_ON and cfg.TEST.MASK_AUG.ENABLED),
        ("TEST.SOFT_NMS", cfg.TEST.SOFT_NMS.ENABLED),
        ("TEST.BBOX_VOTE", cfg.TEST.BBOX_VOTE.ENABLED),
        ("TEST.PROPOSAL_FILES", bool(cfg.TEST.PROPOSAL_FILES)),
    ) if on]
    if unported:
        raise NotImplementedError(
            f"run_inference_on_roidb for generalized_rcnn: {', '.join(unported)} not "
            "ported to sad_tpu_torch yet (ROADMAP.md Queue 1 item 8)")


def _make_infer_fn(cfg, model):
    _refuse_unported_inference(cfg)
    if cfg.MODEL.TYPE == "generalized_rcnn":
        return make_rcnn_inference_fn(cfg, model)
    return make_inference_fn(cfg, model)


def gather_class_masks(mask_prob: torch.Tensor, classes: torch.Tensor) -> torch.Tensor:
    """Each kept detection's own class channel of ``mask_prob`` (B, K, m, m,
    C) as (B, K, m, m) float32, on mask_prob's device: what the paste reads,
    without copying the other C - 1 channels to the host (sad_tpu copies the
    whole array and indexes ``[j, k, :, :, c]`` there). Invalid slots carry
    class 0 and gather the background channel, which nothing reads."""
    idx = classes.long()[:, :, None, None, None].expand(*mask_prob.shape[:4], 1)
    return torch.gather(mask_prob, 4, idx)[..., 0].float()


def run_inference_on_roidb(cfg, model, roidb: List[dict],
                           contiguous_to_json: Dict[int, int],
                           batch_size: int = 8,
                           vis_dir: Optional[str] = None,
                           timing: Optional[Dict[str, float]] = None) -> List[Dict]:
    """COCO-format detection dicts for every image of roidb; with MODEL.MASK_ON
    each carries its mask as uncompressed RLE in 'segmentation'. With
    ``vis_dir`` each image is rendered there with its boxes and masks.
    ``timing``, when given, receives the loop's wall seconds, its batches
    and images, and the seconds of each stage of SPLIT_KEYS."""
    infer = _make_infer_fn(cfg, model)
    dev = next(model.parameters()).device
    land, port = _test_canvas_shapes(cfg)
    groups = {"l": [], "p": []}
    for e in roidb:
        groups["l" if e["width"] >= e["height"] else "p"].append(e)

    detections: List[Dict] = []
    clock = time.perf_counter
    split = dict.fromkeys(SPLIT_KEYS, 0.0)
    batches, t_start = 0, clock()
    for key, canvas in (("l", land), ("p", port)):
        entries = groups[key]
        for i in range(0, len(entries), batch_size):
            t0 = clock()
            chunk = entries[i:i + batch_size]
            # pad the final chunk to the static batch size; only chunk's
            # entries produce detections
            batch_entries = chunk + [chunk[-1]] * (batch_size - len(chunk))
            host = prepare_test_batch(cfg, batch_entries, canvas)
            t1 = clock()
            t = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
            out = infer(t["data"], t["im_hw"], t["im_scale"], t["content_hw"])
            boxes, scores, classes, valid = (
                out[k].cpu().numpy() for k in ("boxes", "scores", "classes", "valid"))
            t2 = clock()
            masks = None
            if "mask_prob" in out:
                masks = gather_class_masks(out["mask_prob"], out["classes"]).cpu().numpy()
            t3 = clock()
            paste_s = rle_s = vis_s = 0.0
            for j, e in enumerate(chunk):
                vis_segms = [None] * len(boxes[j])
                for k, (b, s, c, v) in enumerate(zip(boxes[j], scores[j], classes[j], valid[j])):
                    if not v:
                        continue
                    x1, y1, x2, y2 = (float(x) for x in b)
                    det = {
                        "image_id": e["id"],
                        "category_id": contiguous_to_json[int(c)],
                        # xyxy (legacy +1 extents) -> COCO xywh
                        "bbox": [x1, y1, x2 - x1 + 1.0, y2 - y1 + 1.0],
                        "score": float(s),
                    }
                    if masks is not None:
                        # the roi-frame mask pasted into the image frame, as
                        # RLE (segm_results, test.py + segms utils)
                        ta = clock()
                        full = paste_mask_into_image(
                            masks[j, k], b, int(e["height"]), int(e["width"]),
                            cfg.MRCNN.THRESH_BINARIZE)
                        tb = clock()
                        det["segmentation"] = mask_to_rle(full)
                        paste_s += tb - ta
                        rle_s += clock() - tb
                        vis_segms[k] = full
                    detections.append(det)
                if vis_dir is not None:
                    tv = clock()
                    _vis_image(cfg, e, vis_dir, boxes[j], scores[j], classes[j], valid[j],
                               vis_segms if masks is not None else None)
                    vis_s += clock() - tv
            t4 = clock()
            batches += 1
            for name, sec in (("load_resize", t1 - t0), ("device", t2 - t1),
                              ("mask_gather", t3 - t2), ("paste", paste_s), ("rle", rle_s),
                              ("dicts", t4 - t3 - paste_s - rle_s - vis_s), ("vis", vis_s)):
                split[name] += sec
            if (i // batch_size) % 10 == 0:
                logger.info("inference %s: %d/%d (avg %.3fs/batch)", key, i + len(chunk),
                            len(entries), split["device"] / batches)
    wall = clock() - t_start
    logger.info("inference: %d images, %d batches in %.3f s; ms a batch: %s", len(roidb),
                batches, wall, ", ".join(f"{k} {1e3 * v / max(batches, 1):.1f}"
                                         for k, v in split.items()))
    if timing is not None:
        timing.update(split, wall=wall, batches=batches, images=len(roidb))
    return detections


def _served_order(roidb: List[dict]) -> List[dict]:
    """The order run_inference_on_roidb serves images in: the landscape
    ones (the _test_canvas_shapes grouping), then the portrait ones, each
    in roidb order."""
    return ([e for e in roidb if e["width"] >= e["height"]]
            + [e for e in roidb if e["width"] < e["height"]])


def run_inference_sharded(cfg, model, roidb: List[dict], contiguous_to_json: Dict[int, int],
                          batch_size: int = 8, vis_dir: Optional[str] = None,
                          timing: Optional[Dict[str, float]] = None) -> Optional[List[Dict]]:
    """run_inference_on_roidb over the ranks: rank r serves the r-th of W
    contiguous shards of roidb (ceil(N / W) images each, the last fewer),
    and rank 0 gets every detection in the order one process gives them;
    the other ranks get None. ``timing`` on rank 0 holds its own split, the
    slowest rank's wall seconds and every rank's wall seconds and images."""
    info = current()
    if info.world == 1:
        return run_inference_on_roidb(cfg, model, roidb, contiguous_to_json, batch_size,
                                      vis_dir=vis_dir, timing=timing)
    if len({e["id"] for e in roidb}) != len(roidb):
        raise ValueError("a sharded roidb needs unique image ids: the merge keys on them")
    per = -(-len(roidb) // info.world)
    mine: Dict[str, float] = {}
    dets = run_inference_on_roidb(cfg, model, roidb[info.rank * per:(info.rank + 1) * per],
                                  contiguous_to_json, batch_size, vis_dir=vis_dir, timing=mine)
    parts = gather_objects((dets, mine))
    if parts is None:
        return None
    by_image: Dict[int, List[Dict]] = {}
    for part, _ in parts:
        for d in part:
            by_image.setdefault(d["image_id"], []).append(d)
    if timing is not None:
        timing.update(parts[0][1], wall=max(t["wall"] for _, t in parts),
                      images=len(roidb), ranks=info.world,
                      rank_wall=[t["wall"] for _, t in parts],
                      rank_images=[t["images"] for _, t in parts])
    return [d for e in _served_order(roidb) for d in by_image.get(e["id"], [])]


def _vis_image(cfg, entry, vis_dir, boxes, scores, classes, valid, segms) -> None:
    """One image's detection render, with mask overlays (ref:
    test_engine.py:231-244 cfg.VIS dumps -> vis.py vis_one_image; threshold
    cfg.VIS_TH)."""
    from ..utils.vis import vis_one_image

    im_bgr = load_image_bgr(entry["image"], False)
    base = os.path.splitext(os.path.basename(entry["image"]))[0]
    os.makedirs(vis_dir, exist_ok=True)
    vis_one_image(im_bgr[:, :, ::-1], boxes, scores, classes, valid, thresh=cfg.VIS_TH,
                  out_path=os.path.join(vis_dir, base + ".png"), segms=segms)


def _dump_results_json(output_dir, results):
    """Persist the metrics dict next to bbox_results.json so CLI drivers and
    the dress rehearsal can consume APs without parsing logs."""
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "results.json"), "w") as f:
            json.dump({k: float(v) for k, v in results.items()}, f, indent=1)


def _refuse_unported_evaluator(cfg, name: str) -> None:
    """The evaluator dispatch by dataset name (ref: task_evaluation.py:256-266
    _use_cityscapes/_use_voc/_use_vid_evaluator; sad_tpu/eval/test_engine.py:
    578-607): the COCO evaluator is ported, the others raise."""
    if "cityscapes_" in name and cfg.MODEL.MASK_ON:
        evaluator = "the Cityscapes mask evaluator (eval/cityscapes_eval.py)"
    elif name.startswith("vid"):
        evaluator = "the VID evaluator (eval/vid_eval.py)"
    elif name.startswith("voc_") and not cfg.TEST.FORCE_JSON_DATASET_EVAL:
        evaluator = "the VOC evaluator (eval/voc_eval.py; TEST.FORCE_JSON_DATASET_EVAL " \
                    "takes the COCO one)"
    else:
        return
    raise NotImplementedError(f"dataset {name!r}: {evaluator} is not ported to sad_tpu_torch "
                              "yet (ROADMAP.md Queue 1 item 9)")


def test_net_on_dataset(cfg, model, dataset_name: Optional[str] = None, batch_size: int = 8,
                        output_dir: Optional[str] = None,
                        im_range: Optional[Tuple[int, int]] = None,
                        multi_gpu: bool = False) -> Dict[str, float]:
    """Run inference + COCO evaluation on cfg.TEST.DATASETS[0] (or
    ``dataset_name``): the 12 bbox metrics, and under MODEL.MASK_ON the 12
    segm ones with the ``segm_`` prefix. Writes bbox_results.json,
    results.json and timing.json (run_inference_on_roidb's split and the
    seconds of each evaluation, 'eval_bbox' and 'eval_segm') into
    ``output_dir`` when one is given.

    im_range=(start, end) evaluates only that slice of the dataset's images
    (ref test_net.py --range, the reference's subprocess-sharding unit).
    ``multi_gpu`` under torchrun: the slice is served sharded over the
    ranks (run_inference_sharded); rank 0 evaluates and writes, and every
    rank returns its results."""
    name = dataset_name or cfg.TEST.DATASETS[0]
    _refuse_unported_inference(cfg)
    _refuse_unported_evaluator(cfg, name)
    if cfg.TEST.PROPOSAL_FILES and not cfg.MODEL.FASTER_RCNN:
        raise NotImplementedError(
            "TEST.PROPOSAL_FILES (Fast R-CNN on precomputed proposals, "
            "eval/rpn_generator.add_proposals_to_roidb) is not ported to sad_tpu_torch yet "
            "(ROADMAP.md Queue 1 item 8)")
    ds = CocoDataset(name)
    roidb = ds.get_roidb(include_gt=False)
    if im_range is not None:
        roidb = roidb[im_range[0]:im_range[1]]
    vis_dir = (os.path.join(output_dir or get_output_dir(cfg, training=False), "vis")
               if cfg.VIS else None)
    timing: Dict[str, float] = {}
    sharded = multi_gpu and world_size() > 1
    if sharded:
        dets = run_inference_sharded(cfg, model, roidb, ds.contiguous_to_json, batch_size,
                                     vis_dir=vis_dir, timing=timing)
        if dets is None:
            return broadcast_object(None)
    else:
        dets = run_inference_on_roidb(cfg, model, roidb, ds.contiguous_to_json, batch_size,
                                      vis_dir=vis_dir, timing=timing)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "bbox_results.json"), "w") as f:
            json.dump(dets, f)
    t0 = time.perf_counter()
    results = COCOEvaluator(ds.dataset).evaluate(dets, verbose=True)
    timing["eval_bbox"] = time.perf_counter() - t0
    if cfg.MODEL.MASK_ON and dets and "segmentation" in dets[0]:
        t0 = time.perf_counter()
        segm = COCOEvaluator(ds.dataset, iou_type="segm").evaluate(dets, verbose=True)
        timing["eval_segm"] = time.perf_counter() - t0
        results.update({f"segm_{k}": v for k, v in segm.items()})
    _dump_results_json(output_dir, results)
    if output_dir:
        with open(os.path.join(output_dir, "timing.json"), "w") as f:
            json.dump(timing, f, indent=1)
    return broadcast_object(results) if sharded else results


def generate_pseudo_labels(cfg, model, dataset_name: str, out_json: str,
                           score_thresh: float = 0.5, batch_size: int = 8,
                           multi_gpu: bool = False) -> str:
    """The teacher's pseudo-label writer: a COCO-format annotation json over
    an unlabeled dataset (the reference's semi-supervised flow, SURVEY.md
    §3.4), usable as a catalog entry for DISTILLATION.UNLABEL_DATASETS.
    ``multi_gpu`` under torchrun: served sharded over the ranks; rank 0
    writes the merged set (annotation ids follow the one-process order) and
    every rank returns once it is written."""
    ds = CocoDataset(dataset_name)
    roidb = ds.get_roidb(include_gt=False)
    if multi_gpu and world_size() > 1:
        dets = run_inference_sharded(cfg, model, roidb, ds.contiguous_to_json, batch_size)
        if dets is not None:
            _write_pseudo_labels(ds, dets, out_json, score_thresh)
        barrier()
        return out_json
    dets = run_inference_on_roidb(cfg, model, roidb, ds.contiguous_to_json, batch_size)
    _write_pseudo_labels(ds, dets, out_json, score_thresh)
    return out_json


def _write_pseudo_labels(ds, dets: List[Dict], out_json: str, score_thresh: float) -> None:
    anns = []
    for i, d in enumerate(dets):
        if d["score"] < score_thresh:
            continue
        x, y, w, h = d["bbox"]
        anns.append({
            "id": i + 1,
            "image_id": d["image_id"],
            "category_id": d["category_id"],
            "bbox": d["bbox"],
            "area": float(w * h),
            "iscrowd": 0,
            "score": d["score"],  # kept for filtering and inspection
        })
    out = {
        "images": ds.dataset["images"],
        "categories": ds.dataset["categories"],
        "annotations": anns,
    }
    os.makedirs(os.path.dirname(out_json) or ".", exist_ok=True)
    with open(out_json, "w") as f:
        json.dump(out, f)
    logger.info("Wrote %d pseudo annotations for %d images -> %s",
                len(anns), len(ds.dataset["images"]), out_json)
