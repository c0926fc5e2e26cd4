"""Convert Caffe (v1) `.caffemodel` weights to the blob pickle the port (and
the reference) loads (a copy of sad_tpu/tools/pickle_caffe_blobs.py).

The reference converter (tools/pickle_caffe_blobs.py:75-230) goes through
caffe and caffe2; this one decodes the protobuf WIRE FORMAT itself (a
`.caffemodel` is a serialized `NetParameter`), takes each layer's blobs,
folds each BatchNorm + Scale pair into the AffineChannel `res*_bn_s` /
`res*_bn_b` params (std = sqrt(var + 1e-5); s = scale / std; b = bias -
mean * scale / std), adds zero biases to convolutions without one, and
normalizes MSRA ResNet layer names (`res4b11_branch2c` -> `res4_11_branch2c`,
`res2a_branch1` -> `res2_0_branch1`). As in the reference, the BatchNorm
moving-average scale factor (blob 3) is ignored.

Output: a pickle of {'blobs': {blob_name: np.ndarray}} that
`sad_tpu_torch.train.checkpoint.load_reference_or_native` and
`tools/convert_weights` read.

Usage:
  python -m sad_tpu_torch.tools.pickle_caffe_blobs \
      --caffemodel ResNet-50-model.caffemodel --output r50.pkl
"""

from __future__ import annotations

import argparse
import pickle
import struct
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

from sad_tpu_torch.utils.logging import setup_logging

logger = setup_logging("pickle_caffe_blobs")

# protobuf field numbers (caffe.proto)
NET_LAYER = 100  # NetParameter.layer (LayerParameter)
NET_LAYERS_V1 = 2  # NetParameter.layers (deprecated V1LayerParameter)
LAYER_NAME = 1
LAYER_TYPE = 2
LAYER_BLOBS = 7
BLOB_NUM, BLOB_CHANNELS, BLOB_HEIGHT, BLOB_WIDTH = 1, 2, 3, 4
BLOB_DATA = 5
BLOB_SHAPE = 7
SHAPE_DIM = 1


# --------------------------------------------------------------------- wire
def _varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = 0
    out = 0
    while True:
        b = buf[i]
        out |= (b & 0x7F) << shift
        i += 1
        if not b & 0x80:
            return out, i
        shift += 7


def parse_message(buf: bytes) -> Dict[int, List[Tuple[int, object]]]:
    """Decode one protobuf message into {field: [(wire_type, raw_value)]}.

    wire types: 0 varint (int), 1 64-bit (bytes), 2 length-delimited
    (bytes), 5 32-bit (bytes)."""
    i = 0
    out: Dict[int, List] = defaultdict(list)
    n = len(buf)
    while i < n:
        key, i = _varint(buf, i)
        field, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _varint(buf, i)
        elif wt == 1:
            v = buf[i:i + 8]
            i += 8
        elif wt == 2:
            ln, i = _varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wt == 5:
            v = buf[i:i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wt} (field {field})")
        out[field].append((wt, v))
    return out


def _floats(entries: List[Tuple[int, object]]) -> np.ndarray:
    """Repeated float field: packed (wt 2) or unpacked (wt 5)."""
    parts = []
    for wt, v in entries:
        if wt == 2:
            parts.append(np.frombuffer(v, dtype="<f4"))
        elif wt == 5:
            parts.append(np.asarray([struct.unpack("<f", v)[0]], np.float32))
        else:
            raise ValueError("bad wire type for float field")
    return np.concatenate(parts) if parts else np.zeros((0,), np.float32)


def _string(entries) -> str:
    return entries[0][1].decode("utf-8") if entries else ""


def _ints(entries) -> List[int]:
    out = []
    for wt, v in entries:
        if wt == 0:
            out.append(int(v))
        elif wt == 2:  # packed varints
            i = 0
            while i < len(v):
                x, i = _varint(v, i)
                out.append(int(x))
    return out


# -------------------------------------------------------------------- model
def _blob_array(blob_msg: Dict) -> np.ndarray:
    data = _floats(blob_msg.get(BLOB_DATA, []))
    dims: List[int] = []
    if BLOB_SHAPE in blob_msg:
        shape_msg = parse_message(blob_msg[BLOB_SHAPE][0][1])
        dims = _ints(shape_msg.get(SHAPE_DIM, []))
    if not dims:
        dims = [
            _ints(blob_msg.get(f, []))[0] if blob_msg.get(f) else 1
            for f in (BLOB_NUM, BLOB_CHANNELS, BLOB_HEIGHT, BLOB_WIDTH)
        ]
    arr = data.reshape([int(d) for d in dims]) if int(
        np.prod(dims)
    ) == data.size else data
    return np.asarray(arr, np.float32)


def parse_caffemodel(path: str) -> List[Dict]:
    """-> [{'name', 'type', 'blobs': [np.ndarray, ...]}] in file order."""
    with open(path, "rb") as f:
        net = parse_message(f.read())
    if NET_LAYER not in net and NET_LAYERS_V1 in net:
        raise NotImplementedError(
            "legacy V1LayerParameter caffemodels are not supported; "
            "upgrade with caffe's upgrade_net_proto_binary first"
        )
    layers = []
    for _, raw in net.get(NET_LAYER, []):
        msg = parse_message(raw)
        layers.append(
            {
                "name": _string(msg.get(LAYER_NAME, [])),
                "type": _string(msg.get(LAYER_TYPE, [])),
                "blobs": [
                    _blob_array(parse_message(b))
                    for _, b in msg.get(LAYER_BLOBS, [])
                ],
            }
        )
    return layers


def normalize_resnet_name(name: str) -> str:
    """res4b11_branch2c -> res4_11_branch2c; res2a_branch1 -> res2_0_branch1
    (ref: pickle_caffe_blobs.py:75-89)."""
    if name.startswith("res") and "_" in name and not name.startswith("res_"):
        chunk = name[len("res"):name.find("_")]
        if len(chunk) >= 2 and chunk[0].isdigit():
            block = (
                int(chunk[2:]) if len(chunk) > 2 else ord(chunk[1]) - ord("a")
            )
            return f"res{chunk[0]}_{block}" + name[name.find("_"):]
    return name


def convert_caffemodel(path: str) -> Dict[str, np.ndarray]:
    """caffemodel -> {detectron blob name: array} with BN folding."""
    layers = parse_caffemodel(path)
    blobs: Dict[str, np.ndarray] = {}
    bns = {
        l["name"][len("bn"):]: l
        for l in layers if l["type"] == "BatchNorm"
    }
    scales = {
        l["name"][len("scale"):]: l
        for l in layers if l["type"] == "Scale"
    }
    for suffix, bn in bns.items():
        scl = scales.get(suffix)
        if scl is None:
            raise ValueError(f"BatchNorm bn{suffix} without Scale pair")
        mean = bn["blobs"][0].reshape(-1)
        var = bn["blobs"][1].reshape(-1)
        scale = scl["blobs"][0].reshape(-1)
        bias = scl["blobs"][1].reshape(-1)
        std = np.sqrt(var + 1e-5)
        out = normalize_resnet_name("res" + suffix + "_bn")
        blobs[out + "_s"] = (scale / std).astype(np.float32)
        blobs[out + "_b"] = (bias - mean * scale / std).astype(np.float32)
    for l in layers:
        if l["type"] in ("BatchNorm", "Scale") or not l["blobs"]:
            continue
        name = normalize_resnet_name(l["name"])
        blobs[name + "_w"] = l["blobs"][0]
        if len(l["blobs"]) > 1:
            blobs[name + "_b"] = l["blobs"][1].reshape(-1)
        elif l["type"] == "Convolution":
            # C1 conv biases are optional; add zeros (ref:102-110)
            blobs[name + "_b"] = np.zeros(
                (l["blobs"][0].shape[0],), np.float32
            )
    return blobs


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--caffemodel", required=True)
    p.add_argument("--output", required=True)
    p.add_argument(
        "--prototxt", default=None,
        help="unused (weights carry layer types); kept for CLI parity",
    )
    args = p.parse_args(argv)
    blobs = convert_caffemodel(args.caffemodel)
    with open(args.output, "wb") as f:
        pickle.dump({"blobs": blobs}, f, pickle.HIGHEST_PROTOCOL)
    logger.info("Wrote %d blobs -> %s", len(blobs), args.output)
    logger.info("Blob names: %s", sorted(blobs))


if __name__ == "__main__":
    main()
