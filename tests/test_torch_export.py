"""The serving export (eval/export.py) on the CPU: a tiny RetinaNet traced
with torch.export, saved as a .pt2 and reloaded, against the port's live
serving and against sad_tpu's jax.export program on the same converted
float32 weights.

- Reloaded against live serving in this process: exactly equal (the same
  operations in the same order, the NMS through the same op).
- Against sad_tpu's exported program (its Pallas NMS interpreted): the
  tolerances of tests/test_torch_inference.py, the same kept (class, score)
  multiset, scores within 1e-5 and boxes within 1e-3 px.
- The graph holds one ``sad_tpu_torch::nms_multi`` node and none of the
  plain NMS loop's argmax steps.
- Live serving after an export in the same process still works: the trace
  leaves no fake tensor in the anchor caches.
- A child process that imports only torch and the export module loads and
  serves the program, with the same outputs.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import sad_tpu.config as jcfg
from sad_tpu.config.config import merge_cfg_from_dict as j_merge
from sad_tpu.eval import export as j_export
from sad_tpu.models import RetinaNet as JaxRetinaNet
import sad_tpu_torch.config as tcfg
from sad_tpu_torch.config.config import merge_cfg_from_dict as t_merge
from sad_tpu_torch.convert import load_params
from sad_tpu_torch.eval import export, inference
from sad_tpu_torch.eval.inference import make_inference_fn
from sad_tpu_torch.models import RetinaNet
from sad_tpu_torch.models.arch import ModelArch
from test_torch_inference import CFG, _assert_same_detections, canvases
from test_torch_models import one_torch_thread, random_params, sad_tpu_native_loaded  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("boxes", "scores", "classes", "valid")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The tiny model, its inputs, live serving's outputs, and the program
    exported (uint8 canvases, device normalisation inside) after them."""
    tmp = tmp_path_factory.mktemp("export")
    tc = t_merge(tcfg.Config(), CFG)
    arch = graft._tiny_arch()
    data, im_hw, scale, content = canvases(0)
    params = random_params(JaxRetinaNet(arch), data.astype(np.float32), seed=3)
    port = load_params(RetinaNet(ModelArch(**dataclasses.asdict(arch))).eval(), params)
    inputs = tuple(torch.from_numpy(a) for a in (data, im_hw, scale, content))
    live = make_inference_fn(tc, port)(*inputs)
    path = export.export_retinanet_inference(tc, port, 2, tuple(data.shape[1:3]),
                                             str(tmp / "retina.pt2"))
    # the child process of test_a_child_process_loads_and_serves_the_program
    # starts here and runs beside the other cases
    torch.save(inputs, str(tmp / "inputs.pt"))
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    child = subprocess.Popen([sys.executable, "-c", CHILD, path, str(tmp / "inputs.pt"),
                              str(tmp / "out.pt")], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
    yield dict(tc=tc, arch=arch, params=params, port=port, inputs=inputs, live=live,
               path=path, tmp=tmp, program=torch.export.load(path), child=child)
    child.kill()
    child.communicate()


def test_reloaded_program_equals_live_serving(served):
    with torch.no_grad():
        got = served["program"].module()(*served["inputs"])
    assert sorted(got) == sorted(KEYS)
    for k in KEYS:
        assert got[k].dtype == served["live"][k].dtype
        assert torch.equal(got[k], served["live"][k]), k
    assert bool(got["valid"].any())


def test_graph_holds_the_nms_op_and_no_unrolled_loop(served):
    graph = served["program"].graph
    targets = [str(n.target) for n in graph.nodes if n.op == "call_function"]
    assert targets.count("sad_tpu_torch.nms_multi.default") == 1
    # the plain NMS takes one argmax a step (100 steps); the decode none
    assert not [t for t in targets if "argmax" in t]
    assert len(targets) < 1000, len(targets)


def test_live_serving_after_an_export_in_the_same_process(served):
    """The export ran after the fixture's live call: serving again reads the
    anchor cache the trace passed through, and gives the same outputs."""
    for fn in (inference.cell_anchors_on,):
        assert fn.cache_info().currsize == 0  # cleared after the trace
    again = make_inference_fn(served["tc"], served["port"])(*served["inputs"])
    for k in KEYS:
        assert torch.equal(again[k], served["live"][k]), k
    cached = inference.cell_anchors_on(torch.device("cpu"), 3, 4.0, (1.0, 2.0, 0.5), 3)
    assert type(cached) is torch.Tensor


def test_matches_sad_tpus_exported_program(served):
    """sad_tpu's signature: float32 canvases normalised on the host, both
    programs exported from the same weights."""
    jc = j_merge(jcfg.Config(), CFG)
    data, im_hw, scale, content = (t.numpy() for t in served["inputs"])
    images = ((data.astype(np.float32) - np.asarray(jc.PIXEL_MEANS, np.float32))
              / np.asarray(jc.PIXEL_STD, np.float32))
    hw = tuple(data.shape[1:3])
    jpath = str(served["tmp"] / "retina.jaxexport")
    j_export.export_retinanet_inference(jc, JaxRetinaNet(served["arch"]), served["params"], 2,
                                        hw, jpath)
    ref = j_export.load_exported(jpath)(jnp.asarray(images), jnp.asarray(im_hw),
                                        jnp.asarray(scale))
    tpath = export.export_retinanet_inference(served["tc"], served["port"], 2, hw,
                                              str(served["tmp"] / "retina_f32.pt2"), uint8=False)
    got = export.load_exported(tpath)(torch.from_numpy(images), torch.from_numpy(im_hw),
                                      torch.from_numpy(scale))
    _assert_same_detections(ref, {k: v.numpy() for k, v in got.items()}, 2)


CHILD = """
import sys
import torch
import sad_tpu_torch.eval.export as export
torch.set_num_threads(1)  # as the parent's tests: the same summation order
inputs = torch.load(sys.argv[2])
out = export.load_exported(sys.argv[1])(*inputs)
torch.save(out, sys.argv[3])
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "sad_tpu"))
print("IMPORTED", bad)
"""


def test_a_child_process_loads_and_serves_the_program(served):
    child = served["child"]
    stdout, stderr = child.communicate(timeout=300)
    assert child.returncode == 0, stderr[-3000:]
    assert "IMPORTED []" in stdout
    got = torch.load(str(served["tmp"] / "out.pt"))
    for k in KEYS:
        assert torch.equal(got[k], served["live"][k]), k


def test_save_res_is_refused(served):
    tc = t_merge(served["tc"], {"TEST": {"SAVE_RES": True}})
    with pytest.raises(NotImplementedError, match="SAVE_RES"):
        export.export_retinanet_inference(tc, served["port"], 2, (128, 256),
                                          str(served["tmp"] / "x.pt2"))
