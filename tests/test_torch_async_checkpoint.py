"""TRAIN.CHECKPOINT_BACKEND 'orbax' in the port (train/async_checkpoint.py,
train/train_loop.py, train/checkpoint.load_reference_or_native), mirroring
sad_tpu's tests/test_resume.py::test_orbax_backend_trains_and_resumes on
the tiny SAD run of tests/test_torch_train_loop.py (CHANNEL_RATIO 0.25,
SCALES (64,), a labeled and a pseudo-labeled stream, SNAPSHOT_ITERS 3):

- run B trains 3 iterations (its last step, 3, written asynchronously under
  checkpoints/3/, no model_final.pkl, the writer thread ended), equal to the
  pickle run A's model_iter2.pkl leaf for leaf; rerun with MAX_ITER 6 it
  resumes from step 3 and ends bit-identical to the uninterrupted pickle run
  A, its stats.jsonl appended (one series 0..5, not restarted); a third run
  is a no-op; test_net's loader reads the latest step from the run
  directory and from its checkpoints/.
- The checkpointer alone: only the newest 5 steps are kept; a leftover
  ``<step>.tmp`` and a step directory without the payload are ignored; a
  writer's error comes back from ``wait``.
- A directory the port did not write, sad_tpu's own orbax run, is refused
  by name (ROADMAP.md "Not ported").
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from sad_tpu.train.orbax_checkpoint import OrbaxCheckpointer
from sad_tpu_torch.config.config import merge_cfg_from_dict as t_merge
from sad_tpu_torch.convert import state_dict_to_params
from sad_tpu_torch.train import checkpoint as tck
from sad_tpu_torch.train import train_loop as tloop
from sad_tpu_torch.train.async_checkpoint import PAYLOAD, AsyncCheckpointer
from test_torch_models import one_torch_thread, sad_tpu_native_loaded  # noqa: F401  (autouse)
from test_torch_train_loop import TEACHER, _assert_bit_identical, data, t_cfg, train_dir  # noqa: F401

ORBAX = {"TRAIN": {"CHECKPOINT_BACKEND": "orbax"}}


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


def _writers():
    return [t for t in threading.enumerate() if t.name.startswith("async-checkpoint")]


def test_orbax_backend_trains_and_resumes(data, tmp_path):
    teacher = t_cfg(tmp_path, TEACHER)
    a = tloop.train_model(t_cfg(tmp_path / "a"), teacher, device="cpu")

    b3 = tloop.train_model(t_merge(t_cfg(tmp_path / "b", ORBAX), {"SOLVER": {"MAX_ITER": 3}}),
                           teacher, device="cpu")
    run_dir = train_dir(tmp_path / "b")
    ckdir = os.path.join(run_dir, "checkpoints")
    assert AsyncCheckpointer(ckdir).all_steps() == [3]
    assert not os.path.exists(os.path.join(run_dir, "model_final.pkl"))
    assert not _writers() and len(b3.checkpointer.stats["bytes"]) == 1
    # the step's payload is the pickle backend's: run A's snapshot after iter 3
    got = tck.load_checkpoint(os.path.join(ckdir, "3", PAYLOAD))
    want = tck.load_checkpoint(os.path.join(train_dir(tmp_path / "a"), "model_iter2.pkl"))
    assert got["iter"] == want["iter"] == 3 and got["cfg_yaml"]
    for tree in ("params", "velocity"):
        g, w = dict(_leaves(got[tree])), dict(_leaves(want[tree]))
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{tree} {k}")

    b = tloop.train_model(t_cfg(tmp_path / "b", ORBAX), teacher, device="cpu")
    assert b.start_iter == 3 and AsyncCheckpointer(ckdir).all_steps() == [3, 6]
    _assert_bit_identical(a, b)
    with open(os.path.join(run_dir, "stats.jsonl")) as f:
        iters = [json.loads(line)["iter"] for line in f]
    assert iters == sorted(set(iters)) and max(iters) == 5 and 2 in iters, iters

    c = tloop.train_model(t_cfg(tmp_path / "b", ORBAX), teacher, device="cpu")
    assert c.start_iter == 6 and c.iter_seconds == []
    assert AsyncCheckpointer(ckdir).all_steps() == [3, 6]
    _assert_bit_identical(b, c)

    # test_net's loader: the latest step, from the run directory or checkpoints/
    want = state_dict_to_params(b.model.state_dict())
    for path in (run_dir, ckdir):
        model = tloop.create_model(t_cfg(tmp_path / "b"), "cpu", torch.Generator().manual_seed(9))
        tck.load_reference_or_native(path, model)
        loaded = dict(_leaves(state_dict_to_params(model.state_dict())))
        for k, v in _leaves(want):
            np.testing.assert_array_equal(loaded[k], v, err_msg=k)
    assert not _writers()


def test_keeps_five_and_ignores_partial_steps(tmp_path):
    model = torch.nn.Linear(3, 2)
    vel = {k: torch.zeros_like(v) for k, v in model.state_dict().items()}
    ck = AsyncCheckpointer(str(tmp_path / "ck"))
    for step in range(1, 9):
        with torch.no_grad():
            model.weight.fill_(step)
        ck.save(step, model, vel)  # the next save waits for this one
    ck.wait()
    assert ck.all_steps() == [4, 5, 6, 7, 8]
    assert sorted(os.listdir(ck.directory)) == ["4", "5", "6", "7", "8"]
    assert float(ck.restore()["params"]["kernel"].max()) == 8.0
    assert ck.restore(5)["iter"] == 5
    # a crash mid-write leaves <step>.tmp; a step directory without the payload
    os.makedirs(os.path.join(ck.directory, "11.tmp"))
    with open(os.path.join(ck.directory, "11.tmp", PAYLOAD), "wb") as f:
        f.write(b"torn")
    os.makedirs(os.path.join(ck.directory, "12"))
    assert ck.latest_step() == 8
    fresh = torch.nn.Linear(3, 2)
    tck.load_reference_or_native(str(tmp_path / "ck"), fresh)
    assert torch.equal(fresh.weight, torch.full((2, 3), 8.0))
    # a writer's error comes back from wait
    ck.directory = str(tmp_path / "missing" / "dir")
    os.makedirs(os.path.dirname(ck.directory))
    with open(ck.directory, "w"):
        pass  # a file where the step directory's parent should be
    ck.save(9, model, vel)
    with pytest.raises(OSError):
        ck.wait()
    ck.close()


def test_sad_tpu_orbax_run_is_refused_by_name(tmp_path):
    run = tmp_path / "run"
    orbax = OrbaxCheckpointer(str(run / "checkpoints"))
    orbax.save(3, {"w": np.ones((2, 2), np.float32)})
    orbax.wait()
    orbax.close()
    assert os.path.isdir(run / "checkpoints" / "3")
    for path in (run, run / "checkpoints", tmp_path / "empty"):
        os.makedirs(path, exist_ok=True)
        with pytest.raises(NotImplementedError, match="orbax.*Not ported"):
            tck.load_reference_or_native(str(path), torch.nn.Linear(2, 2))
