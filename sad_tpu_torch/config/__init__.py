"""Configuration of sad_tpu_torch: a copy of sad_tpu/config/__init__.py.

The port imports nothing of sad_tpu, so it keeps its own copies of the
config schema (config.py) and the dataset catalog (catalog.py);
tests/test_torch_config.py holds them equal to the originals.
"""

from .config import (
    Config,
    TrainConfig,
    TestConfig,
    ModelConfig,
    FPNConfig,
    RetinaNetConfig,
    ResNetsConfig,
    SolverConfig,
    DistillationConfig,
    load_cfg,
    merge_cfg_from_file,
    merge_cfg_from_list,
    assert_and_infer_cfg,
)
from .catalog import DATASET_CATALOG, get_dataset_spec, register_dataset

__all__ = [
    "Config",
    "TrainConfig",
    "TestConfig",
    "ModelConfig",
    "FPNConfig",
    "RetinaNetConfig",
    "ResNetsConfig",
    "SolverConfig",
    "DistillationConfig",
    "load_cfg",
    "merge_cfg_from_file",
    "merge_cfg_from_list",
    "assert_and_infer_cfg",
    "DATASET_CATALOG",
    "get_dataset_spec",
    "register_dataset",
]
