"""The port's own copy of the settings (counterpart of instag_tpu/config.py,
the reference's ModelParams, PipelineParams and OptimizationParams), with
the JAX package's defaults, its command-line parser and its
``cfg_args.json`` persistence (the JAX package's persistent compile cache
has no counterpart here)."""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Any


@dataclasses.dataclass
class ModelConfig:
    """``approx_topk`` defaults to False, where the JAX package defaults to
    True: True is the TPU's ``approx_max_k``, and the port's
    ``RasterizeConfig`` raises on it. A ``cfg_args.json`` that the JAX
    package wrote carries True, and loads: what reads it takes the fields
    it needs."""
    sh_degree: int = 2
    source_path: str = ""
    model_path: str = ""
    white_background: bool = False
    eval: bool = False
    audio: str = ""
    init_num: int = 10_000
    N_views: int = -1
    audio_extractor: str = "deepspeech"
    type: str = "face"        # "face" | "mouth"
    preload: bool = True
    all_for_train: bool = False
    capacity: int = 0         # 0 => 16 x init_num (at least 16384), tiled to 1024
    max_per_tile: int = 256   # K front-most splats composited per tile
    approx_topk: bool = False
    # pack the padded cloud to its occupancy at log points, under the
    # ceiling resolve_capacity()
    adaptive_capacity: bool = True
    # resizes keep every slot in place (grow pads, never shrinks)
    deterministic_slots: bool = False

    def resolve_capacity(self) -> int:
        if self.capacity > 0:
            return self.capacity
        cap = max(self.init_num * 16, 16384)
        return -(-cap // 1024) * 1024


@dataclasses.dataclass
class PipelineConfig:
    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False


@dataclasses.dataclass
class OptimizationConfig:
    iterations: int = 50_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 45_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.003
    rotation_lr: float = 0.001
    identity_lr: float = 0.01
    percent_dense: float = 0.005
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 45_000
    densify_grad_threshold: float = 0.0002
    random_background: bool = False


def add_dataclass_args(parser: argparse.ArgumentParser, cls,
                       prefix: str = "") -> None:
    """One flag a field: ``--<name>`` (``-s``/``-m`` for the source and
    model paths), ``--no_<name>`` for a bool that defaults to True."""
    for f in dataclasses.fields(cls):
        name = f"--{prefix}{f.name}"
        if f.type == "bool" or f.type is bool:
            if f.default:
                parser.add_argument(f"--no_{prefix}{f.name}",
                                    dest=f"{prefix}{f.name}",
                                    action="store_false", default=True)
            else:
                parser.add_argument(name, action="store_true",
                                    default=f.default)
        else:
            alias = {"source_path": ["-s"], "model_path": ["-m"]}.get(
                f"{prefix}{f.name}", [])
            parser.add_argument(name, *alias, type=type(f.default),
                                default=f.default)


def extract_dataclass(args: argparse.Namespace, cls, prefix: str = ""):
    return cls(**{f.name: getattr(args, f"{prefix}{f.name}")
                  for f in dataclasses.fields(cls)})


def make_parser(description: str) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=description)
    add_dataclass_args(parser, ModelConfig)
    add_dataclass_args(parser, PipelineConfig)
    add_dataclass_args(parser, OptimizationConfig)
    return parser


def parse_all(parser: argparse.ArgumentParser, argv=None):
    args = parser.parse_args(argv)
    return (extract_dataclass(args, ModelConfig),
            extract_dataclass(args, PipelineConfig),
            extract_dataclass(args, OptimizationConfig), args)


def save_cfg(model_path: str, model_cfg: ModelConfig) -> None:
    """Write the model settings to ``<model_path>/cfg_args.json``."""
    os.makedirs(model_path, exist_ok=True)
    with open(os.path.join(model_path, "cfg_args.json"), "w") as f:
        json.dump(dataclasses.asdict(model_cfg), f, indent=2)


def load_cfg(model_path: str, overrides: dict[str, Any] | None = None
             ) -> ModelConfig:
    """The model settings of ``<model_path>/cfg_args.json`` (either
    package's), with the non-None ``overrides`` applied."""
    with open(os.path.join(model_path, "cfg_args.json")) as f:
        data = json.load(f)
    if overrides:
        data.update({k: v for k, v in overrides.items() if v is not None})
    return ModelConfig(**data)
