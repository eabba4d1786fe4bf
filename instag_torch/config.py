"""The port's own copy of the settings (counterpart of instag_tpu/config.py's
``ModelConfig`` and ``OptimizationConfig``, the reference's ModelParams and
OptimizationParams), with the JAX package's defaults."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ModelConfig:
    """The model settings the trainers read. The dataset reader's fields
    (``source_path``, ``N_views``, ...) come with the reader.

    ``approx_topk`` defaults to False, where the JAX package defaults to
    True: True is the TPU's ``approx_max_k``, and the port's
    ``RasterizeConfig`` raises on it."""
    sh_degree: int = 2
    init_num: int = 10_000
    audio_extractor: str = "deepspeech"
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
