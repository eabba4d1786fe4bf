"""Reference (PyTorch) checkpoint -> bundle converter (the port's own copy
of instag_tpu/io/reference_convert.py).

The reference saves trainer checkpoints as torch tuples
(scene/gaussian_model.py:115-132 ``capture()``; save sites
train_face.py:653-661, train_fuse_con.py:216-220, pretrain_face.py:421-443):

    face/mouth ckpt: (gaussians.capture(), motion_sd, motion_opt_sd, iter)
    fuse ckpt:       (face capture, face UMF sd, mouth capture, mouth UMF sd)

with capture() = (active_sh_degree, _xyz, _features_dc, _features_rest,
_identity, _scaling, _rotation, _opacity, max_radii2D, xyz_gradient_accum,
denom, optimizer.state_dict(), spatial_lr_scale, neural_renderer sd,
neural_motion_grid sd).

This module converts those into the bundles both packages read (the same
flax-layout trees the JAX converter builds, written through
``io.checkpoints.save_bundle``, so one ``.pth`` gives the JAX converter's
bytes):

  * capture tuple -> padded GaussianState dict + AdamState (named param
    groups 'xyz'/'f_dc'/... -> per-attribute moments; 'neural_*' skipped);
  * torch motion-net state dicts -> flax param trees with the layout map
    below (Conv1d [O,I,K] -> [K,I,O]; Linear [O,I] -> [I,O]; hash-grid
    embeddings pass through - both sides use the identical offsets rule).

The port reads a converted bundle with ``io.checkpoints.load_branch``,
``state_from_dict`` and ``gopt_from_dict``. There is no exporter to the
reference's naming (the JAX package has none either).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .checkpoints import save_bundle

# --- low-level layer converters -------------------------------------------


def _npy(v):
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


def conv1d(sd, key):
    """torch Conv1d weight/bias -> flax Conv dict."""
    return {"kernel": _npy(sd[f"{key}.weight"]).transpose(2, 1, 0),
            "bias": _npy(sd[f"{key}.bias"])}


def linear(sd, key, bias=True):
    out = {"kernel": _npy(sd[f"{key}.weight"]).T}
    if bias:
        out["bias"] = _npy(sd[f"{key}.bias"])
    return out


def mlp(sd, prefix, num_layers):
    """Reference bias-free MLP (scene/motion_net.py:152-173) -> flax MLP."""
    p = f"{prefix}." if prefix else ""
    return {f"net_{l}": linear(sd, f"{p}net.{l}", bias=False)
            for l in range(num_layers)}


def audio_feature(sd, prefix, extractor: str):
    """AudioNet(+AVE variant) + AudioAttNet -> flax AudioFeature subtree."""
    p = f"{prefix}." if prefix else ""
    if extractor == "ave":
        net = {f"fc_{i}": linear(sd, f"{p}audio_net.encoder_fc1.{2*i}")
               for i in range(3)}
    else:
        net = {f"conv_{i}": conv1d(sd, f"{p}audio_net.encoder_conv.{2*i}")
               for i in range(4)}
        net.update({f"fc_{i}": linear(sd, f"{p}audio_net.encoder_fc1.{2*i}")
                    for i in range(2)})
    att = {f"att_conv_{i}":
           conv1d(sd, f"{p}audio_att_net.attentionConvNet.{2*i}")
           for i in range(5)}
    att["att_fc"] = linear(sd, f"{p}audio_att_net.attentionNet.0")
    return {"audio_net": net, "audio_att_net": att}


def triplane(sd, prefix=""):
    p = f"{prefix}." if prefix else ""
    return {f"encoder_{ax}": {"embeddings": _npy(sd[f"{p}encoder_{ax}.embeddings"])}
            for ax in ("xy", "yz", "xz")}


# --- whole-module converters ----------------------------------------------


def convert_motion_net(sd: dict, extractor: str) -> dict:
    """Reference MotionNetwork (face UMF) state dict -> flax params."""
    return {"params": {
        "audio": audio_feature(sd, "", extractor),
        "encoder": triplane(sd),
        "exp_encode_net": mlp(sd, "exp_encode_net", 2),
        "eye_att_net": mlp(sd, "eye_att_net", 2),
        "sigma_net": mlp(sd, "sigma_net", 3),
        "aud_ch_att_net": mlp(sd, "aud_ch_att_net", 2),
    }}


def convert_mouth_motion_net(sd: dict, extractor: str) -> dict:
    return {"params": {
        "audio": audio_feature(sd, "", extractor),
        "encoder": triplane(sd),
        "sigma_net": mlp(sd, "sigma_net", 3),
        "scaler_net": mlp(sd, "scaler_net", 3),
        "aud_ch_att_net": mlp(sd, "aud_ch_att_net", 2),
    }}


def convert_pmf(sd: dict, extractor: str, kind: str) -> dict:
    out = {
        "audio": audio_feature(sd, "", extractor),
        "encoder": triplane(sd),
        "sigma_net": mlp(sd, "sigma_net", 3),
        "align_net": mlp(sd, "align_net", 2),
        "aud_ch_att_net": mlp(sd, "aud_ch_att_net", 2),
    }
    if kind == "face":
        out["exp_encode_net"] = mlp(sd, "exp_encode_net", 2)
        out["eye_att_net"] = mlp(sd, "eye_att_net", 2)
    return {"params": out}


# reference training_setup group name -> GaussianParams attribute
_GROUPS = {"xyz": "xyz", "f_dc": "features_dc", "f_rest": "features_rest",
           "identity": "identity", "opacity": "opacity",
           "scaling": "scaling", "rotation": "rotation"}


def convert_capture(capture: tuple, capacity: int, extractor: str,
                    kind: str) -> dict:
    """Reference ``capture()`` tuple -> {state, gopt, pmf_params} dicts."""
    (active_sh_degree, xyz, f_dc, f_rest, identity, scaling, rotation,
     opacity, max_radii2d, grad_accum, denom, opt_sd, spatial_lr_scale,
     _renderer_sd, pmf_sd) = capture

    arrays = {"xyz": _npy(xyz), "features_dc": _npy(f_dc),
              "features_rest": _npy(f_rest), "identity": _npy(identity),
              "scaling": _npy(scaling), "rotation": _npy(rotation),
              "opacity": _npy(opacity)}
    n = arrays["xyz"].shape[0]
    assert n <= capacity, f"reference cloud has {n} points > capacity"

    def pad(x):
        return np.pad(np.asarray(x, np.float32),
                      [(0, capacity - n)] + [(0, 0)] * (x.ndim - 1))

    rest_k = arrays["features_rest"].shape[1]
    max_sh_degree = int(round((rest_k + 1) ** 0.5)) - 1

    state = {
        "params": {k: pad(v) for k, v in arrays.items()},
        "alive": np.arange(capacity) < n,
        "max_radii2d": pad(_npy(max_radii2d).reshape(n)),
        "xyz_grad_accum": pad(_npy(grad_accum).reshape(n)),
        "denom": pad(_npy(denom).reshape(n)),
        "active_sh_degree": int(active_sh_degree),
        "dropped_children": 0,
        "spatial_lr_scale": float(spatial_lr_scale),
        "max_sh_degree": max_sh_degree,
    }

    # torch Adam state -> per-attribute moments (groups named at
    # scene/gaussian_model.py:369-403; 'neural_*' groups hold the PMF /
    # GridRenderer params and are skipped — their optimizers restart)
    mu = {k: np.zeros_like(state["params"][k]) for k in arrays}
    nu = {k: np.zeros_like(state["params"][k]) for k in arrays}
    step = 0
    if isinstance(opt_sd, dict) and "param_groups" in opt_sd:
        for g in opt_sd["param_groups"]:
            name = g.get("name", "")
            if name not in _GROUPS:
                continue
            attr = _GROUPS[name]
            for pid in g["params"]:
                st = opt_sd.get("state", {}).get(pid)
                if not st:
                    continue
                mu[attr] = pad(_npy(st["exp_avg"]).reshape(
                    arrays[attr].shape))
                nu[attr] = pad(_npy(st["exp_avg_sq"]).reshape(
                    arrays[attr].shape))
                step = max(step, int(_npy(st["step"]).reshape(-1)[0]))
    gopt = {"mu": mu, "nu": nu, "step": step}

    pmf_params = None
    if pmf_sd is not None:
        pmf_params = convert_pmf(pmf_sd, extractor, kind)
    return {"state": state, "gopt": gopt, "pmf_params": pmf_params}


def convert_reference_checkpoint(in_path: str, out_path: str, kind: str,
                                 capacity: int, extractor: str) -> str:
    """Convert a reference .pth trainer checkpoint to a native bundle.

    kind: 'face' | 'mouth' | 'fuse'.
    """
    data = torch.load(in_path, map_location="cpu", weights_only=False)
    if kind == "fuse":
        face_cap, face_umf_sd, mouth_cap, mouth_umf_sd = data
        face = convert_capture(face_cap, capacity, extractor, "face")
        mouth = convert_capture(mouth_cap, capacity, extractor, "mouth")
        bundle = dict(
            face_state=face["state"], mouth_state=mouth["state"],
            face_umf_params=convert_motion_net(face_umf_sd, extractor),
            mouth_umf_params=convert_mouth_motion_net(mouth_umf_sd, extractor),
            face_pmf_params=face["pmf_params"],
            mouth_pmf_params=mouth["pmf_params"])
    else:
        capture, umf_sd, _umf_opt_sd, iteration = data
        conv = convert_capture(capture, capacity, extractor, kind)
        umf = (convert_motion_net(umf_sd, extractor) if kind == "face"
               else convert_mouth_motion_net(umf_sd, extractor))
        bundle = dict(state=conv["state"], gopt=conv["gopt"],
                      umf_params=umf, pmf_params=conv["pmf_params"],
                      iteration=int(iteration),
                      max_sh_degree=conv["state"]["max_sh_degree"])
    save_bundle(out_path, bundle)
    return out_path


def convert_ave_encoder(state_dict,
                        out_path: str = "weights/ave_encoder.npz") -> str:
    """SyncTalk ``audio_visual_encoder.pth`` -> the JAX AudioEncoder's .npz
    (the AVE mel encoder, reference scene/motion_net.py:100-129: 13
    Conv2d+BatchNorm blocks under ``audio_encoder.{i}.conv_block.{0,1}``).

    Output keys follow flax flatten_dict(sep="/") over the AudioEncoder
    variables: what the JAX package's AVE extractor loads, and what
    ``io.from_jax.load_audio_encoder`` reads into the port's
    ``models.nets.AudioEncoder``.
    """
    # tolerate a wrapping module prefix (checkpoints sometimes carry
    # e.g. "model.audio_encoder....")
    sd = {}
    for k, v in state_dict.items():
        pos = k.find("audio_encoder.")
        if pos >= 0:
            sd[k[pos + len("audio_encoder."):]] = v
    out = {}
    for i in range(13):
        w = _npy(sd[f"{i}.conv_block.0.weight"])      # [O, I, kh, kw]
        out[f"params/block_{i}/conv/kernel"] = w.transpose(2, 3, 1, 0)
        out[f"params/block_{i}/conv/bias"] = _npy(sd[f"{i}.conv_block.0.bias"])
        out[f"params/block_{i}/bn/scale"] = _npy(sd[f"{i}.conv_block.1.weight"])
        out[f"params/block_{i}/bn/bias"] = _npy(sd[f"{i}.conv_block.1.bias"])
        out[f"batch_stats/block_{i}/bn/mean"] = _npy(
            sd[f"{i}.conv_block.1.running_mean"])
        out[f"batch_stats/block_{i}/bn/var"] = _npy(
            sd[f"{i}.conv_block.1.running_var"])
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    np.savez(out_path, **out)
    return out_path
